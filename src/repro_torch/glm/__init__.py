"""The estimator frontend of the port (sklearn-style ``fit``, ``predict``,
``score``); ``repro_torch.core.solver.GLMSolver`` is the session layer
beneath it."""
from repro_torch.glm.estimators import (ElasticNetGLM, LogisticRegressionCD,
                                        MultinomialGLM, PoissonRegressorCD)

__all__ = ["ElasticNetGLM", "LogisticRegressionCD", "MultinomialGLM",
           "PoissonRegressorCD"]
