"""Competing algorithms from paper Section 8.1, on the card: the baselines
the benchmark figures (Figs. 2-6) compare d-GLMNET against, as the
reference's ``repro.baselines`` implements them: ADMM with sharing
(feature-split, Shooting x-updates), distributed online learning by
truncated gradient (example-split), and L-BFGS warm-started by online
learning.  Dense designs only, as in the reference."""
from repro_torch.baselines.admm import fit_admm  # noqa: F401
from repro_torch.baselines.online_tg import fit_online_tg  # noqa: F401
from repro_torch.baselines.lbfgs import (  # noqa: F401
    fit_lbfgs, fit_online_warmstart_lbfgs)
