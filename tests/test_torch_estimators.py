"""repro_torch.glm (the estimators), their artifacts and the serve_glm
launcher on the CPU, against the JAX package's.

Each estimator is fitted by both packages on the same numpy inputs and
held to the reference's bar: ``coef_`` and ``intercept_`` within 1e-5,
the same predictions and labels, scores within 1e-5, CV's ``lam1_`` within
1e-6 relative and the same best index.  The cases are those of
``tests/test_estimators.py`` and the estimator cases of
``tests/test_serve.py``, their own assertions included.  Fits stop at
``tol=1e-4``: at the estimators' default 1e-10 they run into the float32
ties of ROADMAP Queue 3 item 4 (a poisson fit parts by 2.7e-4 there).
``MultinomialGLM`` compounds the per-fit bar over its class visits (3
classes x 12 cycles here): its ``coef_`` is held within 1e-4, and the gap
measured is 5.7e-6.
"""
import json

import numpy as np
import pytest
import torch

from repro.data import synthetic
from repro.glm import ElasticNetGLM as JElasticNet
from repro.glm import LogisticRegressionCD as JLogistic
from repro.glm import MultinomialGLM as JMultinomial
from repro.glm import PoissonRegressorCD as JPoisson
from repro.launch import serve_glm as jserve_glm
from repro.serve import load_artifact as jload
from repro.serve import save_artifact as jsave
from repro_torch.core.dglmnet import DGLMNETConfig
from repro_torch.core.solver import GLMSolver
from repro_torch.data.sparse import SparseCOO
from repro_torch.glm import (ElasticNetGLM, LogisticRegressionCD,
                             MultinomialGLM, PoissonRegressorCD)
from repro_torch.launch import serve_glm
from repro_torch.serve import load_artifact

CFG = dict(tile_size=16, max_outer=80, tol=1e-4, n_lambdas=10, cv=4)
BAR = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small problems: torch's intra-op threads buy nothing here and,
    beside the other test workers, spin on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_fit(port, jax_est):
    np.testing.assert_allclose(port.coef_, np.asarray(jax_est.coef_),
                               rtol=0, atol=BAR)
    assert port.intercept_ == pytest.approx(float(jax_est.intercept_),
                                            abs=BAR)


def test_logistic_estimator_01_labels():
    ds = synthetic.make_dense(n=500, p=24, k_true=6, seed=20, intercept=0.3)
    y01 = (ds.train.y > 0).astype(np.int64)           # {0, 1} encoding
    est = LogisticRegressionCD(lam1=0.1, lam2=0.05, device="cpu", **CFG)
    est.fit(ds.train.X, y01)
    jest = JLogistic(lam1=0.1, lam2=0.05, **CFG).fit(ds.train.X, y01)
    _same_fit(est, jest)
    np.testing.assert_array_equal(est.classes_, [0, 1])
    assert est.coef_.shape == (24,)
    assert isinstance(est.intercept_, float)

    yhat = est.predict(ds.test.X)
    np.testing.assert_array_equal(yhat, jest.predict(ds.test.X))
    assert set(np.unique(yhat)) <= {0, 1}
    y_te = (ds.test.y > 0).astype(np.int64)
    acc = est.score(ds.test.X, y_te)
    assert acc == pytest.approx(jest.score(ds.test.X, y_te)) and acc >= 0.75

    proba = est.predict_proba(ds.test.X)
    np.testing.assert_allclose(proba, jest.predict_proba(ds.test.X),
                               atol=BAR)
    assert proba.shape == (len(ds.test.y), 2)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, atol=1e-6)
    # column 1 is P(classes_[1]) and drives the label
    np.testing.assert_array_equal(yhat, est.classes_[
        (proba[:, 1] > 0.5).astype(int)])


def test_logistic_estimator_pm1_labels_match_01():
    """The same data under {-1, +1} and {0, 1} gives the same beta."""
    ds = synthetic.make_dense(n=300, p=16, k_true=4, seed=21)
    e1 = LogisticRegressionCD(lam1=0.2, device="cpu", **CFG).fit(
        ds.train.X, ds.train.y)
    e2 = LogisticRegressionCD(lam1=0.2, device="cpu", **CFG).fit(
        ds.train.X, (ds.train.y > 0).astype(int))
    np.testing.assert_allclose(e1.coef_, e2.coef_, atol=1e-6)
    _same_fit(e1, JLogistic(lam1=0.2, **CFG).fit(ds.train.X, ds.train.y))
    with pytest.raises(ValueError, match="exactly 2 classes"):
        LogisticRegressionCD(device="cpu", **CFG).fit(
            ds.train.X, np.arange(len(ds.train.y)))


def test_cv_selection_reproduced_by_direct_fit():
    """fit_cv's lambda and coefficients are JAX's, and the selected
    lambda fed to a plain fit reproduces the CV-fitted coefficients."""
    ds = synthetic.make_dense(n=400, p=32, k_true=5, seed=22)
    est_cv = LogisticRegressionCD(lam1=None, device="cpu", **CFG)
    est_cv.fit(ds.train.X, ds.train.y)
    jcv = JLogistic(lam1=None, **CFG).fit(ds.train.X, ds.train.y)
    assert est_cv.cv_result_.best_index == jcv.cv_result_.best_index
    # the grid's head is lambda_max with the intercept fitted first: the
    # packages agree there to about 1e-7 (ROADMAP Queue 3 item 3)
    assert est_cv.lam1_ == pytest.approx(jcv.lam1_, rel=1e-6)
    _same_fit(est_cv, jcv)
    K = len(est_cv.cv_result_.lambdas)
    assert 0 < est_cv.cv_result_.best_index < K - 1      # interior lambda

    est_direct = LogisticRegressionCD(lam1=est_cv.lam1_, device="cpu", **CFG)
    est_direct.fit(ds.train.X, ds.train.y)
    np.testing.assert_allclose(est_cv.coef_, est_direct.coef_, rtol=1e-3,
                               atol=2e-3)
    assert est_cv.intercept_ == pytest.approx(est_direct.intercept_,
                                              abs=2e-3)


def test_poisson_estimator_counts_and_d2():
    ds = synthetic.make_dense(n=500, p=16, k_true=4, family="poisson",
                              seed=23)
    est = PoissonRegressorCD(lam1=0.05, lam2=0.05, device="cpu", **CFG)
    est.fit(ds.train.X, ds.train.y)
    jest = JPoisson(lam1=0.05, lam2=0.05, **CFG).fit(ds.train.X, ds.train.y)
    _same_fit(est, jest)
    mu = est.predict(ds.test.X)
    np.testing.assert_allclose(mu, jest.predict(ds.test.X), rtol=BAR)
    assert (mu > 0).all()                      # exp link
    d2 = est.score(ds.test.X, ds.test.y)
    assert d2 == pytest.approx(jest.score(ds.test.X, ds.test.y), abs=BAR)
    assert 0.0 < d2 <= 1.0
    with pytest.raises(ValueError, match="nonnegative"):
        PoissonRegressorCD(device="cpu", **CFG).fit(
            ds.train.X, -np.ones(len(ds.train.y)))


def test_elasticnet_glm_generic_family_and_offset():
    ds = synthetic.make_dense(n=400, p=16, k_true=4, family="squared",
                              seed=24)
    kw = dict(family="squared", lam1=0.05, lam2=0.05, standardize=True,
              **CFG)
    off = np.full(len(ds.train.y), 0.5, np.float32)
    est = ElasticNetGLM(device="cpu", **kw).fit(ds.train.X, ds.train.y,
                                                offset=off)
    jest = JElasticNet(**kw).fit(ds.train.X, ds.train.y, offset=off)
    _same_fit(est, jest)
    # R^2 on held-out rows, with the matching offset
    off_te = np.full(len(ds.test.y), 0.5, np.float32)
    r2 = est.score(ds.test.X, ds.test.y, offset=off_te)
    assert r2 == pytest.approx(jest.score(ds.test.X, ds.test.y,
                                          offset=off_te), abs=BAR)
    assert r2 > 0.5
    # the offset shifts the link by exactly the given amount
    m0 = est.decision_function(ds.test.X)
    m1 = est.decision_function(ds.test.X,
                               offset=np.ones(len(ds.test.y), np.float32))
    np.testing.assert_allclose(m1 - m0, 1.0, atol=1e-6)


def test_family_pinning_and_unfitted_errors():
    with pytest.raises(ValueError, match="fixed to the"):
        LogisticRegressionCD(family="poisson")
    est = ElasticNetGLM(lam1=0.1, device="cpu", **CFG)
    with pytest.raises(ValueError, match="not fitted"):
        est.predict(np.zeros((3, 2), np.float32))
    with pytest.raises(ValueError, match="not fitted"):
        MultinomialGLM(device="cpu").predict(np.zeros((3, 2), np.float32))
    # file inputs are ported (a missing file raises, and y=None needs a
    # path or a reader); a mesh is a later slice of the port
    with pytest.raises(FileNotFoundError):
        est.fit("data.svm")
    with pytest.raises(ValueError, match="y=None"):
        MultinomialGLM(device="cpu").fit(np.zeros((4, 2), np.float32))
    with pytest.raises(NotImplementedError, match="not ported"):
        ElasticNetGLM(family="squared", lam1=0.1, mesh=object(),
                      device="cpu").fit(np.zeros((4, 2), np.float32),
                                        np.ones(4, np.float32))


def test_estimator_config_passthrough():
    """An explicit DGLMNETConfig wins over the convenience knobs."""
    cfg = DGLMNETConfig(tile_size=32, coupling="jacobi", max_outer=40)
    ds = synthetic.make_dense(n=200, p=16, k_true=4, seed=25)
    est = ElasticNetGLM(lam1=0.3, config=cfg, device="cpu")
    est.fit(ds.train.X, ds.train.y)
    assert est.solver_.config.tile_size == 32
    assert est.solver_.config.coupling == "jacobi"
    assert est.solver_.device.type == "cpu"


def _multinomial_data():
    rng = np.random.default_rng(31)
    n, p, k = 240, 12, 3
    X = rng.normal(size=(n, p)).astype(np.float32)
    B = np.zeros((p, k), np.float32)
    B[:4] = rng.normal(size=(4, k)) * 2.0
    yk = np.argmax(X @ B + 0.3 * rng.normal(size=(n, k)), axis=1)
    return X, np.asarray(["ham", "spam", "eggs"])[yk]   # non-int classes


def test_multinomial_estimator():
    """Class-cycling softmax: label encoding over any class values,
    softmax probabilities, a fit that beats the majority class, and JAX's
    cycles and coefficients."""
    X, labels = _multinomial_data()
    n, p, k = X.shape[0], X.shape[1], 3
    kw = dict(lam1=1e-3, lam2=1e-3, tile_size=16, max_cycles=12,
              standardize=True, tol=1e-4)
    est = MultinomialGLM(device="cpu", **kw).fit(X, labels)
    jest = JMultinomial(**kw).fit(X, labels)
    assert est.n_cycles_ == jest.n_cycles_
    np.testing.assert_allclose(est.coef_, np.asarray(jest.coef_), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(est.intercept_, np.asarray(jest.intercept_),
                               rtol=0, atol=1e-4)
    assert est.objective_ == pytest.approx(jest.objective_, rel=1e-5)
    np.testing.assert_array_equal(est.classes_, ["eggs", "ham", "spam"])
    assert est.coef_.shape == (p, k) and est.intercept_.shape == (k,)
    assert est.n_cycles_ <= 12 and np.isfinite(est.objective_)

    proba = est.predict_proba(X)
    np.testing.assert_allclose(proba, jest.predict_proba(X), atol=1e-4)
    assert proba.shape == (n, k)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, atol=1e-5)
    yhat = est.predict(X)
    assert set(np.unique(yhat)) <= set(est.classes_)
    np.testing.assert_array_equal(
        yhat, est.classes_[np.argmax(est.decision_function(X), axis=1)])
    acc = est.score(X, labels)
    assert acc == pytest.approx(jest.score(X, labels))
    baseline = max(np.mean(labels == c) for c in est.classes_)
    assert acc >= max(0.7, baseline + 0.1), (acc, baseline)
    # SparseCOO rows go through the serving engine and score the same
    coo = SparseCOO(*np.nonzero(X), X[np.nonzero(X)], X.shape)
    np.testing.assert_allclose(est.decision_function(coo),
                               est.decision_function(X), atol=1e-5)


def test_multinomial_two_class_matches_logistic_ranking():
    """With K = 2 the class-cycling fit ranks examples like a binary
    logistic fit on the same data (the coefficients split symmetrically,
    so orderings are compared, not beta)."""
    ds = synthetic.make_dense(n=240, p=12, k_true=4, seed=33)
    y01 = (ds.train.y > 0).astype(int)
    mn = MultinomialGLM(lam1=1e-3, lam2=1e-3, tile_size=16, max_cycles=12,
                        device="cpu").fit(ds.train.X, y01)
    lg = LogisticRegressionCD(lam1=1e-3, lam2=1e-3, tile_size=16,
                              max_outer=80, tol=1e-10,
                              device="cpu").fit(ds.train.X, y01)
    m_mn = mn.decision_function(ds.train.X)
    score_mn = m_mn[:, 1] - m_mn[:, 0]
    score_lg = lg.decision_function(ds.train.X)
    r_mn = np.argsort(np.argsort(score_mn))
    r_lg = np.argsort(np.argsort(score_lg))
    rho = np.corrcoef(r_mn, r_lg)[0, 1]
    assert rho > 0.99, rho
    assert mn.score(ds.train.X, y01) >= 0.8


# -------------------------------------------------------------- artifacts


def _problem(family, n=120, p=24, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p)).astype(np.float32)
    beta = np.zeros(p, np.float32)
    beta[: p // 4] = rng.normal(size=p // 4)
    m = X @ beta
    if family == "logistic":
        y = np.where(rng.random(n) < 1 / (1 + np.exp(-m)), 1.0, -1.0)
    elif family == "poisson":
        y = rng.poisson(np.exp(np.clip(0.3 * m, -5, 3))).astype(np.float32)
    else:
        y = m + 0.1 * rng.normal(size=n)
    return X, y.astype(np.float32), rng


ESTIMATORS = {"logistic": (LogisticRegressionCD, JLogistic),
              "squared": (ElasticNetGLM, JElasticNet),
              "poisson": (PoissonRegressorCD, JPoisson)}


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("family", sorted(ESTIMATORS))
def test_estimator_artifacts_cross_packages(tmp_path, family, quantize):
    """A JAX estimator's artifact loads in the port and predicts as the
    JAX estimator loaded from it does, and the other way round; both
    packages write the same manifest for the same fit."""
    X, y, rng = _problem(family, n=140, p=20)
    if family == "logistic":
        y = (y > 0).astype(int)
    T, J = ESTIMATORS[family]
    kw = dict(lam1=0.05, lam2=0.1, tile_size=8, max_outer=60, tol=1e-4)
    if family == "squared":
        kw["family"] = "squared"
    est = T(device="cpu", **kw).fit(X, y)
    jest = J(**kw).fit(X, y)
    est.save(tmp_path / "port", quantize=quantize)
    jest.save(tmp_path / "jax", quantize=quantize)
    mine, theirs = (json.loads((tmp_path / d / "manifest.json").read_text())
                    for d in ("port", "jax"))
    for key in ("format", "version", "family", "n_outputs", "n_features",
                "dtype", "lam2", "lambdas", "standardized", "extra"):
        assert mine[key] == theirs[key], key
    assert mine["penalty"].keys() == theirs["penalty"].keys()
    X_new = rng.normal(size=(25, 20)).astype(np.float32)
    for src in ("port", "jax"):
        t_loaded = T.load(tmp_path / src, device="cpu")
        j_loaded = J.load(tmp_path / src)
        np.testing.assert_array_equal(t_loaded.coef_,
                                      np.asarray(j_loaded.coef_))
        np.testing.assert_allclose(t_loaded.predict(X_new),
                                   j_loaded.predict(X_new), rtol=BAR,
                                   atol=BAR)
        if family == "logistic":
            np.testing.assert_array_equal(t_loaded.classes_,
                                          j_loaded.classes_)
        if quantize is None:
            np.testing.assert_array_equal(t_loaded.coef_, est.coef_
                                          if src == "port" else
                                          np.asarray(jest.coef_))


def test_logistic_load_from_solver_artifact(tmp_path):
    """GLMSolver.save writes no label state; a classifier loaded from it
    still predicts, in the solver's {-1, +1} encoding."""
    X, y, rng = _problem("logistic")
    solver = GLMSolver(X, y, family="logistic", fit_intercept=True,
                       device="cpu", config=DGLMNETConfig(tile_size=8,
                                                          max_outer=60))
    solver.fit(lam1=0.05)
    solver.save(tmp_path / "s")
    clf = LogisticRegressionCD.load(tmp_path / "s", device="cpu")
    pred = clf.predict(X)
    assert set(np.unique(pred)) <= {-1.0, 1.0}
    np.testing.assert_allclose(clf.decision_function(X),
                               solver.predict(X, kind="link"), atol=1e-5)
    assert clf.predict_proba(X).shape == (len(X), 2)


def test_estimator_save_load_roundtrip(tmp_path):
    X, y, rng = _problem("logistic", n=140, p=20)
    y01 = (y > 0).astype(int)
    clf = LogisticRegressionCD(lam1=0.05, tile_size=8, max_outer=60,
                               device="cpu")
    clf.fit(X, y01)
    clf.save(tmp_path / "clf")
    clf2 = LogisticRegressionCD.load(tmp_path / "clf", device="cpu")
    np.testing.assert_allclose(clf2.coef_, clf.coef_, atol=1e-7)
    assert clf2.intercept_ == pytest.approx(clf.intercept_)
    assert (clf2.classes_ == clf.classes_).all()
    X_new = rng.normal(size=(25, 20)).astype(np.float32)
    assert (clf2.predict(X_new) == clf.predict(X_new)).all()
    np.testing.assert_allclose(clf2.predict_proba(X_new),
                               clf.predict_proba(X_new), atol=1e-5)
    assert clf2.score(X, y01) == pytest.approx(clf.score(X, y01))
    # a loaded estimator scores a SparseCOO through the fused sparse path
    mask = rng.random((10, 20)) < 0.4
    Xs = (X_new[:10] * mask).astype(np.float32)
    coo = SparseCOO(*np.nonzero(Xs), Xs[np.nonzero(Xs)], Xs.shape)
    np.testing.assert_allclose(clf2.decision_function(coo),
                               clf2.decision_function(Xs), atol=1e-5)
    np.testing.assert_allclose(clf2.decision_function(coo),
                               clf.decision_function(coo), atol=1e-6)


def test_estimator_load_guards(tmp_path):
    X, y, _ = _problem("squared", n=80, p=10)
    est = ElasticNetGLM(family="squared", lam1=0.05, tile_size=8,
                        max_outer=40, device="cpu")
    est.fit(X, y)
    est.save(tmp_path / "sq")
    with pytest.raises(ValueError, match="fixed to the 'logistic'"):
        LogisticRegressionCD.load(tmp_path / "sq", device="cpu")
    est2 = ElasticNetGLM.load(tmp_path / "sq", device="cpu")
    np.testing.assert_allclose(est2.predict(X), est.predict(X), atol=1e-5)
    assert est2.score(X, y) == pytest.approx(est.score(X, y), abs=1e-5)
    with pytest.raises(ValueError, match="not fitted"):
        ElasticNetGLM(family="squared").predict(X)


def test_loaded_estimator_reexport_preserves_provenance(tmp_path):
    """load -> save keeps the manifest's provenance (standardize, lam2,
    lambda), not the constructor's defaults."""
    X, y, _ = _problem("squared", n=80, p=10)
    est = ElasticNetGLM(family="squared", lam1=0.07, lam2=0.5,
                        standardize=False, tile_size=8, max_outer=40,
                        penalty_factor=np.linspace(0.5, 1.5, 10),
                        device="cpu")
    est.fit(X, y)
    est.save(tmp_path / "a")
    re_exported = ElasticNetGLM.load(tmp_path / "a", device="cpu")
    re_exported.save(tmp_path / "b")
    for m in (load_artifact(tmp_path / "b"), jload(tmp_path / "b")):
        assert m.standardized is False
        assert m.lam2 == pytest.approx(0.5)
        assert m.lambdas is not None and m.lambdas[0] == pytest.approx(0.07)
        np.testing.assert_allclose(m.penalty["penalty_factor"],
                                   np.linspace(0.5, 1.5, 10), rtol=1e-6)


def test_estimator_load_rejects_multi_output(tmp_path):
    jsave(tmp_path / "p", betas=np.ones((3, 4), np.float32),
          family="squared")
    with pytest.raises(ValueError, match="output columns"):
        ElasticNetGLM.load(tmp_path / "p", device="cpu")


# ------------------------------------------------------------- serve_glm


def test_serve_glm_cli(tmp_path, capsys):
    """The launcher's record: JAX's keys (and the device), the traffic's
    requests all served, the distinct scoring shapes within the bucket
    bound; ``--batch1`` serves one request a call."""
    X, y, _ = _problem("logistic", n=140, p=40)
    LogisticRegressionCD(lam1=0.02, tile_size=8, max_outer=40,
                         device="cpu").fit(X, (y > 0).astype(int)) \
        .save(tmp_path / "clf")
    art = str(tmp_path / "clf")
    out = tmp_path / "rec.json"
    assert serve_glm.main(["--artifact", art, "--requests", "150",
                           "--nnz", "12", "--max-batch", "16",
                           "--json", str(out), "--device", "cpu"]) == 0
    rec = json.loads(out.read_text())
    assert rec == json.loads(capsys.readouterr().out)
    assert rec["n_requests"] == 150 and rec["device"] == "cpu"
    assert rec["p50_ms"] > 0 and rec["p99_ms"] >= rec["p50_ms"]
    assert rec["rows_per_s"] > 0
    assert 0 < rec["compiled_shapes"] <= rec["shape_bucket_bound"] == 18
    assert rec["family"] == "logistic" and rec["mode"] == "coalesced"

    jout = tmp_path / "jrec.json"
    assert jserve_glm.main(["--artifact", art, "--requests", "20",
                            "--nnz", "12", "--max-batch", "4",
                            "--json", str(jout)]) == 0
    capsys.readouterr()
    assert set(rec) == set(json.loads(jout.read_text())) | {"device"}

    assert serve_glm.main(["--artifact", art, "--smoke", "--batch1",
                           "--kind", "link", "--device", "cpu"]) == 0
    rec1 = json.loads(capsys.readouterr().out)
    assert rec1["mode"] == "batch1" and rec1["n_requests"] == 200
    assert rec1["n_batches"] == 200 and rec1["mean_batch"] == 1.0
