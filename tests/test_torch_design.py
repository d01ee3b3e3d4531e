"""repro_torch.data against repro.data: the same generators give the same
arrays, the brick packing is bit-identical, and the design operators agree
on awkward shapes (n and p not multiples of the row block or tile, and
all-zero trailing columns).  Operators are held at 1e-5: the same float32
products summed in another order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import design as jdesign
from repro.data import sparse as jsparse
from repro.data import synthetic as jsynth
from repro_torch import convert
from repro_torch.data import design as tdesign
from repro_torch.data import sparse as tsparse
from repro_torch.data import synthetic as tsynth


def _coo_pair(seed, n, p, nnz, used_cols):
    """The same random COO for both packages; columns >= used_cols stay
    empty (all-zero trailing features)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, nnz)
    cols = (rng.pareto(1.2, nnz) * used_cols / 6).astype(np.int64) \
        % used_cols
    vals = rng.normal(size=nnz).astype(np.float32)
    return (jsparse.SparseCOO(rows, cols, vals, (n, p)),
            tsparse.SparseCOO(rows, cols, vals, (n, p)))


SHAPES = [  # (n, p, used_cols, tile, row_block)
    (100, 70, 60, 16, 32),
    (257, 129, 100, 32, 64),
    (64, 16, 16, 16, 32),
]


@pytest.mark.parametrize("n,p,used,T,rb", SHAPES)
@pytest.mark.parametrize("reorder", [True, False])
def test_build_block_sparse_is_bit_identical(n, p, used, T, rb, reorder):
    jc, tc = _coo_pair(n + p, n, p, 4 * n, used)
    jd, ji = jdesign.build_block_sparse(jc, T, row_block=rb, reorder=reorder)
    td, ti = tdesign.build_block_sparse(tc, T, row_block=rb, reorder=reorder)
    np.testing.assert_array_equal(ti.col_of_feature, ji.col_of_feature)
    np.testing.assert_array_equal(td.bricks.numpy(), np.asarray(jd.bricks))
    np.testing.assert_array_equal(td.brick_row.numpy(),
                                  np.asarray(jd.brick_row))
    np.testing.assert_array_equal(td.brick_tile.numpy(),
                                  np.asarray(jd.brick_tile))
    np.testing.assert_array_equal(td.tile_ptr, np.asarray(jd.tile_ptr))
    assert (td.shape, td.max_bricks_per_tile) == \
        (jd.shape, jd.max_bricks_per_tile)
    assert (ti.occupancy, ti.n_bricks) == (ji.occupancy, ji.n_bricks)
    np.testing.assert_array_equal(td.to_dense().numpy(),
                                  np.asarray(jd.to_dense()))


def _operators_agree(td, jd, seed):
    rng = np.random.default_rng(seed)
    n_rows, p_pad = td.shape
    T = td.tile_size
    w = rng.uniform(0.0, 1.0, n_rows).astype(np.float32)
    w[::7] = 0.0
    r = rng.normal(size=n_rows).astype(np.float32)
    v = rng.normal(size=p_pad).astype(np.float32)
    tol = dict(rtol=1e-5, atol=1e-5)
    for tid in range(td.n_tiles):
        G, g = td.tile_gram(tid, torch.from_numpy(w), torch.from_numpy(r))
        Gj, gj = jd.tile_gram(jnp.int32(tid), jnp.asarray(w), jnp.asarray(r),
                              backend="ref")
        np.testing.assert_allclose(G.numpy(), np.asarray(Gj), **tol)
        np.testing.assert_allclose(g.numpy(), np.asarray(gj), **tol)
        vt = v[tid * T:(tid + 1) * T]
        np.testing.assert_allclose(
            td.tile_matvec(tid, torch.from_numpy(vt)).numpy(),
            np.asarray(jd.tile_matvec(jnp.int32(tid), jnp.asarray(vt))),
            **tol)
    np.testing.assert_allclose(td.matvec(torch.from_numpy(v)).numpy(),
                               np.asarray(jd.matvec(jnp.asarray(v))), **tol)
    np.testing.assert_allclose(td.rmatvec(torch.from_numpy(r)).numpy(),
                               np.asarray(jd.rmatvec(jnp.asarray(r))), **tol)


@pytest.mark.parametrize("n,p,used,T,rb", SHAPES)
def test_brick_operators_match_jax(n, p, used, T, rb):
    jc, tc = _coo_pair(n * p, n, p, 4 * n, used)
    jd, _ = jdesign.build_block_sparse(jc, T, row_block=rb)
    td, _ = tdesign.build_block_sparse(tc, T, row_block=rb)
    _operators_agree(td, jd, seed=n)
    # the trailing all-zero features fill whole tiles with no bricks
    assert np.diff(td.tile_ptr).min() >= 0


@pytest.mark.parametrize("n,p,T", [(100, 70, 16), (33, 64, 32), (10, 5, 8)])
def test_dense_operators_match_jax(n, p, T):
    X = np.random.default_rng(p).normal(size=(n, p)).astype(np.float32)
    X[:, p - 3:] = 0.0                  # all-zero trailing columns
    jd, ji = jdesign.dense_design(X, T)
    td, ti = tdesign.dense_design(X, T)
    assert td.shape == tuple(jd.shape) and ti.shape == ji.shape
    np.testing.assert_array_equal(td.data.numpy(), np.asarray(jd.data))
    _operators_agree(td, jd, seed=n)


def test_design_from_numpy_carries_a_jax_design_across():
    jc, tc = _coo_pair(5, 100, 70, 400, 60)
    jd, _ = jdesign.build_block_sparse(jc, 16, row_block=32)
    td = convert.design_from_numpy(
        tile_size=16, bricks=np.asarray(jd.bricks),
        brick_row=np.asarray(jd.brick_row),
        brick_tile=np.asarray(jd.brick_tile),
        tile_ptr=np.asarray(jd.tile_ptr), row_block=32, n_rows=jd.n_rows)
    built, _ = tdesign.build_block_sparse(tc, 16, row_block=32)
    assert td.max_bricks_per_tile == built.max_bricks_per_tile
    assert torch.equal(td.bricks, built.bricks)
    _operators_agree(td, jd, seed=1)
    X = np.random.default_rng(0).normal(size=(20, 32)).astype(np.float32)
    dd = convert.design_from_numpy(tile_size=16, data=X)
    assert dd.n_tiles == 2 and torch.equal(dd.data, torch.from_numpy(X))
    with pytest.raises(ValueError):
        convert.design_from_numpy(tile_size=16, data=X[:, :20])


def test_design_info_pack_unpack_round_trip():
    jc, tc = _coo_pair(9, 100, 70, 400, 60)
    td, ti = tdesign.build_block_sparse(tc, 16, row_block=32)
    _, ji = jdesign.build_block_sparse(jc, 16, row_block=32)
    beta = np.arange(70, dtype=np.float32)
    packed = ti.pack_beta(beta, td.shape[1])
    np.testing.assert_array_equal(packed, ji.pack_beta(beta, td.shape[1]))
    np.testing.assert_array_equal(ti.unpack_beta(packed), beta)
    np.testing.assert_array_equal(ti.pack_cols(beta, td.shape[1], fill=1.0),
                                  ji.pack_cols(beta, td.shape[1], fill=1.0))


@pytest.mark.parametrize("family", ["logistic", "squared", "probit",
                                    "poisson"])
def test_generators_give_the_same_arrays(family):
    a = jsynth.make_dense(n=120, p=17, k_true=5, family=family, seed=3)
    b = tsynth.make_dense(n=120, p=17, k_true=5, family=family, seed=3)
    for sa, sb in ((a.train, b.train), (a.test, b.test), (a.valid, b.valid)):
        np.testing.assert_array_equal(sa.X, sb.X)
        np.testing.assert_array_equal(sa.y, sb.y)
    np.testing.assert_array_equal(a.beta_true, b.beta_true)
    a = jsynth.make_sparse(n=150, p=300, avg_nnz=9, k_true=10,
                           family=family, seed=4)
    b = tsynth.make_sparse(n=150, p=300, avg_nnz=9, k_true=10,
                           family=family, seed=4)
    for k in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(a.train.X, k),
                                      getattr(b.train.X, k))
    np.testing.assert_array_equal(a.train.y, b.train.y)
    assert a.meta == b.meta


def test_sparse_coo_matches_jax():
    jc, tc = _coo_pair(2, 30, 20, 90, 20)
    v = np.random.default_rng(0).normal(size=30).astype(np.float32)
    b = np.random.default_rng(1).normal(size=20).astype(np.float32)
    np.testing.assert_array_equal(tc.matvec(b), jc.matvec(b))
    np.testing.assert_array_equal(tc.rmatvec(v), jc.rmatvec(v))
    np.testing.assert_array_equal(tc.to_dense(), jc.to_dense())
    np.testing.assert_array_equal(tc.col_frequency_order(),
                                  jc.col_frequency_order())
    for k in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(tc.dedupe(), k),
                                      getattr(jc.dedupe(), k))
        np.testing.assert_array_equal(getattr(tc.take_rows([3, 1]), k),
                                      getattr(jc.take_rows([3, 1]), k))
