"""Plain PyTorch versions of the CUDA kernels of this package.

They mirror ``repro/kernels/ref.py`` (the JAX oracles) operation for
operation.  ``kernels/ops.py`` runs them for tensors on the CPU, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.  Nothing
on the solver's path calls them for a CUDA tensor; the recurrences' scans
run them on the card for a call whose input requires a gradient
(training: ``ops.py``), counted apart.

``tile_live`` arguments are optional host (n_tiles,) bool masks: only the
live tiles' Grams are formed, and dead tiles get G = g = 0 and a zero step
(the JAX oracle's ``shaped_tile_grams`` compacts the same way, under a
``lax.cond`` over fixed compaction sizes that eager PyTorch does not need).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import glm as glm_lib


def cd_tile_solve(G, g, h, beta_t, dbeta_t, mu, nu, lam1, lam2, penf=None):
    """One cyclic pass of exact coordinate minimization over a feature tile.

    G (T, T) tile Gram block; g (T,) the tile gradient at entry; h = diag(G);
    beta_t the fixed outer iterate; dbeta_t the accumulated step (updated);
    penf optional (T,) penalty factors (0 = unpenalized).  Returns the new
    (T,) step.  Updating coordinate j by delta changes g_k by
    -mu * delta * G[k, j], so X is never touched again.  Leading batch
    dimensions solve several tiles side by side (the Jacobi sweep), each
    with the same operations as one tile alone.
    """
    T = g.shape[-1]
    pf = torch.ones_like(g) if penf is None else penf
    mu = torch.as_tensor(mu, dtype=g.dtype, device=g.device)
    nu = torch.as_tensor(nu, dtype=g.dtype, device=g.device)
    lam1v = lam1 * pf
    lam2v = lam2 * pf
    den = mu * h + nu + lam2v
    den_safe = torch.clamp(den, min=1e-30)
    g_c = g.clone()
    d_c = dbeta_t.clone()
    for j in range(T):
        b_j = beta_t[..., j]
        num = g_c[..., j] + mu * h[..., j] * (b_j + d_c[..., j]) + nu * b_j
        u = glm_lib.soft_threshold(num, lam1v[..., j]) / den_safe[..., j]
        # dead coordinate (all-zero column, nu == lam2 == 0): keep at 0
        u = torch.where(den[..., j] > 0, u, b_j)
        d_new = u - b_j
        delta = d_new - d_c[..., j]
        g_c = g_c - (mu * delta)[..., None] * G[..., :, j]
        d_c[..., j] = d_new
    return d_c


def jacobi_tile_solves(G_all, g_all, beta, mu, nu, lam1, lam2, penf=None,
                       tile_live=None):
    """Every tile's chain from a zero step (Jacobi: the tiles do not see
    each other's steps); returns the (p,) step, zero on dead tiles."""
    nt, T = g_all.shape
    beta_r = beta.reshape(nt, T)
    penf_r = None if penf is None else penf.reshape(nt, T)
    h_all = torch.diagonal(G_all, dim1=1, dim2=2)
    d = cd_tile_solve(G_all, g_all, h_all, beta_r, torch.zeros_like(beta_r),
                      mu, nu, lam1, lam2, penf=penf_r)
    if tile_live is not None:
        live = torch.from_numpy(np.asarray(tile_live, bool)).to(d.device)
        d = torch.where(live[:, None], d, torch.zeros_like(d))
    return d.reshape(-1)


def tile_gram(bricks, rows, n_valid, w2, r2, precision="fp32"):
    """G = sum_k b_k^T diag(w[rows[k]]) b_k,  g = sum_k b_k^T r[rows[k]].

    bricks (K, rb, T) the bricks of one feature tile (slots k >= n_valid are
    ignored); rows (K,) their row-block ids; w2, r2 (n_row_blocks, rb).
    ``precision="bf16"`` rounds b w (formed in float32), b and r to
    bfloat16 and sums in float64, as ``gram_brick_tiles`` (below) does.
    """
    K = bricks.shape[0]
    mask = (torch.arange(K, device=bricks.device) < int(n_valid)) \
        .to(bricks.dtype)
    b = bricks * mask[:, None, None]
    wk = w2[rows.long()]
    rk = r2[rows.long()]
    if is_bf16(precision):
        B = _bf16(b)
        G = torch.einsum("kit,kiu->tu", _bf16(b * wk[:, :, None]), B)
        g = torch.einsum("kit,ki->t", B, _bf16(rk))
        return G.float(), g.float()
    G = torch.einsum("kit,kiu->tu", b * wk[:, :, None], b)
    g = torch.einsum("kit,ki->t", b, rk)
    return G, g


def glm_stats(y, xb, weights, family, offset=None):
    """(loss_i, s_i, w_i) at margins ``xb + offset``, scaled by ``weights``."""
    fam = glm_lib.resolve_family(family)
    return fam.stats(y, xb, weights=weights, offset=offset)


def multinomial_stats(y, margins, weights=None, offset=None):
    """The softmax family's statistics: margins (n, K), y integer class
    ids; s and w come back (n, K), the loss (n,).  No kernel has a body
    for it: the class-cycling estimator needs only the logistic one."""
    fam = glm_lib.resolve_family("multinomial")
    return fam.stats(y, margins, weights=weights, offset=offset)


def alpha_search(y, xb, xdb, weights, alphas, family, offset=None):
    """losses[k] = sum_i weights_i * l(y_i, xb_i + o_i + alphas[k] * xdb_i)."""
    fam = glm_lib.resolve_family(family)
    if offset is not None:
        xb = xb + offset
    m = xb[None, :] + alphas[:, None] * xdb[None, :]
    loss, _, _ = fam.stats(y[None, :], m)
    return torch.sum(loss * weights[None, :], dim=-1)


# ---------------------------------------------------------------------------
# fused superstep (K5 stats_gram_solve, K6 margin_ls)
#
# ``precision`` is the reference's ``DGLMNETConfig.precision``: "fp32", or
# "bf16" for bfloat16 inputs of the Gram and margin products (w x formed in
# float32 and then rounded, x, s and dbeta rounded, to nearest even) with
# the products summed in float32 or wider; the stats, the solves and the
# candidate losses stay float32 either way.  A product of two bfloat16
# values is exact in float32, so the sums below differ from the kernels'
# only in their order.  Never ``torch.matmul`` on bfloat16 tensors: its
# output would be rounded to bfloat16.
# ---------------------------------------------------------------------------

PRECISIONS = ("fp32", "bf16")


def is_bf16(precision: str) -> bool:
    """True for "bf16", False for "fp32"; anything else raises."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; have "
                         f"{PRECISIONS}")
    return precision == "bf16"


def _bf16(x):
    """x rounded to bfloat16 (to nearest, ties to even), as float64."""
    return x.to(torch.bfloat16).double()


def gram_dense_tiles(Xt3, w, r, precision="fp32"):
    """(G_all (nt, T, T), g_all (nt, T)) from the tile-major (nt, n, T)
    operand: G_t = X_t^T diag(w) X_t, g_t = X_t^T r, one batched product
    each, summed in float64 and rounded to float32.  A float32 product on
    the card may sum its n rows in one running sum, which drifts by up to
    n x 6e-8 of a sum of near-equal terms such as the intercept's diagonal
    entry, so the plain version would be the worse of the two it is held
    against.  Under "bf16", G_t[i, j] = sum_k bf16(w_k x_ki) bf16(x_kj),
    which is not symmetric."""
    if is_bf16(precision):
        A = _bf16(Xt3 * w[None, :, None])
        B = _bf16(Xt3)
        rr = _bf16(r)
    else:
        B = Xt3.double()
        A = B * w.double()[None, :, None]
        rr = r.double()
    G = torch.matmul(A.transpose(1, 2), B)
    g = torch.matmul(B.transpose(1, 2), rr[None, :, None])[..., 0]
    return G.float(), g.float()


def gram_brick_tiles(b3, rows, valid, w, r, precision="fp32"):
    """(G_all, g_all) from the batched brick layout of
    ``BlockSparseDesign.gather_all_tiles``: b3 (nt, K, rb, T), rows (nt, K)
    row-block ids, valid (nt, K) 0/1.  Each tile's K bricks are one
    (K rb, T) operand of a batched product, summed in float64 as in
    ``gram_dense_tiles``.  Under "bf16" the brick times its gathered
    (weight times valid) is formed in float32 and then rounded; the weight
    itself is not rounded."""
    nt, K, rb, T = b3.shape
    b3f = b3.reshape(nt, K * rb, T)
    rows = rows.long()
    wk = (w.reshape(-1, rb)[rows] * valid[..., None]).reshape(nt, K * rb, 1)
    rk = (r.reshape(-1, rb)[rows] * valid[..., None]).reshape(nt, K * rb, 1)
    if is_bf16(precision):
        A = _bf16(b3f * wk)
        B = _bf16(b3f)
        rr = _bf16(rk)
    else:
        B = b3f.double()
        A = B * wk.double()
        rr = rk.double()
    G = torch.matmul(A.transpose(1, 2), B)
    g = torch.matmul(B.transpose(1, 2), rr)[..., 0]
    return G.float(), g.float()


def shaped_tile_grams(n_tiles, gram_of_ids, tile_live):
    """The live tiles' (G, g) from ``gram_of_ids(ids)``, scattered into
    zeros; every tile when ``tile_live`` is None."""
    if tile_live is None:
        return gram_of_ids(slice(None))
    ids = torch.from_numpy(np.flatnonzero(np.asarray(tile_live, bool)))
    G_s, g_s = gram_of_ids(ids)
    G = G_s.new_zeros((n_tiles,) + tuple(G_s.shape[1:]))
    g = g_s.new_zeros((n_tiles,) + tuple(g_s.shape[1:]))
    G[ids.to(G.device)] = G_s
    g[ids.to(g.device)] = g_s
    return G, g


def fused_stats_gram_dense(Xt3, y, xb, weights, family, offset=None,
                           tile_live=None, precision="fp32"):
    """(loss_i, s, w, G_all, g_all): the link stats and every live tile's
    Gram and gradient (r = s: the step enters at zero) on the dense
    tile-major layout."""
    loss_i, s, w = glm_stats(y, xb, weights, family, offset=offset)
    G, g = shaped_tile_grams(
        Xt3.shape[0],
        lambda ids: gram_dense_tiles(Xt3[ids], w, s, precision), tile_live)
    return loss_i, s, w, G, g


def fused_stats_gram_bricks(b3, rows, valid, y, xb, weights, family,
                            offset=None, tile_live=None, precision="fp32"):
    """Brick-layout twin of ``fused_stats_gram_dense``."""
    loss_i, s, w = glm_stats(y, xb, weights, family, offset=offset)
    G, g = shaped_tile_grams(
        b3.shape[0],
        lambda ids: gram_brick_tiles(b3[ids], rows[ids], valid[ids], w, s,
                                     precision),
        tile_live)
    return loss_i, s, w, G, g


def stats_gram_solve(Xt3, y, xb, weights, beta, family, *, mu, nu, lam1,
                     lam2, offset=None, penf=None, tile_live=None,
                     precision="fp32"):
    """K5's function: (loss_i, s, w, G_all, g_all, dbeta (p,)), the stats,
    every live tile's Gram and gradient, and each live tile's chain from a
    zero step; dead tiles get G = g = 0 and a zero step."""
    loss_i, s, w, G, g = fused_stats_gram_dense(
        Xt3, y, xb, weights, family, offset=offset, tile_live=tile_live,
        precision=precision)
    dbeta = jacobi_tile_solves(G, g, beta, mu, nu, lam1, lam2, penf=penf,
                               tile_live=tile_live)
    return loss_i, s, w, G, g, dbeta


def fused_ls_dense(Xt3, y, xb, dbeta, weights, alphas, family, offset=None,
                   precision="fp32"):
    """K6's function: the margin delta xdb = X dbeta (summed over tiles)
    and every candidate step's loss, (xdb (n,), losses (K,)).  Under
    "bf16", X and dbeta are rounded first (float32 products of the rounded
    values are exact); the losses are float32 either way."""
    nt, _, T = Xt3.shape
    dr = dbeta.reshape(nt, T)
    if is_bf16(precision):
        Xt3 = Xt3.to(torch.bfloat16).float()
        dr = dr.to(torch.bfloat16).float()
    xdb = torch.sum(torch.matmul(Xt3, dr[:, :, None])[..., 0], dim=0)
    losses = alpha_search(y, xb, xdb, weights, alphas, family,
                          offset=offset)
    return xdb, losses


# ---------------------------------------------------------------------------
# predict_tile (K7): fused sparse scoring for serving
# ---------------------------------------------------------------------------


def predict_tile(slots, vals, table, b0, family, kind="link"):
    """out[b, l] = link(sum_j vals[b, j] table[slots[b, j], l] + b0[l]).

    slots (B, J) int32 rows of the compacted table (padding and inactive
    features point at its trailing all-zero row); vals (B, J) f32; table
    (A+1, L) f32; b0 (L,).  ``kind="link"`` gives margins, ``"response"``
    the family's inverse link.
    """
    rows = table[slots.long()]                               # (B, J, L)
    m = torch.einsum("bj,bjl->bl", vals, rows) + b0.reshape(1, -1)
    if kind == "link":
        return m
    return glm_lib.resolve_family(family).predict(m)


# ---------------------------------------------------------------------------
# the two sequential scans of the paper's competing algorithms (no Pallas
# counterpart: the reference leaves them to XLA as one loop each)
# ---------------------------------------------------------------------------


def shooting_pass(At, x, v, col_sq, lam1_eff, lam2_eff, passes=1):
    """The ADMM x-update of every block: ``passes`` cyclic coordinate
    passes (Shooting) on 0.5 ||A_m x - v_m||^2 + lam1_eff ||x||_1
    + 0.5 lam2_eff ||x||^2, for all M blocks side by side.

    At (M, p_block, n) holds each block column-major (row j of block m is
    its column j), x (M, p_block), v (M, n), col_sq (M, p_block) the
    columns' squared norms.  As the reference's ``_shooting_pass``
    (``repro/baselines/admm.py``), each pass starts from a fresh residual
    r = A x - v, and coordinate j takes rho_j = a_j . r - c_j x_j,
    x_j' = S(-rho_j, lam1_eff) / max(c_j + lam2_eff, 1e-30), then
    r += a_j (x_j' - x_j).  Returns the new (M, p_block) x.
    """
    x = x.clone()
    den = torch.clamp(col_sq + lam2_eff, min=1e-30)
    for _ in range(passes):
        r = torch.einsum("mjn,mj->mn", At, x) - v
        for j in range(x.shape[1]):
            aj = At[:, j, :]
            xj = x[:, j]
            rho = torch.einsum("mn,mn->m", aj, r) - col_sq[:, j] * xj
            xj_new = glm_lib.soft_threshold(-rho, lam1_eff) / den[:, j]
            r = r + aj * (xj_new - xj)[:, None]
            x[:, j] = xj_new
    return x


def online_tg_steps(t0, n_rows: int, lr, power):
    """(n_rows,) float32 step sizes eta = lr / t^power of one online pass,
    with t counted up by 1 in float32 from ``t0`` (the reference's scan
    carries t in float32, so it stops growing at 2^24)."""
    if n_rows == 0:
        return np.zeros(0, np.float32)
    ts = np.cumsum(np.concatenate([np.float32([t0]),
                                   np.ones(n_rows - 1, np.float32)]),
                   dtype=np.float32)
    return (np.float32(lr) / np.power(ts, np.float32(power))) \
        .astype(np.float32)


def online_tg_epoch(X_sh, y_sh, w0, t0, family, lr, power, lam1, lam2):
    """One pass of every shard of distributed online truncated gradient,
    from the shared start w0 (p,) at global step t0; returns the shards'
    mean weight (p,), as the reference's ``_epoch``
    (``repro/baselines/online_tg.py``).

    X_sh (M, n_per, p), y_sh (M, n_per).  Each shard walks its rows in
    order: m = x . w, the family's s at m, then w += (eta s) x, the L2
    shrink w *= 1 - eta lam2 and the truncation w = S(w, eta lam1).
    """
    fam = glm_lib.resolve_family(family)
    M, n_per, p = X_sh.shape
    etas = torch.from_numpy(online_tg_steps(t0, n_per, lr, power)) \
        .to(X_sh.device)
    w = w0.reshape(1, p).expand(M, p).clone()
    for i in range(n_per):
        x = X_sh[:, i, :]
        eta = etas[i]
        _, s, _ = fam.stats(y_sh[:, i], torch.einsum("mp,mp->m", x, w))
        w = w + (eta * s)[:, None] * x
        w = w * (1.0 - eta * lam2)
        w = glm_lib.soft_threshold(w, eta * lam1)
    return torch.mean(w, dim=0)


# ---------------------------------------------------------------------------
# the recurrences' scans of the LM template (no Pallas counterpart: the
# reference runs each as a lax.scan, which XLA compiles into one loop)
# ---------------------------------------------------------------------------

def _log_sigmoid(x):
    """log sigmoid(x) as the reference writes it, -softplus(-x)."""
    return -F.softplus(-x)


# The training forms save what the backward needs.  Mamba2's and the
# mLSTM's states are large ((hd, ds) and (hd_k, hd_v) a head), so the
# forward keeps the state before every CKPT_EVERY-th step and the backward
# recomputes a segment's states from its checkpoint, with the forward's own
# step, then runs that segment in reverse.  16 steps: the checkpoints of a
# 1,024-step Mamba2 call are 1/16 of its states (128 MB at zamba2's B 2, H
# 64, hd 64, ds 64), and the kernel's segment of 17 states a (b, h) is 35
# MB there, inside the card's 50 MB L2.  The sLSTM's state is small: its
# forward saves every step's c, n, m and gate pre-activations.  The
# backward oracles below are explicit reverse-time loops, no autograd;
# they follow the plain loops' autograd at torch.maximum (half the
# gradient to each side at a tie), abs (0 at 0), clamp_min (the whole
# gradient at the bound) and softplus (its threshold of 20).
CKPT_EVERY = 16


def _max_weights(a, b):
    """The shares of torch.maximum(a, b)'s gradient that go to a and b."""
    wa = (a > b).to(a.dtype) + 0.5 * (a == b).to(a.dtype)
    return wa, 1.0 - wa


def _dlog_sigmoid(x):
    """d/dx of ``_log_sigmoid``: softplus'(-x), 1 past torch's threshold."""
    z = torch.exp(-x)
    return torch.where(-x > 20, torch.ones_like(x), z / (z + 1))


def _ssm_step(h, xt, Bt, dtt, A):
    """One step of Mamba2's state: h decay + (x dt) B."""
    decay = torch.exp(-dtt * A)                          # (B, H)
    upd = (xt * dtt[..., None])[..., None] * Bt[:, None, None, :]
    return h * decay[..., None, None] + upd


def ssm_scan(xh, Bm, Cm, dt, A, D, state0, ckpt_every: int = 0):
    """Mamba2's selective scan, the reference's ``_ssm_scan``
    (``repro/models/ssm.py``).  xh (B, S, H, hd); Bm, Cm (B, S, ds); dt
    (B, S, H); A, D (H,); state0 (B, H, hd, ds), all float32.  For each
    step, decay = exp(-dt A), h = h decay + (x dt) B, y = h C + D x.
    Returns (y (B, S, H, hd), the final state); with ``ckpt_every`` L
    also the states before steps 0, L, 2L, ... stacked (ceil(S / L), B,
    H, hd, ds), what ``ssm_scan_bwd`` reads."""
    h = state0
    ys, ckpts = [], []
    for t in range(xh.shape[1]):
        if ckpt_every and t % ckpt_every == 0:
            ckpts.append(h)
        xt, Ct = xh[:, t], Cm[:, t]
        h = _ssm_step(h, xt, Bm[:, t], dt[:, t], A)
        ys.append((h @ Ct[:, None, :, None])[..., 0]
                  + D[None, :, None] * xt)
    if ckpt_every:
        return torch.stack(ys, dim=1), h, torch.stack(ckpts)
    return torch.stack(ys, dim=1), h


def ssm_scan_bwd(xh, Bm, Cm, dt, A, D, ckpts, dy, dh, ckpt_every: int):
    """The gradients of ``ssm_scan`` (dxh, dBm, dCm, ddt, dA, dD,
    dstate0) from its inputs, its checkpoints and the cotangents of y
    (dy) and of the final state (dh).  Segment by segment from the last,
    the states are recomputed from the checkpoint, then
    G = dL/dh_t runs back: G += dy_t C_t, the step's gradients from G,
    h_{t-1} and h_t, then G *= decay_t."""
    L = ckpt_every
    S = xh.shape[1]
    G = dh
    dx, ddt = torch.empty_like(xh), torch.empty_like(dt)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    dA, dD = torch.zeros_like(A), torch.zeros_like(D)
    for seg in reversed(range(ckpts.shape[0])):
        t0, t1 = seg * L, min(S, seg * L + L)
        hs = [ckpts[seg]]
        for t in range(t0, t1):
            hs.append(_ssm_step(hs[-1], xh[:, t], Bm[:, t], dt[:, t], A))
        for t in reversed(range(t0, t1)):
            h_t, h_p = hs[t - t0 + 1], hs[t - t0]
            xt, Bt, Ct, dtt, dyt = xh[:, t], Bm[:, t], Cm[:, t], dt[:, t], \
                dy[:, t]
            G = G + dyt[..., None] * Ct[:, None, None, :]
            dC[:, t] = torch.einsum("bhps,bhp->bs", h_t, dyt)
            dD = dD + (dyt * xt).sum(dim=(0, 2))
            decay = torch.exp(-dtt * A)
            dxdt = torch.einsum("bhps,bs->bhp", G, Bt)
            dB[:, t] = torch.einsum("bhps,bhp->bs", G, xt * dtt[..., None])
            dx[:, t] = dxdt * dtt[..., None] + D[None, :, None] * dyt
            du = (G * h_p).sum(dim=(-2, -1)) * decay         # d(-dt A)
            ddt[:, t] = (dxdt * xt).sum(dim=-1) - du * A
            dA = dA - (du * dtt).sum(dim=0)
            G = G * decay[..., None, None]
    return dx, dB, dC, ddt, dA, dD, G


def _mlstm_update(state, k, v, i_pre, f_pre):
    """The mLSTM's state update (C, n, m) of one step: the forward's and
    the backward's recompute (the same operations, the same bits)."""
    C, n, m = state
    log_f = _log_sigmoid(f_pre)
    m_new = torch.maximum(log_f + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(log_f + m - m_new)
    kv = k[..., :, None] @ v[..., None, :]               # (hd, 1) x (1, hd_v)
    C = C * f_g[..., None, None] + i_g[..., None, None] * kv
    n = n * f_g[..., None] + i_g[..., None] * k
    return C, n, m_new


def _mlstm_step(state, q, k, v, i_pre, f_pre):
    """``mlstm_step`` that also returns q.n (the normalizer's sign and
    branch, what the backward reads)."""
    C, n, m_new = _mlstm_update(state, k, v, i_pre, f_pre)
    num = (q[..., None, :] @ C)[..., 0, :]               # (B, H, hd_v)
    qn = (q[..., None, :] @ n[..., :, None])[..., 0, 0]  # (B, H)
    den = torch.maximum(qn.abs(), torch.exp(-m_new))
    return (C, n, m_new), num / den[..., None], qn


def mlstm_step(state, q, k, v, i_pre, f_pre):
    """One mLSTM step, the reference's ``_mlstm_step``
    (``repro/models/xlstm.py``): state (C (B, H, hd, hd_v), n (B, H, hd),
    m (B, H)); q, k (B, H, hd), k scaled by 1/sqrt(hd); v (B, H, hd_v);
    gates (B, H).  The memory's update k v^T and the normalizer q.n are
    matrix products, as the reference's einsums are.  Returns (state,
    h (B, H, hd_v))."""
    state, h, _ = _mlstm_step(state, q, k, v, i_pre, f_pre)
    return state, h


def mlstm_scan(q, k, v, i_pre, f_pre, state, ckpt_every: int = 0):
    """The mLSTM step scan, the reference's ``_mlstm_core`` over its
    scaled keys: q, k (B, S, H, hd), k scaled by 1/sqrt(hd); v (B, S, H,
    hd_v); gates (B, S, H); state (C, n, m) as ``mlstm_step``'s.  Returns
    (h (B, S, H, hd_v), the final state); with ``ckpt_every`` L also
    (C and n before steps 0, L, 2L, ... stacked, every step's m and q.n
    (B, S, H)), what ``mlstm_scan_bwd`` reads."""
    hs, Cs, ns, ms, qns = [], [], [], [], []
    for t in range(q.shape[1]):
        if ckpt_every and t % ckpt_every == 0:
            Cs.append(state[0])
            ns.append(state[1])
        state, h, qn = _mlstm_step(state, q[:, t], k[:, t], v[:, t],
                                   i_pre[:, t], f_pre[:, t])
        hs.append(h)
        ms.append(state[2])
        qns.append(qn)
    if ckpt_every:
        return torch.stack(hs, dim=1), state, (
            torch.stack(Cs), torch.stack(ns), torch.stack(ms, dim=1),
            torch.stack(qns, dim=1))
    return torch.stack(hs, dim=1), state


def mlstm_scan_bwd(q, k, v, i_pre, f_pre, m0, saved, hs, dhs, dC, dn, dm,
                   ckpt_every: int):
    """The gradients of ``mlstm_scan`` (dq, dk, dv, di_pre, df_pre, dC0,
    dn0, dm0) from its inputs, m0, its saved (C and n checkpoints, ms,
    qns), its output hs and the cotangents of hs and of the final (C, n,
    m).  Segment by segment from the last, (C, n) are recomputed from the
    checkpoint by the forward's state update; then, with den = max(|q.n|, e^-m),
    dC_{t-1} = f_g (dC_t + q_t dnum_t^T) with dnum = dh / den, the same
    for dn with q_t d(q.n)_t, and the stabilizer's scalar chain through
    the maxes."""
    L = ckpt_every
    C_ck, n_ck, ms, qns = saved
    S = q.shape[1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    di_pre, df_pre = torch.empty_like(i_pre), torch.empty_like(f_pre)
    for seg in reversed(range(C_ck.shape[0])):
        t0, t1 = seg * L, min(S, seg * L + L)
        m_p = ms[:, t0 - 1] if t0 else m0
        sts = [(C_ck[seg], n_ck[seg], m_p)]
        for t in range(t0, t1):
            sts.append(_mlstm_update(sts[-1], k[:, t], v[:, t], i_pre[:, t],
                                     f_pre[:, t]))
        for t in reversed(range(t0, t1)):
            (C_p, n_p, m_p), (C_t, n_t, m_t) = sts[t - t0], sts[t - t0 + 1]
            qt, kt, vt, it, ft = q[:, t], k[:, t], v[:, t], i_pre[:, t], \
                f_pre[:, t]
            log_f = _log_sigmoid(ft)
            a = log_f + m_p
            i_g = torch.exp(it - m_t)
            f_g = torch.exp(a - m_t)
            qn, e = qns[:, t], torch.exp(-m_t)
            den = torch.maximum(qn.abs(), e)
            dh = dhs[:, t]
            dnum = dh / den[..., None]
            dden = -(dh * hs[:, t]).sum(dim=-1) / den
            w_q, w_e = _max_weights(qn.abs(), e)
            dqn = dden * w_q * torch.sign(qn)
            dm = dm - e * (dden * w_e)
            dC = dC + qt[..., :, None] * dnum[..., None, :]
            dn = dn + qt * dqn[..., None]
            dq[:, t] = (C_t @ dnum[..., None])[..., 0] + n_t * dqn[..., None]
            dCv = (dC @ vt[..., None])[..., 0] + dn           # (B, H, hd_k)
            dk[:, t] = i_g[..., None] * dCv
            dv[:, t] = i_g[..., None] * (kt[..., None, :] @ dC)[..., 0, :]
            dig = (kt * dCv).sum(dim=-1)
            dfg = (dC * C_p).sum(dim=(-2, -1)) + (dn * n_p).sum(dim=-1)
            dC = dC * f_g[..., None, None]
            dn = dn * f_g[..., None]
            di = dig * i_g
            da = dfg * f_g
            dm = dm - di - da
            w_a, w_i = _max_weights(a, it)
            da = da + dm * w_a
            di_pre[:, t] = di + dm * w_i
            df_pre[:, t] = da * _dlog_sigmoid(ft)
            dm = da
    return dq, dk, dv, di_pre, df_pre, dC, dn, dm


def _slstm_step(r, state, g_in, sc):
    """One sLSTM step: (the new state (c, n, h, m), the gate
    pre-activations (B, 4, H, hd_v))."""
    c, n, h, m = state
    rec = torch.einsum("bhk,hgkv->bghv", h, r)            # (B, 4, H, hd_v)
    z_pre, i_pre, f_pre, o_pre = [g_in[:, i] + rec[:, i] for i in range(4)]
    if sc is None:
        i_sc = i_pre.mean(dim=-1)                         # head-level
        f_sc = f_pre.mean(dim=-1)                         # stabilization
    else:
        i_sc, f_sc = sc[:, 0], sc[:, 1]
    log_f = _log_sigmoid(f_sc)
    m_new = torch.maximum(log_f + m, i_sc)
    i_g = torch.exp(i_pre - m_new[..., None])
    f_g = torch.exp(log_f[..., None] + (m - m_new)[..., None])
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    c = f_g * c + i_g * z
    n = f_g * n + i_g
    h = o * c / torch.clamp_min(n, 1e-6)
    return (c, n, h, m_new), (z_pre, i_pre, f_pre, o_pre)


def slstm_scan(r, state, gates_in, steps: int, sc=None, save: bool = False):
    """The sLSTM scan, a ``lax.scan`` over the reference's ``_slstm_step``
    (``repro/models/xlstm.py``), over the first ``steps`` positions of
    gates_in (B, S, 4, H, hd_v) with r (H, 4, hd_k, hd_v) the recurrent
    gates.  state: (c, n (B, H, hd_v), h (B, H, hd_k), m (B, H)), h the
    whole previous output.  The head-level stabilizers are the means of
    i_pre and f_pre over hd; with ``sc`` (B, 2, H) given (one step of a
    block of hd, ``steps`` 1) they are its two rows instead.  Returns
    (h (B, steps, H, hd_v), (c, n, h, m)); with ``save`` also every
    step's (gate pre-activations (B, steps, 4, H, hd_v), c, n (B, steps,
    H, hd_v), m (B, steps, H)), what ``slstm_scan_bwd`` reads."""
    hs, pres, cs, ns, ms = [], [], [], [], []
    for t in range(steps):
        state, pre = _slstm_step(r, state, gates_in[:, t], sc)
        hs.append(state[2])
        if save:
            pres.append(torch.stack(pre, dim=1))
            cs.append(state[0])
            ns.append(state[1])
            ms.append(state[3])
    if save:
        return torch.stack(hs, dim=1), state, (
            torch.stack(pres, dim=1), torch.stack(cs, dim=1),
            torch.stack(ns, dim=1), torch.stack(ms, dim=1))
    return torch.stack(hs, dim=1), state


def slstm_scan_bwd(r, state0, sc, saved, hs, dhs, dc, dn, dh, dm):
    """The gradients of ``slstm_scan`` from r, the initial state, sc, its
    saved (pre, c, n, m a step), its output hs and the cotangents of hs
    and of the final (c, n, h, m): (dpre (B, steps, 4, H, hd_v), the
    gates' gradient on those positions; dr; dc0, dn0, dh0, dm0; dsc (B,
    2, H) or None).  Step by step from the last: the cell's gradients
    from the saved values, the head-level stabilizer's scalar chain
    (through the means, or into dsc), dh_{t-1} = sum_g r_g dpre_g,t."""
    c0, n0, h0, m0 = state0
    pres, cs, ns, ms = saved
    steps, hd = pres.shape[1], pres.shape[-1]
    dpres = torch.empty_like(pres)
    dh_rec, dsc = dh, None
    for t in reversed(range(steps)):
        z_pre, i_pre, f_pre, o_pre = pres[:, t].unbind(dim=1)
        if sc is None:
            i_sc, f_sc = i_pre.mean(dim=-1), f_pre.mean(dim=-1)
        else:
            i_sc, f_sc = sc[:, 0], sc[:, 1]
        m_t, c_t, n_t = ms[:, t], cs[:, t], ns[:, t]
        m_p, c_p, n_p = (ms[:, t - 1], cs[:, t - 1], ns[:, t - 1]) if t \
            else (m0, c0, n0)
        log_f = _log_sigmoid(f_sc)
        a = log_f + m_p
        i_g = torch.exp(i_pre - m_t[..., None])
        f_g = torch.exp(log_f + (m_p - m_t))                  # (B, H)
        z, o = torch.tanh(z_pre), torch.sigmoid(o_pre)
        nc = torch.clamp_min(n_t, 1e-6)
        dht = dhs[:, t] + dh_rec
        dc = dc + dht * o / nc
        dn = dn - dht * hs[:, t] / nc * (n_t >= 1e-6).to(n_t.dtype)
        dpre_o = dht * c_t / nc * (o * (1 - o))
        dfg = (dc * c_p).sum(dim=-1) + (dn * n_p).sum(dim=-1)
        dpre_z = dc * i_g * (1 - z * z)
        dpre_i = (dc * z + dn) * i_g
        dc = dc * f_g[..., None]
        dn = dn * f_g[..., None]
        ds = dfg * f_g
        dm = dm - dpre_i.sum(dim=-1) - ds
        w_a, w_i = _max_weights(a, i_sc)
        da, di_sc = dm * w_a, dm * w_i
        df_sc = (ds + da) * _dlog_sigmoid(f_sc)
        if sc is None:
            dpre_i = dpre_i + (di_sc / hd)[..., None]
            dpre_f = (df_sc / hd)[..., None].expand_as(dpre_i)
        else:
            dpre_f = torch.zeros_like(dpre_i)
            dsc = torch.stack([di_sc, df_sc], dim=1)
        dpre = torch.stack([dpre_z, dpre_i, dpre_f, dpre_o], dim=1)
        dpres[:, t] = dpre
        dh_rec = torch.einsum("bghv,hgkv->bhk", dpre, r)
        dm = ds + da
    return dpres, slstm_dr(h0, hs, dpres), (dc, dn, dh_rec, dm), dsc


def slstm_dr(h0, hs, dpres):
    """The sLSTM's dr_gates: the sum over rows and steps of h_{t-1}
    dpre_t, h_{-1} = h0 (the whole h: one step with ``sc`` given)."""
    hprev = h0[:, None] if dpres.shape[1] == 1 else torch.cat(
        [h0[:, None], hs[:, :-1]], dim=1)
    return torch.einsum("bthk,btghv->hgkv", hprev, dpres)
