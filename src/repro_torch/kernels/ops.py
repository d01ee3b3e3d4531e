"""Entry points of the kernels, dispatched by the device of the tensors.

A CUDA tensor launches the hand-written kernel (or raises); a CPU tensor
runs the plain PyTorch version of ``kernels/ref.py``.  There is no backend
switch and no fallback between the two.  A family whose name is outside a
kernel's family set (``glm_stats.FAMILY_CODES``,
``predict_tile.LINK_CODES``: a registered family, the multinomial one) has
no body in that kernel and runs its plain version on either device, as the
reference routes it to its jnp oracle; the name decides before any launch,
and no launch error is ever caught.  Each CUDA kernel counts its launches
(``launch_counts``), and the calls on the card that took the plain version
for their family count apart (``"glm_stats/plain"``, ...), so a run can
show that its main path went through the kernels.  The two entries of the
tile chain (K2), ``cd_tile_solve`` and ``jacobi_tile_solves``, take its
constants as one tensor made by ``solve_params``, built once a sweep.

Beside the counts, ``launch_trace()`` collects the logical launches of
each dispatcher in call order, under the reference's names, on either
device (``record_launch``).  ``CUDA_FUNCTIONS`` names the CUDA functions
behind one logical launch of each kernel (what a profile of the card
shows), and ``kernel_resources()`` what each of them asks of the card.

The recurrences' scans (``ssm_scan``, ``mlstm_scan``, ``slstm_scan``)
have a forward and a backward kernel each.  A call whose input requires
a gradient under grad mode (a training step) goes through a
``torch.autograd.Function`` (``SsmScan``, ``MlstmScan``, ``SlstmScan``):
on the card its forward launches the forward kernel in its training mode
(which also writes what the backward reads) and its backward launches the
``<name>_bwd`` kernel; on the CPU the same Function runs the plain forward
and the plain backward of ``kernels/ref.py``.  Any other call launches the
forward kernel alone on the card (serving: the models' parameters are
frozen as built), or runs the plain loop on the CPU.  No scan call on the
card takes a plain route: their ``"<name>/plain"`` counts stay 0.
"""
from __future__ import annotations

import contextlib
import pathlib

import numpy as np
import torch

from repro_torch.core import glm as glm_lib
from repro_torch.kernels import admm_shooting as admm_shooting_k
from repro_torch.kernels import alpha_search as alpha_search_k
from repro_torch.kernels import build
from repro_torch.kernels import cd_tile_solve as cd_tile_solve_k
from repro_torch.kernels import glm_stats as glm_stats_k
from repro_torch.kernels import margin_ls as margin_ls_k
from repro_torch.kernels import mlstm_scan as mlstm_scan_k
from repro_torch.kernels import online_tg as online_tg_k
from repro_torch.kernels import predict_tile as predict_tile_k
from repro_torch.kernels import ref
from repro_torch.kernels import slstm_scan as slstm_scan_k
from repro_torch.kernels import ssm_scan as ssm_scan_k
from repro_torch.kernels import stats_gram_solve as stats_gram_solve_k
from repro_torch.kernels import tile_gram as tile_gram_k

# the bf16 modes of K3, K5 and K6 (``precision="bf16"``) count apart, so a
# run shows which mode its path went through
KERNELS = {
    "glm_stats": glm_stats_k.KERNEL,
    "cd_tile_solve": cd_tile_solve_k.KERNEL,
    "tile_gram": tile_gram_k.KERNEL,
    "alpha_search": alpha_search_k.KERNEL,
    "stats_gram_solve": stats_gram_solve_k.KERNEL,
    "margin_ls": margin_ls_k.KERNEL,
    "predict_tile": predict_tile_k.KERNEL,
    "tile_gram_bf16": tile_gram_k.KERNEL_BF16,
    "stats_gram_solve_bf16": stats_gram_solve_k.KERNEL_BF16,
    "margin_ls_bf16": margin_ls_k.KERNEL_BF16,
    # the two sequential scans of the competing algorithms (no Pallas
    # counterpart)
    "admm_shooting": admm_shooting_k.KERNEL,
    "online_tg": online_tg_k.KERNEL,
    # the LM template's recurrences (no Pallas counterpart)
    "ssm_scan": ssm_scan_k.KERNEL,
    "mlstm_scan": mlstm_scan_k.KERNEL,
    "slstm_scan": slstm_scan_k.KERNEL,
    "ssm_scan_bwd": ssm_scan_k.KERNEL_BWD,
    "mlstm_scan_bwd": mlstm_scan_k.KERNEL_BWD,
    "slstm_scan_bwd": slstm_scan_k.KERNEL_BWD,
}


# the CUDA functions behind one logical launch of each kernel (both modes
# of K3, K5 and K6 are instances of the same functions), each run once a
# launch: a profile of the card holds one device record of each for every
# count of ``launch_counts()``
CUDA_FUNCTIONS = {
    "glm_stats": ("glm_stats_kernel",),
    "alpha_search": ("alpha_search_pass",),
    "cd_tile_solve": ("cd_tile_solve_kernel",),
    "tile_gram": ("tile_gram_partial", "tile_gram_reduce"),
    "stats_gram_solve": ("sgs_partial", "sgs_reduce", "sgs_solve"),
    "margin_ls": ("margin_ls_stream", "margin_ls_finish"),
    "predict_tile": ("predict_tile_kernel",),
    "admm_shooting": ("admm_shooting_kernel",),
    "online_tg": ("online_tg_kernel",),
    "ssm_scan": ("ssm_scan_kernel",),
    "mlstm_scan": ("mlstm_scan_kernel",),
    "slstm_scan": ("slstm_scan_kernel",),
    "ssm_scan_bwd": ("ssm_scan_bwd_kernel", "ssm_scan_bwd_reduce"),
    "mlstm_scan_bwd": ("mlstm_scan_bwd_kernel", "mlstm_scan_bwd_reduce"),
    "slstm_scan_bwd": ("slstm_scan_bwd_kernel",),
}


def kernel_resources() -> dict:
    """{source stem: [one record a ``__global__`` function]} for every
    ``csrc/*.cu`` of the library on the current card: registers, static
    shared bytes, local bytes a thread (stack and spills), the dynamic
    shared cap and the most threads a block (``cudaFuncGetAttributes``),
    and the most dynamic shared bytes and threads a block that any of its
    launches asked for since the library was loaded (``launches``: how
    many).  Card only: it loads the library."""
    return {pathlib.Path(src).stem: build.resources(pathlib.Path(src).stem)
            for src in build.SOURCES}


# calls on the card that ran a kernel's plain version, by kernel: the GLM
# kernels' for a family without a body in them.  The recurrences' scans
# have none (training launches their backward kernels); their keys stay,
# held at 0, so that a run shows it
PLAIN_ROUTES = ("glm_stats", "alpha_search", "stats_gram_solve",
                "margin_ls", "predict_tile", "ssm_scan", "mlstm_scan",
                "slstm_scan")
_plain_calls = dict.fromkeys(PLAIN_ROUTES, 0)


def launch_counts() -> dict:
    """Launches of each CUDA kernel since the last reset, and under
    ``"<kernel>/plain"`` the calls on the card that ran its plain version
    for a family without a body in it (a scan's stays 0)."""
    counts = {name: k.launches for name, k in KERNELS.items()}
    counts.update({f"{k}/plain": v for k, v in _plain_calls.items()})
    return counts


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
    for k in _plain_calls:
        _plain_calls[k] = 0


# --- logical launch events (the reference's ``launch_trace``) -------------
# Every dispatcher below records one logical launch while a
# ``launch_trace()`` is active, on the card and on the CPU alike, under the
# reference's name (``jacobi_tile_solves`` is its batched ``cd_tile_solve``;
# ``core/cd.py`` adds ``matvec`` for the Jacobi sweep's merge pass).  The
# reference records at trace time, once a compile; the port runs eagerly
# and records once a call, so a trace around one superstep holds that
# superstep's launches.  The dispatchers a fused entry composes on the
# brick route are parts of its one logical launch and record nothing.
# Outside a trace the cost is one ``is None`` test a call (and one context
# manager a fused call).
_LAUNCH_EVENTS = None


@contextlib.contextmanager
def launch_trace():
    """Collect the dispatchers' logical launch events; yields the live
    list."""
    global _LAUNCH_EVENTS
    prev = _LAUNCH_EVENTS
    _LAUNCH_EVENTS = events = []
    try:
        yield events
    finally:
        _LAUNCH_EVENTS = prev


def record_launch(name):
    """Record one logical device launch (no-op outside ``launch_trace()``)."""
    if _LAUNCH_EVENTS is not None:
        _LAUNCH_EVENTS.append(name)


@contextlib.contextmanager
def _parts_of(name):
    """Record ``name`` once; the dispatchers called inside record nothing."""
    global _LAUNCH_EVENTS
    record_launch(name)
    prev, _LAUNCH_EVENTS = _LAUNCH_EVENTS, None
    try:
        yield
    finally:
        _LAUNCH_EVENTS = prev


def _on_card(t) -> bool:
    """True for a CUDA tensor, False for a CPU one; anything else raises."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no kernel for tensors on {t.device}")
    return False


def _launches(t, kernel: str, family: str, codes) -> bool:
    """True when the call launches ``kernel``: ``t`` lies on the card and
    the family has a body there.  A family outside ``codes`` runs the
    plain version on the card too, counted as ``"<kernel>/plain"``."""
    if not _on_card(t):
        return False
    if family in codes:
        return True
    _plain_calls[kernel] += 1
    return False


def _differentiated(*tensors) -> bool:
    """True when a recurrence's scan call carries a gradient: grad mode
    is on and one of its inputs requires a gradient (a training step)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class SsmScan(torch.autograd.Function):
    """``ssm_scan`` with its backward: the forward keeps the state every
    ``ref.CKPT_EVERY`` steps; the backward recomputes each segment from
    its checkpoint and runs it in reverse (the ``ssm_scan_bwd`` kernel on
    the card, ``ref.ssm_scan_bwd`` on the CPU)."""

    @staticmethod
    def forward(ctx, xh, Bm, Cm, dt, A, D, state0):
        L = ref.CKPT_EVERY
        if _on_card(xh):
            y, h, ckpts = ssm_scan_k.launch(xh, Bm, Cm, dt, A, D, state0,
                                            ckpt_every=L)
        else:
            y, h, ckpts = ref.ssm_scan(xh, Bm, Cm, dt, A, D, state0,
                                       ckpt_every=L)
        ctx.save_for_backward(xh, Bm, Cm, dt, A, D, ckpts)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        args = (*ctx.saved_tensors, dy.contiguous(), dh.contiguous(),
                ref.CKPT_EVERY)
        if args[0].is_cuda:
            return ssm_scan_k.launch_bwd(*args)
        return ref.ssm_scan_bwd(*args)


class MlstmScan(torch.autograd.Function):
    """``mlstm_scan`` with its backward: the forward keeps (C, n) every
    ``ref.CKPT_EVERY`` steps and every step's m and q.n; the backward
    recomputes each segment's (C, n) from its checkpoint and runs it in
    reverse (the ``mlstm_scan_bwd`` kernel on the card,
    ``ref.mlstm_scan_bwd`` on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, i_pre, f_pre, C0, n0, m0):
        L = ref.CKPT_EVERY
        if _on_card(q):
            hs, st, saved = mlstm_scan_k.launch(
                q, k, v, i_pre, f_pre, (C0, n0, m0), ckpt_every=L)
        else:
            hs, st, saved = ref.mlstm_scan(q, k, v, i_pre, f_pre,
                                           (C0, n0, m0), ckpt_every=L)
        ctx.save_for_backward(q, k, v, i_pre, f_pre, m0, *saved, hs)
        return (hs, *st)

    @staticmethod
    def backward(ctx, dhs, dC, dn, dm):
        q, k, v, i_pre, f_pre, m0, *saved, hs = ctx.saved_tensors
        args = (q, k, v, i_pre, f_pre, m0, tuple(saved), hs,
                dhs.contiguous(), dC.contiguous(), dn.contiguous(),
                dm.contiguous(), ref.CKPT_EVERY)
        if q.is_cuda:
            return mlstm_scan_k.launch_bwd(*args)
        return ref.mlstm_scan_bwd(*args)


class SlstmScan(torch.autograd.Function):
    """``slstm_scan`` with its backward: the forward keeps every step's
    gate pre-activations, c, n and m; the backward runs the steps in
    reverse (the ``slstm_scan_bwd`` kernel on the card,
    ``ref.slstm_scan_bwd`` on the CPU), and dr_gates = sum over rows and
    steps of h_{t-1} dpre_t is one product after it."""

    @staticmethod
    def forward(ctx, r, c0, n0, h0, m0, gates_in, sc, steps):
        state = (c0, n0, h0, m0)
        if _on_card(r):
            hs, st, saved = slstm_scan_k.launch(r, state, gates_in, steps,
                                                sc=sc, save=True)
        else:
            hs, st, saved = ref.slstm_scan(r, state, gates_in, steps, sc=sc,
                                           save=True)
        ctx.save_for_backward(r, c0, n0, h0, m0, sc, *saved, hs)
        ctx.gates_shape = gates_in.shape
        return (hs, *st)

    @staticmethod
    def backward(ctx, dhs, dc, dn, dh, dm):
        r, c0, n0, h0, m0, sc, *saved, hs = ctx.saved_tensors
        args = (r, (c0, n0, h0, m0), sc, tuple(saved), hs, dhs.contiguous(),
                dc.contiguous(), dn.contiguous(), dh.contiguous(),
                dm.contiguous())
        if r.is_cuda:
            dpres, dr, dstate, dsc = slstm_scan_k.launch_bwd(*args)
        else:
            dpres, dr, dstate, dsc = ref.slstm_scan_bwd(*args)
        dgates = dpres
        if dpres.shape[1] != ctx.gates_shape[1]:
            dgates = dpres.new_zeros(ctx.gates_shape)
            dgates[:, :dpres.shape[1]] = dpres
        return (dr, *dstate, dgates, dsc, None)


def _into(out, state):
    """The plain version's final state written into ``out``'s given
    leaves (a cache's, in place), as the kernels write it."""
    if out is None:
        return state
    return tuple(build.into(o, s) for o, s in zip(out, state))


def solve_params(mu, nu, lam1, lam2, like):
    """[mu, nu, lam1, lam2] as a (4,) f32 tensor on ``like``'s device, the
    constants of the tile chain (K2), built once a sweep.  ``mu`` may be a
    float or a 0-d tensor.  On the card it is built by fill kernels: a copy
    from pageable host memory would make the host wait for the card."""
    mu = mu.to(torch.float32).reshape(()) if torch.is_tensor(mu) \
        else like.new_full((), mu)
    return torch.stack([mu, like.new_full((), nu), like.new_full((), lam1),
                        like.new_full((), lam2)])


def cd_tile_solve(G, g, h, beta_t, dbeta_t, params, *, penf=None):
    """Exact sequential tile solve (K2); see kernels/cd_tile_solve.py.

    ``params`` the (4,) [mu, nu, lam1, lam2] of ``solve_params`` on g's
    device; ``h`` = diag(G), a view will do; ``penf`` optional (T,) penalty
    factors (0 = unpenalized).
    """
    record_launch("cd_tile_solve")
    if not _on_card(g):
        return ref.cd_tile_solve(G, g, h, beta_t, dbeta_t, *params.unbind(),
                                 penf=penf)
    return cd_tile_solve_k.launch(G, g, h, beta_t, dbeta_t, params, penf)


def tile_gram(bricks, rows, n_valid, w, r, *, precision="fp32"):
    """Brick Gram/gradient of one feature tile (K3); see kernels/tile_gram.py.

    bricks (K, rb, T), rows (K,) int32, n_valid a host int; w, r flat
    (n_rows,) vectors.  Slots k >= n_valid are skipped.  ``precision``
    "bf16" rounds the product inputs to bfloat16 (``ref.tile_gram``).
    """
    record_launch("tile_gram")
    if not _on_card(bricks):
        rb = bricks.shape[1]
        return ref.tile_gram(bricks, rows, n_valid, w.reshape(-1, rb),
                             r.reshape(-1, rb), precision=precision)
    return tile_gram_k.launch(bricks, rows, n_valid, w, r,
                              precision=precision)


def glm_stats(y, xb, family, *, weights=None, offset=None):
    """(loss_i, s_i, w_i) per example (K1).

    ``weights`` is the combined observation weight (sample weight x fold
    mask x row padding); ``offset`` shifts the margins.
    """
    record_launch("glm_stats")
    fam = glm_lib.resolve_family(family)
    if weights is None:
        weights = torch.ones_like(y)
    if not _launches(y, "glm_stats", fam.name, glm_stats_k.FAMILY_CODES):
        return ref.glm_stats(y, xb, weights, fam, offset=offset)
    return glm_stats_k.launch(y, xb, weights, fam.name, offset=offset)


def alpha_search(y, xb, xdb, alphas, family, *, weights=None, offset=None):
    """losses[k] = sum_i weights_i * l(y_i, xb_i + o_i + alphas[k]*xdb_i)."""
    record_launch("alpha_search")
    fam = glm_lib.resolve_family(family)
    if weights is None:
        weights = torch.ones_like(y)
    if not _launches(y, "alpha_search", fam.name, glm_stats_k.FAMILY_CODES):
        return ref.alpha_search(y, xb, xdb, weights, alphas, fam,
                                offset=offset)
    return alpha_search_k.launch(y, xb, xdb, weights, alphas, fam.name,
                                 offset=offset)


def jacobi_tile_solves(G_all, g_all, beta, params, *, penf=None,
                       tile_live=None):
    """The (p,) Jacobi step: each live tile's chain from a zero step (one
    K2 launch for all tiles on the card); dead tiles (host ``tile_live``
    False) get 0.  ``params`` as for ``cd_tile_solve``."""
    record_launch("cd_tile_solve")
    if not _on_card(g_all):
        return ref.jacobi_tile_solves(G_all, g_all, beta, *params.unbind(),
                                      penf=penf, tile_live=tile_live)
    order, n_live = tile_order(tile_live, g_all.shape[0], g_all.device)
    return cd_tile_solve_k.launch_tiles(G_all, g_all, beta, params, order,
                                        n_live, penf)


def tile_order(tile_live, nt: int, device):
    """(order (nt,) int32 on ``device``: live tiles first, then dead ones;
    n_live), the tile remap of the fused kernel.  The host mask goes over
    through pinned memory without blocking the host."""
    live = np.ones(nt, bool) if tile_live is None \
        else np.asarray(tile_live, bool)
    order = np.concatenate([np.flatnonzero(live), np.flatnonzero(~live)])
    host = torch.from_numpy(order.astype(np.int32)).pin_memory()
    return host.to(device, non_blocking=True), int(live.sum())


def fused_stats_sweep(design, y, xb, beta, family, *, mu, nu, lam1, lam2,
                      weights=None, offset=None, penf=None, tile_live=None,
                      precision="fp32"):
    """Fused launch 1 of the Jacobi superstep: link stats, every live tile's
    Gram and gradient, and each live tile's chain from a zero step.

    Returns (loss_i, s, w, dbeta (p,), G_all (nt, T, T), g_all (nt, T)).
    ``tile_live`` is an optional host (nt,) bool mask: dead tiles cost no
    Gram or solve work and get G = g = 0 and a zero step.  A dense design
    on the card runs K5 (``stats_gram_solve``) over the row-major data in
    place; a brick design on the card composes K1, then K3 and K2 for each
    live tile (the reference has no fused brick kernel either).
    ``precision="bf16"`` forms G and g from bfloat16 inputs (K5's and
    K3's bf16 modes); the stats and the solves stay float32.  A family
    without a body in K5 takes the plain dense version on the card too;
    on bricks only K1 depends on the family (``glm_stats`` routes it).
    """
    with _parts_of("fused_stats_sweep"):
        return _fused_stats_sweep(design, y, xb, beta, family, mu=mu, nu=nu,
                                  lam1=lam1, lam2=lam2, weights=weights,
                                  offset=offset, penf=penf,
                                  tile_live=tile_live, precision=precision)


def _fused_stats_sweep(design, y, xb, beta, family, *, mu, nu, lam1, lam2,
                       weights, offset, penf, tile_live, precision):
    fam = glm_lib.resolve_family(family)
    if weights is None:
        weights = torch.ones_like(y)
    dense = hasattr(design, "tiles3")
    on_card = _launches(y, "stats_gram_solve", fam.name,
                        glm_stats_k.FAMILY_CODES) if dense else _on_card(y)
    if not on_card:
        if dense:
            loss_i, s, w, G_all, g_all, dbeta = ref.stats_gram_solve(
                design.tiles3(), y, xb, weights, beta, fam, mu=mu, nu=nu,
                lam1=lam1, lam2=lam2, offset=offset, penf=penf,
                tile_live=tile_live, precision=precision)
            return loss_i, s, w, dbeta, G_all, g_all
        b3, rows, valid = design.gather_all_tiles()
        loss_i, s, w, G_all, g_all = ref.fused_stats_gram_bricks(
            b3, rows, valid, y, xb, weights, fam, offset=offset,
            tile_live=tile_live, precision=precision)
        dbeta = ref.jacobi_tile_solves(G_all, g_all, beta, mu, nu, lam1,
                                       lam2, penf=penf, tile_live=tile_live)
        return loss_i, s, w, dbeta, G_all, g_all
    if dense:
        if penf is None:
            penf = torch.ones_like(beta)
        order, n_live = tile_order(tile_live, design.n_tiles, y.device)
        loss_i, s, w, G_all, g_all, dbeta = stats_gram_solve_k.launch(
            design.data, y, xb, weights, offset, beta, penf,
            solve_params(mu, nu, lam1, lam2, y), order, n_live,
            design.tile_size, fam.name, precision=precision)
        return loss_i, s, w, dbeta, G_all, g_all
    loss_i, s, w = glm_stats(y, xb, fam, weights=weights, offset=offset)
    G_all, g_all = design.all_tile_grams(w, s, tile_live,
                                         precision=precision)
    dbeta = jacobi_tile_solves(G_all, g_all, beta,
                               solve_params(mu, nu, lam1, lam2, y),
                               penf=penf, tile_live=tile_live)
    return loss_i, s, w, dbeta, G_all, g_all


def fused_ls(design, y, xb, dbeta, alphas, family, *, weights=None,
             offset=None, precision="fp32"):
    """Fused launch 2 of the Jacobi superstep: the margin delta xdb = X dbeta
    and every candidate step's loss, (xdb (n,), losses (K,)).  A dense
    design on the card runs K6 (``margin_ls``; under ``precision="bf16"``
    from bfloat16 X and dbeta); a brick design forms xdb with
    ``design.matvec`` and the losses with K4 over all candidates, in
    float32 at either precision, as the reference does."""
    with _parts_of("fused_ls"):
        return _fused_ls(design, y, xb, dbeta, alphas, family,
                         weights=weights, offset=offset,
                         precision=precision)


def _fused_ls(design, y, xb, dbeta, alphas, family, *, weights, offset,
              precision):
    ref.is_bf16(precision)      # the brick route reads it nowhere else
    fam = glm_lib.resolve_family(family)
    if weights is None:
        weights = torch.ones_like(y)
    if hasattr(design, "tiles3"):
        if not _launches(y, "margin_ls", fam.name, glm_stats_k.FAMILY_CODES):
            return ref.fused_ls_dense(design.tiles3(), y, xb, dbeta, weights,
                                      alphas, fam, offset=offset,
                                      precision=precision)
        return margin_ls_k.launch(design.data, dbeta, y, xb, weights, alphas,
                                  fam.name, offset=offset,
                                  precision=precision)
    xdb = design.matvec(dbeta)
    return xdb, alpha_search(y, xb, xdb, alphas, fam, weights=weights,
                             offset=offset)


def predict_tile(slots, vals, table, b0, family, *, kind="link"):
    """Fused sparse scoring (K7): out[b, l] = link(sum_j vals[b, j]
    table[slots[b, j], l] + b0[l]).

    slots (B, J) int32, vals (B, J) f32, table (A+1, L) f32 with an all-zero
    last row (the padding target), b0 (L,).  A registered family without a
    link body in the kernel (the multinomial one: a softmax over the L
    columns) takes the plain version on either device; an unregistered
    name raises.
    """
    record_launch("predict_tile")
    fam = glm_lib.resolve_family(family)
    if kind not in ("link", "response"):
        raise ValueError(f"unknown kind {kind!r}; use 'link' or 'response'")
    if not _launches(vals, "predict_tile", fam.name,
                     predict_tile_k.LINK_CODES):
        return ref.predict_tile(slots, vals, table, b0, fam, kind=kind)
    return predict_tile_k.launch(slots, vals, table, b0, fam.name, kind)


def admm_shooting(At, x, v, col_sq, lam1_eff, lam2_eff, passes):
    """The ADMM x-update of every feature block: ``passes`` Shooting passes
    (one launch on the card); see kernels/admm_shooting.py.  At (M,
    p_block, n) column-major blocks, x and col_sq (M, p_block), v (M, n);
    returns the new (M, p_block) x."""
    record_launch("admm_shooting")
    if not _on_card(At):
        return ref.shooting_pass(At, x, v, col_sq, lam1_eff, lam2_eff,
                                 passes)
    return admm_shooting_k.launch(At, x, v, col_sq, lam1_eff, lam2_eff,
                                  passes)


def online_tg_epoch(X_sh, y_sh, w0, t0, family, *, lr, power, lam1, lam2):
    """One online truncated-gradient pass of every shard from w0 at global
    step t0 (one launch on the card); returns the shards' mean weight
    (p,).  See kernels/online_tg.py.  On the card a family without a body
    in the kernel raises: its plain version is a loop over rows."""
    record_launch("online_tg")
    fam = glm_lib.resolve_family(family)
    if not _on_card(X_sh):
        return ref.online_tg_epoch(X_sh, y_sh, w0, t0, fam, lr, power, lam1,
                                   lam2)
    return online_tg_k.launch(X_sh, y_sh, w0, t0, fam.name, lr, power, lam1,
                              lam2)


def ssm_scan(xh, Bm, Cm, dt, A, D, state0, *, out=None):
    """Mamba2's selective scan (one launch on the card); see
    kernels/ssm_scan.py.  xh (B, S, H, hd), Bm and Cm (B, S, ds), dt (B,
    S, H), A and D (H,), state0 (B, H, hd, ds), all float32; returns (y
    (B, S, H, hd), the final state).  ``out``: a cache's state, which
    takes the final state in place.  A call that carries a gradient goes
    through ``SsmScan``."""
    record_launch("ssm_scan")
    if _differentiated(xh, Bm, Cm, dt, A, D, state0):
        y, h = SsmScan.apply(xh, Bm, Cm, dt, A, D, state0)
        return y, build.into(out, h)
    if not _on_card(xh):
        y, h = ref.ssm_scan(xh, Bm, Cm, dt, A, D, state0)
        return y, build.into(out, h)
    return ssm_scan_k.launch(xh, Bm, Cm, dt, A, D, state0, out=out)


def mlstm_scan(q, k, v, i_pre, f_pre, state, *, out=None):
    """The mLSTM step scan (one launch on the card); see
    kernels/mlstm_scan.py.  q, k (B, S, H, hd_k), k scaled by 1/sqrt(hd);
    v (B, S, H, hd_v); gates (B, S, H); state (C, n, m); returns (h (B,
    S, H, hd_v), (C, n, m)).  ``out``: (C, n, m), each a cache's leaf or
    None, the leaves given taking the final state in place.  A call that
    carries a gradient goes through ``MlstmScan``."""
    record_launch("mlstm_scan")
    if _differentiated(q, k, v, i_pre, f_pre, *state):
        hs, *st = MlstmScan.apply(q, k, v, i_pre, f_pre, *state)
        return hs, _into(out, tuple(st))
    if not _on_card(q):
        hs, st = ref.mlstm_scan(q, k, v, i_pre, f_pre, state)
        return hs, _into(out, st)
    return mlstm_scan_k.launch(q, k, v, i_pre, f_pre, state, out=out)


def slstm_scan(r, state, gates_in, steps: int, *, sc=None, out=None):
    """The sLSTM scan over the first ``steps`` positions of gates_in (B,
    S, 4, H, hd_v) (one launch on the card); see kernels/slstm_scan.py.
    r (H, 4, hd_k, hd_v); state (c, n, h, m), h (B, H, hd_k) the whole
    previous output; ``sc`` (B, 2, H) the head-level stabilizers of one
    step of a block of hd; returns (h (B, steps, H, hd_v), (c, n, h, m)).
    ``out``: (c, n, h, m), each a cache's leaf or None, the leaves given
    taking the final state in place.  A call that carries a gradient goes
    through ``SlstmScan``."""
    record_launch("slstm_scan")
    if _differentiated(r, gates_in, sc, *state):
        hs, *st = SlstmScan.apply(r, *state, gates_in, sc, steps)
        return hs, _into(out, tuple(st))
    if not _on_card(r):
        hs, st = ref.slstm_scan(r, state, gates_in, steps, sc=sc)
        return hs, _into(out, st)
    return slstm_scan_k.launch(r, state, gates_in, steps, sc=sc, out=out)
