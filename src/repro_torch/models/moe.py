"""Mixture-of-Experts FFN with Switch/GSPMD-style grouped capacity dispatch.

A port of the JAX package's ``repro.models.moe``.  Tokens are taken
batch-major in groups of ``n_g = min(GROUP_SIZE, B * S)``; within a group
each token's top-k experts give it a capacity slot, the running count of
that expert over the group in token order.  An expert holds ``C`` slots
(``_capacity``); assignments past them are dropped.  The gates are a
softmax over the top-k logits only.  The shared experts (deepseek) are
one dense SwiGLU of width ``moe_d_ff * n_shared_experts``, added for
every token.

The reference dispatches and combines by one-hot einsums; here the same
slots are an index scatter into the (G, E, C, d) expert inputs and a
gather back, with the same drops and the same gates.  Every slot of every
expert runs its expert's SwiGLU (``torch.bmm`` over the experts), filled
or not, as the reference's einsums do.  ``GROUP_SIZE`` and
``CAPACITY_FACTOR`` are read at call time, so a caller may patch them
(the reference's test sets ``CAPACITY_FACTOR = 16`` so that nothing
drops).

Tensor parallelism (``layout``, a ``model`` axis past 1): the stream
enters the MoE whole over ``model`` (``tensor_parallel.enter``), so the
router, the groups, the capacity and the drops are computed whole and
alike on every rank.  With E >= 16 experts (deepseek) each rank holds and
runs its E/M experts, global ids ``m E/M ... (m + 1) E/M``: its slots are
those of its experts, an assignment to another rank's expert reads the
spare zero row, and its combine is a partial sum.  The reference's
``_shard_moe`` constraint makes GSPMD move the (G, E, C, d) dispatch
tensor onto the expert-sharded axis by an all-to-all; here every rank
already holds every token, so it takes its own experts' slots and no
all-to-all is needed.  With E < 16 (mixtral) every expert is split inside
on ``f`` (``w_gate``/``w_up`` by column, ``w_down`` by row), and the
combine is a partial sum too.  The shared experts are a column/row
SwiGLU; the caller sums the routed and shared partial sums over
``model`` in one ``tensor_parallel.leave``.  The router's gradient is
then partial on each rank (``lm.reduce_grads`` sums it).

Over ``data`` the reference groups the global batch's tokens.  A rank
whose rows make whole groups (``whole_groups``) routes its own; where
they do not (a serving step's few rows: a decode's B/D tokens) the
rows are gathered over ``data``, the group is routed and run whole on
every rank, and each keeps its rows (``data``; serving only, no gradient
crosses the gather: training raises first, ``lm.check_moe_groups``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import mlp
from repro_torch.models.common import ParamDef, matmul, promoted
from repro_torch.sharding import tensor_parallel as tp

GROUP_SIZE = 256
CAPACITY_FACTOR = 1.5


# whole leaves used inside the MoE's tensor-parallel region: each rank's
# router gradient covers only its experts or its block of f (summed over
# ``model`` by ``lm.reduce_grads``)
REGION_WHOLE = ("router",)


def moe_defs(cfg):
    d, f, E = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts
    if E >= 16:     # expert-parallel over the model axis
        specs = (("model", None, None),) * 3
    else:           # TP inside each expert
        specs = ((None, None, "model"), (None, None, "model"),
                 (None, "model", None))
    defs = {
        "router": ParamDef((d, E), (None, None)),
        "w_gate": ParamDef((E, d, f), specs[0]),
        "w_up": ParamDef((E, d, f), specs[1]),
        "w_down": ParamDef((E, f, d), specs[2]),
    }
    if cfg.n_shared_experts:
        defs["shared"] = mlp.swiglu_defs(
            cfg, d_ff=(cfg.moe_d_ff or cfg.d_ff) * cfg.n_shared_experts)
    return defs


def _capacity(n_g: int, E: int, k: int) -> int:
    c = int(n_g * k * CAPACITY_FACTOR / E)
    return max(4, min(c, n_g))


def route(p, x, cfg):
    """The router's decisions for x (B, S, d): (gates (G, n, k), experts
    (G, n, k), slots (G, n, k), capacity C).  An assignment is kept where
    its slot is below C."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    N = B * S
    n_g = min(GROUP_SIZE, N)
    if N % n_g:
        raise ValueError(
            f"{N} tokens (batch {B} x {S}) do not split into groups of "
            f"{n_g}: the reference's reshape to (G, n_g, d) fails there too")
    xg = x.reshape(N // n_g, n_g, d)
    logits = matmul(xg, p["router"])                   # (G, n, E)
    gate_vals, idx = torch.topk(logits, k, dim=-1)     # (G, n, k)
    gates = torch.softmax(gate_vals, dim=-1).to(x.dtype)
    C = _capacity(n_g, E, k)
    # each (token, expert) pair appears at most once in a top-k list
    mask = idx.new_zeros((*idx.shape[:2], E)).scatter_(2, idx, 1)  # 0/1
    pos = mask.cumsum(dim=1) - 1                       # running count
    return gates, idx, pos.gather(2, idx), C


def whole_groups(tokens: int, n_data: int) -> bool:
    """Whether a rank's ``tokens`` of a batch split over ``n_data`` ranks
    are whole token groups of the global batch's (``GROUP_SIZE`` tokens,
    or all of them)."""
    return tokens % min(GROUP_SIZE, tokens * n_data) == 0


def moe_apply(p, x, cfg, layout=None, data=None):
    """x: (B, S, d) -> (B, S, d); on a tensor-parallel ``layout`` this
    rank's partial sum; ``data``: the rank's ``Layout`` where its rows
    are its block of a batch split over ``data`` (module docstring)."""
    B, S, d = x.shape
    if data is not None and data.D > 1 and not whole_groups(B * S, data.D):
        if torch.is_grad_enabled() and x.requires_grad:
            raise ValueError("a rank's tokens are not whole MoE groups of "
                             "the global batch (lm.check_moe_groups)")
        y = moe_apply(p, tp.all_gather(x, data.data, 0), cfg, layout)
        return y[data.d * B:(data.d + 1) * B]
    gates, idx, slot, C = route(p, x, cfg)
    G, n_g, k = idx.shape
    # this rank's experts: all of them, or its E/M under expert parallelism
    E = p["w_gate"].shape[0]
    e0 = layout.m * E if layout is not None and E < cfg.n_experts else 0
    mine = (slot < C) & (idx >= e0) & (idx < e0 + E)
    # a dropped assignment (or another rank's) goes to one spare row past
    # the slots, and reads zeros from there: no boolean indexing, so no
    # read of the card
    g_ix = torch.arange(G, device=x.device)[:, None, None]
    flat = torch.where(mine, (g_ix * E + idx - e0) * C + slot, G * E * C)
    xg = x.reshape(G, n_g, 1, d).expand(G, n_g, k, d)
    x_e = x.new_zeros((G * E * C + 1, d))
    x_e[flat.reshape(-1)] = xg.reshape(-1, d)          # each slot once
    x_e = x_e[:-1].reshape(G, E, C, d).transpose(0, 1).reshape(E, G * C, d)
    x_e, w_gate, w_up = promoted(x_e, p["w_gate"], p["w_up"])
    h = F.silu(torch.bmm(x_e, w_gate)) * torch.bmm(x_e, w_up)
    h, w_down = promoted(h, p["w_down"])
    y_e = torch.bmm(h, w_down)                         # (E, G * C, d)
    y_e = y_e.reshape(E, G, C, d).transpose(0, 1).reshape(G * E * C, d)
    y_e = torch.cat([y_e, y_e.new_zeros((1, d))])
    y = (y_e[flat] * gates[..., None].to(y_e.dtype)).sum(dim=2)
    y = y.reshape(B, S, d)
    if cfg.n_shared_experts:
        y = y + mlp.swiglu_apply(p["shared"], x)
    return y


def moe_aux_loss(p, x, cfg):
    """Load-balancing auxiliary loss (Switch/Mixtral style)."""
    logits = matmul(x, p["router"])
    probs = torch.softmax(logits, dim=-1)
    _, idx = torch.topk(logits, cfg.top_k, dim=-1)
    onehot = F.one_hot(idx, cfg.n_experts).to(probs.dtype)
    lead = tuple(range(idx.ndim - 1))
    frac_tokens = onehot.sum(dim=-2).mean(dim=lead)
    frac_probs = probs.mean(dim=tuple(range(probs.ndim - 1)))
    return cfg.n_experts * (frac_tokens * frac_probs).sum()
