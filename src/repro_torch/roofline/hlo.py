"""The launch model of one d-GLMNET superstep, and the card's memory
budget of a kernel launch.

``superstep_launch_targets`` is a copy of the JAX package's
(``repro.roofline.hlo``): pure arithmetic, the DESIGN.md section 8 launch
contract (fused = 2 launches, unfused = 5) with each launch's float32
flops and device-memory bytes.  ``analysis/audit.py`` holds the port's
superstep to its launch count.

``shared_memory_budget`` takes the place of the JAX package's
``VMEM_BUDGET_BYTES``: on the H100 a kernel's fast memory is its block's
static plus dynamic shared memory, and the most a block may opt in to is
the card's own ``shared_memory_per_block_optin`` (read from the card,
never a constant); ``registers_per_sm`` bounds a block's registers
times its threads.

The roofline terms and model flops of the LM template are
``roofline/model.py``.  The JAX package's HLO analyser (``analyze_hlo``)
has no counterpart: the port's dry-run (``launch/dryrun.py``) compiles
nothing, and takes a cell's flops from ``roofline/model.py`` and its
bytes from the step's arguments.
"""
from __future__ import annotations


def superstep_launch_targets(n: int, p: int, tile_size: int, *,
                             n_candidates: int = 294,
                             fused: bool = True) -> dict:
    """Analytic per-launch FLOP/byte targets for one d-GLMNET superstep
    (the launch contract ``analysis/audit.py`` holds).

    The model is the DESIGN.md §8 launch contract, f32 everywhere:

    unfused (4+ launches, every (n,)-vector round-trips HBM between them):
      glm_stats       — ~10 flops/row; reads y, xβ, w; writes loss, s, w
      gram+solve      — Gram 2·n·p·T flops reading X once per tile sweep +
                        the (p/T)·T² blocks; sequential solves 4·p·T flops
      matvec          — 2·n·p; reads X again, writes xdb
      alpha_search×2  — ~6·K·n flops; reads y, xβ, xdb, w per phase
                        (two phases: 14-candidate grid, 20-step chain)

    fused (2 launches; s, w, xdb stay on chip):
      stats+gram+solve — the first three rolled into one X pass
      margin+ls        — matvec + ALL candidate losses in one X pass

    Bytes count HBM traffic only (block-resident reuse is the point of the
    fusion): X is (n, p)·4 per pass over the design; (n,)-vectors 4n each.
    """
    T = tile_size
    nt = p // T
    f32 = 4.0
    xbytes = float(n) * p * f32
    vec = float(n) * f32
    stats_f = 10.0 * n
    gram_f = 2.0 * float(n) * p * T + 2.0 * float(n) * p
    solve_f = 4.0 * float(p) * T
    matvec_f = 2.0 * float(n) * p
    ls_f = 6.0 * float(n_candidates) * n
    gram_b = xbytes + nt * (T * T) * f32 + 2.0 * vec
    if fused:
        launches = {
            "stats_gram_solve": {
                "flops": stats_f + gram_f + solve_f,
                "bytes": gram_b + 3.0 * vec + 2.0 * p * f32,
            },
            "margin_ls": {
                "flops": matvec_f + ls_f,
                "bytes": xbytes + 4.0 * vec + float(n_candidates) * f32,
            },
        }
    else:
        grid, chain = 14, 20
        launches = {
            "glm_stats": {"flops": stats_f, "bytes": 6.0 * vec},
            "gram_solve": {"flops": gram_f + solve_f,
                           "bytes": gram_b + 2.0 * p * f32},
            "matvec": {"flops": matvec_f, "bytes": xbytes + vec},
            "alpha_search_grid": {"flops": 6.0 * grid * n,
                                  "bytes": 4.0 * vec},
            "alpha_search_chain": {"flops": 6.0 * chain * n,
                                   "bytes": 4.0 * vec},
        }
    total_f = sum(l["flops"] for l in launches.values())
    total_b = sum(l["bytes"] for l in launches.values())
    return {"fused": fused, "n_launches": len(launches),
            "launches": launches, "total_flops": total_f,
            "total_bytes": total_b,
            "vector_roundtrip_bytes_saved": 0.0 if not fused else 5.0 * vec}


def shared_memory_budget(device) -> int:
    """Bytes of shared memory (static + dynamic) one block may use on the
    card ``device`` after opting in: the budget of the port's kernels."""
    import torch
    return int(torch.cuda.get_device_properties(device)
               .shared_memory_per_block_optin)


def registers_per_sm(device) -> int:
    """32-bit registers of one SM of the card ``device``: a block's
    registers times its threads must fit in them."""
    import torch
    return int(torch.cuda.get_device_properties(device)
               .regs_per_multiprocessor)
