"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

A port of the JAX package's ``repro.launch.train``: any registry
architecture (full, or reduced with ``--smoke``) trained by
``repro_torch.runtime.trainer.Trainer`` on the card, checkpointed into
``--ckpt-dir`` (a run on the same directory resumes), its log in
``<ckpt-dir>/train.jsonl``.  ``--device cpu`` runs the plain PyTorch path
on the CPU; the default is the CUDA card, which raises where there is
none.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch phi4-mini-3.8b --smoke --steps 20 --device cpu

``--devices N`` trains on the mesh (1, N), as the reference's simulated
mesh: N processes, one rank each (``repro_torch.dist.launcher``), that
run ``Trainer(mesh=make_dist_mesh(1, N))``: tensor parallelism over N
for any architecture of the registry, where N divides the dims its
specs split (``transformer.check_layout``).  With ``--device cpu`` the
ranks run on the CPU over gloo; on cards over NCCL, a card a rank, and
more ranks than cards raise as ``dist.bootstrap`` does.  The ranks' output
is printed, process 0's last.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch phi4-mini-3.8b --smoke --steps 20 --devices 2 --device cpu
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

ENV_COORD = "REPRO_DIST_COORD"     # set for each rank by dist.launcher
RANK_TIMEOUT_S = 24 * 3600


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--devices", type=int, default=0,
                    help="train on the mesh (1, N): N ranks, one process "
                         "each")
    ap.add_argument("--parallelism", default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.devices and ENV_COORD not in os.environ:
        return launch_ranks(args.devices, args.device,
                            list(sys.argv[1:] if argv is None else argv))

    from repro_torch.configs.registry import get_arch, smoke_variant
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    mesh = None
    if args.devices:
        from repro_torch.dist import bootstrap
        bootstrap.initialize(backend="gloo" if args.device == "cpu"
                             else None, device=args.device)
        mesh = bootstrap.make_dist_mesh(1, args.devices)
    cfg = smoke_variant(args.arch) if args.smoke else get_arch(args.arch)
    cfg = cfg.replace(parallelism=args.parallelism)
    trainer = Trainer(
        cfg,
        adamw.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                          total_steps=args.steps),
        TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir, batch=args.batch,
                      seq_len=args.seq_len,
                      microbatches=args.microbatches,
                      log_path=os.path.join(args.ckpt_dir, "train.jsonl")),
        mesh=mesh, device=args.device)
    _, _, losses = trainer.run()
    print(f"final loss: {losses[-1]:.4f} over {len(losses)} steps")
    if mesh is not None:
        from repro_torch.dist import bootstrap
        bootstrap.shutdown()
    return 0


def launch_ranks(n: int, device, argv: list) -> int:
    """Run this command as the ``n`` ranks of a (1, n) mesh and print
    their output, process 0's last.  On cards (``device`` not "cpu") each
    rank takes one: fewer cards than ranks raise ``ValueError``, as
    ``dist.bootstrap`` does."""
    from repro_torch.dist import launcher
    if device != "cpu":
        import torch
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise ValueError(
                f"--devices {n} puts {n} NCCL ranks on {have} card(s): "
                "NCCL needs a card per rank; pass --device cpu to run the "
                "ranks on the CPU over gloo")
    res = launcher.run_local(n, "repro_torch.launch.train", args=argv,
                             timeout_s=RANK_TIMEOUT_S)
    for i in reversed(range(n)):
        print(f"--- rank {i} (exit {res.returncodes[i]}) ---\n"
              f"{res.outputs[i]}", end="", flush=True)
    if not res.ok:
        raise RuntimeError(f"--devices {n}: a rank failed\n"
                           + res.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
