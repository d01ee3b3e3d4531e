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

``--devices N`` (the reference's simulated mesh) raises: sharded training
is a later slice (ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Optional


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
                    help="a mesh of N devices (not ported: raises)")
    ap.add_argument("--parallelism", default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    if args.devices:
        raise NotImplementedError(
            f"--devices {args.devices}: sharded training comes with its "
            "own slice (ROADMAP Queue 1 item 6, after the scan kernels)")

    from repro_torch.configs.registry import get_arch, smoke_variant
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

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
        device=args.device)
    _, _, losses = trainer.run()
    print(f"final loss: {losses[-1]:.4f} over {len(losses)} steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
