"""LM-template serving demo: batched prefill and a greedy decode loop over
the template's configurations, on the card.  This is not the GLM serving
path: the paper's models are served by ``repro_torch.launch.serve_glm``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \
        --smoke --batch 4 --prompt-len 16 --gen 24 [--device cpu]

A port of the JAX package's ``repro.launch.serve`` with ``--device``
(default: the CUDA card, which raises where there is none).  ``generate``
under the CLI runs one request batch on a built model and returns its
record, so a caller can reuse one set of weights; the tokens stay on the
device and are read to the host once, at the end.  The vlm and audio
families read the modality stubs (``image_embeds``, ``audio_embeds``):
the CLI draws them as the reference does, normal (B, n_image_tokens or
n_audio_frames, d_model), from a seeded generator on the device.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional

import torch

from repro_torch.timing import timed


def modality_inputs(cfg, batch: int, generator: torch.Generator) -> dict:
    """The modality stubs ``cfg``'s model reads (none for a text-only
    family), drawn from ``generator`` on its device."""
    frames = {"vlm": ("image_embeds", cfg.n_image_tokens),
              "audio": ("audio_embeds", cfg.n_audio_frames)}
    if cfg.family not in frames:
        return {}
    name, n = frames[cfg.family]
    return {name: torch.randn((batch, n, cfg.d_model), generator=generator,
                              device=generator.device)}


def generate(model, prompts: torch.Tensor, gen: int, *,
             extra: Optional[dict] = None,
             keep_logits: bool = False) -> dict:
    """Prefill ``prompts`` (B, S) on the model's device, then ``gen`` greedy
    tokens (the prefill's and ``gen - 1`` decode steps); ``extra``: the
    modality inputs (``modality_inputs``), given to every step.  Returns
    the record: seconds and rates of both parts, the tokens (``tokens``,
    on the host; ``seq``, the device tensor) and, with ``keep_logits``,
    the logits that chose each token (``logits``, (B, gen, V) on the
    device).

    On a mesh (a model built with a ``layout``; one process a rank, each
    passing the whole request) each rank serves its rows
    (``lm.served_rows``) from its blocks of the caches
    (``lm.init_cache(layout=)``), takes its greedy tokens from the
    gathered logits, and gathers every rank's rows over ``data`` at the
    end: every rank returns the single-card record."""
    from repro_torch.models import lm

    cfg = model.cfg
    B, S = prompts.shape
    if gen < 1:
        raise ValueError(f"gen must be at least 1, got {gen}")
    lay = model.mesh_layout
    caches = lm.init_cache(cfg, B, S + gen, device=prompts.device,
                           layout=lay)
    prefill = lm.make_prefill_step(model)
    decode = lm.make_decode_step(model)
    rows = lm.served_rows(B, lay)
    prompts = prompts[rows]
    extra = {k: v[rows] for k, v in (extra or {}).items()}
    (logits, caches), prefill_s = timed(prefill, caches,
                                        {"tokens": prompts, **extra})
    kept = [logits] if keep_logits else None

    def decode_loop(caches, logits):
        tok = logits.argmax(dim=-1)[:, None]
        outs = [tok]
        for i in range(S, S + gen - 1):
            logits, caches = decode(caches, tok, i, extra)
            tok = logits.argmax(dim=-1)[:, None]
            outs.append(tok)
            if kept is not None:
                kept.append(logits)
        return torch.cat(outs, dim=1)

    seq, decode_s = timed(decode_loop, caches, logits)
    if rows != slice(0, B):
        # every rank's rows, so each returns the whole request's record
        from repro_torch.sharding import tensor_parallel as tp
        seq = tp.all_gather(seq, lay.data, 0)
        if kept is not None:
            kept = [tp.all_gather(t, lay.data, 0) for t in kept]
    tokens = seq.cpu().numpy()
    steps = gen - 1
    rec = {"arch": cfg.name, "batch": B, "prompt_len": S, "gen": gen,
           "device": str(prompts.device),
           "prefill_s": prefill_s, "prefill_tok_per_s": B * S / prefill_s,
           "decode_s": decode_s, "decode_steps": steps,
           "decode_ms_per_step": decode_s / steps * 1e3 if steps else None,
           "decode_tok_per_s": B * steps / decode_s if steps else None,
           "tokens": tokens.tolist(), "seq": seq}
    if kept is not None:
        rec["logits"] = torch.stack(kept, dim=1)
    return rec


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import get_arch, smoke_variant
    from repro_torch.device import resolve_device
    from repro_torch.models import lm

    dev = resolve_device(args.device)
    cfg = smoke_variant(args.arch) if args.smoke else get_arch(args.arch)
    model = lm.build_model(
        cfg, generator=torch.Generator(device=dev).manual_seed(0))
    prompts = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len),
        generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    extra = modality_inputs(cfg, args.batch,
                            torch.Generator(device=dev).manual_seed(2))
    rec = generate(model, prompts, args.gen, extra=extra)
    print(f"prefill {args.prompt_len} tokens x{args.batch}: "
          f"{rec['prefill_s']:.2f}s")
    rate = rec["decode_tok_per_s"]
    print(f"decoded {args.gen} tokens x{args.batch} in {rec['decode_s']:.2f}s"
          + (f" ({rate:.1f} tok/s)" if rate else ""))
    print("sample:", rec["tokens"][0][:16])
    return 0


if __name__ == "__main__":
    sys.exit(main())
