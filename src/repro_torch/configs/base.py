"""Architecture + input-shape schema for the assigned (arch × shape) grid."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    # attention flavour
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    sliding_window: Optional[int] = None
    local_global_ratio: int = 0      # gemma3: N local layers per 1 global
    local_rope_theta: float = 10_000.0
    attn_softcap: Optional[float] = None
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0      # deepseek: leading dense FFN layers
    # MLA (deepseek)
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # SSM / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    shared_attn_every: int = 0       # zamba: shared attn block period
    # xLSTM
    slstm_period: int = 0            # one sLSTM per this many blocks
    ssm_chunk: int = 0               # >0: chunkwise-parallel mLSTM
    # VLM
    cross_attn_period: int = 0       # cross-attn layer every k self layers
    n_image_tokens: int = 0
    # enc-dec (whisper)
    encoder_layers: int = 0
    n_audio_frames: int = 0
    max_target_positions: int = 0
    # misc
    norm_eps: float = 1e-6
    embed_scale: bool = False        # gemma: h *= sqrt(d_model)
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    attn_chunk: int = 1024           # online-softmax KV chunk
    attn_impl: str = "flash"         # "flash" | "naive" (see common.py)
    remat: bool = True
    remat_group: int = 1             # >1: save activations every G layers
    seq_shard: bool = True           # sequence-parallel residual stream
    parallelism: str = "tp"          # "tp" (Megatron TP+DP) | "fsdp" (ZeRO-3)
    sub_quadratic: bool = False      # eligible for long_500k
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def cell_is_runnable(arch: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """The assignment's skip rules (documented in DESIGN.md)."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "long_500k skipped: pure full-attention architecture"
    return True, ""


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def tp_pad_config(cfg: ArchConfig, tp: int) -> tuple[ArchConfig, dict]:
    """Pad head counts / vocab to the TP axis size.

    jit input shardings require exact divisibility, so dims sharded over the
    ``model`` axis that don't divide it are physically padded (zero-init
    extra heads / vocab rows — inert in the math, visible in the FLOP and
    memory accounting, and discussed in EXPERIMENTS.md §Perf).  Head padding
    preserves integer GQA grouping for every assigned arch (asserted).
    """
    pads = {}
    H, Hkv, V = cfg.n_heads, cfg.n_kv_heads, cfg.vocab_size
    Hp = H if H % tp == 0 else _ceil_to(H, tp)
    # kv heads shard over the same axis: pad unless they already divide tp
    Hkvp = Hkv if (Hkv % tp == 0 or tp % Hkv == 0) else _ceil_to(Hkv, tp)
    if tp % max(Hkvp, 1) == 0 and Hkvp != tp and Hkvp < tp:
        Hkvp = tp  # e.g. 8 kv heads on a 16-way axis -> pad to 16
    Vp = V if V % tp == 0 else _ceil_to(V, tp)
    if Hp != H:
        pads["n_heads"] = (H, Hp)
    if Hkvp != Hkv:
        pads["n_kv_heads"] = (Hkv, Hkvp)
    if Vp != V:
        pads["vocab_size"] = (V, Vp)
    if not pads:
        return cfg, pads
    assert Hp % max(Hkvp, 1) == 0, (cfg.name, Hp, Hkvp)
    return cfg.replace(n_heads=Hp, n_kv_heads=Hkvp, vocab_size=Vp), pads
