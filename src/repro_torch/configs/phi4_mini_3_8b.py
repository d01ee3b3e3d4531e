"""phi4-mini-3.8b [dense]: 32L d=3072 24H (GQA kv=8) ff=8192 vocab=200064;
RoPE + SwiGLU + GQA.  [arXiv:2412.08905; hf]"""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=200_064,
    rope_theta=10_000.0,
    sub_quadratic=False,
)

SMOKE = FULL.replace(
    n_layers=3, d_model=96, n_heads=6, n_kv_heads=2, head_dim=16,
    d_ff=192, vocab_size=256, attn_chunk=16, dtype="float32", remat=False)
