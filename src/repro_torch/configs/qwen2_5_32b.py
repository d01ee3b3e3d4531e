"""qwen2.5-32b [dense]: 64L d=5120 40H (GQA kv=8) ff=27648 vocab=152064;
QKV bias.  [hf:Qwen/Qwen2.5 family; hf]"""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=27648, vocab_size=152_064,
    rope_theta=1_000_000.0, qkv_bias=True,
    sub_quadratic=False,
    notes="40 heads on a 16-way TP axis -> GSPMD pads to 48 (see "
          "EXPERIMENTS.md §Perf for the measured cost)",
)

SMOKE = FULL.replace(
    n_layers=4, d_model=96, n_heads=6, n_kv_heads=2, head_dim=16,
    d_ff=192, vocab_size=256, attn_chunk=16, dtype="float32", remat=False)
