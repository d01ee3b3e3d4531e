"""mixtral-8x7b [moe]: 32L d=4096 32H (GQA kv=8) expert ff=14336
vocab=32000; 8 experts top-2; sliding-window attention (4096).
[arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32_000,
    n_experts=8, top_k=2, moe_d_ff=14336,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    sub_quadratic=True,
    notes="SWA bounds decode KV reads -> runs long_500k; 8 experts < 16-way "
          "axis -> TP inside experts (d_ff sharded)",
)

SMOKE = FULL.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, n_experts=4, top_k=2, moe_d_ff=64,
    sliding_window=16, attn_chunk=16, dtype="float32", remat=False)
