"""zamba2-1.2b [hybrid]: 38 Mamba2 blocks (d=2048, ssm_state=64) with a
single SHARED attention(+MLP) block (32H, kv=32, ff=8192) applied every 6
mamba blocks.  [arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32_000,
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
    shared_attn_every=6,
    sub_quadratic=True,
    notes="SSM state is O(1) per token -> runs long_500k; shared attn "
          "block KV caches are per-application",
)

SMOKE = FULL.replace(
    n_layers=7, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, ssm_state=8, ssm_head_dim=16,
    shared_attn_every=3, attn_chunk=16, dtype="float32", remat=False)
