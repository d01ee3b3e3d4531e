"""gemma3-12b [dense]: 48L d=3840 16H (GQA kv=8, head_dim=256) ff=15360
vocab=262144; 5:1 local(SWA-1024):global interleave, dual rope thetas,
sqrt(d) embedding scale.  [hf:google/gemma-3 family; unverified]"""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15360, vocab_size=262_144,
    local_global_ratio=5, sliding_window=1024,
    rope_theta=1_000_000.0, local_rope_theta=10_000.0,
    embed_scale=True, tie_embeddings=True,
    sub_quadratic=True,
    notes="5:1 local:global; long_500k decode touches full KV only on "
          "every 6th (global) layer",
)

SMOKE = FULL.replace(
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, sliding_window=8, attn_chunk=16,
    dtype="float32", remat=False)
