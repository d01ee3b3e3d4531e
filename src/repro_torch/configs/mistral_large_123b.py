"""mistral-large-123b [dense]: 88L d=12288 96H (GQA kv=8) ff=28672
vocab=32768.  [hf:mistralai/Mistral-Large-Instruct-2407; unverified]"""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=32_768,
    rope_theta=1_000_000.0,
    sub_quadratic=False,
    notes="largest dense arch in the pool; TP-dominant",
)

SMOKE = FULL.replace(
    n_layers=3, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=256, attn_chunk=16, dtype="float32", remat=False)
