"""llama-3.2-vision-11b [vlm]: 40 self-attn layers d=4096 32H (GQA kv=8)
ff=14336 vocab=128256, with a gated cross-attention(+MLP) block every 5
layers attending to image patch embeddings.  The vision tower is a STUB per
the assignment: input_specs provides precomputed patch embeddings.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128_256,
    cross_attn_period=5, n_image_tokens=1601,
    rope_theta=500_000.0,
    sub_quadratic=False,
)

SMOKE = FULL.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, cross_attn_period=2, n_image_tokens=16,
    attn_chunk=16, dtype="float32", remat=False)
