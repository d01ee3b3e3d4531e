"""deepseek-v2-lite-16b [moe]: 27L d=2048 16H, MLA (kv_lora=512,
qk_nope=128, qk_rope=64, v=128), 1 leading dense layer (ff=10944), then MoE
with 64 routed experts top-6 + 2 shared experts, expert ff=1408.
[arXiv:2405.04434; hf]"""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=10944, vocab_size=102_400,
    n_experts=64, top_k=6, n_shared_experts=2, moe_d_ff=1408,
    first_dense_layers=1,
    kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    rope_theta=10_000.0,
    sub_quadratic=False,
    notes="MLA latent cache (512+64/token); experts sharded over the model "
          "axis (4 experts/device on 16-way TP) — true EP",
)

SMOKE = FULL.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=160, vocab_size=256,
    n_experts=8, top_k=2, n_shared_experts=1, moe_d_ff=32,
    first_dense_layers=1,
    kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    attn_chunk=16, dtype="float32", remat=False)
