"""xlstm-1.3b [ssm]: 48 blocks, d=2048, 4 heads (head_dim=512), xLSTM[7:1]
— one sLSTM block per 7 mLSTM blocks; no separate FFN (d_ff=0);
vocab=50304.  [arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, head_dim=512,
    d_ff=0, vocab_size=50_304,
    slstm_period=8,
    sub_quadratic=True,
    notes="recurrent state O(1)/token -> runs long_500k; mLSTM matrix "
          "memory C is (H, 512, 512) per sequence",
)

SMOKE = FULL.replace(
    n_layers=8, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
    vocab_size=256, slstm_period=4, dtype="float32", remat=False)
