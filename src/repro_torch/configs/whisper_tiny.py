"""whisper-tiny [audio]: enc-dec, 4+4L d=384 6H ff=1536 vocab=51865; the
conv/mel frontend is a STUB (input_specs provides 1500 precomputed frame
embeddings).  Decode shapes exceed the model's natural 448-token decoder
context; they lower mechanically per the assignment grid.
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, head_dim=64,
    d_ff=1536, vocab_size=51_865,
    encoder_layers=4, n_audio_frames=1500, max_target_positions=448,
    sub_quadratic=False,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, encoder_layers=2, n_audio_frames=32,
    max_target_positions=64, attn_chunk=16, dtype="float32", remat=False)
