"""whisper-small — encoder-decoder audio backbone, conv frontend STUB.
[arXiv:2212.04356; unverified]: 12+12L, d_model 768, 12H (MHA), head_dim 64,
d_ff 3072, vocab 51865, 1500 mel frames. ``input_specs()`` provides
precomputed frame embeddings. Learned positions are extended to 32768 to
mechanically support the decode_32k cell (noted in DESIGN §4); long_500k is
inapplicable (enc-dec short decoder)."""
from repro_torch.configs.base import ArchConfig, EncoderConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab=51865,
    block_pattern=("global",),
    rope_mode="none",
    encoder=EncoderConfig(n_layers=12, n_frames=1500),
    enc_dec=True,
    max_position=32768,
)
