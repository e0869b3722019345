"""internvl2-26b — VLM: InternViT frontend (STUB) + InternLM2 backbone.
[arXiv:2404.16821; hf]: backbone 48L, d_model 6144, 48H, kv=8, head_dim 128,
d_ff 16384, vocab 92553. The vision tower is stubbed per the assignment:
``input_specs()`` provides precomputed patch embeddings (frontend_dim=3200,
InternViT-6B width) projected into the LM width."""
from repro_torch.configs.base import ArchConfig, EncoderConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=92553,
    block_pattern=("global",),
    encoder=EncoderConfig(n_patches=1024, frontend_dim=3200),
    tie_embeddings=False,
)
