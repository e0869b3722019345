"""chatglm3-6b — dense, aggressive GQA (kv=2), 2d/partial RoPE.
[arXiv:2406.12793; hf]: 28L, d_model 4096, 32H, kv=2, head_dim 128,
d_ff 13696, vocab 65024. RoPE applied to half the head dims (GLM style)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab=65024,
    block_pattern=("global",),
    rope_mode="half",
    tie_embeddings=False,
)
