"""recurrentgemma-2b — RG-LRU + local attention hybrid, 1 attn : 2 recurrent.
[arXiv:2402.19427; hf]: 26L, d_model 2560, 10H, MQA kv=1, head_dim 256,
d_ff 7680, vocab 256000, lru_width 2560, window 2048. Linear recurrence +
windowed attention → long_500k runs (DESIGN §4)."""
from repro_torch.configs.base import ArchConfig, RGLRUConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    block_pattern=("rglru", "rglru", "local"),
    window=2048,
    rglru=RGLRUConfig(lru_width=2560, conv_width=4),
    sub_quadratic=True,
)
