"""qwen3-0.6b — dense GQA with qk_norm. [hf:Qwen/Qwen3-0.6B; hf]:
28L, d_model 1024, 16H, kv=8, head_dim 128, d_ff 3072, vocab 151936."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab=151936,
    block_pattern=("global",),
    qk_norm=True,
    rope_theta=1_000_000.0,
)
