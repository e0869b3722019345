"""olmoe-1b-7b — 64-expert top-8 MoE, qk-norm. [arXiv:2409.02060; hf]:
16L, d_model 2048, 16H (MHA), head_dim 128, expert d_ff 1024, vocab 50304."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab=50304,
    block_pattern=("global",),
    qk_norm=True,
    moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024),
    tie_embeddings=False,
)
