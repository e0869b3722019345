"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed top-6,
first layer dense. [arXiv:2401.06066; hf]: 28L, d_model 2048, 16H (MHA),
head_dim 128, expert d_ff 1408, dense d_ff 10944, vocab 102400."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,              # dense-layer FFN width
    vocab=102400,
    block_pattern=("global",),
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        d_ff_expert=1408,
        num_shared=2,
        d_ff_shared=1408,
        first_k_dense=1,
        d_ff_dense=10944,
    ),
    tie_embeddings=False,
)
