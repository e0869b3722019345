"""mistral-nemo-12b — dense GQA, 128k ctx. [hf:mistralai/Mistral-Nemo-
Base-2407; hf]: 40L, d_model 5120, 32H, kv=8, head_dim 128, d_ff 14336,
vocab 131072. Pure full attention → long_500k skipped (DESIGN §4)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    block_pattern=("global",),
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)
