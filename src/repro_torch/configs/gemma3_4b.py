"""gemma3-4b — dense, 5:1 local:global interleaved attention, 128k ctx.

[hf:google/gemma-3-*-pt; unverified]: 34L, d_model 2560, 8 q-heads,
GQA kv=4, head_dim 256, d_ff 10240, vocab 262144, sliding window 1024.
Sub-quadratic long-context: 5/6 of layers are windowed; global layers
decode against a data-axis-sharded KV cache (DESIGN §4).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab=262144,
    block_pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,
    rope_theta=1_000_000.0,
    sub_quadratic=True,
)
