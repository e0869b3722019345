"""mamba2-1.3b — attention-free SSM with state-space duality.
[arXiv:2405.21060; unverified]: 48L, d_model 2048, ssm_state 128,
head_dim 64, expand 2, vocab 50280. O(1) decode state → long_500k runs."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,           # attention-free; SSD heads live in SSMConfig
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab=50280,
    block_pattern=("ssm",),
    rope_mode="none",
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                  chunk=256),
    sub_quadratic=True,
)
