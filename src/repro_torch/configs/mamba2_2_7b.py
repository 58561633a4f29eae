"""mamba2-2.7b [ssm]: 64L d_model=2560 (attention-free) vocab=50280,
ssm_state=128, SSD (state-space duality). d_inner = 2*2560 = 5120,
head_dim 64 -> 80 SSD heads. [arXiv:2405.21060]
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=1,                  # unused (attention-free)
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4,
                  chunk=256, n_groups=1),
)
