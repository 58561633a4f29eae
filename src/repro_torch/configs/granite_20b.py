"""granite-20b [dense]: 52L d_model=6144 48H (kv=1, MQA) d_ff=24576
vocab=49152 — llama-arch code model. [arXiv:2405.04324]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab=49152,
)
