"""mixtral-8x22b [moe]: 56L d_model=6144 48H (kv=8) d_ff=16384
vocab=32768, 8 experts top-2, sliding-window attention (4096).
[arXiv:2401.04088]
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=32768,
    window=4096,
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=8, top_k=2),
)
