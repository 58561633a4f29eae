"""arctic-480b [moe]: 35L d_model=7168 56H (kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 PLUS a parallel dense residual FFN branch
(dense-MoE hybrid). [hf:Snowflake/snowflake-arctic-base]

As the JAX package records it: the dense residual branch width is set to
d_model (7168); the hf config's dense branch is the 10B dense trunk's FFN.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab=32000,
    moe=MoEConfig(n_experts=128, top_k=2, dense_ff=7168,
                  capacity_factor=1.0),
)
