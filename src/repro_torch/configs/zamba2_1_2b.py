"""zamba2-1.2b [hybrid]: d_model=2048, a Mamba-2 backbone with ONE
weight-shared attention + SwiGLU block (32 heads, 32 KV heads of 64,
d_ff=8192) invoked after every 6 Mamba layers with a per-invocation
LoRA, ssm_state=64. [arXiv:2411.15242]

As the JAX package records it: the shared block consumes
concat(hidden, embedding) through a learned 2d -> d projection, Zamba2's
two shared blocks are represented by the one shared block + LoRA, and
the backbone is rounded to 36 Mamba layers in 6 segments of 6.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=36,                # 6 segments x 6
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=32000,
    attn_every=6,
    shared_attn_lora_rank=32,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_width=4,
                  chunk=128, n_groups=1),
)
