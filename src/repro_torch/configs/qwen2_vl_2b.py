"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (kv=2) d_ff=8960
vocab=151936, M-RoPE, dynamic resolution. [arXiv:2409.12191]

The vision frontend is a stub, as in the JAX package: a batch carries
patch embeddings aligned with the token grid (zeros at text positions;
added to the token embeddings) and the (t, h, w) M-RoPE position
streams. head_dim = 1536/12 = 128 -> mrope sections (16, 24, 24) over
the 64 frequency slots, per the hf config.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    tie_embeddings=True,
)
