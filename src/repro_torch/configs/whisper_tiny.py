"""whisper-tiny [encdec]: 4 encoder and 4 decoder layers, d_model=384,
6 heads (kv=6) of 64, d_ff=1536, vocab=51865, 1500 encoder frames.

The conv frontend is a stub: a request carries its precomputed frame
embeddings (1500, 384). LayerNorm, a GELU MLP with biases, sinusoid
positions (no RoPE), tied embeddings. [arXiv:2212.04356]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,                 # decoder layers
    n_enc_layers=4,
    enc_ctx=1500,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab=51865,
    use_rope=False,
    norm="ln",
    mlp="gelu",
    tie_embeddings=True,
)
