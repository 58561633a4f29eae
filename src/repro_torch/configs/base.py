"""Model/runtime configuration of the PyTorch port.

A copy of the JAX package's `ModelConfig` and `SSMConfig` (its own
module, so the port imports nothing of `repro`), cut to the fields that
describe the models the port serves: each keeps its name and default
there, so a config built here and one built there compare field by
field. `reduced()` derives the same CPU test config as the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | ssm (the families the port serves)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    # attention flavour
    window: Optional[int] = None    # sliding-window size
    qk_norm: bool = False           # Qwen3
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    use_rope: bool = True
    tie_embeddings: bool = False
    # Mamba-2 blocks (family ssm)
    ssm: Optional[SSMConfig] = None
    # block flavour
    norm: str = "rms"
    mlp: str = "swiglu"
    # f32 attention I/O in the chunked (prefill) path
    attn_f32_io: bool = True
    # numerics
    vocab_pad_to: int = 256         # Megatron-style vocab padding
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # chunk of the chunked online-softmax attention (prefill)
    attn_chunk: int = 2048

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return ((self.vocab + m - 1) // m) * m

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def reduced(self) -> "ModelConfig":
        """Same family, toy dims: the CPU test config."""
        kw = dict(
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // max(self.n_heads, 1))),
            head_dim=16,
            d_ff=128,
            vocab=256,
            attn_chunk=64,
        )
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=8, chunk=16)
        if self.window is not None:
            kw["window"] = 32
        return dataclasses.replace(self, **kw)
