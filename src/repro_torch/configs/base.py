"""Model/runtime configuration of the PyTorch port.

A copy of the JAX package's `ModelConfig`, `MoEConfig` and `SSMConfig`
(its own module, so the port imports nothing of `repro`), cut to the fields that
describe the models the port serves: each keeps its name and default
there, so a config built here and one built there compare field by
field. `reduced()` derives the same CPU test config as the reference's.
`ShapeCell`, `SHAPES` and `get_shape` are the reference's shape cells,
which the roofline report reads (`roofline.analysis.build_report`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


#: The `remat` policies the port takes: "none" keeps every activation
#: for the backward, "full" keeps each layer's input and recomputes the
#: rest, as the JAX package's `jax.checkpoint` without a policy does.
REMAT_POLICIES = ("none", "full")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    group_size: int = 256           # tokens per routing group (GShard-style)
    dense_ff: int = 0               # Arctic: parallel dense-residual FFN width
    router_z_coef: float = 1e-3
    load_balance_coef: float = 1e-2
    # "einsum": the reference's GShard one-hot dispatch and combine, whose
    #   combine weights are rounded to the activation dtype; "gather": its
    #   index-based form, f32 combine weights. The port gathers by index
    #   in both, rounding the weights as the mode says (models.moe).
    dispatch: str = "einsum"


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
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
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
    # vlm (Qwen2-VL): the (temporal, height, width) sections of the
    # head_dim / 2 rotary frequency slots, each turned by its own stream
    mrope_sections: Optional[Tuple[int, int, int]] = None
    tie_embeddings: bool = False
    # mixture-of-experts FFN (family moe)
    moe: Optional[MoEConfig] = None
    # Mamba-2 blocks (families ssm and hybrid)
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0             # hybrid: shared attn block period (Zamba2)
    shared_attn_lora_rank: int = 0  # Zamba2 per-invocation LoRA on shared block
    # encoder-decoder (Whisper): encoder layers, and the frames the
    # (stub) conv frontend hands the encoder
    n_enc_layers: int = 0
    enc_ctx: int = 0
    # block flavour
    norm: str = "rms"               # rms | ln (Whisper)
    mlp: str = "swiglu"             # swiglu | gelu (Whisper)
    # f32 attention I/O in the chunked (prefill) path
    attn_f32_io: bool = True
    # numerics
    vocab_pad_to: int = 256         # Megatron-style vocab padding
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # activation checkpointing of each layer in training: none | full
    # (the reference's "dots" policy is not ported)
    remat: str = "full"
    # chunk of the chunked online-softmax attention (prefill)
    attn_chunk: int = 2048

    def __post_init__(self):
        if self.remat not in REMAT_POLICIES:
            what = ("is not ported (it saves the GEMMs' outputs, which the "
                    "GEMM chokepoint would have to save itself)"
                    if self.remat == "dots" else "is unknown")
            raise ValueError(f"remat={self.remat!r} {what}; the port "
                             f"takes {REMAT_POLICIES}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return ((self.vocab + m - 1) // m) * m

    @property
    def subquadratic(self) -> bool:
        """Can this arch serve 500k-token contexts? (DESIGN §6)."""
        return self.family in ("ssm", "hybrid") or self.window is not None

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
        if self.mrope_sections is not None:
            kw["mrope_sections"] = (2, 3, 3)   # head_dim 16: 8 slots
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe,
                n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                group_size=32,
                dense_ff=64 if self.moe.dense_ff else 0,
            )
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=8, chunk=16)
        if self.n_enc_layers:
            kw["n_enc_layers"] = 2
            kw["enc_ctx"] = 32
        if self.attn_every:
            kw["attn_every"] = 2
        if self.window is not None:
            kw["window"] = 32
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) column: what to lower and how big."""
    name: str                       # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                       # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = (
    ShapeCell("train_4k", "train", 4_096, 256),
    ShapeCell("prefill_32k", "prefill", 32_768, 32),
    ShapeCell("decode_32k", "decode", 32_768, 128),
    ShapeCell("long_500k", "decode", 524_288, 1),
)


def get_shape(name: str) -> ShapeCell:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
