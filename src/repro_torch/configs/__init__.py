"""Config registry of the archs the port serves: the dense decoders
qwen3-0.6b, granite-3-8b, granite-20b (MQA) and qwen1.5-32b (MHA, QKV
bias), the vision-language decoder qwen2-vl-2b (M-RoPE, patch
embeddings), the mixture-of-experts decoders mixtral-8x22b (8 experts,
a sliding window) and arctic-480b (128 experts and a dense branch), the
attention-free Mamba-2 mamba2-2.7b, the hybrid zamba2-1.2b (a Mamba-2
backbone with one shared attention block) and the encoder-decoder
whisper-tiny (family encdec: layernorm, a gelu MLP, sinusoid positions,
cross-attention over the encoder's output).

`get_config(name)` returns the full published config; `get_config(name,
reduced=True)` the CPU test derivative.
"""

from __future__ import annotations

from repro_torch.configs import (arctic_480b, granite_3_8b, granite_20b,
                                 mamba2_2_7b, mixtral_8x22b, qwen1_5_32b,
                                 qwen2_vl_2b, qwen3_0_6b, whisper_tiny,
                                 zamba2_1_2b)
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

_REGISTRY = {m.CONFIG.name: m.CONFIG
             for m in (arctic_480b, granite_3_8b, granite_20b, mamba2_2_7b,
                       mixtral_8x22b, qwen1_5_32b, qwen2_vl_2b, qwen3_0_6b,
                       whisper_tiny, zamba2_1_2b)}

ARCH_NAMES = tuple(sorted(_REGISTRY))


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    try:
        cfg = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"the port serves {ARCH_NAMES} (families dense, "
                         f"vlm, moe, ssm, hybrid and encdec), "
                         f"not {name!r}") from None
    return cfg.reduced() if reduced else cfg


__all__ = ["ARCH_NAMES", "ModelConfig", "MoEConfig", "SSMConfig",
           "get_config"]
