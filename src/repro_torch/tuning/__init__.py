"""Benchmark-driven autotuning of the port's GEMM instances.

The port's counterpart of the JAX package's `repro.tuning`. Every GEMM
of the port has several compiled instances (`kernels.matmul.PLANS`) that
sum each output in one k-order; the tuner times them in turns on the
card and caches the fastest by hardware fingerprint, and while a cache
is set (`set_tuned`) the GEMM plans serve its winners, bit for bit the
static plans' outputs. A shape is timed in the layouts the model's step
runs it in. The attention and SSD kernels have a space of one instance,
which nothing times. The launchers wire it in through `--backend tuned` and
`--autotune`.

Layering: cache and timing are leaves (`kernels.matmul` imports the
cache); space and the autotuner sit above the kernels and load lazily,
so `kernels.matmul -> tuning.cache` never cycles back through them.
"""

from repro_torch.tuning.cache import (BACKEND, CACHE_ENV_VAR,
                                      FlashBlockConfig, SSDBlockConfig,
                                      TuningCache, default_cache_path,
                                      flash_bwd_key, flash_decode_key,
                                      flash_decode_paged_key, flash_key,
                                      gated_key, get_cache, matmul_key,
                                      matmul_q_key, reset_cache, set_cache,
                                      set_tuned, ssd_key, tuned,
                                      tuned_cache)
from repro_torch.tuning.timing import time_turns

#: The port's backends: the CUDA kernels on their static plans, or on the
#: tuning cache's winners (`set_tuned`).
BACKENDS = ("cuda", "tuned")

_SPACE = ("flash_bwd_candidates", "flash_candidates",
          "flash_decode_candidates", "flash_decode_paged_candidates",
          "gated_matmul_candidates", "matmul_candidates", "ssd_candidates")
_LAZY = ("TuneResult", "card_timer", "default_exec_backend",
         "describe_warm_start", "model_attention_shapes",
         "model_gemm_layouts", "model_gemm_shapes", "model_ssd_shapes", "tune_flash_attention",
         "tune_flash_bwd", "tune_flash_decode", "tune_flash_decode_paged",
         "tune_gated_matmul", "tune_matmul", "tune_ssd", "warm_start")

__all__ = [
    "BACKEND", "BACKENDS", "CACHE_ENV_VAR", "FlashBlockConfig",
    "SSDBlockConfig", "TuningCache", "default_cache_path", "flash_bwd_key",
    "flash_decode_key", "flash_decode_paged_key", "flash_key", "gated_key",
    "get_cache", "matmul_key", "matmul_q_key", "reset_cache", "set_cache",
    "check_backend", "set_tuned", "ssd_key", "tuned", "tuned_cache",
    "time_turns",
    *_SPACE, *_LAZY,
]


def check_backend(name: str) -> str:
    """`name` if it is one of the port's backends; else a ValueError that
    names them (the JAX package's xla, pallas* and naive* backends have
    no counterpart: every op runs its CUDA kernel on the card)."""
    if name not in BACKENDS:
        raise ValueError(
            f"unknown backend {name!r}: the port's backends are "
            f"{BACKENDS} ('cuda': the CUDA kernels on their static tile "
            f"plans; 'tuned': on the tuning cache's winners)")
    return name


def __getattr__(name):
    if name in _SPACE:
        from repro_torch.tuning import space
        return getattr(space, name)
    if name in _LAZY:
        from repro_torch.tuning import autotuner
        return getattr(autotuner, name)
    raise AttributeError(name)
