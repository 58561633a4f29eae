"""PyTorch/CUDA port of the `repro` package for NVIDIA Hopper.

The JAX package (`repro`) stays the reference; this package imports
nothing of it. Its layout mirrors the reference (`configs/`, `kernels/`,
`core/`, `models/`, `optim/`, `data/`, `training/`, `serving/`,
`tuning/`, `launch/`), and every Pallas kernel on the ported path is a
hand-written CUDA C++ kernel under `kernels/csrc/`, built at first use
with `nvcc` and bound with ctypes.

Entry points run on the card (`device=None` means `"cuda"`) and raise
where there is none, unless the caller passes `device="cpu"`: a kernel
wrapper then runs the kernel's plain PyTorch version, because the
tensor it was given lies on the CPU.

One import surface for the stable API, the reference facade's names:

    import repro_torch

    y = repro_torch.matmul(a, b)                  # GEMM chokepoint
    h = repro_torch.gated_mlp(x, wg, wu)          # dual-GEMM SwiGLU
    engine = repro_torch.ServingEngine(cfg, params, max_slots=4,
                                       max_len=256)
    repro_torch.warm_start(cfg, batch, seq, autotune=True)
    repro_torch.set_tuned(repro_torch.TuningCache().load())

`__all__` is pinned by tests/test_torch_api_surface.py. The reference's
names without a counterpart are left out: the port has no `Policy`
switch (`Policy`, `current_policy`, `set_default_policy`,
`LEGACY_BACKEND_NAMES`, `default_exec_policy`, `set_default_backend`,
`use_backend`); every op runs its CUDA kernel on a card tensor, and tuned
tiles are the process setting `set_tuned` (`default_exec_backend()`
names the backend the cache's timings key). Submodules load lazily:
`import repro_torch` imports no torch until a name is touched.
"""

from __future__ import annotations

__version__ = "0.1.0"

#: name -> (module, attribute) for the lazily-bound part of the facade.
_EXPORTS = {
    # GEMM chokepoint (core.gemm)
    "matmul": ("repro_torch.core.gemm", "matmul"),
    "dense": ("repro_torch.core.gemm", "dense"),
    "dense_q": ("repro_torch.core.gemm", "dense_q"),
    "gated_mlp": ("repro_torch.core.gemm", "gated_mlp"),
    # weight quantization (core.precision / models)
    "QuantSpec": ("repro_torch.core.precision", "QuantSpec"),
    "quantize_int8": ("repro_torch.core.precision", "quantize_int8"),
    "dequantize": ("repro_torch.core.precision", "dequantize"),
    "quantize_params": ("repro_torch.models.model", "quantize_params"),
    # kernel-level ops (kernels.ops)
    "flash_attention": ("repro_torch.kernels.ops", "flash_attention"),
    "flash_attention_bwd": ("repro_torch.kernels.ops", "flash_attention_bwd"),
    "flash_decode": ("repro_torch.kernels.ops", "flash_decode"),
    "flash_decode_paged": ("repro_torch.kernels.ops", "flash_decode_paged"),
    "ssd": ("repro_torch.kernels.ops", "ssd"),
    "add": ("repro_torch.kernels.ops", "add"),
    "sub": ("repro_torch.kernels.ops", "sub"),
    # kernel registry (kernels.registry)
    "register_op": ("repro_torch.kernels.registry", "register_op"),
    "registered_ops": ("repro_torch.kernels.registry", "registered_ops"),
    "registered_backends": ("repro_torch.kernels.registry",
                            "registered_backends"),
    # model configs
    "get_config": ("repro_torch.configs", "get_config"),
    "ARCH_NAMES": ("repro_torch.configs", "ARCH_NAMES"),
    # serving
    "ServingEngine": ("repro_torch.serving", "ServingEngine"),
    "Request": ("repro_torch.serving", "Request"),
    "KVPagePool": ("repro_torch.serving", "KVPagePool"),
    "KVPoolExhausted": ("repro_torch.serving", "KVPoolExhausted"),
    "make_sampler": ("repro_torch.serving", "make_sampler"),
    "synthetic_trace": ("repro_torch.serving", "synthetic_trace"),
    "prefix_heavy_trace": ("repro_torch.serving", "prefix_heavy_trace"),
    "bursty_trace": ("repro_torch.serving", "bursty_trace"),
    "long_context_trace": ("repro_torch.serving", "long_context_trace"),
    "make_trace": ("repro_torch.serving", "make_trace"),
    # speculative decoding (serving.spec)
    "SpecDecoder": ("repro_torch.serving", "SpecDecoder"),
    # fault tolerance (serving.faults)
    "FaultInjector": ("repro_torch.serving", "FaultInjector"),
    "SimulatedKernelFault": ("repro_torch.serving", "SimulatedKernelFault"),
    # tuning
    "TuningCache": ("repro_torch.tuning", "TuningCache"),
    "tune_matmul": ("repro_torch.tuning", "tune_matmul"),
    "tune_gated_matmul": ("repro_torch.tuning", "tune_gated_matmul"),
    "tune_flash_attention": ("repro_torch.tuning", "tune_flash_attention"),
    "tune_flash_bwd": ("repro_torch.tuning", "tune_flash_bwd"),
    "tune_flash_decode": ("repro_torch.tuning", "tune_flash_decode"),
    "tune_flash_decode_paged": ("repro_torch.tuning",
                                "tune_flash_decode_paged"),
    "tune_ssd": ("repro_torch.tuning", "tune_ssd"),
    "warm_start": ("repro_torch.tuning", "warm_start"),
    "default_exec_backend": ("repro_torch.tuning", "default_exec_backend"),
    "set_tuned": ("repro_torch.tuning", "set_tuned"),
}

__all__ = sorted(["__version__", *_EXPORTS])


def __getattr__(name: str):
    try:
        module, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module 'repro_torch' has no attribute {name!r}") from None
    import importlib

    value = getattr(importlib.import_module(module), attr)
    globals()[name] = value      # cache: later lookups skip this
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
