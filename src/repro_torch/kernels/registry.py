"""Kernel registry: op name x backend name -> implementation.

The port's copy of the JAX package's `kernels/registry.py`. The ops of
`kernels.ops` register themselves at import:

    @register_op("matmul", backend="cuda")
    def matmul(a, b, *, out_dtype=None, ...): ...

The registry names what exists: an unknown op or backend raises a
ValueError that lists exactly the registered options. It routes
nothing. Each op runs its CUDA kernel on a tensor on the card and its
plain version on a tensor on the CPU whatever the backend it is
registered under; `"cuda"` is every op's backend, and `matmul` also has
`"naive"`, the paper's Listing 3 (`ops.matmul_naive`). Tuned tiles are
not a backend: they are a process setting (`tuning.cache.set_tuned`)
that the GEMM wrappers read.

A leaf: it imports nothing of the port.
"""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Dict[str, Callable]] = {}


def register_op(op: str, *, backend: str) -> Callable[[Callable], Callable]:
    """Decorator: register `fn` as the implementation of `op` on
    `backend`. Re-registration replaces (tests swap spies in)."""
    def deco(fn: Callable) -> Callable:
        _REGISTRY.setdefault(op, {})[backend] = fn
        return fn
    return deco


def get_impl(op: str, backend: str) -> Callable:
    impls = _REGISTRY.get(op)
    if impls is None:
        raise ValueError(
            f"unknown op {op!r}; registered ops: {registered_ops()}")
    impl = impls.get(backend)
    if impl is None:
        raise ValueError(
            f"op {op!r} has no backend {backend!r}; registered backends: "
            f"{registered_backends(op)} (tuned tiles are not a backend: "
            "they are served by repro_torch.tuning.set_tuned)")
    return impl


def registered_ops() -> tuple:
    return tuple(sorted(_REGISTRY))


def registered_backends(op: str) -> tuple:
    if op not in _REGISTRY:
        raise ValueError(
            f"unknown op {op!r}; registered ops: {registered_ops()}")
    return tuple(sorted(_REGISTRY[op]))
