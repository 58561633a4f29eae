"""The port's kernel registry (`repro_torch.kernels.registry`) against the
JAX package's: the same interface and error messages that list the
options, every public op of `kernels.ops` registered under "cuda" and
`matmul` under "naive", and registration changing no route (a CPU tensor
takes the plain version)."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import registry as jax_registry

from repro_torch.kernels import ops, ref
from repro_torch.kernels import registry

OPS = ("add", "axpy", "flash_attention", "flash_attention_bwd",
       "flash_attention_fwd", "flash_decode", "flash_decode_paged",
       "gated_matmul", "gated_matmul_batched", "matmul", "matmul_batched",
       "matmul_naive", "matmul_q", "ssd", "sub")


def _message(fn, *args):
    with pytest.raises(ValueError) as e:
        fn(*args)
    return str(e.value)


def test_every_public_op_is_registered_under_cuda():
    assert registry.registered_ops() == OPS
    for op in OPS:
        assert "cuda" in registry.registered_backends(op)
        assert registry.get_impl(op, "cuda") is getattr(ops, op)
    assert registry.registered_backends("matmul") == ("cuda", "naive")
    assert registry.get_impl("matmul", "naive") is ops.matmul_naive


def test_no_backend_is_named_after_a_plain_version():
    backends = {b for op in OPS for b in registry.registered_backends(op)}
    assert backends == {"cuda", "naive"}


def test_unknown_names_list_the_options_as_the_reference_does(monkeypatch):
    # the reference's functions over the port's table give its messages
    monkeypatch.setattr(jax_registry, "_REGISTRY", registry._REGISTRY)
    for fn in ("get_impl", "registered_backends"):
        args = ("no_such_op", "cuda")[:2 if fn == "get_impl" else 1]
        assert _message(getattr(registry, fn), *args) == \
            _message(getattr(jax_registry, fn), *args)
    port = _message(registry.get_impl, "matmul", "xla")
    ref_msg = _message(jax_registry.get_impl, "matmul", "xla")
    assert port.startswith(ref_msg[:ref_msg.index(" (legacy")])
    assert "('cuda', 'naive')" in port


def test_register_op_replaces_as_the_reference_does():
    old = registry.get_impl("add", "cuda")
    try:
        spy = registry.register_op("add", backend="cuda")(lambda a, b: "spy")
        assert registry.get_impl("add", "cuda") is spy
    finally:
        registry.register_op("add", backend="cuda")(old)
    assert registry.get_impl("add", "cuda") is ops.add


def test_registration_changes_no_route():
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.standard_normal((5, 7)), dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal((7, 3)), dtype=torch.float32)
    for backend in ("cuda", "naive"):
        got = registry.get_impl("matmul", backend)(a, b)
        assert torch.equal(got, ref.matmul_ref(a, b, torch.float32))
    assert torch.equal(registry.get_impl("add", "cuda")(a, a),
                       ref.binary_ref(a, a, "add"))


def test_the_registry_is_a_leaf():
    tree = ast.parse(Path(registry.__file__).read_text())
    imported = {n.module for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom)} | \
        {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
         for a in n.names}
    assert not {m for m in imported if m and m.startswith("repro")}
