"""The port's public facade (`repro_torch.__all__`), pinned here: every
name resolves, the list is sorted, every name of the JAX facade's
`__all__` is exported under the same name or left out with its reason,
and `import repro_torch` loads no torch until a name is touched.

An intentional API change edits PINNED in the same change."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro
import repro_torch

ROOT = Path(__file__).resolve().parents[1]

PINNED = [
    "ARCH_NAMES", "FaultInjector", "KVPagePool", "KVPoolExhausted",
    "QuantSpec", "Request", "ServingEngine", "SimulatedKernelFault",
    "SpecDecoder", "TuningCache", "__version__", "add", "bursty_trace",
    "default_exec_backend", "dense", "dense_q", "dequantize",
    "flash_attention", "flash_attention_bwd", "flash_decode",
    "flash_decode_paged", "gated_mlp", "get_config", "long_context_trace",
    "make_sampler", "make_trace", "matmul", "prefix_heavy_trace",
    "quantize_int8", "quantize_params", "register_op",
    "registered_backends", "registered_ops", "set_tuned", "ssd", "sub",
    "synthetic_trace", "tune_flash_attention", "tune_flash_bwd",
    "tune_flash_decode", "tune_flash_decode_paged", "tune_gated_matmul",
    "tune_matmul", "tune_ssd", "warm_start",
]

#: The JAX facade's names the port has no counterpart for.
LEFT_OUT = {
    "Policy": "no Policy switch: every op runs its CUDA kernel on a card "
              "tensor and its plain version on a CPU tensor",
    "current_policy": "no Policy switch",
    "set_default_policy": "no Policy switch; tuned tiles are set_tuned",
    "LEGACY_BACKEND_NAMES": "the port's backends are tuning.BACKENDS",
    "default_exec_policy": "no Policy; its counterpart is "
                           "default_exec_backend",
    "set_default_backend": "no string backends to set; set_tuned",
    "use_backend": "no string backends to scope; tuning.tuned",
}

#: The port's names the JAX facade does not have, and what they stand for.
ADDED = {"default_exec_backend": "default_exec_policy",
         "set_tuned": "Policy(autotune='cached')"}


def test_all_is_pinned():
    assert repro_torch.__all__ == PINNED


def test_all_is_sorted_and_unique():
    assert list(repro_torch.__all__) == sorted(set(repro_torch.__all__))


@pytest.mark.parametrize("name", PINNED)
def test_every_export_resolves(name):
    assert getattr(repro_torch, name) is not None


def test_every_reference_name_is_exported_or_left_out_with_a_reason():
    for name in repro.__all__:
        assert (name in repro_torch.__all__) != (name in LEFT_OUT), name
    assert set(repro_torch.__all__) - set(repro.__all__) == set(ADDED)
    assert all(LEFT_OUT.values())


def test_exports_are_the_modules_objects():
    import importlib
    for name, (module, attr) in repro_torch._EXPORTS.items():
        assert module.startswith("repro_torch.")
        assert getattr(repro_torch, name) is \
            getattr(importlib.import_module(module), attr)


def test_import_loads_no_torch():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys, repro_torch; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'repro')]; print(bad); "
            "sys.exit(1 if bad or repro_torch.__version__ != '0.1.0' "
            "else 0)")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
