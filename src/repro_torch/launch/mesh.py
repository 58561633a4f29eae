"""Meshes: the JAX package's `launch/mesh.py` on `torch.distributed`.

Functions, so that importing this module starts no process group.

  make_host_mesh(model_parallel, device)   the world that exists: a
        torchrun world (its env:// rendezvous), a process group the caller
        started (`init_process_group`; the tests' gloo worlds), or else a
        world of 1 in this process; shape (n // mp, mp), names
        ("data", "model"); `host_mesh` is the same as a context that
        ends the process group it started;
  make_production_mesh(multi_pod)          the reference's (16, 16)
        ("data", "model") or (2, 16, 16) ("pod", "data", "model") mesh on a
        fake process group of that size (`FakeStore`): one rank's view,
        for the dry-run's counting; no collective moves data.

The process group's backend follows the device the caller asked for:
nccl for "cuda", gloo for "cpu"; nothing switches it by itself. One card
holds a world of 1 only (NCCL places no two ranks on one device). The
reference's `axis_kw` is a jax compatibility shim and has no counterpart.
"""

from __future__ import annotations

import contextlib
import os

import torch

from repro_torch.core.device import resolve_device


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _ensure_world(device) -> bool:
    """Start the default process group where none is: torchrun's (env://)
    where its variables are set, else a world of 1 on an in-process
    store. True where it started one."""
    import torch.distributed as dist
    if dist.is_initialized():
        return False
    backend = backend_for(device)
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
        return True
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    return True


def make_host_mesh(model_parallel: int = 1, device=None):
    """A ("data", "model") DeviceMesh over the world that exists (see the
    module's docstring), on `device` (None: the card)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    device = resolve_device(device)
    _ensure_world(device)
    n = dist.get_world_size()
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"--model-parallel {model_parallel} does not divide "
                         f"the world of {n}")
    backend = dist.get_backend()
    if backend != backend_for(device):
        raise ValueError(f"the process group runs {backend}; a {device.type} "
                         f"mesh takes {backend_for(device)}")
    return init_device_mesh(device.type, (n // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def host_mesh(model_parallel: int = 1, device=None):
    """`make_host_mesh` as a context: a process group it had to start is
    destroyed on exit (one the caller or torchrun started is kept)."""
    import torch.distributed as dist
    started = _ensure_world(resolve_device(device))
    try:
        yield make_host_mesh(model_parallel, device)
    finally:
        if started:
            dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 ranks a pod; 2x16x16 = 512 across 2 pods, on a fake
    process group of that size (started here unless one of that size
    is)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    elif dist.get_world_size() != n or dist.get_backend() != "fake":
        raise RuntimeError(f"a {dist.get_backend()} process group of "
                           f"{dist.get_world_size()} is running; the "
                           f"production mesh needs a fake one of {n}")
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def dp_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)
