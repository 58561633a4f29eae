"""Build and load the CUDA kernels of `kernels/csrc/`.

Each `csrc/<name>.cu` compiles on its own, with `nvcc` for `sm_90a`,
into a shared library with a plain C interface, which is loaded with
ctypes. Nothing is built when a module is imported: the first launch
builds every source at once (one `nvcc` per source, all started
together) and loads its library. A library is keyed on a hash of the
sources and flags, so an edited source builds anew and an unchanged one
is reused. Builds go to `build/repro_torch/` at the root of the checkout
(or `$REPRO_TORCH_BUILD_DIR`), which `.gitignore` lists.

Each C entry point returns `cudaGetLastError()` after its launch;
`check()` raises if that is not 0, so a refused launch never passes
silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card, at their first launch")


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / _key() / f"lib{name}.so"


def build_all() -> dict:
    """Compile every source whose library is missing, all in parallel.
    Returns {name: path}. Raises with nvcc's output if one fails."""
    out = build_dir() / _key()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources():
        lib = out / f"lib{src.stem}.so"
        if lib.exists():
            continue
        tmp = out / f".lib{src.stem}.{os.getpid()}.so"
        log = open(out / f"{src.stem}.log", "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs[src.stem] = (subprocess.Popen(cmd, stdout=log,
                                            stderr=subprocess.STDOUT),
                           tmp, lib, log)
    failed = []
    for name, (proc, tmp, lib, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(name)
            continue
        os.replace(tmp, lib)          # atomic: concurrent builders agree
    if failed:
        logs = "\n".join((out / f"{n}.log").read_text() for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return {src.stem: out / f"lib{src.stem}.so" for src in sources()}


def build_log(name: str) -> str:
    """nvcc's output (with -Xptxas -v: registers, shared memory and
    spills of each kernel) from the build of `name`, if it ran here."""
    p = build_dir() / _key() / f"{name}.log"
    return p.read_text() if p.exists() else ""


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The ctypes library of `csrc/<name>.cu`, building all sources on
    first use. `signatures` maps each C function to its argtypes; every
    function returns a cudaError_t as int."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
