"""Persistent winner cache for the tile autotuner, and the process
setting that serves it.

The port's copy of the JAX package's `tuning/cache.py`. One JSON file
holds tuned instances for any number of machines, namespaced by
hardware fingerprint (`core.hw.fingerprint`):

    {
      "version": 1,
      "caches": {
        "<fingerprint>": {
          "matmul|4x151936x1024|bfloat16|cuda": {
            "plan": "ROWS16_N32", "bm": 16, "bn": 32, "bk": 128,
            "time_us": 120.1, "baseline_us": 131.4,
            "speedup": 1.094, "tuned_at": "2026-10-18T12:00:00"
          },
          "flash|512x512xd128|bfloat16|cuda": {"bq": 64, "bk": 64, ...}
        }
      }
    }

The keys are the reference's (`matmul|MxNxK|dtype|backend[|epilogue]`
and the rest), with the backend tag "cuda". A GEMM entry names the
compiled instance (`kernels.matmul` `TilePlan.name`) and its tile. A save
is read-modify-write, so other fingerprints' entries in the file survive,
those the JAX package wrote included. Lookups under a fingerprint that
is not in the file miss, and the static plan holds: a timing taken on
one machine (the CPU included) is never served to another.

`set_tuned(cache)` is the port's counterpart of the reference's
`Policy(autotune="cached")`: while a cache is set, the GEMM wrappers'
plan functions serve its winners, and a miss takes the static plan. It
is off unless a launcher or the caller sets it, and only a cache of this
machine's fingerprint can be set. A serving engine keeps the setting of
its construction for everything it runs: its CUDA graphs, captured and
rebuilt, and each step's eager admission prefills.

Import-light on purpose: `kernels.matmul` consults it on every plan.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import threading
from typing import Any, Optional

import torch

from repro_torch.core import hw
from repro_torch.core.blocking import FlashBlockConfig, SSDBlockConfig

CACHE_VERSION = 1
CACHE_ENV_VAR = "REPRO_TORCH_TUNING_CACHE"
DEFAULT_CACHE_PATH = "~/.cache/repro_torch/tuning.json"
#: The backend tag of the port's keys: the CUDA kernels.
BACKEND = "cuda"


def default_cache_path() -> str:
    return os.path.expanduser(os.environ.get(CACHE_ENV_VAR, DEFAULT_CACHE_PATH))


def dtype_name(dtype) -> str:
    """The reference's dtype component of a key ("bfloat16", "float32")
    for a torch dtype or its name."""
    name = str(dtype).removeprefix("torch.")
    if not isinstance(getattr(torch, name, None), torch.dtype):
        raise TypeError(f"not a dtype: {dtype!r}")
    return name


def _backend_tag(backend) -> str:
    if not isinstance(backend, str):
        raise TypeError(f"expected a backend string, got {type(backend)}")
    return backend


def matmul_key(m: int, n: int, k: int, dtype, backend=BACKEND,
               epilogue: str = "none") -> str:
    """Each fused epilogue has its own entry; "none" keeps the plain key."""
    key = f"matmul|{m}x{n}x{k}|{dtype_name(dtype)}|{_backend_tag(backend)}"
    if epilogue not in (None, "none"):
        key += f"|{epilogue}"
    return key


def matmul_q_key(m: int, n: int, k: int, dtype, backend=BACKEND,
                 epilogue: str = "none") -> str:
    """The int8-weight GEMM's winners; `dtype` is the activations'."""
    key = (f"matmul_q|{m}x{n}x{k}|{dtype_name(dtype)}|"
           f"{_backend_tag(backend)}")
    if epilogue not in (None, "none"):
        key += f"|{epilogue}"
    return key


def gated_key(m: int, n: int, k: int, dtype, backend=BACKEND) -> str:
    """The dual GEMM: (m, k) x 2*(k, n) -> (m, n)."""
    return f"gated|{m}x{n}x{k}|{dtype_name(dtype)}|{_backend_tag(backend)}"


def flash_key(tq: int, tk: int, d: int, dtype, backend=BACKEND) -> str:
    return f"flash|{tq}x{tk}xd{d}|{dtype_name(dtype)}|{_backend_tag(backend)}"


def flash_decode_key(tk: int, d: int, dtype, backend=BACKEND) -> str:
    """Keyed by (cache depth, head dim): every slot depth shares one."""
    return (f"flash_decode|{tk}xd{d}|{dtype_name(dtype)}|"
            f"{_backend_tag(backend)}")


def flash_decode_paged_key(page_size: int, d: int, dtype,
                           backend=BACKEND) -> str:
    """Keyed by (page size, head dim), whatever the pool's size."""
    return (f"flash_decode_paged|p{page_size}xd{d}|{dtype_name(dtype)}|"
            f"{_backend_tag(backend)}")


def ssd_key(chunk: int, p: int, n: int, dtype, backend=BACKEND) -> str:
    """Keyed by (model chunk, head dim P, state dim N): the sequence
    length is not in the key."""
    return (f"ssd|Q{chunk}xP{p}xN{n}|{dtype_name(dtype)}|"
            f"{_backend_tag(backend)}")


def flash_bwd_key(tq: int, tk: int, d: int, dtype, backend=BACKEND) -> str:
    return (f"flash_bwd|{tq}x{tk}xd{d}|{dtype_name(dtype)}|"
            f"{_backend_tag(backend)}")


def _plan_entry(plan, meta) -> dict:
    return {"plan": plan.name, "bm": plan.bm, "bn": plan.bn, "bk": plan.bk,
            "tuned_at": _now(), **meta}


class TuningCache:
    """In-memory view of one fingerprint's entries, backed by the JSON
    file. `save()` is read-modify-write so the entries of other
    fingerprints sharing the file survive."""

    def __init__(self, path: str | None = None,
                 fingerprint: str | None = None):
        self.path = path or default_cache_path()
        self.fingerprint = fingerprint or hw.fingerprint()
        self._entries: dict[str, dict] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    # --- persistence -----------------------------------------------------
    def load(self) -> "TuningCache":
        with self._lock:
            doc = self._read_file()
            if self._newer_format(doc):
                self._entries = {}    # unreadable to us; lookups miss
            else:
                self._entries = dict(
                    doc.get("caches", {}).get(self.fingerprint, {}))
        return self

    def save(self) -> str:
        with self._lock:
            doc = self._read_file()
            if self._newer_format(doc):
                raise RuntimeError(
                    f"{self.path} was written by a newer cache format "
                    f"(version {doc['version']} > {CACHE_VERSION}); refusing "
                    f"to overwrite it: set {CACHE_ENV_VAR} to a fresh path")
            doc["version"] = CACHE_VERSION
            doc.setdefault("caches", {}).setdefault(
                self.fingerprint, {}).update(self._entries)
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        return self.path

    @staticmethod
    def _newer_format(doc: dict) -> bool:
        return doc.get("version", CACHE_VERSION) > CACHE_VERSION

    def _read_file(self) -> dict:
        try:
            with open(self.path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            return {}
        return doc if isinstance(doc, dict) else {}

    # --- raw access ------------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    @property
    def entries(self) -> dict[str, dict]:
        return dict(self._entries)

    def get(self, key: str) -> Optional[dict]:
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
        else:
            self.hits += 1
        return entry

    def put(self, key: str, entry: dict) -> None:
        self._entries[key] = dict(entry)

    # --- typed accessors: a GEMM's entry gives its instance's name ---------
    def _plan(self, key: str) -> Optional[str]:
        e = self.get(key)
        return None if e is None else str(e["plan"])

    def get_matmul(self, m: int, n: int, k: int, dtype,
                   epilogue: str = "none") -> Optional[str]:
        return self._plan(matmul_key(m, n, k, dtype, BACKEND, epilogue))

    def put_matmul(self, m: int, n: int, k: int, dtype, plan, *,
                   epilogue: str = "none", **meta: Any) -> str:
        key = matmul_key(m, n, k, dtype, BACKEND, epilogue)
        self.put(key, _plan_entry(plan, meta))
        return key

    def get_matmul_q(self, m: int, n: int, k: int, dtype,
                     epilogue: str = "none") -> Optional[str]:
        return self._plan(matmul_q_key(m, n, k, dtype, BACKEND, epilogue))

    def put_matmul_q(self, m: int, n: int, k: int, dtype, plan, *,
                     epilogue: str = "none", **meta: Any) -> str:
        key = matmul_q_key(m, n, k, dtype, BACKEND, epilogue)
        self.put(key, _plan_entry(plan, meta))
        return key

    def get_gated(self, m: int, n: int, k: int, dtype) -> Optional[str]:
        return self._plan(gated_key(m, n, k, dtype, BACKEND))

    def put_gated(self, m: int, n: int, k: int, dtype, plan,
                  **meta: Any) -> str:
        key = gated_key(m, n, k, dtype, BACKEND)
        self.put(key, _plan_entry(plan, meta))
        return key

    def _flash(self, key: str) -> Optional[FlashBlockConfig]:
        e = self.get(key)
        return None if e is None else FlashBlockConfig(int(e["bq"]),
                                                       int(e["bk"]))

    def _put_flash(self, key: str, cfg: FlashBlockConfig, meta) -> str:
        self.put(key, {"bq": cfg.bq, "bk": cfg.bk, "tuned_at": _now(),
                       **meta})
        return key

    def get_flash(self, tq: int, tk: int, d: int,
                  dtype) -> Optional[FlashBlockConfig]:
        return self._flash(flash_key(tq, tk, d, dtype))

    def put_flash(self, tq: int, tk: int, d: int, dtype,
                  cfg: FlashBlockConfig, **meta: Any) -> str:
        return self._put_flash(flash_key(tq, tk, d, dtype), cfg, meta)

    def get_flash_bwd(self, tq: int, tk: int, d: int,
                      dtype) -> Optional[FlashBlockConfig]:
        return self._flash(flash_bwd_key(tq, tk, d, dtype))

    def put_flash_bwd(self, tq: int, tk: int, d: int, dtype,
                      cfg: FlashBlockConfig, **meta: Any) -> str:
        return self._put_flash(flash_bwd_key(tq, tk, d, dtype), cfg, meta)

    def get_flash_decode(self, tk: int, d: int,
                         dtype) -> Optional[FlashBlockConfig]:
        return self._flash(flash_decode_key(tk, d, dtype))

    def put_flash_decode(self, tk: int, d: int, dtype,
                         cfg: FlashBlockConfig, **meta: Any) -> str:
        return self._put_flash(flash_decode_key(tk, d, dtype), cfg, meta)

    def get_flash_decode_paged(self, page_size: int, d: int,
                               dtype) -> Optional[FlashBlockConfig]:
        return self._flash(flash_decode_paged_key(page_size, d, dtype))

    def put_flash_decode_paged(self, page_size: int, d: int, dtype,
                               cfg: FlashBlockConfig, **meta: Any) -> str:
        return self._put_flash(flash_decode_paged_key(page_size, d, dtype),
                               cfg, meta)

    def get_ssd(self, chunk: int, p: int, n: int,
                dtype) -> Optional[SSDBlockConfig]:
        e = self.get(ssd_key(chunk, p, n, dtype))
        return None if e is None else SSDBlockConfig(int(e["q"]),
                                                     int(e["bp"]))

    def put_ssd(self, chunk: int, p: int, n: int, dtype,
                cfg: SSDBlockConfig, **meta: Any) -> str:
        key = ssd_key(chunk, p, n, dtype)
        self.put(key, {"q": cfg.q, "bp": cfg.bp, "tuned_at": _now(), **meta})
        return key


def _now() -> str:
    return datetime.datetime.now().isoformat(timespec="seconds")


# --- the process cache, and the setting that serves it ---------------------
_global: TuningCache | None = None
_tuned: TuningCache | None = None
_global_lock = threading.Lock()


def get_cache(refresh: bool = False) -> TuningCache:
    """The shared cache instance, loaded lazily from default_cache_path()
    under this machine's fingerprint; loaded again if the path's env var
    changed since the last call."""
    global _global
    with _global_lock:
        if _global is None or refresh or _global.path != default_cache_path():
            _global = TuningCache().load()
        return _global


def set_cache(cache: TuningCache | None) -> None:
    global _global
    with _global_lock:
        _global = cache


def reset_cache() -> None:
    set_cache(None)


def set_tuned(cache: TuningCache | None) -> TuningCache | None:
    """Serve `cache`'s winners to the GEMM plans of this process (None:
    the static plans). Returns the setting it replaces. A cache of
    another machine's fingerprint is refused: its timings were taken
    elsewhere (on the CPU, or on another card or stack)."""
    global _tuned
    if cache is not None and cache.fingerprint != hw.fingerprint():
        raise ValueError(
            f"tuning cache {cache.path} holds entries of {cache.fingerprint!r}"
            f"; this machine is {hw.fingerprint()!r}, and a timing taken "
            f"on another is never served here")
    with _global_lock:
        old, _tuned = _tuned, cache
    return old


def tuned_cache() -> TuningCache | None:
    """The cache whose winners the GEMM plans serve, or None."""
    return _tuned


@contextlib.contextmanager
def tuned(cache: TuningCache | None):
    """`set_tuned(cache)` for the body, the previous setting after."""
    old = set_tuned(cache)
    try:
        yield cache
    finally:
        set_tuned(old)
