"""Atomic, async checkpoints of a train state: the JAX package's
`checkpoint/checkpointer.py` on trees of tensors, its on-disk layout
included, so either package restores what the other saved.

Layout:   <dir>/step_<N>/
             manifest.json      the tree's structure, shapes, dtypes, step,
                                logical sharding spec (names only)
             arr_<i>.npy        one file per leaf, in `flatten`'s order

  * atomic: written to step_<N>.tmp, then os.rename'd, so a crash during
    a save never corrupts the latest checkpoint; a .tmp directory is
    never listed as a step;
  * async: `save(..., blocking=False)` hands the host copy to a writer
    thread, and training goes on. The copy is taken before `save`
    returns, into fresh host memory, so a donated step that rewrites
    the state in place next cannot reach what the thread writes;
  * in place: `restore(step, like)` copies each leaf into `like`'s own
    tensor and returns `like`, so a donated state, and whatever aliases
    it, stays valid;
  * re-meshed: `restore(step, like, shardings=)` lays each leaf out on a
    mesh (`distributed.sharding.Sharding`, the elastic re-mesh): `like`
    gives the whole shapes and dtypes, and each rank gets a new tree of
    its blocks, from a checkpoint of whole leaves written at any world
    size or by the reference. `save(..., shardings=)` writes a tree of
    such blocks: every rank gathers each whole leaf, rank 0 writes it.

bfloat16 leaves are stored as raw uint16 views (`raw_views: "bfloat16"`),
as the reference stores them: numpy has no bfloat16.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch


def flatten(tree) -> list:
    """The leaves of `tree` in `jax.tree`'s order: a dict's in sorted key
    order, a tuple's or list's (a NamedTuple's fields too) in order,
    None an empty node. So a JAX `TrainState(params, opt, ef=None)` and
    the port's `TrainState(params, opt)` put the same leaf at each
    index."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in flatten(v)]
    return [tree]


def structure(tree) -> str:
    """A string of the tree's structure, leaves as `*` (the manifest's
    "treedef"; restore reads the leaf count, not this)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(structure(v) for v in tree)
        return f"{type(tree).__name__}({inner})"
    return "*"


def unflatten(like, xs) -> Any:
    """`like`'s structure with the leaves `xs` in `flatten`'s order."""
    it = iter(xs)

    def rebuild(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: rebuild(node[k]) for k in sorted(node)}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(rebuild(v) for v in node))
        if isinstance(node, (tuple, list)):
            return type(node)(rebuild(v) for v in node)
        return next(it)
    return rebuild(like)


def _host_copy(x) -> tuple:
    """(a numpy copy of leaf x in fresh host memory, its raw view name)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), None
    return np.array(x), None


def _load(path: str, raw_view: Optional[str]) -> torch.Tensor:
    a = np.load(path)
    if raw_view == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save --------------------------------------------------------------
    def save(self, step: int, tree: Any, *, spec: Any = None,
             blocking: bool = True, shardings: Any = None) -> None:
        """Write `tree` as step `step`. Every leaf is copied to host
        memory before this returns; blocking=False writes the files on a
        thread (`wait()` joins it). spec: a tree of logical sharding
        specs, stored by name. shardings: a tree of `Sharding`s matching
        `tree`, whose leaves are then this rank's blocks: every rank of
        the mesh calls save, each whole leaf is gathered, and rank 0
        writes (spec, unless given, the shardings' specs)."""
        self.wait()
        xs = flatten(tree)
        if shardings is not None:
            import torch.distributed as dist
            shs = flatten(shardings)
            xs = [sh.gather(x) for sh, x in zip(shs, xs)]
            spec = [repr(sh.spec) for sh in shs] if spec is None else spec
            if dist.get_rank() != 0:
                return
        copies = [_host_copy(x) for x in xs]
        host = [a for a, _ in copies]
        raw_views = [r for _, r in copies]
        manifest = {
            "step": step,
            "treedef": structure(tree),
            "n_leaves": len(host),
            "shapes": [list(a.shape) for a in host],
            "dtypes": [str(a.dtype) for a in host],
            "raw_views": raw_views,
            "spec": None if spec is None else [str(s) for s in flatten(spec)],
        }

        if blocking:
            self._write(step, host, manifest)
            return

        def run():
            try:
                self._write(step, host, manifest)
            except BaseException as e:      # raised again by wait()
                self._error = e
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def _write(self, step: int, host: list, manifest: dict) -> None:
        """The files of one checkpoint: into step_<N>.tmp, renamed to
        step_<N>, then the old steps past `keep` removed."""
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for i, a in enumerate(host):
            np.save(os.path.join(tmp, f"arr_{i}.npy"), a)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()

    def wait(self) -> None:
        """Join the writer thread, if any; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        for s in self.steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore -----------------------------------------------------------
    def steps(self) -> list:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_", 1)[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, *, shardings: Any = None) -> Any:
        """Copy step `step` into the tensors of `like` and return `like`.
        The leaf count and every shape must match; a leaf stored in
        another dtype is cast to its tensor's. shardings: a tree of
        `Sharding`s matching `like` (the elastic re-mesh): then `like`'s
        leaves (any tensors, fake or meta ones too) give the whole shapes
        and dtypes, and a new tree of this rank's blocks is returned, on
        the mesh's device."""
        if shardings is not None:
            return self._restore_blocks(step, like, flatten(shardings))
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        dst = flatten(like)
        if manifest["n_leaves"] != len(dst):
            raise ValueError(f"checkpoint step {step} holds "
                             f"{manifest['n_leaves']} leaves; the state "
                             f"has {len(dst)}")
        raw_views = manifest.get("raw_views") or [None] * len(dst)
        for i, t in enumerate(dst):
            src = _load(os.path.join(path, f"arr_{i}.npy"), raw_views[i])
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"checkpoint step {step} leaf {i}: shape "
                                 f"{tuple(src.shape)}, the state's "
                                 f"{tuple(t.shape)}")
            with torch.no_grad():
                t.copy_(src)
        return like

    def _restore_blocks(self, step: int, like: Any, shardings: list) -> Any:
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        ref = flatten(like)
        if manifest["n_leaves"] != len(ref) or len(shardings) != len(ref):
            raise ValueError(f"checkpoint step {step} holds "
                             f"{manifest['n_leaves']} leaves; the state has "
                             f"{len(ref)}, the shardings {len(shardings)}")
        raw_views = manifest.get("raw_views") or [None] * len(ref)
        out = []
        for i, (t, sh) in enumerate(zip(ref, shardings)):
            src = _load(os.path.join(path, f"arr_{i}.npy"), raw_views[i])
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"checkpoint step {step} leaf {i}: shape "
                                 f"{tuple(src.shape)}, the state's "
                                 f"{tuple(t.shape)}")
            block = sh.local(src.to(t.dtype))
            out.append(block.to(sh.mesh.device_type, copy=True)
                       .contiguous())
        return unflatten(like, out)
