"""Sharding rules: param path regex -> partition spec, the JAX package's
`distributed/sharding.py` on `torch.distributed`.

The table and its candidate order are the reference's: TP over "model",
FSDP over "data", DP over ("pod", "data") for activations, EP over
"model" for expert banks, a stacked layer dim never sharded. The rules
are logical: the same table serves the 16x16 and 2x16x16 production
meshes and any re-mesh; only the mesh changes. A mesh here is a
`torch.distributed.DeviceMesh` or any object with axis sizes (a dict of
name -> size, or an object whose `.shape` is one), or None.

`P` is the port's `PartitionSpec`: a tuple of one entry a dim, each an
axis name, a tuple of names, or None (replicated). `shardings_for` pairs
a DeviceMesh with each spec (`Sharding`, the counterpart of
`NamedSharding`), which maps to `Shard(d)` / `Replicate()` placements,
takes a rank's local block of a whole tensor and gathers the whole back.

`model_layout` is what the port's tensor-parallel step holds on a rank
(models/, `training.train_loop`): each leaf's spec with every axis but
"model" dropped. The params are replicated over "data" where the
reference's pjit shards them (FSDP); K/V projections whose heads do not
divide over "model" (MQA) are replicated, as `cache_specs` replicates
their cache.
"""

from __future__ import annotations

import math
import re
from typing import Any, Mapping, Optional

import torch

from repro_torch.core.tree import tree_map


class P(tuple):
    """A partition spec: one entry a tensor dim. A tuple of one name is
    that name, as `PartitionSpec` keeps it."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, (tuple, list)) and len(p) == 1
            else tuple(p) if isinstance(p, list) else p for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# (regex over the "/"-joined param path, candidate specs in priority
# order, without the stacked layer dims). The first candidate whose axes
# all divide their dims is used; failing that, the last candidate with
# its failing axes dropped. The first regex that matches wins.
_RULES = (
    # MoE expert banks (E, D, F) / (E, F, D): EP on E + FSDP on the
    # middle dim; where E < |model| (8 experts on a 16-wide axis), TP +
    # FSDP inside each expert.
    (r"moe/w_(gate|up)$",        (P("model", "data", None),
                                  P(None, "data", "model"))),
    (r"moe/w_down$",             (P("model", "data", None),
                                  P(None, "model", "data"))),
    (r"moe/router/w$",           (P("data", None),)),
    # attention projections
    (r"attn/w[qkv]/w$",          (P("data", "model"),)),
    (r"attn/w[qkv]/b$",          (P("model"),)),
    (r"attn/wo/w$",              (P("model", "data"),)),
    (r"attn/wo/b$",              (P(None),)),
    (r"cross_attn/w[qkv]/w$",    (P("data", "model"),)),
    (r"cross_attn/w[qkv]/b$",    (P("model"),)),
    (r"cross_attn/wo/w$",        (P("model", "data"),)),
    (r"cross_attn/wo/b$",        (P(None),)),
    # MLPs
    (r"(mlp|dense)/w_(gate|up|in)/w$",  (P("data", "model"),)),
    (r"(mlp|dense)/w_(down|out)/w$",    (P("model", "data"),)),
    (r"(mlp|dense)/w_(gate|up|in)/b$",  (P("model"),)),
    (r"(mlp|dense)/w_(down|out)/b$",    (P(None),)),
    # Mamba2
    (r"mamba/in_proj/w$",        (P("data", "model"),)),
    # B/C/dt projection and conv: a replicated output
    (r"mamba/in_proj_bc/w$",     (P("data", None),)),
    (r"mamba/conv_bc_w$",        (P(None, None),)),
    (r"mamba/conv_bc_b$",        (P(None),)),
    (r"mamba/out_proj/w$",       (P("model", "data"),)),
    (r"mamba/conv_w$",           (P(None, "model"),)),
    (r"mamba/conv_b$",           (P("model"),)),
    (r"mamba/(A_log|D|dt_bias)$", (P("model"),)),
    (r"mamba/norm/scale$",       (P("model"),)),
    # Zamba2's shared block
    (r"shared/in_proj/w$",       (P("data", "model"),)),
    (r"lora_a$",                 (P(None, "data", None),)),
    (r"lora_b$",                 (P(None, None, "model"),)),
    # embeddings and head (the vocab is padded to 256, so these divide)
    (r"embed/w$",                (P("model", "data"),)),
    (r"lm_head/w$",              (P("data", "model"),)),
    # norms and anything 1-D
    (r".*",                      (P(),)),
)

# param paths with leading stacked-layer dims: the spec shifts right by
# their number
_STACK1 = re.compile(r"^(layers|enc_layers|dec_layers)/|^hybrid/(shared_conv)?")
_STACK2 = re.compile(r"^hybrid/mamba/")
_STACK1_HYBRID = re.compile(r"^hybrid/(lora_a|lora_b)$")


def _stack_dims(path_s: str) -> int:
    if _STACK2.match(path_s):
        return 2                       # (n_seg, per_seg, ...)
    if _STACK1_HYBRID.match(path_s):
        return 1                       # (n_seg, ...)
    if path_s.startswith("hybrid/shared"):
        return 0
    if _STACK1.match(path_s):
        return 1
    return 0


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh, a dict, an object whose
    `.shape` maps names to sizes (a jax Mesh), or None ({})."""
    if mesh is None:
        return {}
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axis_size(sizes: dict, name) -> int:
    if isinstance(name, (tuple, list)):
        return math.prod(sizes.get(n, 1) for n in name)
    return sizes.get(name, 1)


def _fits(parts, shape, sizes) -> bool:
    return all(part is None or dim % _axis_size(sizes, part) == 0
               for part, dim in zip(parts, shape))


def spec_for(path_s: str, shape: tuple, mesh=None) -> P:
    """The spec of the param at `path_s` ("/"-joined keys) of `shape` on
    `mesh`: the reference's answer for the same path, shape and sizes."""
    sizes = axis_sizes(mesh)
    ndim = len(shape)
    stack = _stack_dims(path_s)
    candidates = (P(),)
    for pat, specs in _RULES:
        if re.search(pat, path_s):
            candidates = specs
            break

    def expand(spec) -> list:
        parts = ([None] * stack) + list(spec)
        if len(parts) > ndim:          # e.g. a bias matched to a 2-D rule
            parts = parts[:ndim]
        return parts + [None] * (ndim - len(parts))

    for spec in candidates:
        parts = expand(spec)
        if _fits(parts, shape, sizes):
            return P(*parts)
    parts = expand(candidates[-1])
    return P(*[p if p is not None and shape[i] % _axis_size(sizes, p) == 0
               else None for i, p in enumerate(parts)])


def _map_paths(fn, tree, prefix=""):
    """fn("/"-joined path, leaf) over a tree of dicts (and NamedTuples or
    tuples, their fields by index as `jax.tree_util` keys them); None
    stays None, and a P is a leaf."""
    if tree is None:
        return None
    if isinstance(tree, P):
        return fn(prefix[:-1], tree)
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_paths(fn, v, f"{prefix}{k}/")
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_paths(fn, v, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def param_specs(params, mesh=None) -> Any:
    """A tree of P matching `params` (shape and mesh aware)."""
    return _map_paths(lambda ps, leaf: spec_for(ps, tuple(leaf.shape), mesh),
                      params)


def data_spec(ndim: int, *, multi_pod: bool) -> P:
    dp = ("pod", "data") if multi_pod else ("data",)
    return P(dp, *([None] * (ndim - 1)))


def cache_specs(cache, mesh, *, multi_pod: bool) -> Any:
    """KV and SSM state caches: the batch over DP where it divides, KV
    heads, SSD heads and conv channels over "model" where they divide
    (MQA and batch-1 long-context leaves are replicated)."""
    sizes = axis_sizes(mesh)
    dp_axes = ("pod", "data") if multi_pod else ("data",)
    dp = math.prod(sizes[a] for a in dp_axes)
    tp = sizes["model"]

    def fn(path_s, leaf):
        nd = leaf.dim()
        parts: list = [None] * nd
        key = path_s.rsplit("/", 1)[-1]
        if key in ("k", "v"):          # (*stack, B, T, H, D)
            b_ax, h_ax = nd - 4, nd - 2
        elif key == "ssd":             # (*stack, B, H, P, N)
            b_ax, h_ax = nd - 4, nd - 3
        elif key == "conv":            # (*stack, B, W-1, C)
            b_ax, h_ax = nd - 3, nd - 1
        else:
            return P(*parts)
        if leaf.shape[b_ax] % dp == 0:
            parts[b_ax] = dp_axes
        if leaf.shape[h_ax] % tp == 0:
            parts[h_ax] = "model"
        return P(*parts)
    return _map_paths(fn, cache)


# ----------------------------------------------------------------------
# Specs on a DeviceMesh
# ----------------------------------------------------------------------

def _names(part) -> tuple:
    if part is None:
        return ()
    return tuple(part) if isinstance(part, (tuple, list)) else (part,)


class Sharding:
    """A spec on a DeviceMesh: the counterpart of `NamedSharding`."""

    def __init__(self, mesh, spec: P):
        self.mesh = mesh
        self.spec = P(*spec)

    def __repr__(self) -> str:
        return f"Sharding({dict(axis_sizes(self.mesh))}, {self.spec!r})"

    def placements(self) -> list:
        """One placement a mesh dim: `Shard(d)` where tensor dim d takes
        that axis, else `Replicate()`. A dim over a tuple of axes takes
        them in order, the first the major one (as the reference lays out
        ("pod", "data")); so does a DTensor of these placements."""
        from torch.distributed.tensor import Replicate, Shard
        out = [Replicate() for _ in self.mesh.mesh_dim_names]
        for d, part in enumerate(self.spec):
            for name in _names(part):
                out[self.mesh.mesh_dim_names.index(name)] = Shard(d)
        return out

    def _block_index(self, part) -> tuple:
        """(index of this rank's block, number of blocks) along a dim
        laid out over `part`."""
        coord = self.mesh.get_coordinate()
        idx, n = 0, 1
        for name in _names(part):
            i = self.mesh.mesh_dim_names.index(name)
            size = self.mesh.shape[i]
            idx, n = idx * size + coord[i], n * size
        return idx, n

    def local(self, whole: torch.Tensor) -> torch.Tensor:
        """This rank's block of `whole` (a view)."""
        out = whole
        for d, part in enumerate(self.spec):
            if part is None:
                continue
            idx, n = self._block_index(part)
            size = whole.shape[d] // n
            out = out.narrow(d, idx * size, size)
        return out

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's block (`local` this rank's):
        an all-gather over each axis a dim is laid out over, minor axis
        first."""
        from repro_torch.core.distributed import _all_gather, _size
        out = local
        for d, part in enumerate(self.spec):
            for name in reversed(_names(part)):
                group = self.mesh.get_group(name)
                if _size(group) > 1:
                    out = _all_gather(out, group, d)
        return out.contiguous()


def shardings_for(mesh, specs) -> Any:
    return tree_map(lambda s: Sharding(mesh, s), specs) \
        if not isinstance(specs, P) else Sharding(mesh, specs)


# ----------------------------------------------------------------------
# The port's tensor-parallel layout
# ----------------------------------------------------------------------

#: The families the port shards over "model"; the others raise on a
#: mesh whose "model" axis is wider than 1.
TP_FAMILIES = ("dense",)

#: What ports tensor parallelism of the other families.
TP_TODO = ("ROADMAP.md queue 1 item 2 (tensor and expert parallelism of "
           "the moe, ssm, hybrid, encdec and vlm families)")


def check_tp(cfg, tp: int) -> None:
    """Raise where the port cannot shard `cfg` over a "model" axis of
    `tp`: a family other than TP_FAMILIES (NotImplementedError naming the
    ROADMAP item that ports it), or heads, d_ff or the padded vocab that
    do not divide (ValueError)."""
    if tp <= 1:
        return
    if cfg.family not in TP_FAMILIES:
        raise NotImplementedError(
            f"tensor parallelism (a \"model\" axis of {tp}) covers the "
            f"families {TP_FAMILIES}, not {cfg.name} ({cfg.family}): "
            f"see {TP_TODO}")
    hkv = cfg.n_kv_heads
    bad = [f"{what} {n}" for what, n in (
        ("n_heads", cfg.n_heads), ("d_ff", cfg.d_ff),
        ("padded_vocab", cfg.padded_vocab)) if n % tp]
    if hkv % tp and tp % hkv:
        bad.append(f"n_kv_heads {hkv} (neither divides the other)")
    if bad:
        raise ValueError(f"{cfg.name} does not shard over a \"model\" axis "
                         f"of {tp}: {', '.join(bad)}")


def _kv_path(path_s: str) -> bool:
    return re.search(r"(^|/)attn/w[kv]/[wb]$", path_s) is not None


def model_layout(cfg, params, mesh) -> Any:
    """A tree of P for `params` (whole shapes): what a rank of `mesh`
    holds in the port's tensor-parallel step. Each leaf's `param_specs`
    spec keeps its "model" axis alone (replicated over "data"); K/V
    projections whose heads do not divide over "model" are replicated."""
    tp = axis_sizes(mesh).get("model", 1)
    check_tp(cfg, tp)

    def fn(path_s, leaf):
        spec = spec_for(path_s, tuple(leaf.shape), mesh)
        if _kv_path(path_s) and cfg.n_kv_heads % tp:
            return P(*([None] * len(spec)))
        return P(*[p if "model" in _names(p) else None for p in spec])
    return _map_paths(fn, params)


def model_sharded(cfg, params, tp: int) -> Any:
    """A tree of bools matching a rank's `params` under `model_layout` on
    a "model" axis of `tp`: True for a leaf held in blocks. From the rules
    alone (each rule of the families `check_tp` passes has one candidate,
    whose dims it checks divide), so local shapes do."""
    check_tp(cfg, tp)
    return _map_paths(
        lambda ps, x: "model" in spec_for(ps, tuple(x.shape))
        and not (_kv_path(ps) and cfg.n_kv_heads % tp), params)
