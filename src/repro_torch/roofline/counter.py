"""Costs of a step, counted while it runs: the port's counterpart of the
JAX package's `roofline/hlo.py`.

There is no HLO to parse. `count()` is a context manager over a
`TorchDispatchMode` that charges every aten op the step dispatches, by
the reference analyzer's conventions:

  flops        matrix products only (`torch.utils.flop_counter`'s
               formulas: mm, bmm, addmm, baddbmm and the like);
               elementwise ops are ignored;
  hbm bytes    an op's operands' bytes plus its outputs' bytes (a
               broadcast operand's distinct elements); a gather or index
               reads only what it produces, counted twice (read plus
               write); an in-place slice write (copy_, index_put_,
               scatter, index_copy_) costs 2x the update; views,
               allocations and metadata (the `prim` ops a fake tensor
               dispatches among them) cost nothing;
  collectives  each collective a step dispatches (the `c10d` ops of
               torch.distributed: all-reduce, all-gather, reduce-scatter,
               a send of a ring's permute), with its result bytes and its
               group's size, and the link bytes a rank moves by the
               reference's ring model (`roofline/hlo.py`
               `Collective.ici_bytes`): all-reduce 2n(p-1)/p, all-gather
               n(p-1)/p, reduce-scatter n(p-1), a permute n (none in a
               group of one); each also costs 2n device-memory bytes, as
               the reference charges it. A receive is its send's other
               end and costs nothing, nor does any other c10d op.

Each op of `kernels.ops` charges itself, as the reference charges a
custom call: its compulsory bytes (each operand and output once) and its
FLOPs, from its charge function in `roofline.analysis`, under its kernel's
launch-counter name (`Costs.calls`, `Costs.tagged_bytes`). Its body, the
kernel on the card or the plain version on the CPU, then runs with
counting suspended, so nothing is counted twice and a step counts the
same on the CPU and on the card: `Costs.calls` of a step equals the
launches `ops.launch_counts()` gains over it.

A masked product is counted in two conventions at once. `Costs.flops`
is what the reference's XLA route counts for the same call: every
(query, key) pair of causal flash attention forward and backward and the
whole (Q, Q) square of an SSD chunk. `Costs.kept_flops` is what the
kernels compute on these inputs, the pairs the mask keeps (the
backward's recompute of S included): the least work, which a bound
counts. An aten product counts the same in both. Decode attention
charges only the keys up to each slot's position in both.

A decode op reads its slots' positions on the host to charge them. So
counting is refused under CUDA graph capture, and no counter is active
outside `count()`: a captured step's replays are not counted. Count one
eager run of the same function (the serving engine's `_decode_fn`)
instead. Counting changes no output bit and no launch count; without a
counter, an op's cost is one check of `ACTIVE`.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

#: The counter of the active `count()`, or None: the one flag the kernel
#: ops check on every call.
ACTIVE: Optional["Counter"] = None

_aten = torch.ops.aten
# no bytes: allocation, aliasing and metadata
_FREE = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
         _aten.new_empty_strided, _aten._unsafe_view, _aten.lift_fresh,
         _aten.set_, _aten.resize_, _aten._local_scalar_dense,
         _aten.is_nonzero, _aten.equal}
# reads only what it produces
_GATHER = {_aten.index, _aten.gather, _aten.index_select, _aten.embedding,
           _aten.take}
# in-place writes of an update, by the update's argument position
_UPDATE = {_aten.copy_: 1, _aten.index_put_: 2, _aten.index_put: 2,
           _aten._index_put_impl_: 2, _aten.scatter_: 3, _aten.scatter: 3,
           _aten.scatter_add_: 3, _aten.scatter_add: 3, _aten.index_copy_: 3,
           _aten.index_copy: 3, _aten.index_add_: 3, _aten.slice_scatter: 1,
           _aten.select_scatter: 1}


def _bytes(t: torch.Tensor) -> int:
    """Distinct elements' bytes: a dim of stride 0 (a broadcast) once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def _tensor_bytes(tree) -> int:
    return sum(_bytes(x) for x in tree_flatten(tree)[0]
               if isinstance(x, torch.Tensor))


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


# the torch.distributed ops the port dispatches, by the reference's
# collective names; each op's first argument holds its result
_COLLECTIVES = {"allreduce_": "all-reduce",
                "_allgather_base_": "all-gather",
                "_reduce_scatter_base_": "reduce-scatter",
                "send": "collective-permute"}


@dataclasses.dataclass
class Collective:
    """One collective call: the reference's `roofline/hlo.py` record."""
    op: str
    bytes_result: int
    group_size: int
    count: int = 1
    where: str = ""

    @property
    def ici_bytes(self) -> float:
        """Ring-model bytes a rank moves over the links, a call."""
        p, n = self.group_size, self.bytes_result
        if p <= 1:
            return 0.0
        if self.op == "all-reduce":
            return 2 * n * (p - 1) / p
        if self.op == "all-gather":
            return n * (p - 1) / p
        if self.op == "reduce-scatter":
            return n * (p - 1)          # operand = result * p
        return n


def _group_size(args) -> int:
    """The size of the process group among a c10d op's arguments."""
    pg_cls = torch._C._distributed_c10d.ProcessGroup
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return pg_cls.unbox(a).size()
            except RuntimeError:        # a ReduceOp, not a group
                continue
    return 1


@dataclasses.dataclass
class Costs:
    """A counted run's FLOPs (the reference's convention, and the kept
    pairs'), its device-memory bytes, each charge (bytes, description,
    FLOPs), the bytes and calls by kernel op, and on the card the run's
    peak of `torch.cuda.memory_allocated` where `count()` could read it
    (`peak_bytes`)."""
    flops: float = 0.0
    kept_flops: float = 0.0
    hbm_bytes: float = 0.0
    collectives: list = dataclasses.field(default_factory=list)
    charges: list = dataclasses.field(default_factory=list)
    # bytes of each kernel op, by its launch-counter name
    tagged_bytes: dict = dataclasses.field(default_factory=dict)
    calls: dict = dataclasses.field(default_factory=dict)
    peak_bytes: Optional[int] = None

    def top_charges(self, n: int = 15):
        return sorted(self.charges, key=lambda c: c[0], reverse=True)[:n]

    @property
    def ici_bytes(self) -> float:
        """Ring-model bytes a rank moves over the links between cards."""
        return sum(c.ici_bytes * c.count for c in self.collectives)

    def collective_summary(self) -> dict:
        """{op: {"count", "bytes", "ici_bytes"}}, as the reference's."""
        agg = {}
        for c in self.collectives:
            a = agg.setdefault(c.op, {"count": 0, "bytes": 0.0,
                                      "ici_bytes": 0.0})
            a["count"] += c.count
            a["bytes"] += c.bytes_result * c.count
            a["ici_bytes"] += c.ici_bytes * c.count
        return agg


class Counter:
    """The state of one `count()`: its Costs and how deep the kernel ops'
    suspension of aten counting runs."""

    def __init__(self):
        self.costs = Costs()
        self.suspended = 0

    def _charge(self, nbytes: float, desc: str, flops: float = 0.0,
                kept_flops: float = 0.0):
        self.costs.flops += flops
        self.costs.kept_flops += kept_flops
        self.costs.hbm_bytes += nbytes
        self.costs.charges.append((nbytes, desc, flops))

    def charge_aten(self, func, args, kwargs, out) -> None:
        packet = func.overloadpacket
        if func.is_view or packet in _FREE or func.namespace == "prim":
            return
        flops = 0.0
        formula = flop_registry.get(packet)
        if formula is not None:
            flops = float(formula(*args, out_val=out, **kwargs))
        if packet in _GATHER:
            nbytes = 2 * _tensor_bytes(out)
        elif packet in _UPDATE:
            upd = args[_UPDATE[packet]] if len(args) > _UPDATE[packet] \
                else None
            nbytes = 2 * _tensor_bytes(upd if isinstance(upd, torch.Tensor)
                                       else out)
        else:
            nbytes = _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        shape = tuple(out.shape) if isinstance(out, torch.Tensor) else ""
        self._charge(float(nbytes), f"aten.{packet.__name__} {shape}", flops,
                     flops)

    def charge_collective(self, func, args) -> None:
        """A c10d op: its Collective (see the module's docstring)."""
        op = _COLLECTIVES.get(func.overloadpacket.__name__)
        if op is None:
            return
        n = _tensor_bytes(args[0])
        self.costs.collectives.append(Collective(
            op=op, bytes_result=n, group_size=_group_size(args),
            where=f"c10d.{func.overloadpacket.__name__}"))
        self._charge(2.0 * n, f"{op} {n} B")

    def run_op(self, charge_fn, fn, args, kwargs):
        """Run the kernel op `fn` with counting suspended, then charge it
        what `charge_fn` (its `roofline.analysis` charge) says."""
        if _capturing():
            raise RuntimeError("a kernel op was called under CUDA graph "
                               "capture with a counter active: count an "
                               "eager run of the step instead")
        self.suspended += 1
        try:
            out = fn(*args, **kwargs)
            c = charge_fn(*args, **kwargs)
        finally:
            self.suspended -= 1
        costs = self.costs
        self._charge(c.hbm_bytes, f"{c.kernel} {c.what}", c.flops,
                     c.kept_flops)
        costs.tagged_bytes[c.kernel] = \
            costs.tagged_bytes.get(c.kernel, 0.0) + c.hbm_bytes
        costs.calls[c.kernel] = costs.calls.get(c.kernel, 0) + 1
        return out


class _Mode(TorchDispatchMode):
    def __init__(self, counter: Counter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.counter.suspended:
            return out
        if func.namespace == "c10d":
            self.counter.charge_collective(func, args)
        else:
            self.counter.charge_aten(func, args, kwargs, out)
        return out


def _window_peak(entry_peak: int, entry_allocated: int) -> Optional[int]:
    """The peak of `memory_allocated` since the entry whose peak statistic
    and allocation were these, read without resetting the process-wide
    statistic: the peak now where the run raised it or where it began at
    its peak (a caller's `reset_peak_memory_stats()` just before), else
    unknown (None)."""
    peak = torch.cuda.max_memory_allocated()
    return peak if peak > entry_peak or entry_peak == entry_allocated \
        else None


@contextlib.contextmanager
def count():
    """Count what runs inside: yields the Costs, filled as it runs. On
    the card `Costs.peak_bytes` is the run's peak of allocated memory,
    read from `max_memory_allocated`, which count() never resets (a
    caller's peak window may enclose it): where the run did not raise
    the process's peak, the caller gets it by resetting the peak
    statistic just before count(), else it stays None. Refused under
    CUDA graph capture and inside another count()."""
    global ACTIVE
    if ACTIVE is not None:
        raise RuntimeError("count() is already active")
    if _capturing():
        raise RuntimeError("count() under CUDA graph capture: count an "
                           "eager run of the step instead")
    counter = Counter()
    card = torch.cuda.is_available() and torch.cuda.is_initialized()
    if card:
        torch.cuda.synchronize()
        entry = (torch.cuda.max_memory_allocated(),
                 torch.cuda.memory_allocated())
    ACTIVE = counter
    try:
        with _Mode(counter):
            yield counter.costs
    finally:
        ACTIVE = None
    if card:
        torch.cuda.synchronize()
        counter.costs.peak_bytes = _window_peak(*entry)
