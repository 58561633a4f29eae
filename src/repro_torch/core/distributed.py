"""Multi-card GEMM, the paper's Tesla S2050 section, on
`torch.distributed`: the JAX package's `core/distributed.py`.

The block decomposition that feeds shared memory also splits a GEMM
across cards, if the matrices are large enough to amortise the transfer
(`comm_model_bytes` beside `core.intensity`). A process group takes the
place of the reference's named mesh axis (`axis=`: a ProcessGroup, or
None for a world of one, where nothing is sent). Every local GEMM is one
call of the GEMM chokepoint (`core.gemm.matmul`, no split of K), so on
the card it runs the port's tiled kernel.

  column_parallel  W sharded on N: no communication forward, X's
                   cotangent all-reduced backward (`copy_to`).
  row_parallel     W sharded on K: one reduce-scatter (or all-reduce)
                   of the partial products.
  ring_matmul      W sharded on K and passed around the ring while each
                   rank multiplies the K-block it holds: the next block's
                   send and receive are posted before the local GEMM, so
                   the transfer can hide behind it.

The collectives the tensor-parallel model runs are autograd Functions
here, each with its backward: `copy_to` (identity; all-reduce backward),
`reduce_from` (all-reduce; identity backward), `reduce_scatter_from` and
`gather_from` (along the last dim; each other's backward). On a group of
one, or none, each is the identity, so a single-process step keeps its
bits.
"""

from __future__ import annotations

import torch

from repro_torch.core import gemm as _gemm


def _size(group) -> int:
    import torch.distributed as dist
    return 1 if group is None else dist.get_world_size(group)


def _rank(group) -> int:
    import torch.distributed as dist
    return 0 if group is None else dist.get_rank(group)


def _all_reduce(x, group, op=None):
    import torch.distributed as dist
    x = x.contiguous().clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM if op is None else op,
                    group=group)
    return x


def _all_gather(x, group, dim):
    """Every rank's x joined along `dim` (the collective joins dim 0)."""
    dim %= x.dim()
    import torch.distributed as dist
    p = _size(group)
    x = x.movedim(dim, 0).contiguous()
    buf = x.new_empty((p * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(buf, x, group=group)
    # a tensor of its own, not a view (a Function's output is written in
    # place: the logits' pad classes)
    return buf if dim == 0 else buf.movedim(0, dim).contiguous()


def _all_gather_last(x, group):
    return _all_gather(x, group, x.dim() - 1)


def _reduce_scatter_last(x, group):
    import torch.distributed as dist
    p = _size(group)
    inp = x.movedim(-1, 0).contiguous()
    out = inp.new_empty((inp.shape[0] // p, *inp.shape[1:]))
    dist.reduce_scatter_tensor(out, inp, group=group)
    return out if out.dim() == 1 else out.movedim(0, -1).contiguous()


def _local_last(x, group):
    n = x.shape[-1] // _size(group)
    return x.narrow(-1, _rank(group) * n, n).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceScatterFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_last(g, ctx.group), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _local_last(g, ctx.group), None


def copy_to(x, axis=None):
    """x into a column-parallel region: the identity; its cotangent is
    all-reduced over `axis`."""
    return x if _size(axis) == 1 else _CopyTo.apply(x, axis)


def reduce_from(x, axis=None):
    """The sum of x over `axis` (all-reduce); the identity backward."""
    return x if _size(axis) == 1 else _ReduceFrom.apply(x, axis)


def reduce_scatter_from(x, axis=None):
    """The sum of x over `axis`, this rank's block of the last dim
    (reduce-scatter); all-gather backward."""
    return x if _size(axis) == 1 else _ReduceScatterFrom.apply(x, axis)


def gather_from(x, axis=None):
    """Every rank's x joined along the last dim (all-gather); the
    backward takes this rank's block."""
    return x if _size(axis) == 1 else _GatherFrom.apply(x, axis)


def column_parallel(x, w, *, axis=None):
    """Y[..., N/p] = X @ W[:, N/p]: X replicated, the output sharded on N."""
    return _gemm.matmul(copy_to(x, axis), w)


def row_parallel(x, w, *, axis=None, scatter: bool = True):
    """X sharded on K (its last dim), W on K (its first): the partial
    products summed over `axis`, reduce-scattered on N (scatter=True) or
    all-reduced (the output replicated)."""
    part = _gemm.matmul(x, w)
    return reduce_scatter_from(part, axis) if scatter \
        else reduce_from(part, axis)


def ring_matmul(x, w, *, axis=None):
    """Ring-overlapped Y = X @ W. On each rank: x (M_local, K), the whole
    K; w (K/p, N), this rank's K-block. Step t multiplies the block first
    owned by rank (idx - t) % p, after posting the send of that block to
    the next rank and the receive of the following one into a second
    buffer; p local GEMMs of (M_local, K/p, N), p - 1 transfers, the
    products summed in that order (the reference adds the first to zeros:
    the same sums). Forward only (no autograd)."""
    import torch.distributed as dist
    p, idx = _size(axis), _rank(axis)
    kb = w.shape[0]
    acc = None
    # the received blocks land in two buffers of this call's own: w may
    # be a view of the caller's B
    w_t = w.contiguous() if p == 1 else w.clone(
        memory_format=torch.contiguous_format)
    nxt = torch.empty_like(w_t) if p > 1 else None
    for t in range(p):
        reqs = []
        if t < p - 1:
            send_to = dist.get_global_rank(axis, (idx + 1) % p)
            recv_from = dist.get_global_rank(axis, (idx - 1) % p)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, w_t, send_to, group=axis),
                dist.P2POp(dist.irecv, nxt, recv_from, group=axis)])
        owner = (idx - t) % p
        x_blk = x.narrow(x.dim() - 1, owner * kb, kb)
        y = _gemm.matmul(x_blk, w_t)
        acc = y if acc is None else acc + y
        for r in reqs:
            r.wait()
        if t < p - 1:
            w_t, nxt = nxt, w_t
    return acc


def _blocks(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = t.shape[dim] // _size(group)
    return t.narrow(dim, _rank(group) * n, n).contiguous()


def _gather_rows(y, group):
    return y if _size(group) == 1 else _all_gather(y, group, 0)


def sharded_matmul(a: torch.Tensor, b: torch.Tensor, mesh, *,
                   axis: str = "model", schedule: str = "ring") -> torch.Tensor:
    """The multi-card GEMM (the S2050 reproduction's entry point). Every
    rank passes the whole A (M, K) and B (K, N) and gets the whole
    product. Each takes its blocks as the reference's in_specs say
    (ring: A's rows and B's rows; column: A's rows, B whole; row: A's
    columns and B's rows), runs the schedule over `mesh`'s `axis` group
    (`mesh` None: a world of one), and joins the outputs as its out_specs
    do (ring, column: an all-gather of the row blocks; row: the
    all-reduce)."""
    group = None if mesh is None else mesh.get_group(axis)
    if _size(group) == 1:
        group = None
    if schedule == "ring":
        y = ring_matmul(_blocks(a, 0, group), _blocks(b, 0, group),
                        axis=group)
        return _gather_rows(y, group)
    if schedule == "column":
        return _gather_rows(column_parallel(_blocks(a, 0, group), b,
                                            axis=group), group)
    if schedule == "row":
        return row_parallel(_blocks(a, 1, group), _blocks(b, 0, group),
                            axis=group, scatter=False)
    raise ValueError(f"unknown schedule {schedule!r}")


def comm_model_bytes(m: int, n: int, k: int, p: int, itemsize: int,
                     schedule: str) -> int:
    """Link bytes a rank moves for each schedule, the reference's model:
    the 'matrices must be very large' claim quantified."""
    if schedule == "column":
        return 0
    if schedule == "row":
        return 2 * m * n * itemsize * (p - 1) // p      # all-reduce
    if schedule == "ring":
        return k * n * itemsize * (p - 1) // p          # W blocks cycled
    raise ValueError(schedule)
