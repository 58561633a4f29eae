"""AdamW with global-norm clipping, and the cosine schedule: the JAX
package's `optim/adamw.py` on param trees of tensors.

Plain PyTorch ops, as the JAX package runs them in XLA: a handful of
elementwise passes a leaf, bound by the bytes of params, grads and the
two moments. `update` is functional, as the reference is: it returns new
params and a new state and leaves its inputs as they were. With
`donate=True`, the counterpart of the JAX launcher's donated train
state, it writes the new params and moments into the state's own tensors
and scales the grads in place, a slice of each leaf at a time
(`_slices`), so that no new tree and no temporary the size of a leaf is
made; the arithmetic of each element is the same, so are the bits.

Under tensor parallelism (`sharded=`, `group=`: the train step on a
mesh) each rank updates its blocks of the params; the global norm's sum
of squares over the leaves held in blocks is all-reduced over the
"model" group, and a replicated leaf is counted once, so the clip is the
whole model's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core.tree import leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor          # () int32, the number of updates taken
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    state_dtype: str = "float32"    # bfloat16 halves the moments' bytes

    def init(self, params) -> AdamWState:
        dt = getattr(torch, self.state_dtype)
        zeros = lambda p: torch.zeros_like(p, dtype=dt)
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32,
                             device=leaves(params)[0].device),
            m=tree_map(zeros, params), v=tree_map(zeros, params))

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, *, donate=False,
               sharded=None, group=None):
        """(new params, new state, the global grad norm before clipping).
        Weight decay applies to the leaves of two or more dims only (not
        to norms or biases). donate: the new params, m and v are written
        into `params`, `state.m` and `state.v` (returned), and `grads` is
        scaled in place; the caller reads none of them as the old values
        again. sharded, group: a tree of bools (True: this rank's block of
        a leaf split over `group`), for the global norm."""
        step = state.step + 1
        gnorm = global_norm(grads, sharded=sharded, group=group)
        scale = None
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)

        b1, b2 = self.b1, self.b2
        dt = getattr(torch, self.state_dtype)
        stepf = step.float()
        bc1 = 1 - b1 ** stepf
        bc2 = 1 - b2 ** stepf
        lr = self._lr(step)

        def leaf(p, g, mm, vv):
            """(new p, new m, new v) of one leaf (or a slice of one)."""
            if scale is not None:
                g = g.mul_(scale) if donate else g * scale
            mm = (b1 * mm.float() + (1 - b1) * g.float()).to(dt)
            vv = (b2 * vv.float() + (1 - b2) * torch.square(g.float())).to(dt)
            mhat = mm.float() / bc1
            vhat = vv.float() / bc2
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            if self.weight_decay and p.dim() >= 2:
                delta = delta + self.weight_decay * p.float()
            return (p.float() - lr * delta).to(p.dtype), mm, vv

        if not donate:
            out = tree_map(leaf, params, grads, state.m, state.v)
            new_p, m, v = (tree_map(lambda t, i=i: t[i], out)
                           for i in range(3))
            return new_p, AdamWState(step=step, m=m, v=v), gnorm

        for p, g, mm, vv in zip(*map(leaves, (params, grads, state.m,
                                              state.v))):
            # a (1, ...) slice keeps p.dim(), which decides weight decay
            for sl in _slices(p):
                new = leaf(p[sl], g[sl], mm[sl], vv[sl])
                for dst, src in zip((p, mm, vv), new):
                    dst[sl].copy_(src)
        state.step.copy_(step)
        return params, state, gnorm


#: The most elements an in-place update or the norm takes of a leaf at a
#: time (64 MiB of f32).
SLICE_ELEMS = 1 << 24


def _slices(x: torch.Tensor) -> list:
    """Index tuples that cover x in slices of whole rows along dim 0, each
    of at most SLICE_ELEMS elements (one row where a row is larger); a
    leaf of fewer than two dims is one slice."""
    if x.dim() < 2 or x.numel() <= SLICE_ELEMS:
        return [(slice(None),)]
    rows = max(1, SLICE_ELEMS // (x.numel() // x.shape[0]))
    return [(slice(i, i + rows),) for i in range(0, x.shape[0], rows)]


def _sum_squares(x: torch.Tensor) -> torch.Tensor:
    return sum(torch.sum(torch.square(x[sl].float())) for sl in _slices(x))


def global_norm(tree, *, sharded=None, group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, each leaf's sum
    taken over `_slices` of it, so no temporary is the size of a large
    leaf. sharded, group: the leaves marked True in the tree of bools
    `sharded` are blocks of leaves split over `group`, their sum of
    squares all-reduced over it; the others are counted once."""
    if group is None:
        return torch.sqrt(sum(_sum_squares(x) for x in leaves(tree)))
    import torch.distributed as dist
    xs = leaves(tree)
    zero = torch.zeros((), dtype=torch.float32, device=xs[0].device)
    own = sum((_sum_squares(x) for x, s in zip(xs, leaves(sharded)) if s),
              zero)
    dist.all_reduce(own, group=group)
    return torch.sqrt(own + sum((_sum_squares(x) for x, s in
                                 zip(xs, leaves(sharded)) if not s), zero))


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1):
    """lr(step): linear warmup to peak_lr over `warmup` steps, then a
    cosine decay to floor_frac * peak_lr at `total`."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor_frac + (1 - floor_frac)
                         * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr
