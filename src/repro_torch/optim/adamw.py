"""AdamW with global-norm clipping, and the cosine schedule: the JAX
package's `optim/adamw.py` on param trees of tensors.

Plain PyTorch ops, as the JAX package runs them in XLA: a handful of
elementwise passes a leaf, bound by the bytes of params, grads and the
two moments. `update` is functional, as the reference is: it returns new
params and a new state and leaves its inputs as they were.
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
    def update(self, grads, state: AdamWState, params):
        """(new params, new state, the global grad norm before clipping).
        Weight decay applies to the leaves of two or more dims only (not
        to norms or biases)."""
        step = state.step + 1
        gnorm = global_norm(grads)
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
            grads = tree_map(lambda g: g * scale, grads)

        b1, b2 = self.b1, self.b2
        dt = getattr(torch, self.state_dtype)
        m = tree_map(lambda mm, g: (b1 * mm.float()
                                    + (1 - b1) * g.float()).to(dt),
                     state.m, grads)
        v = tree_map(lambda vv, g: (b2 * vv.float()
                                    + (1 - b2) * torch.square(g.float())
                                    ).to(dt),
                     state.v, grads)
        stepf = step.float()
        bc1 = 1 - b1 ** stepf
        bc2 = 1 - b2 ** stepf
        lr = self._lr(step)

        def upd(p, mm, vv):
            mhat = mm.float() / bc1
            vhat = vv.float() / bc2
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            if self.weight_decay and p.dim() >= 2:
                delta = delta + self.weight_decay * p.float()
            return (p.float() - lr * delta).to(p.dtype)

        new_params = tree_map(upd, params, m, v)
        return new_params, AdamWState(step=step, m=m, v=v), gnorm


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


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
