"""The train step: the JAX package's `training/train_loop.py` for every
family, in PyTorch.

    state = init_state(cfg, optimizer, generator, device)
    step = make_train_step(cfg, optimizer, accum=2, donate=True)
    state, metrics = step(state, batch)

A step takes the loss and its gradients (the forward and the backward
run through the CUDA kernels on the card: the GEMM chokepoint's autograd
Functions, the flash attention pair, the expert banks' Functions and
the SSD Function, each layer rematerialised as `cfg.remat` says),
accumulates them over `accum` microbatches of the batch, and takes one
AdamW step with global-norm clipping. With `donate=True`, the
counterpart of the JAX launcher's `donate_argnums=(0,)`, the step
updates the state's tensors in place (`AdamW.update(donate=True)`) and
returns them. Gradient compression
(`compress`) is not ported yet.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.tree import tree_map
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamW, AdamWState


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def init_state(cfg, optimizer: AdamW, generator: torch.Generator,
               device=None) -> TrainState:
    params = M.init_params(cfg, generator, device)
    return TrainState(params=params, opt=optimizer.init(params))


def _loss_and_grads(cfg, params, batch):
    """(loss, metrics, grads) of `M.loss_fn` at `params`; the params are
    read through fresh leaves, so the caller's tensors get no .grad."""
    p = tree_map(lambda x: x.detach().requires_grad_(), params)
    loss, metrics = M.loss_fn(cfg, p, batch)
    loss.backward()
    grads = tree_map(lambda x: torch.zeros_like(x) if x.grad is None
                     else x.grad, p)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _split(batch, accum: int):
    """`accum` microbatches along the batch dim, in order."""
    b = batch["tokens"].shape[0]
    if b % accum:
        raise ValueError(f"batch {b} does not split into {accum} microbatches")
    n = b // accum
    return [{k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            for i in range(accum)]


def make_train_step(cfg, optimizer: AdamW, *, accum: int = 1,
                    donate: bool = False):
    """step(state, batch) -> (state, metrics). batch: {"tokens", "labels"}
    (B, T) integer tensors on the params' device, and what the family's
    forward reads ("enc_frames" (B, enc_ctx, d_model) for encdec,
    "patch_embeds" (B, T, d_model) and (B, T, 3) "positions" for vlm),
    every entry cut along dim 0 into the microbatches. metrics: the last
    microbatch's loss_fn metrics (a moe model's router losses and dropped
    fraction among them) with "ce_loss" and "loss" the mean over the
    microbatches, and "grad_norm" before clipping, as tensors.
    donate: the returned state is the given one, updated in place (the
    same bits as the functional step's); the caller must not read the old
    state again."""

    def train_step(state: TrainState, batch):
        if accum == 1:
            loss, metrics, grads = _loss_and_grads(cfg, state.params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for mb in _split(batch, accum):
                l, metrics, g = _loss_and_grads(cfg, state.params, mb)
                tree_map(lambda acc, x: acc.add_(x), grads, g)
                del g
                loss = loss + l
            tree_map(lambda g: g.div_(accum), grads)
            loss = loss / accum
            metrics = dict(metrics, ce_loss=loss)
        params, opt, gnorm = optimizer.update(grads, state.opt, state.params,
                                              donate=donate)
        return TrainState(params, opt), dict(metrics, grad_norm=gnorm,
                                             loss=loss)

    return train_step
