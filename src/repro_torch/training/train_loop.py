"""The train step: the JAX package's `training/train_loop.py` for the
dense family, in PyTorch.

    state = init_state(cfg, optimizer, generator, device)
    step = make_train_step(cfg, optimizer, accum=2)
    state, metrics = step(state, batch)

A step takes the loss and its gradients (the forward and the backward
run through the CUDA kernels on the card: the GEMM chokepoint's autograd
Functions and the flash attention pair), accumulates them over `accum`
microbatches of the batch, and takes one AdamW step with global-norm
clipping. Gradient compression (`compress`) is not ported yet.
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


def make_train_step(cfg, optimizer: AdamW, *, accum: int = 1):
    """step(state, batch) -> (state, metrics). batch: {"tokens", "labels"}
    (B, T) integer tensors on the params' device. metrics: the last
    microbatch's loss_fn metrics with "ce_loss" and "loss" the mean over
    the microbatches, and "grad_norm" before clipping, as tensors."""

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
                grads = tree_map(torch.add, grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / accum, grads)
            loss = loss / accum
            metrics = dict(metrics, ce_loss=loss)
        params, opt, gnorm = optimizer.update(grads, state.opt, state.params)
        return TrainState(params, opt), dict(metrics, grad_norm=gnorm,
                                             loss=loss)

    return train_step
