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
returns them. With `compress=True` (and a state made with
`init_state(..., compress=True)`) the gradients go through int8
error-feedback compression (`distributed.compression.compress_grads`)
after the accumulation and before the update, as the reference's step
compresses them.

On a mesh (`mesh=`, or the current one of `distributed.context`), a
("data", "model") DeviceMesh (`launch.mesh.make_host_mesh`):
  * each rank holds its block of every param over "model"
    (`init_state(..., mesh=)`: `distributed.sharding.model_layout`), and
    the dense family's forward and backward are tensor-parallel
    (models/); the params are replicated over "data";
  * the step takes the global batch and each "data" rank its block of
    rows; the gradients are averaged over the "data" group, then
    compressed (so the EF state is the same on every rank, and the
    reference's compression of the whole logical gradient is matched),
    then the update runs on each rank's blocks, the global norm's sum of
    squares over a sharded leaf all-reduced over "model";
  * "loss" and "ce_loss" are averaged over "data".
Both packages' steps all-reduce f32 gradients: the int8 values that
compression makes are dequantised before the reduction, not sent as an
int8 payload (the reference's docstring says otherwise).
"""

from __future__ import annotations

import contextlib
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.tree import leaves, tree_map
from repro_torch.distributed import compression as comp
from repro_torch.distributed import context as ctx
from repro_torch.distributed import sharding as SH
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamW, AdamWState


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    ef: Optional[comp.EFState] = None


def init_state(cfg, optimizer: AdamW, generator: torch.Generator,
               device=None, *, compress: bool = False,
               mesh=None) -> TrainState:
    """The params drawn whole from `generator` (every rank the same), then
    on a mesh whose "model" axis is wider than 1 each cut to this rank's
    block; the AdamW state and, with `compress`, the EF state of those."""
    params = M.init_params(cfg, generator, device)
    if ctx.axis_size("model", mesh) > 1:
        params = tree_map(lambda s, x: SH.Sharding(mesh, s).local(x).clone(),
                          SH.model_layout(cfg, params, mesh), params)
    return TrainState(params=params, opt=optimizer.init(params),
                      ef=comp.init_ef(params) if compress else None)


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


def _local_batch(batch, mesh):
    """This data rank's block of rows of the global batch."""
    idx, n = ctx.data_index(mesh)
    if n == 1:
        return batch
    b = batch["tokens"].shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split over {n} data ranks")
    rows = b // n
    return {k: v[idx * rows:(idx + 1) * rows] for k, v in batch.items()}


def _data_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """x summed over the data-parallel groups of `mesh`, over their size
    (in place)."""
    import torch.distributed as dist
    groups = ctx.data_groups(mesh)
    for g in groups:
        dist.all_reduce(x, group=g)
    if groups:
        x.div_(ctx.data_index(mesh)[1])
    return x


def make_train_step(cfg, optimizer: AdamW, *, accum: int = 1,
                    donate: bool = False, compress: bool = False,
                    mesh=None):
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
    state again. compress: int8 error-feedback compression of the
    gradients (the state's `ef`). mesh: the DeviceMesh to run on (None:
    the current one of `distributed.context`, if any; see the module's
    docstring)."""
    def train_step(state: TrainState, batch):
        m = mesh if mesh is not None else ctx.current_mesh()
        scope = ctx.mesh_context(m) if m is not None \
            else contextlib.nullcontext()
        with scope:
            return _step(state, batch, m)

    def _step(state: TrainState, batch, m):
        if m is not None:
            batch = _local_batch(batch, m)
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
        shard, group = None, None
        if m is not None:
            for g in leaves(grads):
                _data_mean(g, m)
            loss = _data_mean(loss.clone(), m)
            metrics = dict(metrics, ce_loss=_data_mean(
                metrics["ce_loss"].clone(), m))
            group = ctx.model_group(m)
            if group is not None:
                shard = SH.model_sharded(cfg, state.params,
                                         ctx.axis_size("model", m))
        ef = state.ef
        if compress and ef is not None:
            grads, new_ef = comp.compress_grads(grads, ef, sharded=shard,
                                                group=group)
            if donate:
                tree_map(lambda old, new: old.copy_(new), ef.error,
                         new_ef.error)
            else:
                ef = new_ef
        params, opt, gnorm = optimizer.update(grads, state.opt, state.params,
                                              donate=donate, sharded=shard,
                                              group=group)
        return TrainState(params, opt, ef), dict(metrics, grad_norm=gnorm,
                                                 loss=loss)

    return train_step
