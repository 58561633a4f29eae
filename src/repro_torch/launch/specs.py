"""Stand-ins for the inputs of every (arch x shape) cell: the JAX
package's `launch/specs.py`, with fake tensors (`FakeTensorMode`) in
place of `ShapeDtypeStruct`s. No memory is allocated: each function
builds its tensors under the caller's FakeTensorMode, or a new one where
none is active, and a step run on them (the dry-run's count) stays fake.
Modality frontends are stubs, as in the reference: whisper gets
precomputed frame embeddings, qwen2-vl aligned patch embeddings and
M-RoPE position streams.

`decode_inputs` gives the position as an int, the cell's last one (a
full context): the port's counter charges a decode step by the keys up
to its position, read on the host (`roofline.analysis.decode_keys`),
where the reference's position is an abstract scalar.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.distributed.sharding import P
from repro_torch.models import model as M


def _fake():
    """A context in which tensors are fake: the active FakeTensorMode,
    or a new one."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    return contextlib.nullcontext() if detect_fake_mode() is not None \
        else FakeTensorMode()


def sds(shape, dtype):
    """A fake tensor of `shape` and `dtype` (zeros)."""
    with _fake():
        return torch.zeros(shape, dtype=getattr(torch, str(dtype)))


def train_batch_specs(cfg: ModelConfig, cell: ShapeCell):
    b, s = cell.global_batch, cell.seq_len
    batch = {"tokens": sds((b, s), "int32"), "labels": sds((b, s), "int32")}
    if cfg.family == "vlm":
        batch["patch_embeds"] = sds((b, s, cfg.d_model), cfg.dtype)
        batch["positions"] = sds((b, s, 3), "int32")
    if cfg.family == "encdec":
        batch["enc_frames"] = sds((b, cfg.enc_ctx, cfg.d_model), cfg.dtype)
    return batch


def prefill_batch_specs(cfg: ModelConfig, cell: ShapeCell):
    batch = train_batch_specs(cfg, cell)
    batch.pop("labels")
    return batch


def cache_specs_struct(cfg: ModelConfig, cell: ShapeCell):
    """The serving cache at this cell's batch and length, fake."""
    with _fake():
        return M.init_cache(cfg, cell.global_batch, cell.seq_len,
                            device="cpu")


def decode_inputs(cfg: ModelConfig, cell: ShapeCell):
    """(token (B, 1), the position (an int: the cell's last), cache)."""
    token = sds((cell.global_batch, 1), "int32")
    return token, cell.seq_len - 1, cache_specs_struct(cfg, cell)


def batch_pspec(batch, *, multi_pod: bool, dp: int):
    """A P for each entry of a batch dict: the leading (batch) dim over DP
    where it divides."""
    axes = ("pod", "data") if multi_pod else ("data",)

    def fn(leaf):
        if leaf.dim() and leaf.shape[0] % dp == 0 and leaf.shape[0] > 1:
            return P(axes, *([None] * (leaf.dim() - 1)))
        return P(*([None] * leaf.dim()))
    return {k: fn(v) for k, v in batch.items()}


def applicable(cfg: ModelConfig, cell: ShapeCell) -> tuple[bool, str]:
    """(runs?, the reason where it is skipped): the reference's table."""
    if cell.name == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch: 500k-token KV decode is "
                       "quadratic-cost/OOM; skipped per spec, see DESIGN §6")
    if cell.name == "long_500k" and cfg.family == "encdec":
        return False, "enc-dec decoder caps at short contexts (DESIGN §6)"
    return True, ""
