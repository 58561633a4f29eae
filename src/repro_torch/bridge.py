"""Params and optimizer state of the JAX package, as the port's tensors.

`params_from_numpy` takes the reference's param tree with its leaves as
numpy arrays (what `jax.tree.map(np.asarray, params)` gives) and returns
the same nested dict of torch tensors: the same keys, the same shapes,
the stacked leading layer dim kept. `adamw_state_from_numpy` does the
same for an `AdamWState` (step, m, v), so both packages step from the
same state. This module imports no jax.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(x, device, dtype):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":           # ml_dtypes: no torch.from_numpy
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))      # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device, dtype=None):
    """Leaf-for-leaf conversion; `dtype` (if given) casts floating leaves."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    return _tensor(tree, device, dtype)


def adamw_state_from_numpy(state, device):
    """The reference's AdamWState, its leaves as numpy arrays, as the
    port's `optim.adamw.AdamWState`: the step an int32 scalar tensor, the
    moments leaf for leaf in their own dtype."""
    from repro_torch.optim.adamw import AdamWState
    return AdamWState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=device),
        m=params_from_numpy(state.m, device), v=params_from_numpy(state.v, device))
