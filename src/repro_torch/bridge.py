"""Params of the JAX package, as the port's tensors.

`params_from_numpy` takes the reference's param tree with its leaves as
numpy arrays (what `jax.tree.map(np.asarray, params)` gives) and returns
the same nested dict of torch tensors: the same keys, the same shapes,
the stacked leading layer dim kept. This module imports no jax.
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
