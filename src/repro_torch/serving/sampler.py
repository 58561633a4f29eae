"""Token selection for the serving engine: greedy, the argmax of the
(vocab,) f32 logits row of each active slot, taken on the host."""

from __future__ import annotations

import numpy as np


def greedy(logits: np.ndarray) -> int:
    """logits: (vocab,) float32 -> token id."""
    return int(np.argmax(logits))
