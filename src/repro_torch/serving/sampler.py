"""Token selection for the serving engine: greedy / temperature / top-k,
and the speculative acceptance rule (the JAX package's
`repro/serving/sampler.py`).

Sampling runs on the host, in numpy, on the (vocab,) f32 logits row of
each active slot, as the JAX engine samples: one seed and the same rows
give the JAX package's tokens. `greedy` is the argmax alone.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    kind: str = "greedy"           # greedy | temperature
    temperature: float = 1.0
    top_k: int = 0                 # 0 = full vocab (temperature mode)

    def __post_init__(self):
        if self.kind not in ("greedy", "temperature"):
            raise ValueError(self.kind)
        if self.kind == "temperature" and self.temperature <= 0:
            raise ValueError("temperature must be > 0 (use kind='greedy')")


def greedy(logits: np.ndarray) -> int:
    """logits: (vocab,) float32 -> token id."""
    return int(np.argmax(logits))


class Sampler:
    """Stateful sampler: one np.random.Generator shared by all slots so
    a fixed seed gives a reproducible trace."""

    def __init__(self, config: SamplerConfig | None = None, seed: int = 0):
        self.config = config or SamplerConfig()
        self._rng = np.random.default_rng(seed)

    def __call__(self, logits: np.ndarray) -> int:
        """logits: (vocab,) float32 -> token id."""
        c = self.config
        if c.kind == "greedy":
            return int(np.argmax(logits))
        z = logits.astype(np.float64) / c.temperature
        k = min(c.top_k, z.size)       # top_k >= vocab = full vocab
        if k:
            kth = np.partition(z, -k)[-k]
            z = np.where(z >= kth, z, -np.inf)
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(self._rng.choice(len(p), p=p))

    # -- speculative decoding primitives --------------------------------

    def probs(self, logits: np.ndarray) -> np.ndarray:
        """The (vocab,) distribution this sampler draws from at `logits`
       : greedy is the one-hot delta at the argmax, temperature is the
        (optionally top-k-truncated) softmax. This is the p (target) /
        q (draft) of the speculative acceptance rule."""
        c = self.config
        if c.kind == "greedy":
            p = np.zeros(logits.shape[-1], np.float64)
            p[int(np.argmax(logits))] = 1.0
            return p
        z = logits.astype(np.float64) / c.temperature
        k = min(c.top_k, z.size)
        if k:
            kth = np.partition(z, -k)[-k]
            z = np.where(z >= kth, z, -np.inf)
        z -= z.max()
        p = np.exp(z)
        return p / p.sum()

    def sample_from(self, p: np.ndarray) -> int:
        """Draw from an explicit distribution with this sampler's rng
        stream (used for the residual draw on rejection)."""
        if self.config.kind == "greedy":
            return int(np.argmax(p))
        return int(self._rng.choice(len(p), p=p))

    def speculative_accept(self, target_logits: np.ndarray,
                           draft_tokens, draft_probs=None):
        """Leftover/residual acceptance rule (Leviathan et al.):
        for each draft token x_j with draft distribution q_j and target
        distribution p_j, accept with probability min(1, p_j(x_j) /
        q_j(x_j)); on the first rejection emit a draw from
        norm(max(p_j - q_j, 0)) and stop; on full acceptance emit a
        bonus draw from the final target row. The emitted stream is
        distribution-identical to sampling the target alone: and for
        greedy (q = delta at the draft argmax, p = delta at the target
        argmax) it degenerates to token-exact argmax agreement.

        target_logits: (k+1, vocab): row j scores draft token j, row k
        is the bonus row. draft_tokens: (k,) proposed ids. draft_probs:
        (k, vocab) distributions the DRAFT sampler drew from (its
        .probs of each draft logits row), or None when the draft
        proposes deterministically (greedy draft): q_j is then the
        delta at x_j and acceptance is min(1, p_j(x_j)).

        Returns (emitted tokens list: len in [1, k+1], n_accepted).
        """
        k = len(draft_tokens)
        assert target_logits.shape[0] == k + 1, target_logits.shape
        emitted: list[int] = []
        for j in range(k):
            x = int(draft_tokens[j])
            if self.config.kind == "greedy":
                best = int(np.argmax(target_logits[j]))
                emitted.append(x if x == best else best)
                if x != best:
                    return emitted, j
                continue
            p = self.probs(target_logits[j])
            if draft_probs is None:
                q_x = 1.0
                q = np.zeros_like(p)
                q[x] = 1.0
            else:
                q = np.asarray(draft_probs[j], np.float64)
                q_x = q[x]
            if q_x > 0 and self._rng.random() * q_x <= p[x]:
                emitted.append(x)
                continue
            emitted.append(self.sample_from(residual_distribution(p, q)))
            return emitted, j
        emitted.append(self.sample_from(self.probs(target_logits[k])))
        return emitted, k


def residual_distribution(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """norm(max(p - q, 0)): the rejection-path draw of the speculative
    acceptance rule; falls back to p when the residual has no mass
    (q covers p pointwise, possible only up to float error)."""
    res = np.maximum(np.asarray(p, np.float64) - np.asarray(q, np.float64),
                     0.0)
    mass = res.sum()
    return res / mass if mass > 0 else np.asarray(p, np.float64)


def make_sampler(kind: str = "greedy", *, temperature: float = 1.0,
                 top_k: int = 0, seed: int = 0) -> Sampler:
    return Sampler(SamplerConfig(kind=kind, temperature=temperature,
                                 top_k=top_k), seed=seed)
