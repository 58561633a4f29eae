"""The port's SSD scan against the JAX package's on the CPU: the plain
chunked scan (`ref.ssd_chunked_ref`, what `ops.ssd` runs for CPU
tensors), the scan around the kernel (`kernels.ssd.ssd_chunked`, its
intra-chunk work through the kernel's plain version here) and the plain
version of the kernel's own contract (`ref.ssd_intra_chunk_ref`), held
against `ssd_chunked`, the sequential `ssd_ref` and the Pallas kernel in
interpret mode, on the same numpy inputs.

Stated tolerance: f32 outputs within 1e-5 of the reference, relative to
each element and to the largest |value| of the output (rtol 1e-5, atol
1e-5 x max|want|: the same sums in another order, over terms of the
output's scale); a bf16 y within one bf16 rounding of the f32 result
(rtol 2^-7).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels import ssd as jax_ssd
from repro_torch.core import ssd as core_ssd
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd as kssd

# jitted once a shape: op-by-op dispatch of the scans costs seconds
jax_ssd_chunked = jax.jit(jax_ssd.ssd_chunked, static_argnums=4)
jax_ssd_ref = jax.jit(jax_ref.ssd_ref, static_argnums=4)
jax_ssd_pallas = jax.jit(functools.partial(jax_ssd.ssd_pallas, interpret=True),
                         static_argnums=4)
jax_ssd_intra_chunk = jax.jit(functools.partial(jax_ssd.ssd_intra_chunk,
                                                interpret=True))


def _operands(seed, b=2, l=64, h=4, g=2, p=16, n=16, decay=(0.01, 0.5)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    a = -rng.uniform(*decay, size=(b, l, h)).astype(np.float32)
    bm = rng.normal(size=(b, l, g, n)).astype(np.float32)
    cm = rng.normal(size=(b, l, g, n)).astype(np.float32)
    return x, a, bm, cm


def _t(*arrays, dtype=None):
    out = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    return [t.to(dtype) if dtype is not None else t for t in out]


def _j(*arrays, dtype=None):
    return [jnp.asarray(a, dtype) for a in arrays]


def _close(got, want, **tol):
    want = np.asarray(want, np.float32)
    tol = tol or dict(rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def _close_t(got, want):
    _close(got, want.numpy())


@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("h,g", [(4, 1), (4, 2), (8, 8)])
def test_ssd_chunked_ref_matches_jax(chunk, h, g):
    """Against ssd_chunked, the sequential ssd_ref and the Pallas kernel
    (interpret); the scan around the kernel gives the same."""
    x, a, bm, cm = _operands(0, b=2, l=128, h=h, g=g, p=16, n=32)
    jx = _j(x, a, bm, cm)
    wants = [jax_ssd_chunked(*jx, chunk), jax_ssd_ref(*jx, chunk),
             jax_ssd_pallas(*jx, chunk)]
    for got in (ref.ssd_chunked_ref(*_t(x, a, bm, cm), chunk),
                kssd.ssd_chunked(*_t(x, a, bm, cm), chunk)):
        assert got[1].dtype == torch.float32
        for want in wants:
            _close(got[0], want[0])
            _close(got[1], want[1])


def test_ssd_init_state_matches_jax():
    """A carried state seeds the inter-chunk scan, and changes y."""
    x, a, bm, cm = _operands(1)
    s0 = np.random.default_rng(2).normal(size=(2, 4, 16, 16)).astype(np.float32)
    want = jax_ssd_pallas(*_j(x, a, bm, cm), 16, jnp.asarray(s0))
    for fn in (ref.ssd_chunked_ref, kssd.ssd_chunked):
        y, s = fn(*_t(x, a, bm, cm), 16, *_t(s0))
        _close(y, want[0])
        _close(s, want[1])
    y0, _ = ref.ssd_chunked_ref(*_t(x, a, bm, cm), 16)
    assert float((y - y0).abs().max()) > 1e-3


def test_ssd_carried_state_split_prefill():
    """The second half run from the first half's final state gives the
    whole pass (to f32 roundoff: the plain einsums may block otherwise
    at another chunk count)."""
    x, a, bm, cm = _operands(3)
    full = ref.ssd_chunked_ref(*_t(x, a, bm, cm), 16)
    first = ref.ssd_chunked_ref(*_t(x[:, :32], a[:, :32], bm[:, :32],
                                    cm[:, :32]), 16)
    second = ref.ssd_chunked_ref(*_t(x[:, 32:], a[:, 32:], bm[:, 32:],
                                     cm[:, 32:]), 16, first[1])
    _close_t(first[0], full[0][:, :32])
    _close_t(second[0], full[0][:, 32:])
    _close_t(second[1], full[1])


def test_ssd_execution_chunk_invariance():
    """Chunking is exact: every execution chunk computes the function
    JAX's ssd_chunked computes at chunk 64."""
    x, a, bm, cm = _operands(4)
    want = jax_ssd_chunked(*_j(x, a, bm, cm), 64)
    for q in (64, 32, 16, 8):
        for fn in (ref.ssd_chunked_ref, kssd.ssd_chunked):
            y, s = fn(*_t(x, a, bm, cm), q)
            _close(y, want[0])
            _close(s, want[1])


def test_ssd_bf16_inputs_carry_an_f32_state():
    x, a, bm, cm = _operands(5)
    want = jax_ssd_chunked(*_j(x, dtype=jnp.bfloat16), jnp.asarray(a),
                           *_j(bm, cm, dtype=jnp.bfloat16), 16)
    tx, tb, tc = _t(x, bm, cm, dtype=torch.bfloat16)
    for fn in (ref.ssd_chunked_ref, kssd.ssd_chunked):
        y, s = fn(tx, *_t(a), tb, tc, 16)
        assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
        _close(s, want[1])
        _close(y, want[0], atol=1e-5, rtol=2 ** -7)


def test_ssd_strong_decay_is_finite():
    """a = -20 a step: the log-space decay is masked before the exp."""
    x, a, bm, cm = _operands(6, l=64, decay=(20.0, 20.0))
    want = jax_ssd_chunked(*_j(x, a, bm, cm), 32)
    for fn in (ref.ssd_chunked_ref, kssd.ssd_chunked):
        y, s = fn(*_t(x, a, bm, cm), 32)
        assert torch.isfinite(y).all() and torch.isfinite(s).all()
        _close(y, want[0])
        _close(s, want[1])


@pytest.mark.parametrize("h,g", [(4, 1), (4, 2)])
def test_ssd_intra_chunk_ref_matches_jax_kernel(h, g):
    """The kernel's own contract: per chunk y_diag and the chunk state,
    against the Pallas kernel in interpret mode, which takes B and C
    repeated per head and (B*H, nc, Q, .) operands."""
    bsz, l, p, n, q = 2, 48, 16, 32, 16
    x, a, bm, cm = _operands(7, b=bsz, l=l, h=h, g=g, p=p, n=n)
    nc, rep = l // q, h // g

    def heads(v):          # (B, L, H, .) -> (B*H, nc, Q, .)
        return np.moveaxis(v, 2, 1).reshape(bsz * h, nc, q, *v.shape[3:])

    y_j, st_j = jax_ssd_intra_chunk(
        *_j(heads(x), heads(a), heads(np.repeat(bm, rep, axis=2)),
            heads(np.repeat(cm, rep, axis=2))))
    y, st = ref.ssd_intra_chunk_ref(*_t(x, a, bm, cm), q)
    assert y.shape == (bsz, l, h, p) and st.shape == (bsz, h, nc, n, p)
    _close(y.reshape(bsz, nc, q, h, p).permute(0, 3, 1, 2, 4)
           .reshape(bsz * h, nc, q, p), y_j)
    _close(st.reshape(bsz * h, nc, n, p), st_j)


def test_ssd_seq_ref_matches_jax_ssd_ref():
    x, a, bm, cm = _operands(8, l=24)
    s0 = np.random.default_rng(9).normal(size=(2, 4, 16, 16)).astype(np.float32)
    want = jax_ssd_ref(*_j(x, a, bm, cm), 8, jnp.asarray(s0))
    y, s = ref.ssd_seq_ref(*_t(x, a, bm, cm), 8, *_t(s0))
    _close(y, want[0])
    _close(s, want[1])


def _bad(**kw):
    x, a, bm, cm = _t(*_operands(10, l=32))
    args = dict(x=x, a=a, b=bm, c=cm, chunk=16, init_state=None)
    args.update(kw)
    return args


@pytest.mark.parametrize("args,match", [
    (_bad(x=torch.zeros(2, 32, 4)), "expects"),
    (_bad(a=torch.zeros(2, 32, 3)), "a shape"),
    (_bad(b=torch.zeros(2, 32, 2, 8)), "must match"),
    (_bad(b=torch.zeros(2, 32, 3, 16), c=torch.zeros(2, 32, 3, 16)),
     "divisible by groups"),
    (_bad(chunk=12), "not divisible by chunk"),
    (_bad(chunk=0), "not divisible by chunk"),
    (_bad(init_state=torch.zeros(2, 4, 16, 8)), "init_state shape"),
], ids=["x-ndim", "a-shape", "bc-mismatch", "groups", "ragged-chunk",
        "zero-chunk", "init-state"])
def test_ops_ssd_contract_errors(args, match):
    with pytest.raises(ValueError, match=match):
        ops.ssd(**args)


def test_core_ssd_zero_state_and_no_launch_on_cpu():
    """The chokepoint seeds a missing state with zeros and runs the plain
    scan on the CPU: no kernel launch is counted."""
    x, a, bm, cm = _t(*_operands(11, l=32))
    ops.reset_launch_counts()
    y, s = core_ssd.ssd(x, a, bm, cm, 16)
    want = ref.ssd_chunked_ref(x, a, bm, cm, 16, torch.zeros(2, 4, 16, 16))
    assert torch.equal(y, want[0]) and torch.equal(s, want[1])
    assert ops.launch_counts()["ssd"] == 0
