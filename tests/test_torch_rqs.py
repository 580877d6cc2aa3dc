"""The port's plain PyTorch rational-quadratic spline
(posteriflow_torch.ops.rqs, the CUDA kernel's oracle) against
posteriflow_tpu.ops.rqs and against the Pallas kernel run in interpret
mode. The kernel and its wrapper are tested in test_torch_kernel.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posteriflow_tpu.ops import rqs as jrqs
from posteriflow_tpu.ops.pallas_rqs import (pallas_rqs_forward,
                                            pallas_rqs_inverse)
from posteriflow_torch.ops import rqs as trqs


def _inputs(k, shape=(300, 5), seed=0):
    """x with |x| up to 6 (some rows in the identity tails beyond ±5) and
    raw spline parameters N(0, 0.7²), as tests/test_pallas_rqs.py draws
    them."""
    rng = np.random.default_rng(seed)
    x = np.clip(rng.standard_normal(shape) * 2.5, -6.0, 6.0).astype(np.float32)
    raw = (rng.standard_normal(shape + (3 * k - 1,)) * 0.7).astype(np.float32)
    assert (np.abs(x) > 5.0).any() and (np.abs(x) <= 5.0).any()
    return x, raw


def _torch_fn(inverse):
    return trqs.rqs_inverse if inverse else trqs.rqs_forward


def _error_gain(x, raw, k, inverse):
    """Per element 1 + max(g, 1/g), g = |d out / d in| from the JAX
    reference. exp, softplus and the sums round differently in XLA and in
    PyTorch, so the knots differ by a few float32 steps; a forward output
    moves by up to g times a knot's error and an inverse output by up to
    1/g times it, so a tolerance scales with this gain (1 + 1 = 2 in a
    bin of unit slope)."""
    fn = jrqs.rqs_inverse if inverse else jrqs.rqs_forward
    _, ld = fn(jnp.asarray(x.reshape(-1, 1)),
               jnp.asarray(raw.reshape(-1, 1, raw.shape[-1])), k)
    g = np.exp(np.asarray(ld)).reshape(x.shape)
    return 1.0 + np.maximum(g, 1.0 / g)


def _assert_close_scaled(got, want, atol, gain):
    """|got - want| <= atol · gain, elementwise."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    worst = float(np.max(err / gain))
    assert worst <= atol, f"max |Δ|/gain {worst:.3e} > {atol:g}"


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("k", [8, 12, 16])
def test_plain_matches_jax_rqs(k, inverse):
    """Same formula in float32: atol 1e-5 on out, scaled by each element's
    error gain, and on the D-summed logdet, scaled by the row's summed
    gain (measured: at most 2e-6 and 6e-6 per unit of gain)."""
    x, raw = _inputs(k, seed=k)
    j_fn = jrqs.rqs_inverse if inverse else jrqs.rqs_forward
    jo, jl = j_fn(jnp.asarray(x), jnp.asarray(raw), k)
    to, tl = _torch_fn(inverse)(torch.from_numpy(x), torch.from_numpy(raw), k)
    gain = _error_gain(x, raw, k, inverse)
    _assert_close_scaled(to.numpy(), jo, 1e-5, gain)
    _assert_close_scaled(tl.numpy(), jl, 1e-5, gain.sum(-1))


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("k", [8, 12, 16])
def test_plain_matches_pallas_interpret(k, inverse):
    """The Pallas body takes the bin width as pick(w)·2B instead of
    x_hi - x_lo, so it agrees with rqs.py only to the tolerance of
    tests/test_pallas_rqs.py: 2e-5 on out, 2e-4 on logdet, each scaled by
    the error gain as above."""
    x, raw = _inputs(k, seed=10 + k)
    p_fn = pallas_rqs_inverse if inverse else pallas_rqs_forward
    po, pl_ = p_fn(jnp.asarray(x), jnp.asarray(raw), k, interpret=True)
    to, tl = _torch_fn(inverse)(torch.from_numpy(x), torch.from_numpy(raw), k)
    gain = _error_gain(x, raw, k, inverse)
    _assert_close_scaled(to.numpy(), po, 2e-5, gain)
    _assert_close_scaled(tl.numpy(), pl_, 2e-4, gain.sum(-1))


def test_plain_batched_shapes_match_jax():
    """Sampling shape: x [B, n, D], raw [B, n, D, 3K-1] -> logdet [B, n]."""
    k = 16
    x, raw = _inputs(k, shape=(3, 40, 7), seed=3)
    jo, jl = jrqs.rqs_inverse(jnp.asarray(x), jnp.asarray(raw), k)
    to, tl = trqs.rqs_inverse(torch.from_numpy(x), torch.from_numpy(raw), k)
    assert tuple(to.shape) == (3, 40, 7) and tuple(tl.shape) == (3, 40)
    gain = _error_gain(x, raw, k, inverse=True)
    _assert_close_scaled(to.numpy(), jo, 1e-5, gain)
    _assert_close_scaled(tl.numpy(), jl, 1e-5, gain.sum(-1))


def test_plain_roundtrip_and_tails():
    """forward∘inverse is the identity inside ±B (3e-5, the tolerance of the
    JAX package's own roundtrip test), the logdets cancel, and the tails
    are the identity with logdet 0."""
    k = 16
    x, raw = _inputs(k, seed=5)
    xt, rt = torch.from_numpy(np.clip(x, -4.9, 4.9)), torch.from_numpy(raw)
    y, ld = trqs.rqs_forward(xt, rt, k)
    x2, ld2 = trqs.rqs_inverse(y, rt, k)
    np.testing.assert_allclose(x2.numpy(), xt.numpy(), atol=3e-5, rtol=0)
    np.testing.assert_allclose((ld + ld2).numpy(), 0.0, atol=3e-4)
    tail = torch.full((4, 5), 5.5)
    out, ldt = trqs.rqs_forward(tail, rt[:4], k)
    assert torch.equal(out, tail) and torch.equal(ldt, torch.zeros(4))
