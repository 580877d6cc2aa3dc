"""posteriflow_torch.models.encoder against the flax encoders of
posteriflow_tpu at the real N_SAMPLES (16384) with narrow widths
(d_model 32, 1 layer, 4 heads), in float32 and bfloat16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posteriflow_tpu.models import encoder as jenc
from posteriflow_torch.models import encoder as tenc
from posteriflow_torch.physics.constants import N_SAMPLES
from posteriflow_torch.train.checkpoints import flax_to_state_dict

B = 2
KW = dict(d_model=32, n_layers=1, n_heads=4, context_dim=24, psd_bands=16)
# float32: same arithmetic in another order (FFT, convs, matmuls); bfloat16:
# convs, attention and MLP matmuls round to bf16 (step 2^-8 relative), and
# the last bit is not always the same one in XLA and PyTorch
TOL = {"float32": 2e-4, "bfloat16": 3e-2}


def _strain(seed=0):
    """Whitened-scale strain: unit noise plus a chirp-like burst common to
    all detectors with per-detector delays, so GCC has a peak to find."""
    rng = np.random.default_rng(seed)
    t = np.arange(N_SAMPLES) / 4096.0
    s = rng.standard_normal((B, 3, N_SAMPLES))
    for d, lag in enumerate((0.0, 0.004, -0.007)):
        tt = t - 2.0 - lag
        s[:, d] += 3.0 * np.exp(-(tt / 0.05) ** 2) * np.sin(2 * np.pi * 80
                                                             * tt * (1 + tt))
    bands = 0.1 * rng.standard_normal((B, 3, 16))
    return s.astype(np.float32), bands.astype(np.float32)


@pytest.fixture(scope="module", params=[
    ("coherent", "float32"), ("coherent", "bfloat16"), ("conv", "float32")])
def encoders(request):
    kind, dt = request.param
    jcls, tcls = ((jenc.CoherentEncoder, tenc.CoherentEncoder)
                  if kind == "coherent" else
                  (jenc.LeanStrainEncoder, tenc.LeanStrainEncoder))
    jm = jcls(compute_dtype=dt, **KW)
    strain, bands = _strain()
    params = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                    jnp.asarray(strain), jnp.asarray(bands)))
    tm = tcls(compute_dtype=dt, **KW)
    tm.load_state_dict(flax_to_state_dict(params), strict=True)
    return dt, jm, params, tm.eval()


def test_context_matches(encoders):
    dt, jm, params, tm = encoders
    strain, bands = _strain(seed=1)
    j = np.asarray(jm.apply(params, jnp.asarray(strain), jnp.asarray(bands)))
    with torch.no_grad():
        t = tm(torch.from_numpy(strain), torch.from_numpy(bands)).numpy()
    assert t.shape == (B, KW["context_dim"]) and np.isfinite(t).all()
    np.testing.assert_allclose(t, j, atol=TOL[dt] * max(1.0, np.abs(j).max()))


def test_stem_gives_61_tokens():
    """16384 samples -> 61 tokens per detector; the fusion sequence at the
    flagship is 3·61 + 4 geometry tokens = 187."""
    stem = tenc.ConvStem(d_model=192)
    with torch.no_grad():
        out = stem(torch.zeros(2, N_SAMPLES))
    assert tuple(out.shape) == (2, 61, 192)
    enc = tenc.CoherentEncoder(d_model=192, psd_bands=16)
    with torch.no_grad():
        geom = enc.geometry_tokens(torch.randn(1, 3, N_SAMPLES))
    assert tuple(geom.shape) == (1, 4, 192)
    assert 3 * 61 + geom.shape[1] == 187


def test_geometry_features_match():
    """The geometry tokens (unitary rfft, bands, coherence, GCC lag argmax,
    amplitude ratios, then the MLP) against the flax path's intermediate
    output of geom_to_tokens, float32."""
    jm = jenc.CoherentEncoder(**KW)
    strain, bands = _strain(seed=2)
    params = jax.device_get(jm.init(jax.random.PRNGKey(1),
                                    jnp.asarray(strain), jnp.asarray(bands)))
    _, state = jm.apply(params, jnp.asarray(strain), jnp.asarray(bands),
                        capture_intermediates=True)
    j = np.asarray(state["intermediates"]["geom_to_tokens"]["__call__"][0])
    j = j.reshape(B, -1, KW["d_model"])
    tm = tenc.CoherentEncoder(**KW)
    tm.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        t = tm.geometry_tokens(torch.from_numpy(strain)).numpy()
    np.testing.assert_allclose(t, j, atol=2e-4 * max(1.0, np.abs(j).max()))
