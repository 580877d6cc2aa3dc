"""The port's auxiliary models against the JAX package on the CPU:
models/svd_basis.py, models/transformer_encoder.py and the rest of
utils/logging.py (peak_rss_mb).

Bars: on JAX's own draws (rebuilt from PRNGKey(seed) split into k_m, k_t)
the singular values within 1e-4 relative (measured 7.1e-6 at 64
waveforms: the waveforms agree to the float32 phase rounding and the SVD
runs in complex128 here, complex64 in JAX's numpy); each basis vector's
|⟨b_jax, b_port⟩| >= 0.999 where its singular value stands more than 1%
from its neighbours, and the projector onto the leading vectors within
1e-3 (Frobenius) elsewhere; project_onto_basis within 1e-5 of the largest
coefficient. LightweightTransformerEncoder with a flax tree loaded: within
1e-5 of the largest output at T = 2048 with 2 layers."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posteriflow_tpu.models import svd_basis as JS
from posteriflow_tpu.models.transformer_encoder import \
    LightweightTransformerEncoder as JLTE
from posteriflow_tpu.utils import logging as JL
from posteriflow_torch.models import svd_basis as TS
from posteriflow_torch.models.transformer_encoder import (
    LightweightTransformerEncoder, PretrainedAudioEncoder)
from posteriflow_torch.train.checkpoints import flax_to_state_dict
from posteriflow_torch.utils import logging as TL
from torch_sim_helpers import one_torch_thread  # noqa: F401

N_WF, N_BASIS = 64, 16


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """One torch thread a test (see torch_sim_helpers.one_torch_thread)."""


def _jax_draws(seed: int, n: int) -> TS.SvdDraws:
    k_m, k_t = jax.random.split(jax.random.PRNGKey(seed))
    logm = jax.random.uniform(k_m, (n, 2), minval=np.log(5.0),
                              maxval=np.log(100.0))
    m = np.array(jnp.exp(logm))
    dt = np.array(jax.random.uniform(k_t, (n,), minval=-1.5, maxval=1.5))
    return TS.SvdDraws(torch.from_numpy(np.maximum(m[:, 0], m[:, 1])),
                       torch.from_numpy(np.minimum(m[:, 0], m[:, 1])),
                       torch.from_numpy(dt))


@pytest.fixture(scope="module")
def bases(tmp_path_factory):
    out = tmp_path_factory.mktemp("svd") / "jax_basis.npz"
    jb, js = JS.build_svd_basis(N_WF, N_BASIS, seed=0, out=str(out))
    tb, ts = TS.build_svd_basis(N_WF, N_BASIS, device="cpu",
                                draws=_jax_draws(0, N_WF))
    return jb, js, tb, ts, out


def test_svd_basis_matches_jax(bases):
    jb, js, tb, ts, _ = bases
    assert tb.shape == jb.shape == (N_BASIS, jb.shape[1])
    assert tb.dtype == np.complex64
    assert np.max(np.abs(ts - js) / js) < 1e-4
    gaps = np.minimum(np.abs(np.diff(js, prepend=np.inf)),
                      np.abs(np.diff(js, append=-np.inf))) / js
    overlap = np.abs(np.sum(np.conj(jb) * tb, axis=1))
    sep = gaps > 0.01
    assert sep.sum() >= N_BASIS // 2
    assert np.all(overlap[sep] >= 0.999)
    # the leading block's projector, where vectors may rotate in a pair
    pj = jb.T @ np.conj(jb)
    pt = tb.T @ np.conj(tb)
    assert np.linalg.norm(pj - pt) <= 1e-3 * np.linalg.norm(pj)


def test_project_and_load_jax_basis(bases):
    jb, _, tb, _, out = bases
    loaded = TS.load_svd_basis(out)
    np.testing.assert_array_equal(loaded, JS.load_svd_basis(out))
    rng = np.random.default_rng(2)
    h = (rng.normal(size=(3, 2, jb.shape[1]))
         + 1j * rng.normal(size=(3, 2, jb.shape[1]))).astype(np.complex64)
    ref = np.asarray(JS.project_onto_basis(jnp.asarray(h), jnp.asarray(jb)))
    got = TS.project_onto_basis(torch.from_numpy(h),
                                torch.from_numpy(loaded)).numpy()
    assert got.shape == ref.shape == (3, 2, 2 * N_BASIS)
    assert np.max(np.abs(got - ref)) <= 1e-5 * np.abs(ref).max()


def test_svd_draws_from_a_generator():
    """The port's own draws: ordered masses in the range, shifts in
    ±time_shift_max, the same draws from the same seed."""
    d = TS.draw_svd_inputs(32, (5.0, 100.0), 1.5,
                           torch.Generator().manual_seed(3), "cpu")
    assert torch.all(d.m1 >= d.m2) and torch.all(d.m2 >= 5.0 - 1e-4)
    assert torch.all(d.m1 <= 100.0 + 1e-3)
    assert torch.all(d.dt.abs() <= 1.5)
    again = TS.draw_svd_inputs(32, (5.0, 100.0), 1.5,
                               torch.Generator().manual_seed(3), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(d, again))


def test_lightweight_transformer_loads_flax_tree():
    """A flax tree from JAX's init, loaded into the port by
    flax_to_state_dict with flax's names: outputs within 1e-5 of the
    largest output at T = 2048, 2 layers."""
    cfg = dict(patch=256, d_model=32, n_layers=2, n_heads=4, out_dim=16)
    x = np.random.default_rng(4).normal(0, 1.5, (3, 3, 2048)).astype(
        np.float32)
    x[0, 1, 7] = np.nan
    jm = JLTE(**cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    tm = LightweightTransformerEncoder(**cfg)
    sd = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (3, 16)
    assert np.max(np.abs(got - ref)) <= 1e-5 * np.abs(ref).max()


def test_pretrained_audio_encoder_gated():
    """No cached weights: the JAX package's RuntimeError and message."""
    with pytest.raises(RuntimeError, match="locally cached") as e:
        PretrainedAudioEncoder(device="cpu")
    with pytest.raises(RuntimeError, match="locally cached") as j:
        from posteriflow_tpu.models.transformer_encoder import \
            PretrainedAudioEncoder as JPAE
        JPAE()
    assert str(e.value) == str(j.value)


def _tiny_whisper_config(**tokens):
    from transformers import WhisperConfig
    return WhisperConfig(num_mel_bins=3, d_model=32, encoder_layers=1,
                         encoder_attention_heads=2, decoder_layers=1,
                         decoder_attention_heads=2, encoder_ffn_dim=64,
                         decoder_ffn_dim=64, max_source_positions=128,
                         max_target_positions=32, vocab_size=100, **tokens)


def test_pretrained_audio_encoder_from_config():
    """tests/test_augmentations.py:113's tiny config: the shape and finite
    values from a random-initialised encoder."""
    enc = PretrainedAudioEncoder.from_config(_tiny_whisper_config(),
                                             out_dim=16, device="cpu")
    x = np.random.default_rng(0).normal(size=(2, 3, 256)).astype(np.float32)
    out = enc.encode(x)
    assert out.shape == (2, 16) and torch.isfinite(out).all()


def test_pretrained_audio_encoder_values_match_flax(tmp_path):
    """The flax Whisper model's weights carried into torch's WhisperModel
    (transformers' flax-to-torch loader), saved, and loaded by the gated
    constructor from that local directory: encode within 1e-5 of the
    largest output of the flax model's (measured 1.2e-7 of 1.09). The
    token ids are set inside the tiny vocabulary: torch's whole
    WhisperModel (its decoder embedding) rejects the default pad id 50256
    at vocab_size 100."""
    try:
        from transformers import FlaxWhisperModel, WhisperModel
        from transformers.modeling_flax_pytorch_utils import \
            load_flax_weights_in_pytorch_model
        cfg = _tiny_whisper_config(pad_token_id=1, bos_token_id=2,
                                   eos_token_id=3, decoder_start_token_id=4)
        flax_model = FlaxWhisperModel(cfg, seed=0)
    except Exception as e:    # transformers without its flax backend
        pytest.skip(f"transformers cannot build the flax model here: {e}")
    load_flax_weights_in_pytorch_model(WhisperModel(cfg), flax_model.params
                                       ).save_pretrained(tmp_path / "torch")
    x = np.random.default_rng(5).normal(size=(2, 3, 256)).astype(np.float32)
    ref = np.asarray(flax_model.encode(input_features=jnp.asarray(x))
                     .last_hidden_state.mean(axis=1))[..., :16]
    enc = PretrainedAudioEncoder(str(tmp_path / "torch"), out_dim=16,
                                 device="cpu")
    got = enc.encode(x).numpy()
    assert got.shape == ref.shape == (2, 16)
    assert np.max(np.abs(got - ref)) <= 1e-5 * np.abs(ref).max()


def test_timing_logger_and_peak_rss():
    """peak_rss_mb in JAX's units. JAX's TimingLogger has no twin in the
    port: its counterpart is the span recorder (ROADMAP §1; its tests are
    tests/test_torch_spans.py)."""
    assert hasattr(JL, "TimingLogger") and not hasattr(TL, "TimingLogger")
    rss = TL.peak_rss_mb()
    assert abs(rss - JL.peak_rss_mb()) <= 1e-6 * rss + 64.0
    assert 10.0 < rss < 1e6
    json.dumps({"peak_rss_mb": rss})
