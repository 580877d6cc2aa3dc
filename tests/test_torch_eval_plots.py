"""The port's plots against the JAX package's, pixel for pixel.

For 11-D inputs every figure (pp_plot, sbc_histograms, marginal_cdfs,
PosteriorResult.plot_corner and plot_marginals) is drawn by both packages
from the same numpy arrays and read back with matplotlib.image.imread:
the pixel arrays are equal. reconstruction_overlay draws waveforms that
each package makes in float32 (the 1.2e-3-of-peak phase gap the simulator
tests allow), so its two images are held to differ in at most 0.5% of
their pixels (0.05% measured). Where JAX's fixed 3 × 4 grid has too few axes (15 panels)
it raises IndexError; the port draws ⌈15/4⌉ = 4 rows of 4 at the same
panel size. to_bilby raises JAX's ImportError without bilby.
"""

import sys

import matplotlib.image as mpimg
import numpy as np
import pytest

from posteriflow_tpu.inference import plots as jplots
from posteriflow_tpu.inference.result import PosteriorResult as JResult
from posteriflow_torch import PARAM_NAMES, PARAM_NAMES_PRECESSING
from posteriflow_torch.inference import plots as tplots
from posteriflow_torch.inference.result import PosteriorResult

N_POST = 50


def _samples(p: int, n: int = 400, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base = np.array([35.0, 28.0, 500.0, 1.2, 0.3, 0.6, 0.5, 1.0, 0.01, 0.3,
                     0.2, 1.0, 2.0, 3.0, 4.0])[:p]
    return base * (1 + 0.1 * rng.standard_normal((n, p)))


def _ranks(p: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    ranks = rng.integers(0, N_POST + 1, (64, p))
    live = (rng.random(64) > 0.1).astype(np.float32)
    return ranks, live


def _same_pixels(tmp_path, draw_port, draw_jax):
    draw_port(tmp_path / "port.png")
    draw_jax(tmp_path / "jax.png")
    got, want = mpimg.imread(tmp_path / "port.png"), mpimg.imread(
        tmp_path / "jax.png")
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


FIGURES = {
    "pp_plot": lambda m, s, r, l: lambda path: m.pp_plot(r, l, N_POST, path),
    "sbc_histograms": lambda m, s, r, l: lambda path: m.sbc_histograms(
        r[l > 0], N_POST, path),
    "marginal_cdfs": lambda m, s, r, l: lambda path: m.marginal_cdfs(
        s, path, truths=s[0]),
}


@pytest.mark.parametrize("name", sorted(FIGURES))
def test_plot_functions_match_jax_pixels(name, tmp_path):
    s, (r, l) = _samples(11), _ranks(11)
    _same_pixels(tmp_path, FIGURES[name](tplots, s, r, l),
                 FIGURES[name](jplots, s, r, l))


@pytest.mark.parametrize("method", ["plot_corner", "plot_marginals"])
def test_result_plots_match_jax_pixels(method, tmp_path):
    s = _samples(11)
    _same_pixels(tmp_path, getattr(PosteriorResult(samples=s), method),
                 getattr(JResult(samples=s), method))


def test_reconstruction_overlay_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    strain = rng.standard_normal((3, 16384)).astype(np.float32)
    s = _samples(11)
    s[:, 8] = 0.01 * rng.standard_normal(len(s))
    tplots.reconstruction_overlay(strain, s, tmp_path / "port.png",
                                  n_draws=2, device="cpu")
    jplots.reconstruction_overlay(strain, s, tmp_path / "jax.png", n_draws=2)
    got, want = mpimg.imread(tmp_path / "port.png"), mpimg.imread(
        tmp_path / "jax.png")
    assert got.shape == want.shape
    assert np.mean(np.any(got != want, axis=-1)) <= 0.005


def test_15d_panels_grow_where_jax_raises(tmp_path):
    """JAX's 3 × 4 grids raise IndexError on 15 panels; the port's grow to
    4 × 4 at JAX's panel size, and with the default 11 names both packages
    draw the first 11 of 15 columns on 3 × 4."""
    s = _samples(15)
    r, l = _ranks(15)
    res, jres = (PosteriorResult(samples=s, param_names=PARAM_NAMES_PRECESSING),
                 JResult(samples=s, param_names=PARAM_NAMES_PRECESSING))
    with pytest.raises(IndexError):
        jres.plot_marginals(tmp_path / "jax.png")
    with pytest.raises(IndexError):
        jplots.sbc_histograms(r, N_POST, tmp_path / "j.png",
                              param_names=PARAM_NAMES_PRECESSING)
    res.plot_marginals(tmp_path / "m15.png")
    tplots.sbc_histograms(r, N_POST, tmp_path / "s15.png",
                          param_names=PARAM_NAMES_PRECESSING)
    tplots.marginal_cdfs(s, tmp_path / "c15.png",
                         param_names=PARAM_NAMES_PRECESSING)
    for f in ("m15.png", "s15.png", "c15.png"):
        # JAX's (14, 8) inches at 110 dpi, one row of 8/3 inches taller
        assert mpimg.imread(tmp_path / f).shape[:2] == (1173, 1540)
    assert tplots.grid_rows(11) == 3 and tplots.grid_rows(15) == 4
    assert tplots.grid_rows(4) == 3 and tplots.grid_rows(17) == 5
    # the default names: both draw the first 11 columns, the same pixels
    _same_pixels(tmp_path, lambda p: tplots.sbc_histograms(r, N_POST, p),
                 lambda p: jplots.sbc_histograms(r, N_POST, p))
    assert PARAM_NAMES == PARAM_NAMES_PRECESSING[:11]


def test_to_bilby_raises_jax_import_error_without_bilby(monkeypatch):
    monkeypatch.setitem(sys.modules, "bilby", None)
    s = _samples(11)
    with pytest.raises(ImportError) as want:
        JResult(samples=s).to_bilby()
    with pytest.raises(ImportError) as got:
        PosteriorResult(samples=s).to_bilby()
    assert str(got.value) == str(want.value)
