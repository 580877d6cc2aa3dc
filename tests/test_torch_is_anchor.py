"""The anchor comparison and the command line of the importance slice:
`run_comparison(sampler="smc_prior", importance=True)` on the JAX tests'
TINY engine returns the JAX package's keys, and `tools/infer.py` serves
and importance-corrects on the CPU, writing normalized weights, --plots
draws the corner and marginal plots (one corner plot a rank with
--n-signals), and --event raises the JAX package's ImportError without
gwpy.

The samplers run at test size on the CPU: run_smc_prior with 128
particles and at most 3 stages, importance_correct at pad_block 64 or 128
and at most 2 or 3 stages, in both packages (one [3, 8193] waveform costs
~3 ms here)."""

import dataclasses
import functools
import json
import sys

import jax
import numpy as np
import pytest
from flax.serialization import to_bytes

from posteriflow_tpu.inference import dynesty_bridge as jdb
from posteriflow_tpu.inference import importance as J
from posteriflow_tpu.inference.preprocessing import prepare_simulated as jprep
from posteriflow_tpu.train.checkpoints import _cfg_to_dict
from posteriflow_torch.inference import dynesty_bridge as tdb
from posteriflow_torch.inference import importance as T
from posteriflow_torch.inference.preprocessing import PreparedData
from posteriflow_torch.physics.psd import psd_for
from posteriflow_torch.tools import infer as cli
from torch_is_helpers import BBH, TINY, engines

WEAK = dict(BBH, luminosity_distance=1800.0)


@pytest.fixture(scope="module")
def tiny():
    return engines()


def _shrink(monkeypatch, module, pad_block: int, is_stages: int):
    monkeypatch.setattr(module, "run_smc_prior", functools.partial(
        module.run_smc_prior, n=128, max_stages=3))
    monkeypatch.setattr(module, "importance_correct", functools.partial(
        module.importance_correct, pad_block=pad_block,
        max_stages=is_stages))


def test_run_comparison_smc_prior_returns_jax_keys(tiny, monkeypatch):
    jeng, teng = tiny
    _shrink(monkeypatch, J, 128, 2)
    _shrink(monkeypatch, T, 128, 2)
    prep = jprep([WEAK], seed=6)
    tprep = PreparedData(**{f.name: getattr(prep, f.name)
                            for f in dataclasses.fields(PreparedData)})
    kw = dict(n_samples=256, seed=1, sampler="smc_prior", importance=True)
    ref = jdb.run_comparison(jeng, prep, **kw)
    got = tdb.run_comparison(teng, tprep, **kw)
    assert got.keys() == ref.keys()
    for k in ("nested", "is"):
        assert got[k].keys() == ref[k].keys(), k
    for k in ("comparison", "is_comparison"):
        assert got[k].keys() == ref[k].keys(), k
        for name in got[k]:
            assert got[k][name].keys() == ref[k][name].keys()
            assert all(np.isfinite(v) for v in got[k][name].values())
    assert got["nested"]["sampler"] == "smc_prior"
    assert got["nested"]["samples"].shape[1] == 11
    assert np.isfinite(got["logz_gap"]) and got["is"]["n_stages"] >= 1
    assert got["npe"].samples.shape == (256, 11)


def _write_release(params, root):
    d = root / "tiny_release"
    d.mkdir()
    (d / "params.msgpack").write_bytes(to_bytes(jax.device_get(params)))
    (d / "meta.json").write_text(json.dumps({"config": _cfg_to_dict(TINY)}))
    return d


@pytest.fixture(scope="module")
def release(tiny, tmp_path_factory):
    return _write_release(tiny[0].params, tmp_path_factory.mktemp("rel"))


def test_cli_injection_with_importance_writes_weights(release, tmp_path,
                                                      monkeypatch):
    _shrink(monkeypatch, T, 64, 3)
    out = tmp_path / "inj"
    res = cli.main(["--ckpt", str(release), "--inject", "--importance",
                    "--device", "cpu", "--n-samples", "400", "--seed", "3",
                    "--out", str(out)])
    w = np.load(out / "weights.npy")
    samples = np.load(out / "samples.npy")
    # the untrained flow rails most draws; the ~20 kept are too few for
    # direct IS, so the tempered path runs, on a cloud of pad_block 64
    assert samples.shape == (64, 11) and len(w) == 64
    assert np.all(w >= 0) and abs(w.sum() - 1.0) < 1e-9
    np.testing.assert_array_equal(w, res.weights)
    record = json.loads((out / "result.json").read_text())
    imp = record["diagnostics"]["importance"]
    assert imp["n_stages"] == 3 and len(imp["beta_ladder"]) == 3
    assert np.isfinite(imp["ess"]) and np.isfinite(imp["log_evidence_ratio"])
    assert not (out / "log_prob.npy").exists()


def test_cli_strain_with_asd_override(release, tmp_path):
    n, fs = 16 * 4096, 4096
    f = np.fft.rfftfreq(n, 1.0 / fs)
    rng = np.random.default_rng(0)
    arr = np.stack([np.fft.irfft(np.sqrt(n * fs * psd_for(d, f) / 4.0)
                                 * (rng.standard_normal(f.size)
                                    + 1j * rng.standard_normal(f.size)),
                                 n=n) for d in ("H1", "L1", "V1")])
    np.save(tmp_path / "strain.npy", arr)
    asd = tmp_path / "l1_asd.txt"
    np.savetxt(asd, np.column_stack([f[40:], np.sqrt(psd_for("L1", f))[40:]]))
    out = tmp_path / "ev"
    res = cli.main(["--ckpt", str(release), "--strain",
                    str(tmp_path / "strain.npy"), "--gps", "1369224018",
                    "--asd", f"L1:{asd}", "--device", "cpu",
                    "--n-samples", "32", "--out", str(out)])
    assert np.load(out / "samples.npy").shape == (32, 11)
    assert res.gps_time == 1369224018.0 and res.weights is None
    assert not (out / "weights.npy").exists()


@pytest.mark.parametrize("n_signals", [1, 2])
def test_cli_plots_writes_corner_and_marginals(release, tmp_path,
                                               n_signals):
    """--plots draws what infer.py draws: corner.png and marginals.png
    beside the samples, or rank{r}/corner.png for each rank."""
    out = tmp_path / "plots"
    cli.main(["--ckpt", str(release), "--inject", "--plots", "--device",
              "cpu", "--n-samples", "64", "--n-signals", str(n_signals),
              "--out", str(out)])
    if n_signals == 1:
        names = ["corner.png", "marginals.png"]
    else:
        names = [f"rank{r}/corner.png" for r in range(n_signals)]
        assert not (out / "corner.png").exists()
    for name in names:
        assert (out / name).stat().st_size > 0, name


def test_cli_event_raises_jax_import_error_without_gwpy(monkeypatch,
                                                        tmp_path):
    """--event fetches through fetch_gwosc, which without gwpy raises the
    JAX package's ImportError (before any model is loaded)."""
    from posteriflow_tpu.inference.preprocessing import fetch_gwosc as jfetch
    monkeypatch.setitem(sys.modules, "gwpy", None)
    monkeypatch.setitem(sys.modules, "gwpy.timeseries", None)
    with pytest.raises(ImportError) as want:
        jfetch(event="GW150914")
    with pytest.raises(ImportError) as got:
        cli.main(["--ckpt", str(tmp_path), "--device", "cpu", "--event",
                  "GW150914"])
    assert str(got.value) == str(want.value)
    assert "fetch_gwosc requires gwpy" in str(got.value)
