"""The port's twins of scripts/validate_pipeline_physics.py,
precession_robustness.py, generate_dataset.py and
benchmark_real_events.py, on the CPU at small sizes.

validate_pipeline_physics --device cpu passes the nine checks JAX's
script passes, in JAX's order and with JAX's report keys; the
deterministic checks (3, 4, 8, 9) within 1e-4 relative of JAX's values,
the drawn ones (1, 2, 5, 6, 7) on other draws, so each only against its
own threshold. precession_robustness: the noise-free injected SNRs
within 1e-4 relative of reports/precession_robustness.json (measured
7.9e-6, 9.0e-7, 9.6e-7 for chi_p 0, 0.3, 0.6), JAX's keys."""

import importlib.util
import json
import math
import sys

import h5py
import numpy as np
import pytest

from posteriflow_torch.tools import (benchmark_real_events,
                                     generate_dataset, precession_robustness,
                                     validate_pipeline_physics)
from torch_sim_helpers import one_torch_thread  # noqa: F401
from torch_long_bns_helpers import REPO

DETERMINISTIC = {"inverse_distance_amplitude", "geometric_time_delays",
                 "phenomd_inspiral_consistency", "phenomd_amplitude_peak"}


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """One torch thread a test (see torch_sim_helpers.one_torch_thread)."""


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_validate_pipeline_physics_matches_jax(tmp_path, capsys):
    assert _jax_script("validate_pipeline_physics").main(
        ["--out", str(tmp_path / "jax.json")]) == 0
    ref = json.loads((tmp_path / "jax.json").read_text())
    code = validate_pipeline_physics.main(["--device", "cpu", "--out",
                                           str(tmp_path / "port.json")])
    got = json.loads((tmp_path / "port.json").read_text())
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.rindex('{\n  "passed"'):]) == got
    assert code == 0 and got["passed"] and ref["passed"]
    assert set(got) == set(ref) and got["backend"] == "cpu"
    assert [c["check"] for c in got["checks"]] == \
        [c["check"] for c in ref["checks"]]
    assert len(got["checks"]) == 9
    for g, r in zip(got["checks"], ref["checks"]):
        assert g["passed"] == r["passed"], g["check"]
        assert set(g["detail"]) == set(r["detail"]), g["check"]
        if g["check"] in DETERMINISTIC:
            for k, v in r["detail"].items():
                assert math.isclose(g["detail"][k], v, rel_tol=1e-4), (
                    g["check"], k)


def test_validate_pipeline_physics_exit_code(monkeypatch):
    """A failing check turns into exit code 1."""
    import posteriflow_torch.physics.whiten as W
    monkeypatch.setattr(W, "whiten_td", lambda x, asd: 2.0 * x / asd.max())
    assert validate_pipeline_physics.main(["--device", "cpu"]) == 1


def test_precession_robustness_snrs_match_report(tmp_path):
    out = tmp_path / "prec.json"
    got = precession_robustness.main(["--device", "cpu", "--n-samples",
                                      "64", "--out", str(out)])
    ref = json.loads((REPO / "reports/precession_robustness.json")
                     .read_text())
    assert json.loads(out.read_text()) == got
    assert set(got) == set(ref) and got["truth"] == ref["truth"]
    assert [c["chi_p"] for c in got["cases"]] == [0.0, 0.3, 0.6]
    for g, r in zip(got["cases"], ref["cases"]):
        assert set(g) == set(r)
        assert abs(g["injected_snr"] - r["injected_snr"]) \
            <= 1e-4 * r["injected_snr"]
        assert g["verdict"] in ("HIGH", "MEDIUM", "LOW")
        assert np.isfinite(g["max_abs_z"])


def test_generate_dataset_writes_components(tmp_path, capsys):
    out = tmp_path / "ds.h5"
    stats = generate_dataset.main(["--out", str(out), "--n", "6", "--batch",
                                   "4", "--components", "--device", "cpu"])
    assert set(stats) == {"n_signals_dist", "generated", "seconds",
                          "events_per_second", "mean_net_snr"}
    assert stats["generated"] == 6
    assert sum(stats["n_signals_dist"].values()) == 6
    with h5py.File(out) as f:
        assert f.attrs["n_events"] == 6
        strain, noise, sig = f["strain"][:], f["noise"][:], f["signals"][:]
        n_sig = f["n_sig"][:]
        assert strain.shape == (6, 3, 16384) and sig.shape == (6, 5, 3,
                                                                16384)
        for i, n in enumerate(n_sig):
            assert not np.any(sig[i, n:])
        recon = noise.astype(np.float32) + sig.astype(np.float32).sum(1)
        assert np.max(np.abs(recon - strain)) <= 2e-2 * np.abs(strain).max()
    meta = json.loads((tmp_path / "ds.h5.meta.json").read_text())
    assert meta["generated"] == 6


def test_benchmark_real_events_injection_mode(tmp_path):
    summary = benchmark_real_events.main(
        ["--ckpt", str(REPO / "model_release/npe_r7_best"), "--device",
         "cpu", "--events", "GW150914", "--n-samples", "64", "--nlive",
         "32", "--maxiter", "12", "--out", str(tmp_path / "b")])
    rec = summary["GW150914"]
    assert set(rec) == {"event", "t_npe_s", "t_nested_s", "speedup",
                        "nested_sampler", "verdict", "comparison"}
    assert set(rec["comparison"]) == {"mass_1", "mass_2",
                                      "luminosity_distance"}
    assert (tmp_path / "b" / "GW150914" / "samples.npy").is_file()
    assert json.loads((tmp_path / "b" / "summary.json").read_text())[
        "GW150914"]["event"] == "GW150914"


def test_benchmark_real_events_fetch_needs_gwpy(tmp_path, monkeypatch):
    """--fetch reaches fetch_gwosc, which raises gwpy's ImportError here
    (gwpy blocked), as the JAX script does without gwpy."""
    monkeypatch.setitem(sys.modules, "gwpy", None)
    monkeypatch.setitem(sys.modules, "gwpy.timeseries", None)
    with pytest.raises(ImportError):
        benchmark_real_events.main(
            ["--ckpt", str(REPO / "model_release/npe_r7_best"), "--device",
             "cpu", "--events", "GW150914", "--fetch", "--out",
             str(tmp_path / "b")])
