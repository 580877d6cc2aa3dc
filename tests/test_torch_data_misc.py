"""The rest of the port's data layer against the JAX package on the CPU:
tools/make_noise_bank.py --synthetic writes the bytes that
scripts/download_gwosc_noise_bank.py writes, and its real mode raises the
JAX script's ImportError without gwpy; the GWTC catalog and the SNR
utilities return equal results; the HDF5 dataset I/O round-trips (h5py is
imported inside the port's functions, and this environment has it).

Every comparison is exact: the modules are numpy copies.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

from posteriflow_tpu.data import gwtc as jgwtc
from posteriflow_tpu.data import snr_utils as jsnr
from posteriflow_torch.data import gwtc as tgwtc
from posteriflow_torch.data import io as tio
from posteriflow_torch.data import snr_utils as tsnr
from posteriflow_torch.tools import make_noise_bank
from torch_sim_helpers import one_torch_thread

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """One torch thread a test (see torch_sim_helpers.one_torch_thread)."""


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "download_gwosc_noise_bank",
        ROOT / "scripts" / "download_gwosc_noise_bank.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_make_noise_bank_synthetic_bytes_equal_jax(tmp_path):
    args = ["--synthetic", "2", "--segment-seconds", "16", "--seed", "3"]
    make_noise_bank.main(["--out", str(tmp_path / "t"), *args])
    _jax_script().main(["--out", str(tmp_path / "j"), *args])
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert len(names) == 3 * 2 * 2 + 3
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == \
            (tmp_path / "j" / n).read_bytes(), n


def test_make_noise_bank_real_mode_needs_gwpy(tmp_path, monkeypatch):
    gps = tmp_path / "gps.txt"
    gps.write_text("1262000000\n")
    monkeypatch.setitem(sys.modules, "gwpy", None)
    monkeypatch.setitem(sys.modules, "gwpy.timeseries", None)
    argv = ["--out", str(tmp_path / "b"), "--gps-list", str(gps)]
    with pytest.raises(ImportError) as want:
        _jax_script().main(argv)
    with pytest.raises(ImportError) as got:
        make_noise_bank.main(argv)
    assert str(got.value) == str(want.value)
    with pytest.raises(SystemExit):
        make_noise_bank.main(["--out", str(tmp_path / "b")])


def test_gwtc_equals_jax():
    t, j = tgwtc.GWTCLoader(), jgwtc.GWTCLoader()
    assert t.list_events() == j.list_events()
    assert len(t.list_events()) > 80
    for name in t.list_events() + ["GW230601_123456"]:
        assert t.get_event(name) == j.get_event(name), name
    assert t.get_event_gps_time("GW150914") == 1126259462.4
    for cat in ("GWTC-1", "GWTC-3", "GWTC-4"):
        assert t.list_events(cat) == j.list_events(cat)
    names = ["GW150914", "GW190814", "GW200115"]
    assert t.synthetic_overlap_scenario(names, seed=4) == \
        j.synthetic_overlap_scenario(names, seed=4)
    with pytest.raises(KeyError, match="unknown event"):
        t.get_event("not-an-event")
    assert tgwtc.gps_from_name("GW200129_065458") == \
        jgwtc.gps_from_name("GW200129_065458")


def test_snr_utils_equal_jax():
    rng = np.random.default_rng(0)
    snrs = rng.uniform(0, 60, 40)
    for s in list(snrs) + [0.0, 8.0, 12.0, 20.0, 35.0, -1.0]:
        assert tsnr.classify_snr_regime(s) == jsnr.classify_snr_regime(s)
    assert tsnr.network_snr([3.0, 4.0, 12.0]) == jsnr.network_snr(
        [3.0, 4.0, 12.0]) == 13.0
    for m1, m2, d in rng.uniform([5, 1, 10], [80, 40, 3000], (10, 3)):
        assert tsnr.estimate_snr_from_params(m1, m2, d) == \
            jsnr.estimate_snr_from_params(m1, m2, d)
        assert tsnr.estimate_regime_from_params(m1, m2, d) == \
            jsnr.estimate_regime_from_params(m1, m2, d)
    np.testing.assert_array_equal(tsnr.normalize_priorities(snrs),
                                  jsnr.normalize_priorities(snrs))
    assert tsnr.normalize_priorities([]).size == 0
    assert tsnr.regime_fractions(snrs) == jsnr.regime_fractions(snrs)


def test_dataset_io_round_trip(tmp_path):
    pytest.importorskip("h5py")
    rng = np.random.default_rng(1)
    n, s = 6, 3
    params = rng.uniform(1, 50, (n, s, 11)).astype(np.float32)
    params[..., 2] = 400.0
    params[..., 0] = np.maximum(params[..., 0], params[..., 1])
    batch = dict(strain=rng.standard_normal((n, 3, 64)).astype(np.float32),
                 params=params,
                 n_sig=rng.integers(0, s + 1, n).astype(np.int32),
                 net_snr=rng.uniform(8, 30, n).astype(np.float32),
                 sig_snr=rng.uniform(8, 30, (n, s)).astype(np.float32))
    path = tmp_path / "ds.h5"
    with tio.DatasetWriter(path, config={"k": 1}) as w:
        w.append_batch({k: v[:4] for k, v in batch.items()})
        w.append_batch({k: v[4:] for k, v in batch.items()})
    r = tio.DatasetReader(path)
    assert len(r) == n and r.config == {"k": 1}
    assert sorted(r.keys()) == sorted(batch)
    assert r.read("strain").dtype == np.float16
    np.testing.assert_array_equal(r.read("params"), params)
    np.testing.assert_array_equal(r.read("strain"),
                                  batch["strain"].astype(np.float16))
    assert sum(len(b["n_sig"]) for b in r.batches(4)) == n
    r.close()
    report = tio.validate_dataset(path)
    assert report["n_checked"] == n and report["valid"]
    tio.MetadataManager(path).write({"note": "x"})
    assert tio.MetadataManager(path).read()["note"] == "x"
    # a swapped mass pair is repaired
    params[0, 0, :2] = [5.0, 9.0]
    with tio.DatasetWriter(tmp_path / "bad.h5") as w:
        w.append_batch(dict(batch, params=params))
    out = tio.repair_dataset(tmp_path / "bad.h5")
    assert out["swapped"] == 1 and out["n_out"] == n
    fixed = tio.DatasetReader(out["out_path"])
    assert fixed.read("params")[0, 0, 0] == 9.0
    fixed.close()
