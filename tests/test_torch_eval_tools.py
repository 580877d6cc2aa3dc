"""The evaluation tools of the port on the CPU, on tiny port checkpoints of
the test configs (conv 11-D, coherent 15-D precessing), against the JAX
package's artifacts of the same tools:

- npe_diagnostics writes pp.png, sbc.png and diagnostics.json with the
  keys of reports/diag_r2/diagnostics.json (JAX's); as in JAX, sbc_ks_p
  names the 11 aligned parameters on a 15-D checkpoint.
- twin_grid at --mc-grid 2 --q-grid 1: the keys of analysis/twin_grid.json,
  and each point's SNR-rescaled distance (no noise, no model) within 2e-3
  relative of JAX's — computed with the JAX package's signal_white_fd on
  the same parameters and seeded tilts, and for the first point (Mc 12,
  q 0.35, the first tilts of default_rng(7)) read from JAX's artifact.
- importance_validation on one case with --cross-check: the keys of
  analysis/importance_validation.json, with importance_correct and
  run_smc_prior shrunk to test size through monkeypatch.
- tools/infer.py --plots on the 15-D checkpoint, where JAX's
  plot_marginals raises IndexError: corner.png and a 4 × 4 marginals.png.
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import matplotlib.image as mpimg
import numpy as np
import pytest

from posteriflow_tpu.physics.psd import default_network_asd as jasd
from posteriflow_tpu.physics.simulator import signal_white_fd as jwhite
from posteriflow_torch import PARAM_NAMES, PARAM_NAMES_PRECESSING
from posteriflow_torch.inference import importance as imp
from posteriflow_torch.tools import importance_validation as iv
from posteriflow_torch.tools import infer as cli
from posteriflow_torch.tools import npe_diagnostics, twin_grid
from torch_eval_helpers import port_checkpoint
from torch_sim_helpers import one_torch_thread

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """One torch thread a test (see torch_sim_helpers.one_torch_thread):
    a tool run on the CPU takes 5 to 20 times its time when the suite's
    workers each spread its small ops over every core."""


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpts")
    return {k: port_checkpoint(root, k) for k in ("conv", "coherent")}


def test_npe_diagnostics_writes_jax_keys(ckpts, tmp_path):
    out = tmp_path / "diag"
    report = npe_diagnostics.main(["--ckpt", str(ckpts["coherent"]),
                                   "--n-events", "24", "--n-post", "16",
                                   "--device", "cpu", "--out", str(out)])
    ref = json.loads((ROOT / "reports" / "diag_r2" / "diagnostics.json")
                     .read_text())
    assert json.loads((out / "diagnostics.json").read_text()) == report
    assert report.keys() == ref.keys()
    assert report["coverage"].keys() == ref["coverage"].keys()
    assert all(len(v) == 15 for v in report["coverage"].values())
    assert tuple(report["sbc_ks_p"]) == PARAM_NAMES            # as JAX's
    assert (report["epoch"], report["n_events"], report["n_post"]) == (1, 24,
                                                                       16)
    for name in ("pp.png", "sbc.png"):
        assert mpimg.imread(out / name).ndim == 3


def _jax_distances(grid, target_snr: float = 24.0):
    """The twin grid's distances as scripts/twin_grid.py computes them,
    with the JAX package's waveform, for the 15-D points of `grid`."""
    asd = jasd()
    snr = jax.jit(lambda th: jnp.sqrt(jnp.sum(jnp.abs(jwhite(th, asd)) ** 2)))
    rng = np.random.default_rng(7)
    out = []
    for g in grid:
        mc, q = g["mc"], g["q"]
        m1 = mc * (1 + q) ** 0.2 / q ** 0.6
        p = dict(mass_1=m1, mass_2=q * m1, luminosity_distance=500.0,
                 ra=1.3, dec=-0.2, theta_jn=0.8, psi=0.5, phase=1.0,
                 geocent_time=0.1, a1=0.4, a2=0.2,
                 tilt_1=float(np.arccos(rng.uniform(-1, 1))),
                 tilt_2=float(np.arccos(rng.uniform(-1, 1))),
                 phi_12=float(rng.uniform(0, 2 * np.pi)),
                 phi_jl=float(rng.uniform(0, 2 * np.pi)))
        theta = jnp.asarray([p[k] for k in PARAM_NAMES_PRECESSING],
                            dtype=jnp.float32)
        out.append(float(np.clip(500.0 * float(snr(theta)) / target_snr,
                                 45.0, 2100.0)))
    return out


def test_twin_grid_distances_match_jax(ckpts, tmp_path):
    out = tmp_path / "twin_grid.json"
    report = twin_grid.main(["--ckpt", str(ckpts["coherent"]), "--mc-grid",
                             "2", "--q-grid", "1", "--n-samples", "32",
                             "--device", "cpu", "--out", str(out)])
    ref = json.loads((ROOT / "analysis" / "twin_grid.json").read_text())
    assert json.loads(out.read_text()) == report
    assert report.keys() == ref.keys()
    assert report["_meta"].keys() == ref["_meta"].keys()
    assert [(g["mc"], g["q"]) for g in report["grid"]] == [(12.0, 0.35),
                                                           (45.0, 0.35)]
    for g in report["grid"]:
        assert g.keys() == ref["grid"][0].keys()
        assert len(g["twins"]) == 2 and all(
            np.isfinite(list(t.values())).all() for t in g["twins"])
    dist = [g["distance"] for g in report["grid"]]
    want = _jax_distances(report["grid"])
    assert np.allclose(dist, want, rtol=2e-3, atol=0)
    assert abs(dist[0] / ref["grid"][0]["distance"] - 1.0) <= 2e-3


def test_importance_validation_writes_jax_keys(ckpts, tmp_path,
                                               monkeypatch):
    monkeypatch.setattr(imp, "importance_correct", functools.partial(
        imp.importance_correct, pad_block=64, max_stages=2))
    monkeypatch.setattr(imp, "run_smc_prior", functools.partial(
        imp.run_smc_prior, n=128, max_stages=2))
    out = tmp_path / "iv.json"
    report = iv.main(["--ckpt", str(ckpts["conv"]), "--n-samples", "128",
                      "--cases", "gw170608_like", "--cross-check",
                      "--device", "cpu", "--out", str(out)])
    ref = json.loads((ROOT / "analysis" / "importance_validation.json")
                     .read_text())
    assert json.loads(out.read_text()) == json.loads(json.dumps(report))
    assert list(report) == ["_meta", "gw170608_like"]
    assert report["_meta"].keys() == ref["_meta"].keys()
    case = report["gw170608_like"]
    assert case.keys() == ref["gw170608_like"].keys()
    assert case["smc_prior"].keys() == ref["gw170608_like"]["smc_prior"].keys()
    assert case["truth_mc"] == ref["gw170608_like"]["truth_mc"]
    assert case["n"] > 0 and case["n_stages"] >= 1


def test_infer_plots_on_a_15d_checkpoint(ckpts, tmp_path):
    out = tmp_path / "inj"
    cli.main(["--ckpt", str(ckpts["coherent"]), "--inject", "--plots",
              "--device", "cpu", "--n-samples", "64", "--out", str(out)])
    assert np.load(out / "samples.npy").shape == (64, 15)
    assert mpimg.imread(out / "corner.png").ndim == 3
    # JAX's 3 × 4 grid raises here; the port draws 4 rows of 4
    assert mpimg.imread(out / "marginals.png").shape[:2] == (1173, 1540)
