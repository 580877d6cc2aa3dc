"""The v3 long-BNS front end of the port (build_chirp_token_grid,
chirp_tokens, simulate_long_bns_batch_v3) against the JAX package, the
twins of tests/test_long_bns.py's v3 tests, the v3 paths of
tools/train_long_bns.py and tools/validate_long_bns.py, and
tools/release_long_bns.py, whose params.msgpack the JAX package reads.

Tolerances. The grid's integer fields, counts and features equal JAX's
(float64 numpy of the Newtonian chirp times in both); its heterodyne
carries each package's float32 TaylorF2 phase, whose largest difference
is printed and held under 0.05 rad (measured 7.8e-3 rad at both sizes:
one float32 step of Ψ near 6.5e4 rad). chirp_tokens on JAX's grid: the coherent channels
within 1e-5 of the largest |coherent token| plus 2e-5 (the pooling's
tolerance, tests/test_torch_long_bns_front.py), the energy channels
within 2e-3 (JAX's float32 running sum of |x|² over the 31,488 bins of
the default grid reaches ~6.3e4, where a float32 step is 3.9e-3, and a
one-bin pool halves it; the port sums in float64), features exact. A v3
batch from the same θ and noise: the v1/v4 simulators' bar (2e-2 of the
largest coherent token of the signal alone). The
release read by JAX: the NLL within 1e-5 nats of the port's (JAX run op
by op, as tests/test_torch_long_bns_model.py runs it).
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.serialization import from_bytes

from posteriflow_tpu.models import long_bns as jlb
from posteriflow_torch.models import long_bns as tlb
from posteriflow_torch.physics.waveforms.taylorf2 import \
    taylorf2_polarizations
from posteriflow_torch.physics.projection import project_to_network
from posteriflow_torch.physics.whiten import whiten_fd
from posteriflow_torch.tools import release_long_bns, train_long_bns
from posteriflow_torch.tools import validate_long_bns as val
from posteriflow_torch.train.checkpoints import load_long_bns
from test_torch_long_bns_sim import THETA, _jax_white, _noise
from torch_long_bns_helpers import REPO, V4_RELEASE
from torch_sim_helpers import one_torch_thread  # noqa: F401

SMALL = dict(duration=16.0, f_hi=256.0, pad_multiple=32)
TINY_V3 = ["--device", "cpu", "--tokens", "v3", "--duration", "16",
           "--f-hi", "256", "--batch", "2", "--d-model", "16",
           "--n-layers", "1", "--n-heads", "2", "--cal-events", "4",
           "--cal-post", "8", "--eval-every", "2"]
GRID_INTS = ("i_lo", "cut", "L", "n_tok", "starts", "ends")
GRID_EXACT = GRID_INTS + ("counts", "feat", "freqs", "mc_fid", "m_fid",
                          "duration", "config")


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """One torch thread a test (see torch_sim_helpers.one_torch_thread)."""


@pytest.fixture(scope="module")
def grids():
    """(port, JAX) grids at the JAX tests' small size and at the
    defaults."""
    return {name: (tlb.build_chirp_token_grid(**kw),
                   jlb.build_chirp_token_grid(**kw))
            for name, kw in (("small", SMALL), ("default", {}))}


@pytest.mark.parametrize("name", ["small", "default"])
def test_grid_against_jax(grids, name):
    """The segmentation, counts, features and scalars equal JAX's; the
    heterodyne's phase within 0.05 rad (printed); ~5k tokens at the
    defaults (JAX's docstring: ~4.8k)."""
    tg, jg = grids[name]
    assert set(tg) == set(jg)
    for k in GRID_EXACT:
        np.testing.assert_array_equal(np.asarray(tg[k]), np.asarray(jg[k]),
                                      err_msg=k)
    assert tg["het"].dtype == jg["het"].dtype == np.complex64
    dphi = np.abs(np.angle(tg["het"] * np.conj(jg["het"]))).max()
    print(f"{name}: n_tok {tg['n_tok']}, L {tg['L']}, largest phase "
          f"difference of the heterodyne {dphi:.3e} rad")
    assert dphi < 0.05
    if name == "default":
        assert 4000 < tg["n_tok"] < 6000 and tg["L"] % 64 == 0


def _strain(rng, grid, b=None):
    shape = (3, grid["cut"]) if b is None else (b, 3, grid["cut"])
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def test_chirp_tokens_on_jax_grid(grids):
    """chirp_tokens on JAX's default grid against JAX's tokens."""
    _, jg = grids["default"]
    h = _strain(np.random.default_rng(2), jg, 2)
    jt = np.asarray(jax.jit(jax.vmap(lambda a: jlb.chirp_tokens(a, jg)))(h))
    tt = tlb.chirp_tokens(torch.from_numpy(h), jg).numpy()
    assert tt.shape == jt.shape == (2, jg["L"], 11)
    coh = np.abs(jt[..., :6]).max()
    np.testing.assert_allclose(tt[..., :6], jt[..., :6],
                               atol=1e-5 * coh + 2e-5)
    np.testing.assert_allclose(tt[..., 6:9], jt[..., 6:9], atol=2e-3)
    np.testing.assert_array_equal(tt[..., 9:], jt[..., 9:])


def test_chirp_tokens_pooling_exactness(grids):
    """Twin of tests/test_long_bns.py's: the cumsum + gather pooling
    equals brute-force per-segment sums (the port pools in float64)."""
    grid, _ = grids["small"]
    h = _strain(np.random.default_rng(0), grid)
    tok = tlb.chirp_tokens(torch.from_numpy(h), grid).numpy()
    assert tok.shape == (grid["L"], 11) and np.isfinite(tok).all()
    x = h[:, grid["i_lo"]:] * grid["het"][None, :]
    for t in [0, 1, grid["n_tok"] // 2, grid["n_tok"] - 1]:
        s, e = grid["starts"][t], grid["ends"][t]
        k = float(grid["counts"][t])
        ref = x[:, s:e].sum(axis=1) / np.sqrt(2.0 * k)
        np.testing.assert_allclose(tok[t, :3], ref.real, atol=1e-5)
        np.testing.assert_allclose(tok[t, 3:6], ref.imag, atol=1e-5)
        ref_e = ((np.abs(x[:, s:e]) ** 2).sum(axis=1) - 2 * k) / (
            2 * np.sqrt(k))
        np.testing.assert_allclose(tok[t, 6:9], ref_e, atol=1e-4)


def test_chirp_tokens_snr_retention():
    """Twin of tests/test_long_bns.py's: the v3 grid keeps >= 80% of SNR²
    at the prior's corners."""
    grid = tlb.build_chirp_token_grid(duration=32.0, f_hi=256.0)
    f = torch.tensor(grid["freqs"], dtype=torch.float32)
    asd = tlb._asd(grid["freqs"], "cpu")
    for m, t_off in [(1.4, 0.0), (1.0, -1.5), (2.5, 1.5)]:
        one = torch.tensor([[m]])
        hp, hc = taylorf2_polarizations(f, one, one, 0.0, 0.0, 100.0, 0.5,
                                        1.0)
        h_det = project_to_network(f, hp, hc, torch.tensor([1.0]),
                                   torch.tensor([0.3]), torch.tensor([0.7]),
                                   torch.tensor([t_off]),
                                   duration=grid["duration"])
        h_w = whiten_fd(h_det, asd[None], 1.0 / grid["duration"])[0]
        tok = tlb.chirp_tokens(h_w, grid).numpy()
        hb = h_w.numpy()[:, grid["i_lo"]:]
        rho2 = float((np.abs(hb) ** 2).sum() / 2.0)
        c = tok[:, :3] + 1j * tok[:, 3:6]
        retained = float((np.abs(c) ** 2).sum()) / rho2
        assert retained > 0.80, (m, t_off, retained)


def test_v3_apply_step_against_jax(grids):
    """simulate_long_bns_v3_from_draws on JAX's small grid against the
    body of JAX's simulate_long_bns_batch_v3 on the same θ and noise."""
    _, jg = grids["small"]
    noise = _noise(np.random.default_rng(4), len(THETA), jg["cut"])
    white = _jax_white(jg["freqs"], jg["duration"])
    j_fn = jax.jit(jax.vmap(lambda th, nz: jlb.chirp_tokens(
        white(th) + nz, jg)))
    jt = np.asarray(j_fn(THETA, noise))
    j_sig = np.abs(np.asarray(j_fn(THETA, np.zeros_like(noise)))[..., :6])
    draws = tlb.LongBNSDraws(torch.from_numpy(THETA),
                             torch.from_numpy(noise), None)
    tt, th = (a.numpy() for a in tlb.simulate_long_bns_v3_from_draws(
        draws, jg))
    np.testing.assert_array_equal(th, THETA)
    assert tt.shape == jt.shape == (len(THETA), jg["L"], 11)
    assert np.abs(tt[..., :6] - jt[..., :6]).max() <= 2e-2 * j_sig.max()
    np.testing.assert_allclose(tt[..., 6:9], jt[..., 6:9],
                               atol=1e-3 * np.abs(jt[..., 6:9]).max()
                               + 1e-3)
    np.testing.assert_array_equal(tt[..., 9:], jt[..., 9:])


def test_simulate_v3_and_train_step(grids):
    """Twin of tests/test_long_bns.py's: a v3 batch, two training steps of
    the patched LongBNSNPE (the trainer's optimizer) and its draws."""
    grid, _ = grids["small"]
    gen = torch.Generator().manual_seed(0)
    tokens, theta = tlb.simulate_long_bns_batch_v3(4, grid, gen, "cpu")
    assert tokens.shape == (4, grid["L"], 11)
    assert bool(torch.isfinite(tokens).all())
    assert float(theta[:, 0].max()) <= 2.5 + 1e-5
    model = tlb.LongBNSNPE(enc=dict(d_model=32, n_layers=1, n_heads=4,
                                    context_dim=16, patch=4),
                           flow_layers=2, flow_hidden=32, flow_bins=4,
                           n_feat=11)
    opt = train_long_bns.make_optimizer(model,
                                        train_long_bns.opt_config(1e-3, 4))
    for _ in range(2):
        tok, th = tlb.simulate_long_bns_batch_v3(4, grid, gen, "cpu")
        loss = model(tok, th)
        opt.zero_grad()
        loss.backward()
        opt.step()
        assert np.isfinite(float(loss.detach()))
    with torch.no_grad():
        draws = model.sample(tokens, 8, gen)
    assert draws.shape == (4, 8, 11)


@pytest.fixture(scope="module")
def v3_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("v3") / "run"
    hist, cal, _ = train_long_bns.run_training(
        TINY_V3 + ["--outdir", str(out), "--steps", "3"])
    return out, hist, cal


def test_train_and_validate_v3(v3_run, tmp_path):
    """train_long_bns --tokens v3 records JAX's v3 config (a "chirp"
    tokens config, no flow bins, K = 8) and params.msgpack beside
    state.pt; validate_long_bns takes the chirp branch (the v1 gates)."""
    out, hist, cal = v3_run
    cfg = cal["config"]
    assert cfg["tokens"]["kind"] == "chirp" and cfg["flow"] == {}
    assert cfg["enc"] == {"d_model": 16, "n_layers": 1, "n_heads": 2,
                          "patch": 4}
    assert [h["step"] for h in hist] == [1, 2]
    assert "shuffle_delta" in hist[-1]
    for f in ("params.msgpack", "state.pt", "history.json",
              "calibration.json"):
        assert (out / f).is_file(), f
    assert not (out / "grid.npz").exists()
    model, _, grid = load_long_bns(out, device="cpu")
    assert grid["config"] == cfg["tokens"]
    assert model.flow.num_bins == 8
    code, report, _ = val.run(["--model", str(out), "--device", "cpu",
                               "--n-events", "2", "--chunk", "2",
                               "--n-post", "8", "--out", str(tmp_path)])
    assert code in (0, 1)
    assert [c["gate"] for c in report["checks"]] == list(val.GATES)


def test_release_read_by_jax(v3_run, tmp_path):
    """release_long_bns on the v3 run: JAX's meta keys, and JAX's
    LongBNSNPE reads its params.msgpack with the port's NLL; a report
    with failing gates refuses the release (exit 1)."""
    out, _, cal = v3_run
    rel = tmp_path / "rel"
    assert release_long_bns.main(["--run", str(out), "--out", str(rel),
                                  "--report", str(tmp_path / "none"),
                                  "--init-from", "scratch"]) == 0
    meta = json.loads((rel / "meta.json").read_text())
    assert list(meta) == list(json.loads(
        (V4_RELEASE / "meta.json").read_text()))
    assert meta["model"] == "LongBNSNPE" and meta["trained_steps"] == 2
    assert meta["gate_battery"] == "PENDING"

    model, cfg, grid = load_long_bns(rel, device="cpu")
    tokens, theta = tlb.simulate_long_bns_batch_v3(
        2, grid, torch.Generator().manual_seed(3), "cpu")
    with torch.no_grad():
        t_nll = float(model(tokens, theta))
    jm = jlb.LongBNSNPE(enc=cfg["enc"])
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), tokens.numpy(),
                              theta.numpy())
    params = from_bytes(params, (rel / "params.msgpack").read_bytes())
    j_nll = float(jm.apply(params, jnp.asarray(tokens.numpy()),
                           jnp.asarray(theta.numpy())))
    assert abs(t_nll - j_nll) <= 1e-5, (t_nll, j_nll)

    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "report.json").write_text(json.dumps({"passed": False}))
    assert release_long_bns.main(["--run", str(out), "--out",
                                  str(tmp_path / "refused"), "--report",
                                  str(bad)]) == 1
    assert not (tmp_path / "refused").exists()


def test_rerelease_v4_is_byte_equal(tmp_path):
    """The committed long_bns_v4 run files, released again: the same
    params.msgpack byte for byte, history and calibration copied."""
    run = tmp_path / "run"
    run.mkdir()
    for f in ("params.msgpack", "history.json", "calibration.json"):
        shutil.copy(V4_RELEASE / f, run / f)
    assert release_long_bns.main(
        ["--run", str(run), "--out", str(tmp_path / "rel"), "--report",
         str(REPO / "reports" / "val_long_bns")]) == 0
    for f in ("params.msgpack", "history.json", "calibration.json"):
        assert (tmp_path / "rel" / f).read_bytes() == \
            (V4_RELEASE / f).read_bytes(), f
    meta = json.loads((tmp_path / "rel" / "meta.json").read_text())
    assert meta["model"] == "LongBNSNPEv4" and meta["gates_all_passed"]
