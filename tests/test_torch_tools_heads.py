"""The port's twins of scripts/probe_context.py, frozen_context_heads.py
and real_noise_test.py, on the CPU at small sizes, against scikit-learn
and the JAX heads.

probe_context's ridge probes and 4-fold R² within 1e-9 of scikit-learn's
Ridge(alpha=1) and cross_val_score(cv=4, scoring="r2") on the same
arrays (both float64). The mixture-density head's NLL within 1e-5 of the
JAX head's (relative to max(1, |NLL|)), given JAX's initial parameters
and the same contexts; the flow heads' (bfloat16 conditioners, K = 8)
within 1e-1 nats, the bfloat16 bar of tests/test_torch_flagship.py's log
q (a hidden activation that rounds to the neighbouring bfloat16 value in
one package and not the other), on parameters moved off flax's zero
output layer so that the spline is not the identity (measured 4.7e-3 and
2.1e-2 nats at NLLs up to 18 and 20)."""

import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.linear_model import Ridge
from sklearn.model_selection import cross_val_score

from posteriflow_tpu.models.flow import CouplingNSF as JNSF
from posteriflow_torch.tools import (frozen_context_heads, probe_context,
                                     real_noise_test)
from posteriflow_torch.train.checkpoints import flax_to_state_dict
from torch_long_bns_helpers import REPO
from torch_sim_helpers import one_torch_thread  # noqa: F401

RELEASE = str(REPO / "model_release" / "npe_r7_best")
CTX, NP = 24, 15


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """One torch thread a test (see torch_sim_helpers.one_torch_thread)."""


@pytest.mark.parametrize("n", [203, 256])
def test_ridge_cross_val_matches_sklearn(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 40)) * rng.uniform(0.1, 3.0, 40)
    y = x[:, :5] @ rng.normal(size=5) + rng.normal(0, 2.0, n) + 7.0
    ref = cross_val_score(Ridge(alpha=1.0), x, y, cv=4, scoring="r2")
    got = probe_context.cross_val_r2(x, y)
    assert np.max(np.abs(got - ref)) <= 1e-9
    model = Ridge(alpha=1.0).fit(x, y)
    coef, b = probe_context.ridge_fit(x, y)
    assert np.max(np.abs(coef - model.coef_)) <= 1e-9
    assert abs(b - model.intercept_) <= 1e-9
    sizes = [s.stop - s.start for s in probe_context.kfold_slices(n)]
    assert sizes == [n // 4 + (i < n % 4) for i in range(4)]


def test_probe_context_cli(tmp_path):
    out = tmp_path / "probes.json"
    report = probe_context.main(["--ckpt", RELEASE, "--device", "cpu",
                                 "--n-events", "256", "--out", str(out)])
    assert json.loads(out.read_text()) == report
    assert set(report) == {"probes", "n_events",
                           "context_std_across_events"}
    assert set(report["probes"]) == {"net_snr", "log_net_snr",
                                     "log_distance", "chirp_mass",
                                     "geocent_time", "cos_theta_jn"}
    assert 0 < report["n_events"] <= 256
    assert all(np.isfinite(v) for v in report["probes"].values())


class JMDNHead(nn.Module):
    """scripts/frozen_context_heads.py's MDNHead (defined inside its
    main), with n_params made a field."""
    n_params: int
    n_comp: int = 8

    @nn.compact
    def __call__(self, ctx, y):
        n_params = self.n_params
        h = nn.gelu(nn.Dense(128)(ctx))
        h = nn.gelu(nn.Dense(128)(h))
        logits = nn.Dense(self.n_comp)(h)
        mu = nn.Dense(self.n_comp * n_params)(h).reshape(
            -1, self.n_comp, n_params)
        sig = nn.softplus(nn.Dense(self.n_comp * n_params)(h)).reshape(
            -1, self.n_comp, n_params) + 1e-3
        comp_lp = (-0.5 * jnp.sum(((y[:, None] - mu) / sig) ** 2, -1)
                   - jnp.sum(jnp.log(sig), -1)
                   - 0.5 * n_params * jnp.log(2 * jnp.pi))
        return -jax.scipy.special.logsumexp(
            jax.nn.log_softmax(logits) + comp_lp, axis=-1)


class JFlowHead(nn.Module):
    """scripts/frozen_context_heads.py's FlowHead."""
    n_params: int
    ctx_dim: int
    layers: int = 4
    hidden: int = 64

    def setup(self):
        self.flow = JNSF(features=self.n_params,
                         context_features=self.ctx_dim,
                         num_layers=self.layers, hidden=self.hidden,
                         num_bins=8)

    def __call__(self, ctx, y):
        return -self.flow.log_prob(y, ctx)


def _inputs(seed=0, n=16):
    rng = np.random.default_rng(seed)
    ctx = rng.normal(size=(n, CTX)).astype(np.float32)
    y = rng.uniform(-0.95, 0.95, (n, NP)).astype(np.float32)
    return ctx, y


def _port_head(name, params):
    head = frozen_context_heads.make_head(name, CTX, NP)
    tree = jax.tree_util.tree_map(np.asarray, params)
    head.load_state_dict(flax_to_state_dict(tree), strict=True)
    return head


def test_mdn_head_matches_jax():
    ctx, y = _inputs()
    jm = JMDNHead(n_params=NP)
    params = jm.init(jax.random.PRNGKey(1), ctx, y)
    ref = np.asarray(jm.apply(params, ctx, y))
    with torch.no_grad():
        got = _port_head("mdn", params)(torch.from_numpy(ctx),
                                        torch.from_numpy(y)).numpy()
    assert np.max(np.abs(got - ref)) <= 1e-5 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("name,layers,hidden", [("nsf_small", 4, 64),
                                                ("nsf_large", 8, 128)])
def test_flow_heads_match_jax(name, layers, hidden):
    ctx, y = _inputs(1)
    jm = JFlowHead(n_params=NP, ctx_dim=CTX, layers=layers, hidden=hidden)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), ctx, y)
    rng = np.random.default_rng(2)

    def move_out(path, a):
        """The conditioners' zero output layers drawn at 0.02."""
        a = np.asarray(a)
        if any(getattr(k, "key", None) == "out" for k in path):
            a = a + rng.normal(0, 0.02, a.shape).astype(np.float32)
        return a

    params = jax.tree_util.tree_map_with_path(move_out, params)
    ref = np.asarray(jax.jit(jm.apply)(params, ctx, y))
    with torch.no_grad():
        got = _port_head(name, params)(torch.from_numpy(ctx),
                                       torch.from_numpy(y)).numpy()
    assert np.isfinite(ref).all() and np.std(ref) > 0.1
    assert np.max(np.abs(got - ref)) <= 1e-1


def test_masked_nll_ignores_dead_events():
    ctx, y = _inputs(3, 6)
    head = frozen_context_heads.make_head("mdn", CTX, NP)
    live = torch.tensor([1.0, 0, 1, 1, 0, 1])
    full = head(torch.from_numpy(ctx), torch.from_numpy(y))
    got = frozen_context_heads.masked_nll(head, torch.from_numpy(ctx),
                                          torch.from_numpy(y), live)
    assert torch.allclose(got, full[live > 0].mean())


def test_frozen_context_heads_cli(tmp_path):
    out = tmp_path / "heads.json"
    report = frozen_context_heads.main(
        ["--ckpt", RELEASE, "--device", "cpu", "--steps", "2", "--batch",
         "4", "--out", str(out)])
    assert json.loads(out.read_text()) == report
    assert set(report) == {"heads", "final_nll_spread", "interpretation",
                           "steps"}
    assert set(report["heads"]) == {"nsf_small", "nsf_large", "mdn"}
    for r in report["heads"].values():
        assert set(r) == {"initial_nll", "final_nll"}
        assert np.isfinite(r["final_nll"])


def test_real_noise_test_cli(tmp_path):
    out = tmp_path / "rn.json"
    report = real_noise_test.main(["--ckpt", RELEASE, "--device", "cpu",
                                   "--n-events", "4", "--out", str(out)])
    assert json.loads(out.read_text()) == report
    assert set(report) == {"gaussian_nll", "real_nll", "nll_gap",
                           "gap_within_gate", "gaussian_dist_corr",
                           "real_dist_corr", "gaussian_cov90", "real_cov90",
                           "bank", "n_events"}
    assert report["bank"] == "synthetic" and report["n_events"] == 4
    assert np.isfinite(report["gaussian_nll"]) and np.isfinite(
        report["real_nll"])
    assert report["nll_gap"] == report["real_nll"] - report["gaussian_nll"]
    assert report["gap_within_gate"] == (abs(report["nll_gap"]) < 3.0)
