"""The released 15-D flagship (model_release/FLAGSHIP -> npe_r7_best) loaded
into both packages, at B = 1: the context and 64 draws from the same base
draws, as released (bfloat16 encoder and conditioner matmuls) and with
both switched to float32."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posteriflow_tpu.models.npe import LeanNPE as JNPE
from posteriflow_tpu.train.checkpoints import CheckpointManager
from posteriflow_torch.models.npe import LeanNPE as TNPE
from posteriflow_torch.train.checkpoints import load_release

ROOT = Path(__file__).resolve().parents[1]
RELEASE = ROOT / "model_release" / (ROOT / "model_release" / "FLAGSHIP") \
    .read_text().strip()
N = 64
# (context rel., y abs., log q abs.). float32: measured 1e-6 / 7e-6 / 5e-5.
# bfloat16: measured 3e-3 / 7e-4 / 2e-3 — activations that round to a
# neighbouring bf16 value (step 2^-8) in one package and not the other.
TOL = {"float32": (2e-4, 1e-4, 1e-3), "bfloat16": (3e-2, 2e-2, 1e-1)}


@pytest.fixture(scope="module")
def releases():
    jparams, jcfg, _ = CheckpointManager.load_release(RELEASE)
    state_dict, tcfg, meta = load_release(RELEASE)
    return jparams, jcfg.npe, state_dict, tcfg, meta


def test_release_config_and_weights(releases):
    jparams, jnpe, state_dict, tcfg, meta = releases
    assert tcfg.n_params == 15 and tcfg.flow_layers == 10
    assert tcfg.encoder_dtype == tcfg.flow_dtype == "bfloat16"
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jnpe)
    n_leaves = len(jax.tree_util.tree_leaves(jparams))
    assert len(state_dict) == n_leaves == 165


@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
def test_context_and_samples_match(releases, dt):
    jparams, jnpe, state_dict, tcfg, _ = releases
    jm = JNPE(dataclasses.replace(jnpe, encoder_dtype=dt, flow_dtype=dt))
    tm = TNPE(dataclasses.replace(tcfg, encoder_dtype=dt, flow_dtype=dt))
    tm.load_state_dict(state_dict, strict=True)
    tm.eval()

    rng = np.random.default_rng(0)
    strain = rng.standard_normal((1, 3, 16384)).astype(np.float32)
    bands = (0.1 * rng.standard_normal((1, 3, 16))).astype(np.float32)
    jctx = np.array(jm.apply(jparams, jnp.asarray(strain),
                             jnp.asarray(bands), method=JNPE.encode))
    with torch.no_grad():
        tctx = tm.encode(torch.from_numpy(strain),
                         torch.from_numpy(bands)).numpy()
    t_ctx, t_y, t_lq = TOL[dt]
    np.testing.assert_allclose(tctx, jctx,
                               atol=t_ctx * max(1.0, np.abs(jctx).max()))

    # the same context into both flows, fed the draws JAX takes from its key
    key = jax.random.PRNGKey(1)
    rank = np.zeros(1, np.int32)
    jt, jy, jlq = (np.asarray(a) for a in jm.apply(
        jparams, key, jnp.asarray(jctx), jnp.asarray(rank), N,
        method=JNPE.sample_from_context))
    z = np.array(jax.random.normal(key, (1, N, 15)))
    with torch.no_grad():
        tt, ty, tlq = (a.numpy() for a in tm.sample_from_context(
            torch.from_numpy(jctx), torch.from_numpy(rank).long(), N,
            z=torch.from_numpy(z)))
    assert np.isfinite(tt).all() and tt.shape == (1, N, 15)
    np.testing.assert_allclose(ty, jy, atol=t_y)
    np.testing.assert_allclose(tlq, jlq, atol=t_lq)
