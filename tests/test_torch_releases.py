"""The seven NPE releases other than the flagship, each loaded into both
packages and served on an injection of its own dimension (11-D aligned or
15-D precessing) at B = 1: the port's prepare_simulated strain (JAX's
noise draws, the release's psd_bands) against JAX's; then, on JAX's
strain, the context; on JAX's context, the NLL of the injected
parameters at rank 0 and 32 draws from the same base draws z.

This covers the aligned simulator branch, the conv encoder of
npe_r1c_best, and the float32 encoders of npe_coh_v1_best, npe_r1c_best
and npe_r2_best, which run with TF32 off (utils/precision.fp32_exact).

The NLL is taken with the conditioner switched to float32: the
injections sit where the density is steep (NLL near -20), and there a
bfloat16 rounding flip in a hidden layer moves the NLL by tenths of a nat
(measured 0.1-0.6 between the packages; JAX's own bfloat16 and float32
NLLs of the flagship differ by up to 1.9 nats on a simulated event).

Tolerances: the strain as in test_torch_sim_event.py; the context as
test_torch_flagship.py holds the flagship, by the encoder's dtype: float32
2e-4 of its largest entry, bfloat16 3e-2; the draws of the released
(bfloat16) flow as chip_smoke.py holds bfloat16 draws, median |Δy| one
bfloat16 step (2^-8), and the largest 1e-1 (a flipped activation moved one
draw of 480 by 5.2e-2); the float32 NLL 1e-3."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posteriflow_tpu.inference.preprocessing import \
    prepare_simulated as jprepare
from posteriflow_tpu.models.npe import LeanNPE as JNPE
from posteriflow_tpu.train.checkpoints import CheckpointManager
from posteriflow_torch.inference.preprocessing import \
    prepare_simulated as tprepare
from posteriflow_torch.models.npe import LeanNPE as TNPE
from posteriflow_torch.train.checkpoints import load_release
from torch_sim_helpers import DRAWS, jax_event_draws

ROOT = Path(__file__).resolve().parents[1]
FLAGSHIP = (ROOT / "model_release" / "FLAGSHIP").read_text().strip()
RELEASES = sorted(p.name for p in (ROOT / "model_release").glob("npe_*")
                  if p.name != FLAGSHIP)
N, SEED = 32, 5
CTX_TOL = {"float32": 2e-4, "bfloat16": 3e-2}
Y_MEDIAN, Y_MAX, NLL_TOL = 2.0 ** -8, 1e-1, 1e-3


def _apply(model, model32, params, strain, bands, theta, z):
    ctx = model.apply(params, strain, bands, method=JNPE.encode)
    rank = jnp.zeros(1, jnp.int32)
    nll = model32.apply(params, ctx, theta, rank,
                        method=JNPE.nll_from_context)
    full = model.apply(params, ctx, rank, method=JNPE.full_context)
    y, _ = model.apply(params, z, full[:, None, :],
                       method=lambda m, a, c: m.flow.inverse(a, c))
    return ctx, nll, y


_JAX_APPLY = jax.jit(_apply, static_argnums=(0, 1))


def test_the_seven_releases_are_there():
    assert len(RELEASES) == 7 and FLAGSHIP not in RELEASES


@pytest.mark.parametrize("name", RELEASES)
def test_release_on_injection(name):
    path = ROOT / "model_release" / name
    jparams, jcfg, _ = CheckpointManager.load_release(path)
    state_dict, tcfg, _ = load_release(path)
    p = tcfg.n_params
    names = tcfg.param_names
    inject = [dict(zip(names, DRAWS["bbh"][:p]))]
    jprep = jprepare(inject, seed=SEED, psd_bands=tcfg.psd_bands,
                     param_names=names)
    draws = jax_event_draws(jax.random.PRNGKey(SEED))
    tprep = tprepare(inject, psd_bands=tcfg.psd_bands, param_names=names,
                     device="cpu", draws=draws)
    peak = np.abs(jprep.strain - draws.noise.numpy()).max()
    assert np.abs(tprep.strain - jprep.strain).max() <= 1e-4 + 2e-3 * peak
    np.testing.assert_array_equal(tprep.truth, jprep.truth)

    strain = np.array(jprep.strain[None])
    bands = np.array(jprep.asd_bands[None])
    theta = np.array(jprep.truth[:1])
    z = np.array(jax.random.normal(jax.random.PRNGKey(SEED + 7), (1, N, p)))
    jctx, jnll, jy = (np.array(a) for a in _JAX_APPLY(
        JNPE(jcfg.npe),
        JNPE(dataclasses.replace(jcfg.npe, flow_dtype="float32")),
        jparams, strain, bands, theta, z))
    m, m32 = (TNPE(c) for c in
              (tcfg, dataclasses.replace(tcfg, flow_dtype="float32")))
    for mod in (m, m32):
        mod.load_state_dict(state_dict, strict=True)
        mod.eval()
    rank = torch.zeros(1, dtype=torch.long)
    with torch.no_grad():
        tctx = m.encode(torch.from_numpy(strain),
                        torch.from_numpy(bands)).numpy()
        ctx = torch.from_numpy(jctx)
        tnll = m32.nll_from_context(ctx, torch.from_numpy(theta),
                                    rank).numpy()
        ty, _ = m.flow.inverse(torch.from_numpy(z),
                               m.full_context(ctx, rank)[:, None, :])
    scale = max(1.0, np.abs(jctx).max())
    assert np.abs(tctx - jctx).max() <= CTX_TOL[tcfg.encoder_dtype] * scale
    np.testing.assert_allclose(tnll, jnll, atol=NLL_TOL)
    dy = np.abs(ty.numpy() - jy)
    assert np.median(dy) <= Y_MEDIAN and dy.max() <= Y_MAX, (
        np.median(dy), dy.max())
