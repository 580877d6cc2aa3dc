"""The port's sequence parallelism for long-BNS (models/long_bns.py
make_sharded_encoder, make_sharded_nll, make_sharded_nll_v4) on the CPU:
gloo processes on ('data' 1, 'model' 2), ('data' 2, 'model' 1) and
('data' 2, 'model' 2) meshes against the unsharded port and against the
JAX package's sharded loss on the conftest's CPU mesh;
long_bns_v4_mesh_ft (fine-tuned by JAX through make_sharded_nll_v4)
served through the sharded encoder; tools/train_long_bns.py --mesh 2.

The small models are tests/test_long_bns.py:103's LongBNSNPE (d_model 32,
one layer, 4 heads, 2 flow layers of 32, K = 4), with and without patch
4 as :240 runs it, and the v4 model of tests/torch_long_bns_helpers.py
(K = 12), every weight drawn N(0, 0.1²), on random tokens of 128. (At
0.2 the (2 × 2) gradient of LayerNorm_0.bias cancels to a few 1e-4 of its
entries, and one entry misses the elementwise bar below by 10% while the
leaf stays within 1.5e-5 of its largest entry: float32 summed in another
order.) Their conditioners run float32 matmuls (in JAX through
CouplingNSF's compute_dtype, set for these tests), as
tests/test_torch_train_step.py holds the flagship's: where "data" splits
the batch, each rank rounds its share of a bfloat16 conditioner's weight
gradient to bfloat16 before the sum, so that leaf moves by up to a
bfloat16 ulp (4e-3 relative) from the unsharded one. The v4 model as released, in bfloat16, is held at
(1 × 2), where every rank runs the whole batch's flow and the share is a
power of two.

Tolerances: the sharded context within 1e-5 of the largest |context| of
the unsharded port (float32, another summation order); the sharded loss
within 2e-5 relative and each gradient leaf within rtol 2e-4 / atol 2e-5
of the unsharded port and of JAX's sharded loss (JAX's own bar,
tests/test_long_bns.py:122-133).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from posteriflow_tpu.models import flow as jflow
from posteriflow_tpu.models import long_bns as jlb
from posteriflow_torch.models import long_bns as tlb
from posteriflow_torch.train.checkpoints import load_long_bns
from posteriflow_torch.train.trainer import backward
from torch_dist_helpers import long_bns_model, long_bns_suite, run_ranks
from torch_long_bns_helpers import SMALL_ENC, SMALL_FLOW, carry_params
from torch_sim_helpers import one_torch_thread  # noqa: F401

REPO = __import__("pathlib").Path(__file__).resolve().parents[1]
MESH_FT = REPO / "model_release" / "long_bns_v4_mesh_ft"
SEQ, B = 128, 4
ENC = dict(d_model=32, n_layers=1, n_heads=4, context_dim=16)
FLOW = dict(flow_layers=2, flow_hidden=32, flow_bins=4)
SIGMAS = {"sigma_mc_rel": 5e-4, "sigma_t": 5e-3}


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """One torch thread a test (see torch_sim_helpers.one_torch_thread)."""


def _randomize(params, seed, scale=0.1):
    """Every leaf N(0, scale²) (LayerNorm scales around 1), so that no
    layer is the identity and the conditioners' zero outputs move."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        v = rng.standard_normal(np.shape(a)) * scale
        if path[-1].key == "scale":
            v = 1.0 + v
        return jnp.asarray(v.astype(np.float32))
    return jax.tree_util.tree_map_with_path(draw, params)


def _theta_trig():
    d = tlb.draw_long_bns(B, 8, 3.5, torch.Generator().manual_seed(4), "cpu")
    trig = tlb.trigger_of(d.theta, d.eps, SIGMAS)
    return d.theta.numpy(), trig.numpy()


class _F32CouplingNSF(jflow.CouplingNSF):
    compute_dtype: str = "float32"


@pytest.fixture
def jax_f32_flow(monkeypatch):
    """JAX's CouplingNSF with float32 conditioner matmuls by default (the
    modules import it when they are set up)."""
    monkeypatch.setattr(jflow, "CouplingNSF", _F32CouplingNSF)


def _cases():
    """name -> (JAX module, JAX params, the payload's case)."""
    rng = np.random.default_rng(0)
    theta, trig = _theta_trig()
    out = {}
    for name, enc, n_feat in (("v1", ENC, 6),
                              ("patch4", {**ENC, "patch": 4}, 11)):
        tokens = rng.standard_normal((B, SEQ, n_feat)).astype(np.float32)
        jm = jlb.LongBNSNPE(enc=enc, **FLOW)
        params = _randomize(jax.jit(jm.init)(jax.random.PRNGKey(1), tokens,
                                             theta), seed=2)
        out[name] = (jm, params, dict(
            v4=False, f32=True, kwargs=dict(enc=enc, n_feat=n_feat, **FLOW),
            state_dict=carry_params(params), tokens=tokens, rest=[theta]))
    tokens = rng.standard_normal((B, SEQ, 11)).astype(np.float32)
    jm = jlb.LongBNSNPEv4(enc=SMALL_ENC, **SMALL_FLOW, **SIGMAS)
    params = _randomize(jax.jit(jm.init)(jax.random.PRNGKey(3), tokens,
                                         theta, trig), seed=4)
    case = dict(v4=True, f32=True,
                kwargs=dict(enc=SMALL_ENC, **SMALL_FLOW, **SIGMAS),
                state_dict=carry_params(params), tokens=tokens,
                rest=[theta, trig])
    out["v4"] = (jm, params, case)
    out["v4_bf16"] = (jm, params, {**case, "f32": False, "meshes": (2,)})
    return out


def _unsharded(case):
    model = long_bns_model(case)
    args = [torch.from_numpy(a) for a in [case["tokens"]] + case["rest"]]
    with torch.no_grad():
        ctx = model.encoder(args[0])
    loss = model(*args)
    backward(loss)
    return ctx, float(loss.detach()), {n: p.grad for n, p in
                                       model.named_parameters()}


def _mesh_ft_case():
    """long_bns_v4_mesh_ft on two 64-s events of its own grid."""
    model, cal, grid = load_long_bns(MESH_FT, device="cpu")
    tokens, theta, trig = tlb.simulate_long_bns_batch_v4(
        2, grid, generator=torch.Generator().manual_seed(6), device="cpu")
    return model, dict(
        v4=True, loss=False,
        kwargs=dict(enc=cal["enc"], flow_bins=cal["flow"]["bins"],
                    sigma_mc_rel=cal["tokens"]["sigma_mc_rel"],
                    sigma_t=cal["tokens"]["sigma_t"]),
        state_dict=model.state_dict(), tokens=tokens.numpy(),
        rest=[theta.numpy(), trig.numpy()])


@pytest.fixture(scope="module")
def cases():
    return _cases()


@pytest.fixture(scope="module")
def world2(cases, tmp_path_factory):
    """(1 × 2) and (2 × 1) meshes on two ranks, long_bns_v4_mesh_ft
    through (1 × 2), and tools/train_long_bns.py --mesh 2 on the v4
    path."""
    tmp = tmp_path_factory.mktemp("lbns2")
    ft_model, ft = _mesh_ft_case()
    payload = dict(meshes=[2, 1],
                   cases={**{k: c for k, (_, _, c) in cases.items()},
                          "mesh_ft": ft},
                   train=["--device", "cpu", "--outdir", str(tmp / "run"),
                          "--steps", "3", "--batch", "2", "--d-model", "16",
                          "--n-layers", "1", "--n-heads", "2",
                          "--cal-events", "4", "--cal-post", "8",
                          "--eval-every", "2", "--mesh", "2"])
    outs = run_ranks(tmp / "ranks", 2, long_bns_suite, payload)
    return outs, ft_model, ft, tmp / "run"


@pytest.fixture(scope="module")
def world4(cases, tmp_path_factory):
    """The (2 × 2) mesh on four ranks."""
    tmp = tmp_path_factory.mktemp("lbns4")
    payload = dict(meshes=[2], cases={k: c for k, (_, _, c) in
                                      cases.items() if c["f32"]})
    return run_ranks(tmp, 4, long_bns_suite, payload)


def _close_grads(got, ref, what=""):
    assert set(got) == set(ref)
    for n, r in ref.items():
        np.testing.assert_allclose(got[n].numpy(), r.numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=f"{what} {n}")


@pytest.mark.parametrize("m,name", [
    (2, "v1"), (2, "patch4"), (2, "v4"), (2, "v4_bf16"), (1, "v1"),
    (1, "patch4"), (1, "v4")])
def test_sharded_encoder_and_loss_on_two_ranks(world2, cases, m, name):
    """(1 × 2) splits the sequence, (2 × 1) the batch: every rank's
    context, loss and summed gradients against the unsharded port."""
    outs, *_ = world2
    ctx, loss, grads = _unsharded(cases[name][2])
    for out in outs:
        got = out[(m, name)]
        tol = 1e-5 * float(ctx.abs().max())
        assert float((got["ctx"] - ctx).abs().max()) <= tol
        assert abs(got["loss"] - loss) <= 2e-5 * abs(loss)
        _close_grads(got["grads"], grads)


@pytest.mark.parametrize("name", ["v1", "patch4", "v4"])
def test_sharded_loss_2x2_matches_port_and_jax(world4, cases, name,
                                               jax_f32_flow):
    """On a (2 × 2) mesh every rank's loss and gradients against the
    unsharded port and against JAX's make_sharded_nll[_v4] on a (2, 2)
    mesh of the conftest's CPU devices (its value_and_grad, run as
    tests/test_long_bns.py:103 runs it)."""
    jm, params, case = cases[name]
    ctx, loss, grads = _unsharded(case)
    make = jlb.make_sharded_nll_v4 if case["v4"] else jlb.make_sharded_nll
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    loss_sh = make(mesh, SEQ, jm)
    jl, jg = jax.value_and_grad(lambda p: loss_sh(p, case["tokens"],
                                                  *case["rest"]))(params)
    jg = {n: torch.from_numpy(np.asarray(a))
          for n, a in carry_params(jg).items()}
    for out in world4:
        got = out[(2, name)]
        assert float((got["ctx"] - ctx).abs().max()) <= \
            1e-5 * float(ctx.abs().max())
        for ref in (loss, float(jl)):
            assert abs(got["loss"] - ref) <= 2e-5 * abs(ref)
        _close_grads(got["grads"], grads, "port")
        _close_grads(got["grads"], jg, "jax")


def test_mesh_ft_served_through_the_sharded_encoder(world2):
    """long_bns_v4_mesh_ft, which JAX fine-tuned on a ('data' 1, 'model'
    2) mesh, loads into the unsharded port, and its context through the
    port's sharded encoder on (1 × 2) and (2 × 1) equals the unsharded
    one within 1e-5 of its largest |entry|."""
    outs, model, ft, _ = world2
    with torch.no_grad():
        ctx = model.encoder(torch.from_numpy(ft["tokens"]))
    for out in outs:
        for m in (2, 1):
            got = out[(m, "mesh_ft")]["ctx"]
            assert got.shape == ctx.shape == (2, 256)
            assert float((got - ctx).abs().max()) <= \
                1e-5 * float(ctx.abs().max())


def test_train_long_bns_mesh_2(world2):
    """tools/train_long_bns.py --mesh 2 on two ranks: the same history on
    both, rank 0's files, "mesh": 2 in calibration.json, and the same
    first-step NLL as the unsharded run."""
    from posteriflow_torch.tools import train_long_bns
    outs, _, _, run = world2
    (h0, c0), (h1, c1) = (o["train"] for o in outs)
    strip = (lambda h: [{k: v for k, v in r.items() if k != "seconds"}
                        for r in h])
    assert strip(h0) == strip(h1)
    assert c0["config"]["mesh"] == 2 == c1["config"]["mesh"]
    for f in ("params.msgpack", "state.pt", "history.json",
              "calibration.json", "grid.npz"):
        assert (run / f).is_file(), f
    ref, _, _ = train_long_bns.run_training(
        ["--device", "cpu", "--outdir", str(run.parent / "ref"), "--steps",
         "1", "--batch", "2", "--d-model", "16", "--n-layers", "1",
         "--n-heads", "2", "--cal-events", "2", "--cal-post", "4"])
    assert abs(h0[0]["train_nll"] - ref[0]["train_nll"]) <= \
        2e-5 * abs(ref[0]["train_nll"])
    assert all(np.isfinite(r["val_nll"]) for r in h0)


def test_sharded_patch_must_divide():
    """A shard's length that does not divide by the patch raises, as
    JAX's make_sharded_encoder does (long_bns.py:848-850)."""
    class FakeMesh:
        def __getitem__(self, axis):
            return self

        def size(self):
            return 2

        def get_group(self, axis):
            return None

    with pytest.raises(ValueError, match="not divisible by patch=4"):
        tlb.make_sharded_encoder(FakeMesh(), 132, 11, {"patch": 4})
