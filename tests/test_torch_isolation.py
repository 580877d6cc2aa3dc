"""The port runs on a machine that has PyTorch, numpy and scipy but none of
the JAX stack, msgpack, pyyaml, scikit-learn, ninja, h5py, gwpy, gwosc,
matplotlib, bilby, pandas or transformers.

A subprocess blocks those imports with a sys.meta_path finder, imports
every module of posteriflow_torch (the trainer, its tools and the OOD
fit included), loads the flagship release on the CPU, serves one request
on raw strain, simulates a batch with the flagship's SimConfig, serves one
request on an injection, importance-corrects it through one tempered stage
(the SMC sweep included) and takes one train step of the flagship's
TrainConfig at batch 2, and another on a batch of the flagship's SimConfig
simulated with a synthetic noise bank; it serves long_bns_v4 on its stored
trigger grid and long_bns_v1, trains a tiny long-BNS model for a step
with tools/train_long_bns.py, builds a v3 grid and releases the run with
tools/release_long_bns.py; it takes one data-parallel step of the
flagship on a one-rank gloo group (parallel/mesh.py); it reads
configs/npe_r6.yaml and exports the flagship (packb) and loads the export
back (CheckpointManager.load_release); it builds a small dingo_nsf30
from a seed and serves one request through InferenceEngine.
chip_smoke.py without a GPU exits
non-zero, fast, with no result line. A scan of the sources (the package,
its tools and examples, and chip_smoke.py) checks what they import: h5py,
gwpy, gwosc, matplotlib, bilby, pandas and transformers only inside the
functions that need them (the plots, to_bilby, the dataset writer, the
Whisper encoder), the rest nowhere.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "posteriflow_torch"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "yaml",
           "ninja", "sklearn", "posteriflow_tpu", "h5py", "gwpy", "gwosc",
           "matplotlib", "bilby", "pandas", "transformers")
# imported by the port only inside the functions that need them
OPTIONAL = ("h5py", "gwpy", "gwosc", "matplotlib", "bilby", "pandas",
            "transformers")

_CHILD = r"""
import importlib, importlib.abc, json, pkgutil, sys
BLOCKED = set(%r)

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is not installed on this machine")
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, %r)
for name in BLOCKED:
    try:
        importlib.import_module(name)
    except ImportError:
        pass
    else:
        raise SystemExit(f"blocker failed for {name}")

import numpy as np
import posteriflow_torch
mods = [m.name for m in pkgutil.walk_packages(posteriflow_torch.__path__,
                                              "posteriflow_torch.")]
for m in mods:
    importlib.import_module(m)

import chip_smoke
from posteriflow_torch.inference.pipeline import (InferenceEngine, infer,
                                                 load_model)
eng = load_model("model_release/npe_r7_best", device="cpu")
res = infer(eng, strain=chip_smoke.coloured_noise(seed=1), n_samples=64)

import torch
from posteriflow_torch import PARAM_NAMES_PRECESSING
from posteriflow_torch.physics.simulator import (sim_config_from_dict,
                                                 simulate_batch)
meta = json.load(open("model_release/npe_r7_best/meta.json"))
sim = sim_config_from_dict(meta["config"]["sim"])
batch = simulate_batch(2, sim, device="cpu",
                       generator=torch.Generator().manual_seed(0))
from posteriflow_torch.inference.importance import (
    importance_correct, make_marginalized_log_likelihood)
from posteriflow_torch.inference.preprocessing import prepare_simulated
prep = prepare_simulated([dict(zip(PARAM_NAMES_PRECESSING,
                                   [30.0, 25.0, 400.0, 1.0, 0.2, 0.5, 0.3,
                                    1.0, 0.0, 0.4, 0.3, 1.0, 2.0, 0.5,
                                    1.0]))], seed=2,
                         param_names=PARAM_NAMES_PRECESSING, device="cpu")
inj = infer(eng, data=prep, n_samples=32, seed=2)
# one tempered stage: the device sweep runs once, on the CPU
ctx = eng.encode(prep.strain[None], prep.asd_bands[None])
isr = importance_correct(eng, ctx[0], 0, inj.samples, inj.log_prob,
                         inj.railed, make_marginalized_log_likelihood(
                             prep.strain, device="cpu"),
                         marginalized=True, pad_block=32, min_ess_frac=1.0,
                         max_stages=2)
from posteriflow_torch.core.pipeline import AHSDPipeline
from posteriflow_torch.inference.ranking import rank_overlapping
inj1 = infer(eng, data=prep, rank=1, n_samples=32, seed=2)
order, scores = rank_overlapping([inj, inj1], prep.strain, device="cpu")
dec = AHSDPipeline(eng, max_signals=1, n_samples=32).decompose(prep)
import dataclasses
from posteriflow_torch.train.loop import _merge_params
from posteriflow_torch.train.checkpoints import load_release
from posteriflow_torch.train.trainer import init_state, train_step
from posteriflow_torch.utils.config import load_config
cfg = dataclasses.replace(load_config("model_release/npe_r7_best/meta.json"),
                          batch_size=2)
state = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
state.model.load_state_dict(_merge_params(
    state.model.state_dict(), load_release("model_release/npe_r7_best")[0])[0])
step = train_step(state, batch)
steps = state.step
from posteriflow_torch.data.noise_bank import make_synthetic_bank
bank = make_synthetic_bank(torch.Generator().manual_seed(1), n_segments=2,
                           segment_len=20480, device="cpu")
# seed 3: one real-noise event and one Gaussian at real_noise_prob 0.5
real = simulate_batch(2, sim, device="cpu", bank=bank,
                      generator=torch.Generator().manual_seed(3))
step_real = train_step(state, real)
# long-BNS: v4 served on its stored grid, v1, one tiny training run
import tempfile
from posteriflow_torch.models import long_bns as lb
from posteriflow_torch.tools import train_long_bns
from posteriflow_torch.train.checkpoints import load_long_bns
lbm, _, lbgrid = load_long_bns("model_release/long_bns_v4", device="cpu")
g = torch.Generator().manual_seed(4)
tok, th, tr = lb.simulate_long_bns_batch_v4(2, lbgrid, generator=g,
                                            device="cpu")
v1m, _, _ = load_long_bns("model_release/long_bns_v1", device="cpu")
tok1, th1 = lb.simulate_long_bns_batch(1, generator=g, device="cpu")
with torch.no_grad():
    lb_nll = float(lbm(tok, th, tr))
    lb_draws = lbm.sample(tok, tr, 16, g)
    v1_nll = float(v1m(tok1, th1))
with tempfile.TemporaryDirectory() as tmp:
    lb_hist, _, _ = train_long_bns.run_training(
        ["--device", "cpu", "--outdir", tmp, "--steps", "1", "--batch", "2",
         "--d-model", "16", "--n-layers", "1", "--n-heads", "2",
         "--cal-events", "2", "--cal-post", "4"])
    # the v3 front end's grid, and the run released as flax writes it
    from posteriflow_torch.tools import release_long_bns
    chirp_L = lb.build_chirp_token_grid(duration=16.0, f_hi=256.0)["L"]
    rel_rc = release_long_bns.main(["--run", tmp, "--out", tmp + "/rel",
                                    "--report", tmp + "/none"])
# the process grid: a one-rank gloo group and one data-parallel step
import torch.distributed
from posteriflow_torch.parallel import init_distributed, make_mesh
from posteriflow_torch.train.trainer import make_train_step
with tempfile.TemporaryDirectory() as tmp:
    world = init_distributed(f"file://{tmp}/rendezvous", 1, 0, device="cpu")
    dp = make_train_step(cfg, mesh=make_mesh())(
        state, torch.Generator().manual_seed(5))
    torch.distributed.destroy_process_group()
# the release path: the YAML config, and the flagship exported and read back
from pathlib import Path
from posteriflow_torch.train.checkpoints import (CheckpointManager,
                                                 write_params)
yaml_cfg = load_config("configs/npe_r6.yaml")
with tempfile.TemporaryDirectory() as tmp:
    data = write_params(eng.model, Path(tmp) / "params.msgpack")
    (Path(tmp) / "meta.json").write_text(
        open("model_release/npe_r7_best/meta.json").read())
    rt_model, rt_cfg, _ = CheckpointManager.load_release(tmp, device="cpu")
    export = [data == open("model_release/npe_r7_best/params.msgpack",
                           "rb").read(),
              all(torch.equal(a, b) for a, b in zip(
                  eng.model.state_dict().values(),
                  rt_model.state_dict().values())),
              yaml_cfg.npe == rt_cfg.npe]
# DINGO: dingo_nsf30's blocks at small widths, weights from a seed
from posteriflow_torch.models.dingo import (dingo_config_from_dict,
                                            seeded_state_dict)
dcfg = dataclasses.replace(
    dingo_config_from_dict(json.load(open(
        "posteriflow_torch/models/configs/dingo_nsf30/meta.json"))["config"]),
    f_max=27.875, n_rb=4, resnet_widths=(32, 32, 16, 16), context_dim=16,
    flow_steps=3, flow_hidden=32, flow_blocks=2)
deng = InferenceEngine(seeded_state_dict(dcfg, 1), dcfg, device="cpu")
dstrain = np.random.default_rng(0).standard_normal(
    (1, 3, 3, dcfg.n_freq)).astype(np.float32)
dth, dlq, _ = deng.sample_posterior(deng.encode(dstrain, None), 0, 16,
                                    generator=torch.Generator().manual_seed(0))
loaded = sorted({m.split(".")[0] for m in sys.modules} & BLOCKED)
print(json.dumps({"modules": mods, "shape": list(res.samples.shape),
                  "finite": bool(np.isfinite(res.samples).all()
                                 and np.isfinite(res.log_prob).all()),
                  "verdict": res.verdict, "gate": "refine" in res.gate,
                  "sim": [list(batch.strain.shape),
                          bool(torch.isfinite(batch.strain).all())],
                  "inject": [list(inj.samples.shape),
                             bool(np.isfinite(inj.samples).all())],
                  "train": [bool(torch.isfinite(step["nll"])), steps],
                  "real": [sim.real_noise_prob,
                           bool(torch.isfinite(real.strain).all()),
                           (real.asd_bands.abs().amax(dim=(1, 2)) > 0)
                           .tolist(),
                           bool(torch.isfinite(step_real["nll"]))],
                  "ranking": [sorted(order), bool(np.isfinite(scores).all())],
                  "decompose": [len(dec["stages"]), bool(np.isfinite(
                      dec["stages"][0]["quality"]))],
                  "importance": [list(isr.samples.shape), isr.n_stages,
                                 len(isr.mcmc_acceptance),
                                 abs(float(isr.weights.sum()) - 1.0) < 1e-6],
                  "long_bns": [lbgrid["config"]["kind"], lbgrid["n_tok"],
                               bool(np.isfinite(lb_nll)),
                               list(lb_draws.shape),
                               bool(np.isfinite(v1_nll)), len(lb_hist),
                               chirp_L, rel_rc],
                  "mesh": [world, bool(torch.isfinite(dp["nll"]))],
                  "export": export,
                  "dingo": [list(dth.shape),
                            bool(torch.isfinite(dth).all()
                                 and torch.isfinite(dlq).all())],
                  "loaded": loaded}))
"""


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_port_runs_without_jax_msgpack_yaml_ninja():
    code = _CHILD % (BLOCKED, str(ROOT))
    proc = subprocess.run([sys.executable, "-I", "-c", code], cwd=ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    expected = {"posteriflow_torch." + p for p in (
        "ops.rqs", "ops.rqs_cuda", "models.flow", "models.encoder",
        "models.dingo", "models.dingo_flow",
        "models.npe", "utils.msgpack_lite", "train.checkpoints",
        "inference.preprocessing", "inference.ood", "inference.gating",
        "inference.result", "inference.pipeline", "scaler",
        "physics.constants", "physics.psd", "physics.detectors",
        "physics.projection", "physics.whiten", "physics.simulator",
        "physics.waveforms.taylorf2", "physics.waveforms.imr",
        "physics.waveforms.phenomd", "physics.waveforms.tidal",
        "physics.waveforms.precession", "prior", "utils.precision",
        "utils.native",
        "tools.bench", "tools.bench_train", "tools.train_npe",
        "train.trainer", "train.diagnostics", "train.gates", "train.loop",
        "utils.config", "inference.importance", "inference.dynesty_bridge",
        "evaluation.metrics", "tools.infer", "models.priority_net",
        "inference.ranking", "train.train_priority", "core.calibrator",
        "core.subtractor", "core.bias_corrector", "core.pipeline",
        "core.pod", "evaluation.benchmarks", "tools.priority_eval",
        "tools.overlap_bench", "data", "data.noise_bank", "data.native_bank",
        "data.host_feed", "data.io", "data.gwtc", "data.snr_utils",
        "tools.make_noise_bank", "utils.provenance", "utils.logging",
        "evaluation", "evaluation.validation", "evaluation.noise_analysis",
        "inference.plots", "tools.validate_checkpoint",
        "tools.npe_diagnostics", "tools.twin_grid",
        "tools.importance_validation", "models.long_bns",
        "tools.validate_long_bns", "tools.train_long_bns",
        "tools.export_release", "utils.noise_marginalization",
        "tools.calibrate_priority_net", "tools.priority_fusion_bound",
        "tools.make_anchors", "tools.anchor_convergence",
        "tools.evidence_validation", "parallel", "parallel.mesh",
        "tools.dryrun_multichip", "tools.release_long_bns",
        "physics.cosmology", "models.svd_basis",
        "models.transformer_encoder", "tools.validate_pipeline_physics",
        "tools.generate_dataset", "tools.real_noise_test",
        "tools.precession_robustness", "tools.probe_context",
        "tools.frozen_context_heads", "tools.benchmark_real_events",
        "examples", "examples.analyze_results", "examples.explore_data",
        "examples.toy_2d_npe")}
    assert expected <= set(out["modules"])
    assert out["shape"] == [64, 15] and out["finite"]
    assert out["verdict"] in ("HIGH", "MEDIUM", "LOW") and out["gate"]
    assert out["sim"] == [[2, 3, 16384], True]
    assert out["inject"] == [[32, 15], True]
    assert out["train"] == [True, 1]
    assert out["real"] == [0.5, True, [True, False], True]
    assert out["importance"] == [[32, 15], 2, 1, True]
    assert out["ranking"] == [[0, 1], True]
    assert out["decompose"] == [1, True]
    assert out["long_bns"] == ["trigger", 168, True, [2, 16, 11], True, 1,
                               2560, 0]
    assert out["mesh"] == [1, True]
    assert out["export"] == [True, True, True]
    assert out["dingo"] == [[1, 16, 15], True]
    assert out["loaded"] == []


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=_env(), capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_fast_without_gpu(tmp_path):
    """In the repo, and alone in an empty directory: non-zero exit, no
    ImportError, no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (ROOT, tmp_path):
        proc = _run_smoke(cwd)
        assert proc.returncode != 0
        assert "ImportError" not in proc.stderr + proc.stdout
        assert "Traceback" not in proc.stderr
        assert '"ok": true' not in proc.stdout


def _python_sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _walk_with_scope(tree):
    """(node, inside a function) for every node of `tree`."""
    stack = [(tree, False)]
    while stack:
        node, in_fn = stack.pop()
        yield node, in_fn
        inner = in_fn or isinstance(node, (ast.FunctionDef,
                                           ast.AsyncFunctionDef))
        stack.extend((c, inner) for c in ast.iter_child_nodes(node))


def test_sources_import_nothing_of_the_jax_stack():
    """No import of the JAX stack, msgpack, yaml, ninja or the JAX package,
    by statement or by importlib, no import of h5py, gwpy, gwosc,
    matplotlib, bilby, pandas or transformers outside a function, and no
    use of
    PyTorch's C++ extension loader. (Docstrings may cite the JAX package's
    files by name.)"""
    bad = []
    for path in _python_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node, in_fn in _walk_with_scope(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "attr", getattr(node.func, "id", ""))
                  in ("import_module", "__import__") and node.args
                  and isinstance(node.args[0], ast.Constant)):
                names = [str(node.args[0].value)]
            elif isinstance(node, (ast.Attribute, ast.Name)):
                ident = getattr(node, "attr", getattr(node, "id", ""))
                if ident in ("cpp_extension", "load_inline"):
                    bad.append(f"{path}: uses {ident}")
            for n in names:
                top = n.split(".")[0]
                if top in OPTIONAL and in_fn:
                    continue
                if top in BLOCKED or "cpp_extension" in n:
                    bad.append(f"{path}: imports {n}")
    assert bad == []
    cu = (PKG / "csrc" / "rqs.cu").read_text()
    assert "torch/extension.h" not in cu and "pybind11" not in cu
