"""Posterior sampling throughput of the port, with bench.py's protocol.

    python -m posteriflow_torch.tools.bench [--release DIR] [--device cuda]

Reads the model and simulator config from the YAML config, as bench.py
does (configs/npe_r6.yaml, the 15-D flagship's), and the weights from the
release (default: the flagship named in model_release/FLAGSHIP, whose
model config must equal the YAML's), simulates one batch of 8 events with
the config's SimConfig through physics.simulator.simulate_batch, encodes
it once, then
times 10 sampling calls of 16384 draws per event
(LeanNPE.sample_from_context: base draws, coupling-flow inverse with the
CUDA spline, wrap, denormalize) after one warm-up call, synchronizing the
device at the end. bench.py itself times a randomly initialized model of
the same shape; the draw rate does not depend on the weights.

Prints ONE JSON line with bench.py's keys (metric, value, unit,
vs_baseline, model) and the device it ran on: `card` is what
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
(on the CPU, "cpu"), beside the simulate and encode times of the batch.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

from posteriflow_torch.inference.pipeline import InferenceEngine
from posteriflow_torch.physics.simulator import simulate_batch
from posteriflow_torch.train.checkpoints import load_release
from posteriflow_torch.utils.config import load_config

ROOT = Path(__file__).resolve().parents[2]
CONFIG = ROOT / "configs" / "npe_r6.yaml"   # bench.py:36-38
BASELINE_DRAWS_PER_SEC = 5000.0 / 4.465     # bench.py's reference figure


def bench_config(release):
    """-> (the release's state_dict, NPEConfig, SimConfig): the model and
    simulator config from CONFIG, the weights from `release`. ValueError
    if the release's model config is not CONFIG's."""
    state_dict, rel_cfg, _ = load_release(release)
    cfg = load_config(CONFIG)
    if cfg.npe != rel_cfg:
        raise ValueError(f"{release}'s model config differs from {CONFIG}'s")
    return state_dict, cfg.npe, cfg.sim


def card_name(device: torch.device) -> str:
    if device.type != "cuda":
        return str(device)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    lines = out.stdout.strip().splitlines()
    idx = device.index or 0
    return lines[idx].strip() if len(lines) > idx else "unknown card"


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(release, device="cuda", n_events: int = 8, n_draws: int = 16384,
        iters: int = 10, generator: Optional[torch.Generator] = None
        ) -> dict:
    """bench.py's protocol on `device`; the batch and the base draws come
    from `generator` (a generator on the device seeded with 1 if None)."""
    device = torch.device(device)
    state_dict, cfg, sim = bench_config(release)
    engine = InferenceEngine(state_dict, cfg, device=device)
    gen = generator or torch.Generator(device=device).manual_seed(1)

    t0 = time.perf_counter()
    batch = simulate_batch(n_events, sim, device=device, generator=gen)
    _sync(device)
    sim_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ctx = engine.encode(batch.strain, batch.asd_bands)
    _sync(device)
    enc_s = time.perf_counter() - t0
    rank = torch.zeros(n_events, dtype=torch.long, device=device)

    @torch.no_grad()
    def draw():
        return engine.model.sample_from_context(ctx, rank, n_draws,
                                                generator=gen)[0]

    draw()                                   # warm-up
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = draw()
    _sync(device)
    dt = time.perf_counter() - t0
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("non-finite draws")
    rate = iters * n_events * n_draws / dt
    return {
        "metric": "posterior_draws_per_sec_per_chip",
        "value": round(rate, 1),
        "unit": "draws/s",
        "vs_baseline": round(rate / BASELINE_DRAWS_PER_SEC, 1),
        "model": f"{cfg.n_params}-D release {Path(release).name}, "
                 f"{n_events} simulated events x {n_draws} draws",
        "device": str(device),
        "card": card_name(device),
        "simulate_ms": sim_s * 1e3,
        "encode_ms": enc_s * 1e3,
        "n_sig": batch.n_sig.tolist(),
    }


def main(argv=None):
    flagship = (ROOT / "model_release" / "FLAGSHIP").read_text().strip()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--release", default=str(ROOT / "model_release"
                                             / flagship))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--events", type=int, default=8)
    ap.add_argument("--draws", type=int, default=16384)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")
    print(json.dumps(run(args.release, args.device, args.events, args.draws,
                         args.iters)))


if __name__ == "__main__":
    main()
