"""Training throughput of the port: steps/s, events/s and model FLOPs
utilisation (the twin of scripts/bench_train.py).

    python -m posteriflow_torch.tools.bench_train [--config YAML_OR_JSON]
        [--batch 128] [--steps 20] [--init-from RELEASE] [--no-bank]
        [--peak-tflops 989] [--device cuda] [--out FILE]

Builds the TrainConfig (default: configs/npe_production.yaml, as the JAX
script; `--config model_release/npe_r7_best` for the flagship) and a
fresh TrainState (or the release's weights with --init-from), runs warm-up
steps, then times `--steps` full steps (simulate → encode → per-rank NLL →
backward → clip → AdamW) as one steady-state window that ends in a device
synchronisation. As in the JAX script, a config with real_noise_prob > 0
(the flagship's 0.5) trains on a synthetic bank of 8 segments a detector
(make_synthetic_bank, seed 7) unless --no-bank is given, which times the
all-Gaussian workload.

FLOPs per step are counted once with torch.utils.flop_counter.FlopCounterMode
over one whole step: the matrix products and convolutions of the forward
and backward passes. The RQS spline kernels (forward and backward, custom
CUDA), the simulator's FFTs and the elementwise work are not counted, so
the MFU is a floor. MFU = counted FLOPs × steps/s over the card's dense
bf16 peak (--peak-tflops, default PEAK_BF16_FLOPS: NVIDIA's H100 SXM data
sheet at 700 W; the JAX script's 197 is a TPU's). The JAX script's --prng
picks JAX's bit generator, which torch has no counterpart of.

Prints ONE JSON line: steps_per_sec, events_per_sec, flops_per_step,
achieved_tflops, mfu, the final NLL, real_noise_prob (0 without a bank),
the bank's segment count and `card`, what
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints (on
the CPU, "cpu"); --out also writes it to a file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
CONFIG = ROOT / "configs" / "npe_production.yaml"   # the JAX script's
PEAK_BF16_FLOPS = 989e12        # H100 SXM, dense bf16 (NVIDIA data sheet)
BANK_SEGMENTS, BANK_SEED = 8, 7   # the JAX script's synthetic bank


def flops_per_step(state, batch) -> int:
    """FLOPs that FlopCounterMode counts in one train step on `batch`
    (matmuls and convolutions, forward and backward; the spline kernels
    and the optimizer's elementwise work are not counted). The step is
    taken: the state moves on by one update."""
    from torch.utils.flop_counter import FlopCounterMode

    from posteriflow_torch.train.trainer import train_step
    counter = FlopCounterMode(display=False)
    with counter:
        train_step(state, batch)
    return int(counter.get_total_flops())


def run(cfg, device="cuda", steps: int = 20, warmup: int = 2,
        init_from=None, seed: int = 0, bank=None,
        peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    """The benchmark on `device` (mixing in `bank`'s real noise with
    cfg.sim.real_noise_prob) -> the report dict."""
    from posteriflow_torch.physics.simulator import simulate_batch
    from posteriflow_torch.tools.bench import card_name
    from posteriflow_torch.train.checkpoints import load_release
    from posteriflow_torch.train.loop import _merge_params
    from posteriflow_torch.train.trainer import init_state, make_train_step

    dev = torch.device(device)
    state = init_state(cfg, generator=torch.Generator().manual_seed(seed),
                       device=dev)
    if init_from:
        merged, _, _ = _merge_params(state.model.state_dict(),
                                     load_release(init_from)[0])
        state.model.load_state_dict(merged)
    n_params = sum(p.numel() for p in state.model.parameters())
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    step = make_train_step(cfg, bank)

    t0 = time.perf_counter()
    m = step(state, gen)                        # first step: builds, warms
    flops = flops_per_step(state, simulate_batch(cfg.batch_size, cfg.sim,
                                                 device=dev, generator=gen,
                                                 bank=bank))
    for _ in range(max(warmup - 1, 0)):
        m = step(state, gen)
    float(m["nll"])
    warm_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(steps):
        m = step(state, gen)
    final_nll = float(m["nll"])                 # waits for the last step
    dt = time.perf_counter() - t0

    steps_per_s = steps / dt
    achieved = flops * steps_per_s
    return {
        "device": str(dev), "card": card_name(dev),
        "batch_size": cfg.batch_size, "encoder": cfg.npe.encoder_type,
        "psd_cond": cfg.npe.psd_cond,
        "real_noise_prob": cfg.sim.real_noise_prob if bank is not None
        else 0.0,
        "bank_segments": bank.n_segments if bank is not None else None,
        "n_params": n_params, "warmup_s": round(warm_s, 3),
        "steps_timed": steps, "steps_per_sec": steps_per_s,
        "events_per_sec": steps_per_s * cfg.batch_size,
        "flops_per_step": flops,
        "flops_counted": "matmuls and convolutions, forward and backward; "
                         "not the spline kernels, FFTs or elementwise work",
        "achieved_tflops": achieved / 1e12,
        "peak_tflops": peak_flops / 1e12,
        "mfu": achieved / peak_flops,
        "final_nll": final_nll,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--config", default=str(CONFIG),
                    help="YAML or JSON TrainConfig, a release's meta.json "
                         "or a release directory")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--init-from", default=None,
                    help="a release directory whose weights to train")
    ap.add_argument("--no-bank", action="store_true",
                    help="no synthetic noise bank: all events Gaussian")
    ap.add_argument("--peak-tflops", type=float,
                    default=PEAK_BF16_FLOPS / 1e12,
                    help="the card's dense bf16 peak in TFLOP/s (H100 SXM: "
                         "989)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    from posteriflow_torch.utils.config import load_config
    cfg = load_config(args.config)
    if args.batch:
        cfg = dataclasses.replace(cfg, batch_size=args.batch)
    bank = None
    if cfg.sim.real_noise_prob > 0.0 and not args.no_bank:
        from posteriflow_torch.data.noise_bank import make_synthetic_bank
        bank = make_synthetic_bank(
            torch.Generator(device=args.device).manual_seed(BANK_SEED),
            n_segments=BANK_SEGMENTS, psd_bands=cfg.sim.psd_bands,
            device=args.device)
    report = run(cfg, device=args.device, steps=args.steps,
                 warmup=args.warmup, init_from=args.init_from, bank=bank,
                 peak_flops=args.peak_tflops * 1e12)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=2))
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
