"""Data-exploration walkthrough: a batch of the training simulator, its
whitened strain with the merger times marked, the prior's histograms over
live signals, a spectrogram, and the batch's statistics.

The port's twin of examples/explore_data.py, on --device. The compute
(`explore`) is split from the plots (`plot`, which needs matplotlib).

Run: python -m posteriflow_torch.examples.explore_data [--out /tmp/explore] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def explore(batch: int = 64, seed: int = 0, device="cuda") -> dict:
    """A SimConfig() batch as numpy ({"strain", "params", "n_sig",
    "net_snr"}) and its statistics ({"n_sig_dist", "regimes",
    "whitened_std"})."""
    import torch

    from posteriflow_torch.data.snr_utils import regime_fractions
    from posteriflow_torch.physics.simulator import SimConfig, simulate_batch

    with torch.no_grad():
        b = simulate_batch(batch, SimConfig(), device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(seed))
    data = {"strain": b.strain.cpu().numpy(),
            "params": b.params.cpu().numpy(),
            "n_sig": b.n_sig.cpu().numpy(),
            "net_snr": b.net_snr.cpu().numpy()}
    n_sig, snr = data["n_sig"], data["net_snr"]
    stats = {"n_sig_dist": {int(k): int(v) for k, v in
                            zip(*np.unique(n_sig, return_counts=True))},
             "regimes": regime_fractions(snr[n_sig > 0]),
             "whitened_std": round(float(data["strain"].std()), 3)}
    return {"data": data, "stats": stats}


def plot(data: dict, out: Path):
    """strain.png, priors.png and spectrogram.png of the loudest event."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from posteriflow_torch import PARAM_NAMES
    from posteriflow_torch.physics.constants import (DETECTORS, DURATION,
                                                     SAMPLE_RATE)
    strain, params = data["strain"], data["params"]
    n_sig, snr = data["n_sig"], data["net_snr"]

    i = int(np.argmax(snr))
    t = np.arange(strain.shape[-1]) / SAMPLE_RATE - DURATION / 2
    fig, axes = plt.subplots(3, 1, figsize=(12, 7), sharex=True)
    for d, det in enumerate(DETECTORS):
        axes[d].plot(t, strain[i, d], lw=0.4, color="0.5")
        axes[d].set_ylabel(det)
    for k in range(n_sig[i]):
        for ax in axes:
            ax.axvline(params[i, k, 8], color="#cc3311", ls="--", lw=1)
    axes[0].set_title(f"event {i}: n_sig={n_sig[i]} net SNR={snr[i]:.1f} "
                      f"(dashed = merger times)")
    axes[-1].set_xlabel("t - GPS_REF [s]")
    fig.tight_layout()
    fig.savefig(out / "strain.png", dpi=110)
    plt.close(fig)

    live = np.arange(params.shape[1])[None] < n_sig[:, None]
    p = params[live]
    fig, axes = plt.subplots(3, 4, figsize=(14, 8))
    for j, name in enumerate(PARAM_NAMES):
        axes.flat[j].hist(p[:, j], bins=30, color="#4477aa")
        axes.flat[j].set_title(name, fontsize=9)
    axes.flat[11].hist(snr[n_sig > 0], bins=30, color="#ee7733")
    axes.flat[11].set_title("network SNR", fontsize=9)
    fig.tight_layout()
    fig.savefig(out / "priors.png", dpi=110)
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(10, 4))
    ax.specgram(strain[i, 0], NFFT=256, Fs=SAMPLE_RATE, noverlap=192,
                cmap="viridis")
    ax.set_ylim(0, 512)
    ax.set_xlabel("t [s]")
    ax.set_ylabel("f [Hz]")
    ax.set_title("H1 spectrogram (loudest event)")
    fig.tight_layout()
    fig.savefig(out / "spectrogram.png", dpi=110)
    plt.close(fig)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--out", default="/tmp/explore")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    tour = explore(args.batch, args.seed, args.device)
    plot(tour["data"], out)
    stats = tour["stats"]
    print("batch stats:")
    print("  n_sig distribution:", stats["n_sig_dist"])
    print("  SNR regimes:", stats["regimes"])
    print("  whitened std:", stats["whitened_std"])
    print(f"figures -> {out}")
    return stats


if __name__ == "__main__":
    main()
