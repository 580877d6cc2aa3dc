"""Diagnostic plots: PP-plots, SBC histograms, whitened-strain
reconstruction overlays, marginal CDFs.

Port of posteriflow_tpu/inference/plots.py. matplotlib is imported only
inside the functions that draw. The figures are JAX's, axis for axis,
with one departure: where JAX's fixed 3 × 4 grid has too few axes for the
parameters (15-D) and raises IndexError, the grid grows to ⌈P/4⌉ rows of
4 (`grid_rows`). With the default 11 names on wider inputs both packages
show the first 11 parameters.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from posteriflow_torch import PARAM_NAMES


def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def grid_rows(n_params: int) -> int:
    """Rows of 4 axes for n_params panels: JAX's 3 while they fit, else
    ⌈n_params/4⌉."""
    return max(3, -(-n_params // 4))


def _panel_grid(plt, n_params: int):
    """(fig, axes) of JAX's 3 × 4 panels at (14, 8) inches, grown by rows
    of the same height when more panels are needed."""
    rows = grid_rows(n_params)
    return plt.subplots(rows, 4, figsize=(14, 8 * rows / 3))


def pp_plot(ranks: np.ndarray, live: Optional[np.ndarray], n_post: int,
            path: str | Path, param_names: Sequence[str] = PARAM_NAMES):
    """Probability–probability plot from SBC ranks [N, P]: for a calibrated
    posterior the empirical CDF of rank quantiles is the diagonal."""
    plt = _mpl()
    ranks = np.asarray(ranks)
    if live is not None:
        ranks = ranks[np.asarray(live) > 0]
    u = (ranks + 0.5) / (n_post + 1.0)
    n = u.shape[0]
    grid = np.linspace(0, 1, 101)
    fig, ax = plt.subplots(figsize=(6, 6))
    # 3σ binomial confidence band around the diagonal
    band = 3.0 * np.sqrt(grid * (1 - grid) / max(n, 1))
    ax.fill_between(grid, grid - band, grid + band, color="0.9",
                    label=r"3σ band")
    for j, name in enumerate(param_names):
        ecdf = np.searchsorted(np.sort(u[:, j]), grid) / max(n, 1)
        ax.plot(grid, ecdf, lw=1, label=name)
    ax.plot([0, 1], [0, 1], "k--", lw=1)
    ax.set_xlabel("credible level")
    ax.set_ylabel("empirical coverage")
    ax.set_title(f"PP plot ({n} events × {n_post} draws)")
    ax.legend(fontsize=7, ncol=2)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def sbc_histograms(ranks: np.ndarray, n_post: int, path: str | Path,
                   param_names: Sequence[str] = PARAM_NAMES,
                   n_bins: int = 20):
    """Per-parameter SBC rank histograms (uniform = calibrated)."""
    plt = _mpl()
    ranks = np.asarray(ranks)
    fig, axes = _panel_grid(plt, len(param_names))
    expect = ranks.shape[0] / n_bins
    for j, name in enumerate(param_names):
        ax = axes.flat[j]
        ax.hist(ranks[:, j], bins=n_bins, range=(0, n_post),
                color="#4477aa")
        ax.axhline(expect, color="k", ls="--", lw=1)
        ax.set_title(name, fontsize=9)
    for j in range(len(param_names), axes.size):
        axes.flat[j].axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def reconstruction_overlay(strain_white: np.ndarray,
                           samples: np.ndarray, path: str | Path,
                           n_draws: int = 20, window_s: float = 1.0,
                           device="cuda"):
    """Whitened data with posterior-draw waveform reconstructions overlaid
    around the inferred merger; the waveforms are made on `device`."""
    import torch

    from posteriflow_torch.physics.constants import (DETECTORS, DURATION,
                                                     SAMPLE_RATE)
    from posteriflow_torch.physics.psd import default_network_asd
    from posteriflow_torch.physics.simulator import signal_white_fd
    from posteriflow_torch.physics.whiten import fd_white_to_td

    plt = _mpl()
    asd = default_network_asd(device=device)
    t_med = float(np.median(samples[:, 8]))
    c = int((t_med + DURATION / 2) * SAMPLE_RATE)
    half = int(window_s * SAMPLE_RATE / 2)
    lo, hi = max(c - half, 0), min(c + half, strain_white.shape[-1])
    t_axis = (np.arange(lo, hi) / SAMPLE_RATE) - DURATION / 2

    fig, axes = plt.subplots(3, 1, figsize=(12, 8), sharex=True)
    idx = np.random.default_rng(0).choice(len(samples),
                                          min(n_draws, len(samples)),
                                          replace=False)
    theta = torch.as_tensor(np.asarray(samples)[idx], dtype=torch.float32,
                            device=device)
    recon = fd_white_to_td(signal_white_fd(theta, asd)).cpu().numpy()
    for d, det in enumerate(DETECTORS):
        ax = axes[d]
        ax.plot(t_axis, strain_white[d, lo:hi], color="0.6", lw=0.5,
                label="whitened data")
        for r in recon:
            ax.plot(t_axis, r[d, lo:hi], color="#cc3311", alpha=0.15,
                    lw=0.8)
        ax.set_ylabel(det)
    axes[0].legend(loc="upper left", fontsize=8)
    axes[-1].set_xlabel("time from window center [s]")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def marginal_cdfs(samples: np.ndarray, path: str | Path,
                  truths: Optional[np.ndarray] = None,
                  param_names: Sequence[str] = PARAM_NAMES):
    plt = _mpl()
    fig, axes = _panel_grid(plt, len(param_names))
    for j, name in enumerate(param_names):
        ax = axes.flat[j]
        s = np.sort(samples[:, j])
        ax.plot(s, np.linspace(0, 1, len(s)), color="#4477aa")
        if truths is not None:
            ax.axvline(truths[j], color="#cc3311", ls="--", lw=1)
        ax.set_title(name, fontsize=9)
    for j in range(len(param_names), axes.size):
        axes.flat[j].axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
