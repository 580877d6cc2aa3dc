"""Offline dataset generation: the simulator into HDF5 component storage.

The port's twin of scripts/generate_dataset.py. Batches of --batch events
from simulate_batch on --device (a generator seeded by --seed), the
strain as float16, parameters, signal counts, SNRs and ASD bands, and with
--components each live signal's whitened time series (and the noise as
the strain less their sum), written through data/io.DatasetWriter, with
run statistics in the sidecar metadata. Generation (`generate`) is split
from the write: the write needs h5py.

Usage:
  python -m posteriflow_torch.tools.generate_dataset --out data/val.h5 --n 5000
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, Iterator

import numpy as np

# placeholder parameters of dead slots (masses of 0 give NaN waveforms);
# their components are masked to 0
_SAFE = [30., 25., 500., 0., 0., 0., 0., 0., 0., 0., 0.]


def sim_config(max_signals: int = 5, overlap_fraction: float = 0.45,
               min_snr: float = 8.0):
    """The SimConfig of the tool's options (their defaults here)."""
    from posteriflow_torch.physics.simulator import SimConfig
    from posteriflow_torch.prior import PriorConfig
    return SimConfig(prior=PriorConfig(max_signals=max_signals,
                                       overlap_fraction=overlap_fraction),
                     min_snr=min_snr)


def components(params, n_sig, asd):
    """Per-signal whitened time series [B, S, 3, T] float16 (0 in dead
    slots) of params [B, S, 11]."""
    import torch

    from posteriflow_torch.physics.simulator import signal_white_fd
    from posteriflow_torch.physics.whiten import fd_white_to_td
    b, s, p = params.shape
    safe = torch.where(params[..., :1] > 0.5, params,
                       torch.tensor(_SAFE[:p], device=params.device))
    comp = fd_white_to_td(signal_white_fd(safe.reshape(b * s, p), asd))
    live = (torch.arange(s, device=params.device)[None, :]
            < n_sig[:, None]).float()
    comp = comp.reshape(b, s, *comp.shape[1:]) * live[..., None, None]
    return comp.to(torch.float16)


def generate(cfg, n: int, batch: int, seed: int, with_components: bool,
             device) -> Iterator[Dict[str, np.ndarray]]:
    """Records of up to `batch` events (numpy, the DatasetWriter's keys)
    until n events are made."""
    import torch

    from posteriflow_torch.physics.simulator import design_asd, simulate_batch
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    asd = design_asd(device)
    done = 0
    with torch.no_grad():
        while done < n:
            b = simulate_batch(batch, cfg, device=device, generator=gen)
            take = min(batch, n - done)
            rec = {
                "strain": b.strain[:take].to(torch.float16).cpu().numpy(),
                "params": b.params[:take].cpu().numpy(),
                "n_sig": b.n_sig[:take].to(torch.int32).cpu().numpy(),
                "net_snr": b.net_snr[:take].cpu().numpy(),
                "sig_snr": b.sig_snr[:take].cpu().numpy(),
                "asd_bands": b.asd_bands[:take].cpu().numpy(),
            }
            if with_components:
                comp = components(b.params[:take], b.n_sig[:take], asd)
                rec["signals"] = comp.cpu().numpy()
                rec["noise"] = rec["strain"] - comp.sum(dim=1).to(
                    torch.float16).cpu().numpy()
            done += take
            yield rec


def tally(stats: dict, rec: dict):
    """Add a record's signal counts, SNR sum and events to `stats`."""
    for k in rec["n_sig"].tolist():
        stats["n_signals_dist"][str(k)] = \
            stats["n_signals_dist"].get(str(k), 0) + 1
    stats["snr_sum"] += float(np.sum(rec["net_snr"]))
    stats["generated"] += len(rec["n_sig"])


def finish(stats: dict, seconds: float) -> dict:
    done = stats["generated"]
    stats.update(seconds=round(seconds, 1),
                 events_per_second=round(done / seconds, 1),
                 mean_net_snr=stats.pop("snr_sum") / max(done, 1))
    return stats


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=5000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--overlap-fraction", type=float, default=0.45)
    ap.add_argument("--min-snr", type=float, default=8.0)
    ap.add_argument("--max-signals", type=int, default=5)
    ap.add_argument("--components", action="store_true",
                    help="also store per-signal whitened components")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from posteriflow_torch.data.io import DatasetWriter, MetadataManager
    from posteriflow_torch.utils.logging import setup_logging
    log = setup_logging()

    cfg = sim_config(args.max_signals, args.overlap_fraction,
                     args.min_snr)
    t0 = time.time()
    stats = {"n_signals_dist": {}, "snr_sum": 0.0, "generated": 0}
    with DatasetWriter(args.out, config=dataclasses.asdict(cfg)) as w:
        for i, rec in enumerate(generate(cfg, args.n, args.batch, args.seed,
                                         args.components, args.device)):
            w.append_batch(rec)
            tally(stats, rec)
            if (i + 1) % 10 == 0:
                log.info("%d / %d events (%.0f ev/s)", stats["generated"],
                         args.n, stats["generated"] / (time.time() - t0))
    stats = finish(stats, time.time() - t0)
    MetadataManager(args.out).write(stats)
    log.info("wrote %d events -> %s in %.1fs (%.0f ev/s)", stats["generated"],
             args.out, stats["seconds"], stats["events_per_second"])
    print(json.dumps(stats, indent=2))
    return stats


if __name__ == "__main__":
    main()
