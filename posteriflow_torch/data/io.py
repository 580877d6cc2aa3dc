"""Offline dataset I/O: HDF5 writer/reader + metadata.

Port of posteriflow_tpu/data/io.py, the same file layout, with h5py
imported inside the functions that need it (a machine without h5py can
import the module). The training path never touches disk (on-device
synthesis); the offline format is for frozen evaluation sets,
cross-framework comparisons, and simulator output stored by component
(whitened noise + each whitened signal separately, float16, so components
re-sum exactly).

Layout per file (HDF5):
  strain    [N, 3, T]  f16   whitened noise+signals
  noise     [N, 3, T]  f16   whitened noise component
  signals   [N, S, 3, T] f16 per-signal whitened components
  params    [N, S, 11] f32   rank-ordered physical parameters
  n_sig     [N]        i32
  net_snr   [N]        f32
  sig_snr   [N, S]     f32
  attrs: config JSON, creation metadata
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np


class DatasetWriter:
    def __init__(self, path: str | Path, config: Optional[dict] = None):
        import h5py
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = h5py.File(self.path, "w")
        self._f.attrs["config"] = json.dumps(config or {})
        self._f.attrs["created"] = time.time()
        self._f.attrs["framework"] = "posteriflow_torch"
        self._n = 0

    def append_batch(self, batch: Dict[str, np.ndarray]):
        """batch: dict of arrays with matching leading dim."""
        import h5py
        n_new = len(next(iter(batch.values())))
        for k, v in batch.items():
            v = np.asarray(v)
            if k not in self._f:
                maxshape = (None,) + v.shape[1:]
                dt = np.float16 if k in ("strain", "noise",
                                         "signals") else v.dtype
                self._f.create_dataset(k, shape=(0,) + v.shape[1:],
                                       maxshape=maxshape, dtype=dt,
                                       chunks=(min(64, max(n_new, 1)),)
                                       + v.shape[1:])
            ds = self._f[k]
            ds.resize(self._n + n_new, axis=0)
            ds[self._n:self._n + n_new] = v
        self._n += n_new

    def close(self):
        self._f.attrs["n_events"] = self._n
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class DatasetReader:
    def __init__(self, path: str | Path):
        import h5py
        self.path = Path(path)
        self._f = h5py.File(self.path, "r")

    @property
    def n_events(self) -> int:
        return int(self._f.attrs.get("n_events",
                                     len(self._f["params"])))

    @property
    def config(self) -> dict:
        return json.loads(self._f.attrs.get("config", "{}"))

    def __len__(self):
        return self.n_events

    def keys(self):
        return list(self._f.keys())

    def read(self, key: str, start: int = 0,
             stop: Optional[int] = None) -> np.ndarray:
        return np.asarray(self._f[key][start:stop])

    def batches(self, batch_size: int = 128) -> Iterator[Dict]:
        for i in range(0, self.n_events, batch_size):
            yield {k: np.asarray(self._f[k][i:i + batch_size])
                   for k in self._f.keys()}

    def close(self):
        self._f.close()


class MetadataManager:
    """Sidecar JSON metadata (reference MetadataManager: io_utils.py:507)."""

    def __init__(self, dataset_path: str | Path):
        self.path = Path(str(dataset_path) + ".meta.json")

    def write(self, meta: dict):
        meta = {**meta, "updated": time.time()}
        self.path.write_text(json.dumps(meta, indent=2, default=float))

    def read(self) -> dict:
        return json.loads(self.path.read_text()) if self.path.exists() \
            else {}


def validate_dataset(path: str | Path, max_events: int = 2048) -> dict:
    """Post-hoc dataset validation: integrity, distributions, SNR gate
    (reference analog: src/ahsd/data/scripts/validate_dataset.py)."""
    r = DatasetReader(path)
    issues = []
    n = min(r.n_events, max_events)
    strain = r.read("strain", 0, n).astype(np.float32)
    params = r.read("params", 0, n)
    n_sig = r.read("n_sig", 0, n)
    sig_snr = r.read("sig_snr", 0, n)

    if not np.isfinite(strain).all():
        issues.append("non-finite strain")
    std = strain.std(axis=(1, 2))
    if not ((std > 0.8) & (std < 3.0)).all():
        issues.append(f"whitened std out of range: "
                      f"[{std.min():.2f}, {std.max():.2f}]")
    live = np.arange(params.shape[1])[None, :] < n_sig[:, None]
    if live.any():
        m1, m2 = params[..., 0][live], params[..., 1][live]
        if (m1 < m2 - 1e-5).any():
            issues.append("mass ordering violated")
        if (sig_snr[live] < 8.0 - 1e-3).any():
            issues.append(f"SNR gate violated: min {sig_snr[live].min():.2f}")
        d = params[..., 2][live]
        if d.min() < 5.0 or d.max() > 2200.0:
            issues.append(f"distance outside prior: [{d.min()}, {d.max()}]")
    frac_overlap = float((n_sig >= 2).mean())
    frac_noise = float((n_sig == 0).mean())
    report = {
        "valid": not issues, "issues": issues, "n_checked": int(n),
        "frac_overlap": frac_overlap, "frac_noise_only": frac_noise,
        "mean_strain_std": float(std.mean()),
        "mean_live_snr": float(sig_snr[live].mean()) if live.any() else None,
    }
    r.close()
    return report


def repair_dataset(path: str | Path, out_path: Optional[str | Path] = None,
                   max_events: Optional[int] = None) -> dict:
    """Legacy-dataset repair (reference: io_utils.py repair machinery):
    rewrite a dataset fixing the recoverable defect classes —

      - truncated/ragged arrays: clipped to the shortest consistent length;
      - non-finite strain: events dropped;
      - mass-ordering violations: m1/m2 swapped in place;
      - wrong dtypes: strain -> float16 storage, params -> float32;
      - missing sidecar metadata: regenerated with repair provenance.

    Returns {n_in, n_out, dropped, swapped, out_path}.
    """
    r = DatasetReader(path)
    n = r.n_events
    keys = list(r.keys())
    lengths = []
    data = {}
    for k in keys:
        arr = r.read(k, 0, n)
        lengths.append(len(arr))
        data[k] = arr
    cfg = r.config
    r.close()
    n_min = min(lengths) if lengths else 0
    if max_events:
        n_min = min(n_min, max_events)
    data = {k: v[:n_min] for k, v in data.items()}

    dropped = np.zeros(n_min, dtype=bool)
    if "strain" in data:
        dropped |= ~np.isfinite(
            data["strain"].astype(np.float32)).all(axis=(1, 2))
    swapped = 0
    if "params" in data:
        p = data["params"].astype(np.float32)
        bad = p[..., 0] < p[..., 1]
        swapped = int(bad.sum())
        m1 = np.maximum(p[..., 0], p[..., 1])
        m2 = np.minimum(p[..., 0], p[..., 1])
        p[..., 0], p[..., 1] = m1, m2
        data["params"] = p
    keep = ~dropped
    data = {k: v[keep] for k, v in data.items()}

    out_path = Path(out_path or (str(path) + ".repaired.h5"))
    with DatasetWriter(out_path, config=cfg) as w:
        for start in range(0, int(keep.sum()), 1024):
            w.append_batch({k: v[start:start + 1024]
                            for k, v in data.items()})
    MetadataManager(out_path).write({
        "repaired_from": str(path), "n_in": int(n),
        "n_out": int(keep.sum()), "dropped": int(dropped.sum()),
        "mass_order_swapped": swapped})
    return {"n_in": int(n), "n_out": int(keep.sum()),
            "dropped": int(dropped.sum()), "swapped": swapped,
            "out_path": str(out_path)}
