"""ctypes bindings for the native noise-bank crop server (csrc/bankd.cpp).

The native path is for banks too large to live in device memory: segments
stay memory-mapped on the host, and each training step asks for
[n, 3, T] float32 crops (multithreaded f16 → f32 with the flip/sign
decorrelation) in a host buffer that data/host_feed.py then copies to the
card. The library is built at first use by utils/native.py with

    $CXX (g++ when unset) -O3 -std=c++17 -fPIC -Wall -Wextra -pthread -shared

and has the JAX package's C ABI (runtime/bankd.cpp), so both servers give
the same crops from one seed. Without a compiler, or if the build fails
(the compiler's output is logged), the server reads the same files with
numpy: the same distribution, another random stream;
`NativeBankServer.native` says which path serves.
"""

from __future__ import annotations

import ctypes
import logging
import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from posteriflow_torch.physics.constants import DETECTORS, N_SAMPLES
from posteriflow_torch.utils import native

log = logging.getLogger("posteriflow.data")

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "bankd.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
             "-shared")
LIBRARY = native.Library(SOURCE, CXX_FLAGS, "pfbank",
                         lambda: os.environ.get("CXX", "g++"), extra=())


def build_native() -> bool:
    """Compile the shared library into _build/ unless it is there; returns
    success. A failed build logs the compiler's output."""
    try:
        LIBRARY.build()
    except RuntimeError as e:
        log.warning("bank server build failed: %s; serving crops with "
                    "numpy", e)
        return False
    return True


def _load_lib() -> Optional[ctypes.CDLL]:
    if not build_native():
        return None
    LIBRARY.bind("pf_bank_open", [ctypes.c_char_p], ctypes.c_void_p)
    LIBRARY.bind("pf_bank_n_segments", [ctypes.c_void_p, ctypes.c_int])
    LIBRARY.bind("pf_bank_sample", [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int])
    LIBRARY.bind("pf_bank_close", [ctypes.c_void_p], None)
    return LIBRARY.load()


class NativeBankServer:
    """Host-side crop server. sample(seed, n) -> (crops [n, 3, T] f32,
    seg_idx [n, 3] i32). Deterministic in (seed, event index)."""

    def __init__(self, bank_dir: str | Path, n_threads: int = 4):
        self.bank_dir = Path(bank_dir)
        self.n_threads = n_threads
        self._lib = _load_lib()
        self._handle = None
        if self._lib is not None:
            h = self._lib.pf_bank_open(str(self.bank_dir).encode())
            self._handle = h or None
        if self._handle is None:
            # numpy path: memmap the same files
            self._segments = {
                d: [np.load(f, mmap_mode="r") for f in
                    sorted(self.bank_dir.glob(f"{d}_*_strain.npy"))]
                for d in DETECTORS}
            if any(not v for v in self._segments.values()):
                raise ValueError(f"no bank segments under {self.bank_dir}")

    @property
    def native(self) -> bool:
        return self._handle is not None

    def n_segments(self, det: int = 0) -> int:
        if self.native:
            return self._lib.pf_bank_n_segments(
                ctypes.c_void_p(self._handle), det)
        return len(self._segments[DETECTORS[det]])

    def sample(self, seed: int, n_events: int, crop_len: int = N_SAMPLES,
               out: Optional[np.ndarray] = None,
               idx: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Crops of n_events events, written into `out` [n, 3, crop_len]
        float32 and `idx` [n, 3] int32 (C-contiguous, e.g. views of pinned
        host tensors) when given."""
        if out is None:
            out = np.empty((n_events, 3, crop_len), dtype=np.float32)
        if idx is None:
            idx = np.empty((n_events, 3), dtype=np.int32)
        if (out.shape != (n_events, 3, crop_len) or out.dtype != np.float32
                or not out.flags.c_contiguous or idx.shape != (n_events, 3)
                or idx.dtype != np.int32 or not idx.flags.c_contiguous):
            raise ValueError("out must be C-contiguous float32 [n, 3, "
                             "crop_len] and idx int32 [n, 3]")
        if self.native:
            rc = self._lib.pf_bank_sample(
                ctypes.c_void_p(self._handle), ctypes.c_uint64(seed),
                n_events, crop_len,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                self.n_threads)
            if rc != 0:
                raise RuntimeError(f"pf_bank_sample failed rc={rc}")
            return out, idx
        # numpy path (the same distribution; another random stream)
        rng = np.random.default_rng(seed)
        for i in range(n_events):
            for d, det in enumerate(DETECTORS):
                segs = self._segments[det]
                k = int(rng.integers(len(segs)))
                seg = segs[k]
                off = int(rng.integers(0, len(seg) - crop_len + 1))
                c = np.asarray(seg[off:off + crop_len], dtype=np.float32)
                if rng.uniform() < 0.5:
                    c = -c[::-1]
                out[i, d] = c
                idx[i, d] = k
        return out, idx

    def close(self):
        if self.native and self._handle is not None:
            self._lib.pf_bank_close(ctypes.c_void_p(self._handle))
            self._handle = None
