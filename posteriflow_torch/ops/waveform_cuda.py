"""The simulator's per-bin waveform passes as CUDA kernels
(csrc/waveform.cu), with their plain versions.

A training batch's waveforms (physics/simulator.py:gated_signal_sum) take
one table of its B·S slots' per-signal constants and, for the precessing
set, their coarse twist (physics/signal_table.py, PyTorch ops), then two
passes over the bins: the gate's amplitude-only SNR of every slot
(`wf_snr`; plain: signal_table.snr_plain) and, after the gate, the kept
slots' whitened sum (`wf_sum`; plain: the slots' white_fd_plain weighted
by keep and summed). `KERNEL` and `PLAIN` give the two passes under the
same names (`snr`, `sum`); `passes(x, asd)` picks KERNEL for CUDA float32
inputs that need no gradient (grad mode off, or none requires grad) and
PLAIN otherwise: CPU tensors, other dtypes, and autograd, for which the
kernels have no backward. On the inputs it takes, a kernel launches or
raises; there is no fallback.

The kernels evaluate the plain versions' formulas in float32, each op
rounded as PyTorch's card ops round it: `sum` gives the plain sum's bits,
`snr` sums its bins in a fixed order of its own (within ~2e-7 of the
plain SNR), and both are deterministic.
`KERNEL.launches` counts the launches. The library is built at first use
by utils/native.py.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from posteriflow_torch.physics.constants import DELTA_F, N_DETECTORS
from posteriflow_torch.physics.signal_table import (COLUMNS, FREQS_NP,
                                                    SQRT_4DF, Twist,
                                                    snr_plain,
                                                    white_fd_plain)
from posteriflow_torch.utils import native

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "waveform.cu"
# -fmad=false: PyTorch rounds each op of the plain evaluation apart, so no
# product may be contracted into a sum; no fast math (the phase reaches
# ~1e4 rad)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
# csrc/waveform.cu: kMaxSlots
MAX_SLOTS = 16
N_BINS = FREQS_NP.shape[0]


def kernel_takes(x: torch.Tensor, *others: Optional[torch.Tensor]) -> bool:
    """True for a CUDA float32 `x` when no gradient is needed through x or
    `others`."""
    if x.device.type != "cuda" or x.dtype != torch.float32:
        return False
    return not (torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, *others)))


class PlainPasses:
    """The plain versions of the two kernels, in PyTorch ops."""

    @staticmethod
    def snr(table: torch.Tensor, twist: Optional[Twist], asd: torch.Tensor,
            decimate: int, f_lower: float = 20.0) -> torch.Tensor:
        return snr_plain(table, twist, asd, decimate, f_lower)

    @staticmethod
    def sum(table: torch.Tensor, twist: Optional[Twist], keep: torch.Tensor,
            asd: torch.Tensor, f_lower: float = 20.0) -> torch.Tensor:
        """Every slot's whitened waveform, weighted by keep [B, S] and
        summed an event."""
        b, s = keep.shape
        h_w = white_fd_plain(table, twist, asd, f_lower).reshape(
            b, s, N_DETECTORS, -1)
        return torch.sum(keep[:, :, None, None] * h_w, dim=1)


PLAIN = PlainPasses()


def _on_card(name: str, t: torch.Tensor, device: torch.device,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"waveform kernels need every input on one CUDA "
                         f"device, got {name} on {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"waveform kernels take {name} in {dtype}, got "
                        f"{t.dtype}")
    return t.contiguous()


class WaveformKernel(native.Library):
    """The library of csrc/waveform.cu, its two launchers and their
    launch count.

    `launches` goes up by one for each launch of either kernel and nowhere
    else; callers read and reset it to show that a path ran the
    kernels."""

    def __init__(self):
        super().__init__(SOURCE, NVCC_FLAGS, "waveform")
        self._fns = None
        self.launches = 0

    def _bind(self) -> dict:
        if self._fns is None:
            ncol = self.bind("pf_wf_columns", [])()
            if ncol != len(COLUMNS):
                raise RuntimeError(f"{SOURCE.name} has {ncol} table columns, "
                                   f"signal_table.COLUMNS {len(COLUMNS)}")
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            self._fns = {
                "snr": self.bind("pf_wf_snr_launch", [
                    p, i, p, p, i, p, p, p, i, i, i, f, f, i, p, i, p]),
                "sum": self.bind("pf_wf_sum_launch", [
                    p, p, i, i, p, p, i, p, p, p, i, f, f, f, i, p, i, p]),
            }
        return self._fns

    def _launch(self, name: str, device: torch.device, *args):
        index = device.index or 0
        err = self._bind()[name](
            *args, index, torch.cuda.current_stream(index).cuda_stream)
        if err != 0:
            raise RuntimeError(f"wf_{name} launch failed with CUDA error "
                               f"{err}")
        self.launches += 1

    @staticmethod
    def _twist_args(twist: Optional[Twist], n: int, n_bins: int) -> tuple:
        if twist is None:
            return None, None, 0, None, None
        k = twist.grid.freqs.shape[0]
        for name, t in (("sp", twist.sp), ("sm", twist.sm)):
            if (t.dtype != torch.complex64 or tuple(t.shape) != (n, k)
                    or not t.is_contiguous()):
                raise ValueError(f"twist {name} must be contiguous complex64 "
                                 f"[{n}, {k}], got {t.dtype} "
                                 f"{tuple(t.shape)}")
        if twist.grid.seg.shape[0] != n_bins:
            raise ValueError(f"twist grid of {twist.grid.seg.shape[0]} "
                             f"bins for {n_bins}")
        return (twist.sp.data_ptr(), twist.sm.data_ptr(), k,
                twist.grid.seg.data_ptr(), twist.grid.w.data_ptr())

    @staticmethod
    def _table_asd(table, twist, asd):
        dev = table.device
        table = _on_card("table", table, dev)
        asd = _on_card("asd", asd, dev)
        if table.dim() != 2 or table.shape[1] != len(COLUMNS):
            raise ValueError(f"table must be [N, {len(COLUMNS)}], got "
                             f"{tuple(table.shape)}")
        if tuple(asd.shape) != (N_DETECTORS, N_BINS):
            raise ValueError(f"asd must be [{N_DETECTORS}, {N_BINS}], got "
                             f"{tuple(asd.shape)}")
        if twist is not None:
            _on_card("twist", twist.sp, dev, torch.complex64)
            _on_card("twist", twist.sm, dev, torch.complex64)
        return table, asd

    def snr(self, table: torch.Tensor, twist: Optional[Twist],
            asd: torch.Tensor, decimate: int,
            f_lower: float = 20.0) -> torch.Tensor:
        """wf_snr: the network SNR [N] of the table's signals from the
        amplitude alone on every decimate-th bin (twist: the precessing
        set's, on that grid)."""
        table, asd = self._table_asd(table, twist, asd)
        n = table.shape[0]
        n_bins = (N_BINS - 1) // decimate + 1
        targs = self._twist_args(twist, n, n_bins)
        out = torch.empty(n, dtype=torch.float32, device=table.device)
        if n:
            self._launch("snr", table.device, table.data_ptr(), n, *targs,
                         asd.data_ptr(), N_BINS, n_bins, decimate, DELTA_F,
                         f_lower, int(twist is not None), out.data_ptr())
        return out

    def sum(self, table: torch.Tensor, twist: Optional[Twist],
            keep: torch.Tensor, asd: torch.Tensor,
            f_lower: float = 20.0) -> torch.Tensor:
        """wf_sum: [B, n_det, N_RFFT] complex64, each event's kept slots'
        whitened strain summed in slot order; table [B·S, C] in event-major
        slot order, keep [B, S] (kept where not 0)."""
        table, asd = self._table_asd(table, twist, asd)
        keep = _on_card("keep", keep, table.device)
        if keep.dim() != 2 or keep.shape[0] * keep.shape[1] != table.shape[0]:
            raise ValueError(f"keep must be [B, S] with B·S = "
                             f"{table.shape[0]}, got {tuple(keep.shape)}")
        b, s = keep.shape
        if not 0 < s <= MAX_SLOTS:
            raise ValueError(f"wf_sum takes 1 to {MAX_SLOTS} slots, got "
                             f"{s}")
        targs = self._twist_args(twist, table.shape[0], N_BINS)
        out = torch.empty((b, N_DETECTORS, N_BINS), dtype=torch.complex64,
                          device=table.device)
        if b:
            self._launch("sum", table.device, table.data_ptr(),
                         keep.data_ptr(), b, s, *targs, asd.data_ptr(),
                         N_BINS, DELTA_F, f_lower, SQRT_4DF,
                         int(twist is not None), out.data_ptr())
        return out


KERNEL = WaveformKernel()


def passes(x: torch.Tensor, *others: Optional[torch.Tensor]):
    """KERNEL where `kernel_takes(x, *others)`, else PLAIN."""
    return KERNEL if kernel_takes(x, *others) else PLAIN
