"""Host-side real-noise feed: the native crop server, pinned staging
buffers and an asynchronous copy to the card.

Port of posteriflow_tpu/data/host_feed.py. For banks larger than device
memory the segments stay memory-mapped on the host (data/native_bank.py);
a producer thread keeps the next `depth` batches of crops staged while the
current training step runs. The feed supplies (noise [B, 3, T], recolor
[B, 3, F], asd_bands [B, 3, K]), the per-event quantities that
simulate_batch takes as `real_feed`; deterministic in (seed, batch index).

On the card each batch's crops are written by the server straight into a
pinned host buffer, copied with non_blocking=True on the feed's own CUDA
stream, where the segment filters and band summaries (small, held on the
card) are gathered too; an event recorded after them is what `next()`
makes the caller's stream wait on. A pinned buffer is written again only
after the copy out of it has finished (its event is synchronised first),
and the tensors handed out are recorded on the caller's stream, so the
allocator keeps them until that stream is done with them.
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from posteriflow_torch.data.native_bank import NativeBankServer
from posteriflow_torch.data.noise_bank import bank_filters
from posteriflow_torch.physics.constants import DETECTORS, N_SAMPLES


class _Slot:
    """One pinned staging buffer and the event of the last copy out of it."""

    def __init__(self, batch_size: int, pin: bool):
        self.crops = torch.empty((batch_size, len(DETECTORS), N_SAMPLES),
                                 dtype=torch.float32, pin_memory=pin)
        self.idx = torch.empty((batch_size, len(DETECTORS)),
                               dtype=torch.int32, pin_memory=pin)
        self.copied: Optional[torch.cuda.Event] = None


class HostNoiseFeed:
    """Prefetching real-noise batch source backed by the native server.

    next() -> (noise, recolor, asd_bands) on `device` for batch_size
    events; batch i comes from server seed seed·1_000_003 + i."""

    def __init__(self, bank_dir: str | Path, batch_size: int,
                 psd_bands: int = 16, seed: int = 0, depth: int = 2,
                 n_threads: int = 4, device="cuda"):
        self.bank_dir = Path(bank_dir)
        self.batch_size = batch_size
        self.seed = seed
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        if self._cuda and self.device.index is None:
            # the producer thread selects this card by its index
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.server = NativeBankServer(self.bank_dir, n_threads=n_threads)

        # per-segment recolor filters and band summaries, on the device
        per_det = [bank_filters(self.bank_dir, d, psd_bands)
                   for d in DETECTORS]
        n = min(len(p) for p in per_det)
        self._recolor = torch.from_numpy(np.stack(
            [np.stack([f for _, f, _ in p[:n]]) for p in per_det])
        ).to(self.device)
        self._bands = torch.from_numpy(np.stack(
            [np.stack([b for _, _, b in p[:n]]) for p in per_det])
        ).to(self.device)
        self._det = torch.arange(len(DETECTORS), device=self.device)

        self._stream = None
        if self._cuda:
            # the feed's stream orders its gathers after the tables' copies
            self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        # depth batches queued, one being handed out, one being filled
        self._slots: List[_Slot] = [_Slot(batch_size, self._cuda)
                                    for _ in range(depth + 2)]
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[Exception] = None
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _make(self, i: int, slot: _Slot):
        """Batch i through `slot`: crops into its host buffer, then to the
        device (on the feed's stream on the card) with the gathers."""
        if slot.copied is not None:
            slot.copied.synchronize()        # its last copy has finished
        self.server.sample(seed=self.seed * 1_000_003 + i,
                           n_events=self.batch_size, crop_len=N_SAMPLES,
                           out=slot.crops.numpy(), idx=slot.idx.numpy())
        if not self._cuda:
            seg = slot.idx.long()
            return (slot.crops.clone(), self._recolor[self._det, seg],
                    self._bands[self._det, seg]), None
        with torch.cuda.stream(self._stream):
            noise = slot.crops.to(self.device, non_blocking=True)
            seg = slot.idx.to(self.device, non_blocking=True).long()
            out = (noise, self._recolor[self._det, seg],
                   self._bands[self._det, seg])
            slot.copied = torch.cuda.Event()
            slot.copied.record(self._stream)
        return out, slot.copied

    def _producer(self):
        if self._cuda:
            torch.cuda.set_device(self.device)
        i = 0
        try:
            while not self._stop.is_set():
                item = self._make(i, self._slots[i % len(self._slots)])
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                i += 1
        except Exception as e:              # handed to the consumer
            self._error = e
            self._q.put(None)

    def next(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The next batch; on the card, ordered after its copy on the
        caller's current stream."""
        item = self._q.get()
        if item is None:
            raise RuntimeError("host noise feed failed") from self._error
        tensors, copied = item
        if copied is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(copied)
            for t in tensors:
                t.record_stream(stream)
        return tensors

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
        if self._stream is not None:
            self._stream.synchronize()
        self.server.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
