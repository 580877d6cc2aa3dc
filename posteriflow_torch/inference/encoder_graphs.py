"""The served encoder's forward as CUDA graphs, one per part.

The coherent encoder's gradient-free forward is ~480 small operators: on
an H100 ~1.2 ms of device work behind ~10 ms of the host's dispatch.
`ServedEncoder` captures that forward once for an input shape, as one CUDA
graph per part of `LeanStrainEncoder.parts()` (energy with the input's
clean-up, geometry, stem, fusion, head) over one memory pool, and replays
the parts, each inside its own `pf.encoder.*` span. The kernels, the
precision and the arithmetic are the eager call's.

`GraphPolicy` decides by the input's shape key: the first call of a key
runs eagerly, the second captures and replays, later calls replay; at
most MAX_KEYS keys are kept, the least recently used dropped first. So a
shape seen once pays nothing. Only `InferenceEngine.encode` uses this, on
a card (it runs with gradients off); training calls the model directly.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Hashable

import torch

from posteriflow_torch.utils.logging import count, count_h2d, paused, span
from posteriflow_torch.utils.precision import fp32_exact

MAX_KEYS = 8
EAGER, CAPTURE, REPLAY = "eager", "capture", "replay"


def to_device(strain, bands, device, into=(None, None)):
    """The caller's strain and bands (numpy or tensors; bands may be None)
    as float32 tensors on `device`, copied into the tensors `into` where
    given; a copy from pageable host memory each is counted."""
    return tuple(None if a is None else _to_device(a, device, buf)
                 for a, buf in zip((strain, bands), into))


def _to_device(a, device, buf):
    count_h2d(a, device)
    if buf is None:
        return torch.as_tensor(a, dtype=torch.float32, device=device)
    return buf.copy_(torch.as_tensor(a, dtype=torch.float32))


def shape_key(strain, bands) -> tuple:
    """(strain's shape, the bands' shape or None) of numpy arrays or
    tensors."""
    return tuple(strain.shape), None if bands is None else tuple(bands.shape)


class GraphPolicy:
    """Which way each call of a shape key goes, and what a key keeps.

    `step(key)` returns EAGER for a key it does not hold (and then holds
    it), CAPTURE for a held key with nothing stored, REPLAY for one with
    graphs stored by `store`. Holding more than MAX_KEYS keys drops the
    least recently stepped one."""

    def __init__(self):
        self._held: "OrderedDict[Hashable, object]" = OrderedDict()

    def step(self, key: Hashable) -> str:
        if key in self._held:
            self._held.move_to_end(key)
            return CAPTURE if self._held[key] is None else REPLAY
        self._held[key] = None
        if len(self._held) > MAX_KEYS:
            self._held.popitem(last=False)
        return EAGER

    def store(self, key: Hashable, graphs) -> None:
        self._held[key] = graphs

    def get(self, key: Hashable):
        return self._held.get(key)


class EncoderGraphs:
    """One shape's captured forward: static input buffers, one CUDA graph
    a part in the order of `encoder.parts()`, and the static tensors the
    parts leave (`io`). The parts share one memory pool; they are replayed
    in the order they were captured, and each part's output stays held in
    `io`, so no part overwrites what a later one reads."""

    def __init__(self, encoder, key: tuple, device: torch.device):
        strain_shape, bands_shape = key
        self.encoder = encoder
        self.io = {"strain": torch.empty(strain_shape, device=device),
                   "bands": (None if bands_shape is None
                             else torch.empty(bands_shape, device=device))}
        self.graphs = []

    def load(self, strain, bands) -> None:
        """Copy the caller's arrays into the static inputs (a copy from
        pageable host memory each is counted)."""
        to_device(strain, bands, self.io["strain"].device,
                  into=(self.io["strain"], self.io["bands"]))

    def capture(self) -> None:
        """Warm the parts up on a side stream, then capture each, with
        the span recorder paused. Run inside fp32_exact(), as the eager
        call is."""
        steps = self.encoder.parts()
        with paused():
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                warm = dict(self.io)
                for _, step in steps:
                    step(warm)
            torch.cuda.current_stream().wait_stream(side)
            del warm
            pool = torch.cuda.graph_pool_handle()
            for name, step in steps:
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=pool):
                    step(self.io)
                self.graphs.append((name, graph))

    def replay(self) -> torch.Tensor:
        """Replay the parts, each in its span -> a copy of the context."""
        for name, graph in self.graphs:
            with span(name):
                graph.replay()
        return self.io["context"].clone()


class ServedEncoder:
    """The engine's encoder call on a CUDA device: eager, capture or
    replay by `GraphPolicy`, counted in `pf.encoder` as encoder_eager,
    encoder_graph_capture or encoder_graph_replay."""

    def __init__(self, encoder, device):
        self.encoder = encoder
        self.device = torch.device(device)
        self.policy = GraphPolicy()

    def __call__(self, strain, bands) -> torch.Tensor:
        """strain [B, D, T], bands [B, D, K] or None (numpy or tensors)
        -> context [B, C], a tensor of the caller's own."""
        key = shape_key(strain, bands)
        way = self.policy.step(key)
        if way == EAGER:
            strain, bands = to_device(strain, bands, self.device)
            with span("pf.encoder"), fp32_exact():
                count("encoder_eager")
                return self.encoder._forward(strain, bands)
        with torch.cuda.device(self.device):
            graphs = self.policy.get(key)
            if graphs is None:
                graphs = EncoderGraphs(self.encoder, key, self.device)
            graphs.load(strain, bands)
            with span("pf.encoder"), fp32_exact():
                if way == CAPTURE:
                    count("encoder_graph_capture")
                    graphs.capture()
                    self.policy.store(key, graphs)
                else:
                    count("encoder_graph_replay")
                return graphs.replay()
