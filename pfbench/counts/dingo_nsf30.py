"""Matrix-product FLOPs and spline bytes of DINGO's network from the sizes
in pfbench/configs/dingo_nsf30.json, by the conventions of npe_r7.py: a
FLOP is one multiply or one add of a matrix product (2·M·N·K a product),
whatever kernels carry it out. Elementwise work, batch norm, the LU
transforms' triangular solves (15 × 15, under 0.1% of the products) and
the spline are not counted in the FLOPs; the spline is counted in bytes
(rqs.py), without a derivative bias, which DINGO's spline has not."""

from __future__ import annotations

from pfbench.counts.rqs import rqs_bytes


def _mm(m, n, k) -> int:
    return 2 * m * n * k


def _dingo(cfg: dict) -> dict:
    return cfg["config"]["dingo"]


def _n_tr(d: dict, step: int) -> int:
    """Features a step's spline transforms: 0, 2, ... on even steps, 1, 3,
    ... on odd ones."""
    p = len(d["param_names"])
    return (p - step % 2 + 1) // 2


def embedding_flops(cfg: dict, events: int) -> int:
    """LinearProjectionRB and DenseResidualNet over `events` events."""
    d = _dingo(cfg)
    n_f = int(round((d["f_max"] - d["f_min"]) / d["delta_f"])) + 1
    n_det, rb2 = len(d["detectors"]), 2 * d["n_rb"]
    widths = d["resnet_widths"]
    total = n_det * _mm(events, rb2, 3 * n_f)
    total += _mm(events, widths[0], n_det * rb2)
    for w in widths:
        total += 2 * _mm(events, w, w)
    for a, b in zip(widths, widths[1:]):
        if a != b:
            total += _mm(events, b, a)
    return total + _mm(events, d["context_dim"], widths[-1])


def flow_flops(cfg: dict, rows: int, ctx_rows: int) -> int:
    """The flow's conditioners over `rows` rows, their context terms (the
    first layer's context columns and the gates) over `ctx_rows`."""
    d = _dingo(cfg)
    p, h, c = len(d["param_names"]), d["flow_hidden"], d["context_dim"]
    n_raw = 3 * d["flow_bins"] - 1
    total = 0
    for s in range(d["flow_steps"]):
        n_tr = _n_tr(d, s)
        total += _mm(rows, h, p - n_tr) + _mm(ctx_rows, h, c)
        total += d["flow_blocks"] * (2 * _mm(rows, h, h)
                                     + _mm(ctx_rows, h, c))
        total += _mm(rows, n_tr * n_raw, h)
    return total


def sample_request(cfg: dict, events: int, draws: int) -> dict:
    """A request: embed `events` events, then the flow's inverse over
    events·draws rows with the context terms computed once an event."""
    d = _dingo(cfg)
    rows = events * draws
    return {"flops": embedding_flops(cfg, events)
            + flow_flops(cfg, rows, events),
            "rqs_tile_bytes": sum(rqs_bytes(rows, _n_tr(d, s),
                                            d["flow_bins"], bias=False)
                                  for s in range(d["flow_steps"]))}
