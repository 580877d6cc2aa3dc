"""Matrix-product FLOPs and spline bytes of LeanNPE (coherent encoder,
coupling NSF) from the sizes in pfbench/configs/npe_r7.json.

A FLOP here is one multiply or one add of a matrix product or a
convolution (2·M·N·K a product), forward and, for training, backward: the
work of the model at these shapes, whatever kernels carry it out. FFTs,
elementwise work and the spline are not counted in the FLOPs; the spline
is counted in bytes (rqs.py)."""

from __future__ import annotations

from pfbench.counts.rqs import rqs_bytes, rqs_grad_bytes


def _sizes(cfg: dict) -> dict:
    npe, sh = cfg["config"]["npe"], cfg["shapes"]
    d, dm = sh["n_detectors"], npe["d_model"]
    length = sh["n_samples"]
    stem, cin = [], 1
    for out, k, s in sh["stem"]:
        length = (length - k) // s + 1
        stem.append((out, cin, k, length))
        cin = out
    df = sh["sample_rate"] / sh["n_samples"]
    lo = -(-sh["f_lower"] // df)                   # first bin >= f_lower
    hi = -(-sh["f_upper"] // df)                   # first bin >= f_upper
    n_pairs = d * (d - 1) // 2
    g = sh["geometry_bands"]
    return dict(
        d=d, dm=dm, stem=stem, tokens=d * length + sh["geom_tokens"],
        nf=int(hi - lo), g=g, lags=2 * sh["max_lag"] + 1, pairs=n_pairs,
        n_geom=d * g + n_pairs * (3 * g + 3), gh=sh["geom_hidden"],
        gt=sh["geom_tokens"], q=sh["pool_queries"],
        ew=d * sh["energy_windows"], psd=d * npe["psd_bands"],
        ff=sh["ff_mult"] * dm, oh=sh["out_hidden"],
        ctx=npe["context_dim"], rank=npe["rank_dim"],
        layers=npe["enc_layers"], p=len(npe["param_names"]),
        flow_layers=npe["flow_layers"], hidden=npe["flow_hidden"],
        bins=npe["flow_bins"])


def _mm(m, n, k) -> int:
    return 2 * m * n * k


def encoder_terms(cfg: dict, b: int):
    """[(forward FLOPs, input needs a gradient, has weights)] of one
    encode of b events."""
    s = _sizes(cfg)
    d, dm, n, q = s["d"], s["dm"], s["tokens"], s["q"]
    t = [(_mm(b, 64, s["ew"]), False, True), (_mm(b, 64, 64), True, True)]
    for i, (out, cin, k, length) in enumerate(s["stem"]):
        t.append((2 * b * d * length * out * cin * k, i > 0, True))
    # geometry features: band sums and lag correlations of the strain
    geo = (_mm(b * d, s["g"], s["nf"])
           + s["pairs"] * (3 * _mm(b, s["g"], s["nf"])
                           + 2 * _mm(b, s["lags"], s["nf"])))
    t.append((geo, False, False))
    t += [(_mm(b, s["gh"], s["n_geom"]), False, True),
          (_mm(b, s["gh"], s["gh"]), True, True),
          (_mm(b, s["gt"] * dm, s["gh"]), True, True)]
    for _ in range(s["layers"]):
        t += [(4 * _mm(b * n, dm, dm), True, True),
              (2 * _mm(b * n, n, dm), True, False),
              (_mm(b * n, s["ff"], dm), True, True),
              (_mm(b * n, dm, s["ff"]), True, True)]
    t += [(_mm(b * q, dm, dm), True, True),            # pool query
          (2 * _mm(b * n, dm, dm), True, True),        # pool key, value
          (2 * _mm(b * q, n, dm), True, False),        # scores, values
          (_mm(b * q, dm, dm), True, True),            # pool out
          (_mm(b, 64, s["psd"]), False, True), (_mm(b, 32, 64), True, True),
          (_mm(b, s["oh"], q * dm + 64 + 32), True, True),
          (_mm(b, s["ctx"], s["oh"]), True, True)]
    return t


def flow_terms(cfg: dict, rows: int, ctx_rows: int, forward: bool):
    """[(FLOPs, input needs a gradient, has weights)] of one flow pass
    over `rows` rows with the context projected on `ctx_rows` rows."""
    s = _sizes(cfg)
    p, h = s["p"], s["hidden"]
    n_id = p // 2 + p % 2
    n_raw = (p - n_id) * (3 * s["bins"] - 1)
    t = []
    for i in range(s["flow_layers"]):
        t += [(_mm(rows, h, n_id), forward and i > 0, True),
              (_mm(ctx_rows, h, s["ctx"] + s["rank"]), True, True),
              (_mm(rows, h, h), True, True),
              (_mm(rows, n_raw, h), True, True)]
    return t


def _forward(terms) -> int:
    return sum(f for f, _, _ in terms)


def _backward(terms) -> int:
    """The gradient of the weights of every weighted product, and of its
    input where that input needs one; a product without weights (the
    attention's) takes both operands' gradients where its input needs one."""
    total = 0
    for f, needs_dx, weighted in terms:
        if weighted:
            total += f + (f if needs_dx else 0)
        elif needs_dx:
            total += 2 * f
    return total


def _spline(cfg: dict):
    s = _sizes(cfg)
    p = s["p"]
    return s["flow_layers"], p - (p // 2 + p % 2), s["bins"]


def sample_request(cfg: dict, events: int, draws: int) -> dict:
    """A request: encode `events` events, then the flow's inverse over
    events·draws rows with the context projected once an event."""
    layers, d_tr, k = _spline(cfg)
    rows = events * draws
    return {"flops": _forward(encoder_terms(cfg, events))
            + _forward(flow_terms(cfg, rows, events, forward=False)),
            "rqs_tile_bytes": layers * rqs_bytes(rows, d_tr, k)}


def train_step(cfg: dict, batch: int) -> dict:
    """A training step on `batch` events: the encoder, the flow's forward
    over batch·max_signals (event, rank) rows, and both backward."""
    layers, d_tr, k = _spline(cfg)
    rows = batch * cfg["config"]["npe"]["max_signals"]
    enc = encoder_terms(cfg, batch)
    flow = flow_terms(cfg, rows, rows, forward=True)
    return {"flops": _forward(enc) + _forward(flow) + _backward(enc)
            + _backward(flow),
            "rqs_tile_bytes": layers * rqs_bytes(rows, d_tr, k),
            "rqs_grad_bytes": layers * rqs_grad_bytes(rows, d_tr, k)}
