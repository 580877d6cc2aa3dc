"""Matrix-product FLOPs and spline bytes of LongBNSNPEv4 from the sizes in
pfbench/configs/long_bns_v4.json and the release's trigger grid (192
tokens). FLOPs as in npe_r7.py: 2·M·N·K a product; the heterodyne, the
pooling sums and the spline are not counted in them."""

from __future__ import annotations

from pfbench.counts.rqs import rqs_bytes

GRID_TOKENS = 192          # the stored trigger grid's L (trigger_341114687ac7)


def _mm(m, n, k) -> int:
    return 2 * m * n * k


def _sizes(cfg: dict) -> dict:
    c, sh = cfg["config"], cfg["shapes"]
    enc = c["enc"]
    d = sh["n_detectors"]
    return dict(dm=enc["d_model"], layers=enc["n_layers"],
                patch=enc["patch"], feat=3 * d + 2,
                n=GRID_TOKENS // enc["patch"], ctx=sh["context_dim"],
                cond=sh["context_dim"] + 2 + d,
                ff=sh["ff_mult"] * enc["d_model"],
                flow_layers=sh["flow_layers"], hidden=sh["flow_hidden"],
                p=sh["n_params"], bins=c["flow"]["bins"])


def encoder_flops(cfg: dict, b: int) -> int:
    s = _sizes(cfg)
    dm, n = s["dm"], s["n"]
    f = _mm(b * n, dm, s["patch"] * s["feat"])
    f += s["layers"] * (4 * _mm(b * n, dm, dm) + 2 * _mm(b * n, n, dm)
                        + _mm(b * n, s["ff"], dm) + _mm(b * n, dm, s["ff"]))
    return f + _mm(b, s["ctx"], dm)


def flow_flops(cfg: dict, rows: int, ctx_rows: int) -> int:
    s = _sizes(cfg)
    p, h = s["p"], s["hidden"]
    n_id = p // 2 + p % 2
    n_raw = (p - n_id) * (3 * s["bins"] - 1)
    return s["flow_layers"] * (_mm(rows, h, n_id) + _mm(ctx_rows, h, s["cond"])
                               + _mm(rows, h, h) + _mm(rows, n_raw, h))


def sample_request(cfg: dict, triggers: int, draws: int) -> dict:
    """A request: tokens and the encoder for `triggers` triggers, then the
    flow's inverse over triggers·draws rows."""
    s = _sizes(cfg)
    rows = triggers * draws
    d_tr = s["p"] - (s["p"] // 2 + s["p"] % 2)
    return {"flops": encoder_flops(cfg, triggers)
            + flow_flops(cfg, rows, triggers),
            "rqs_tile_bytes": s["flow_layers"] * rqs_bytes(rows, d_tr,
                                                           s["bins"])}
