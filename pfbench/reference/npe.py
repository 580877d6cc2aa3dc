"""The plain reference of the LeanNPE cells, and the gaps that decide
`correct`.

The model is the frozen copy in pfbench/reference/frozen (the port's plain
PyTorch code, with the plain spline of ops/rqs.py in every layer), built
from the release's own files: meta.json for the sizes and params.msgpack
read by the copy's msgpack reader. It computes in the precision that the
configuration states (bf16 matrix products in the encoder and in the
flow's hidden layers, float32 output projections and spline, TF32 off).
`lower_precision()` puts it one step below that for the control.
"""

from __future__ import annotations

import contextlib
import json
import math
from pathlib import Path
from typing import Dict, List

import torch
import torch.nn.functional as F

from pfbench.reference.frozen.models.npe import LeanNPE
from pfbench.reference.frozen.train.checkpoints import (cfg_from_dict,
                                                        flax_to_state_dict)
from pfbench.reference.frozen.utils.msgpack_lite import unpackb


def load_release(release_dir, device) -> LeanNPE:
    release_dir = Path(release_dir)
    meta = json.loads((release_dir / "meta.json").read_text())
    model = LeanNPE(cfg_from_dict(meta["config"]))
    sd = flax_to_state_dict(unpackb((release_dir / "params.msgpack")
                                    .read_bytes()))
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval()


@torch.no_grad()
def sample(model: LeanNPE, strain, asd_bands, z: torch.Tensor, rank: int):
    """Whitened strain [B, D, T] and base draws z [B, n, P] -> (physical
    draws [B, n, P] with m1 >= m2, log q in physical units [B, n])."""
    dev = z.device
    s = torch.as_tensor(strain, dtype=torch.float32, device=dev)
    a = torch.as_tensor(asd_bands, dtype=torch.float32, device=dev)
    ctx = model.encode(s, a)
    r = torch.full((ctx.shape[0],), rank, dtype=torch.long, device=dev)
    theta, _, log_q = model.sample_from_context(ctx, r, z.shape[1], z=z)
    log_q = log_q + model.scaler.log_abs_det_jacobian(theta)
    m1 = torch.maximum(theta[..., 0], theta[..., 1])
    m2 = torch.minimum(theta[..., 0], theta[..., 1])
    theta = torch.cat([m1[..., None], m2[..., None], theta[..., 2:]], dim=-1)
    return theta, log_q


# an event's gaps are read at these quantiles of its draws
QUANTILES = {"p50": 0.5, "p90": 0.9, "p99": 0.99, "p999": 0.999}


def event_quantiles(name: str, per_draw: torch.Tensor) -> Dict[str, float]:
    """Per-draw gaps [B, n] -> `<name>_<q>`: each event's q-quantile of its
    draws' gaps (the nearest rank), the widest over the B events; and
    `<name>_max`, the widest gap of any draw. A NaN reads as infinity.

    One draw's gap is no measure of a sound program: the flow's inverse
    amplifies rounding a thousandfold where its Jacobian is large, so a
    sound run with other rounding moves a few draws of a million across
    the box. An event's quantile is steady, and a fault that alters an
    event's answer moves it."""
    x = torch.nan_to_num(per_draw.float(), nan=math.inf)
    x = torch.sort(x.reshape(x.shape[0], -1), dim=1).values
    n = x.shape[1]
    out = {f"{name}_{k}": float(torch.max(x[:, max(0, math.ceil(q * n) - 1)]))
           for k, q in QUANTILES.items()}
    out[f"{name}_max"] = float(torch.max(x[:, -1]))
    return out


def draw_gaps(scaler, theta_p, theta_r, logq_p, logq_r) -> Dict[str, float]:
    """The gaps between served draws and the reference's from the same
    inputs, read by `event_quantiles`: `draw_gap`, a draw's widest gap
    over its parameters in the scaler's [-1, 1] coordinates (a circular
    parameter modulo its period 2), and `logq_gap`, |Δ log q| in nats over
    the reference's |log q| or 1, whichever is larger."""
    dev = theta_r.device
    yp = scaler.normalize(torch.as_tensor(theta_p, device=dev).float())
    yr = scaler.normalize(theta_r.float())
    d = torch.abs(yp - yr)
    circ = scaler._consts(dev)[3]
    d = torch.where(circ, torch.minimum(d, torch.abs(2.0 - d)), d)
    lp = torch.as_tensor(logq_p, device=dev).float()
    dq = torch.abs(lp - logq_r) / torch.clamp(torch.abs(logq_r), min=1.0)
    return {**event_quantiles("draw_gap", torch.amax(d, dim=-1)),
            **event_quantiles("logq_gap", dq)}


# ── the control: one step of precision below the configuration's ───────


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale a tensor (its largest
    magnitude to the format's largest), in x's dtype."""
    x = x.detach()
    amax = torch.amax(torch.abs(x)).float().clamp(min=1e-12)
    scale = 448.0 / amax
    q = (x.float() * scale).to(torch.float8_e4m3fn).float() / scale
    return q.to(x.dtype)


def _lower(x):
    """bfloat16 or float16 operands to float8; float32 to bfloat16. The
    gradient passes the rounding unchanged."""
    if not isinstance(x, torch.Tensor) or not x.is_floating_point():
        return x
    if x.dtype in (torch.bfloat16, torch.float16):
        low = _fp8(x)
    elif x.dtype == torch.float32:
        low = x.detach().to(torch.bfloat16).float()
    else:
        return x
    return x + (low - x.detach()) if x.requires_grad else low


@contextlib.contextmanager
def lower_precision():
    """Every matrix product and convolution of the reference (F.linear,
    F.conv1d, torch.einsum, @) takes its operands one step of precision
    below their own: bfloat16 to float8 e4m3, float32 to bfloat16."""
    saved = (F.linear, F.conv1d, torch.einsum, torch.Tensor.__matmul__)
    lin, conv, ein, mm = saved

    def linear(x, w, b=None):
        return lin(_lower(x), _lower(w), None if b is None else _lower(b))

    def conv1d(x, w, b=None, *args, **kw):
        return conv(_lower(x), _lower(w),
                    None if b is None else _lower(b), *args, **kw)

    def einsum(eq, *ops):
        return ein(eq, *[_lower(o) for o in ops])

    def matmul(a, b):
        return mm(_lower(a), _lower(b))

    F.linear, F.conv1d, torch.einsum = linear, conv1d, einsum
    torch.Tensor.__matmul__ = matmul
    try:
        yield
    finally:
        F.linear, F.conv1d, torch.einsum, torch.Tensor.__matmul__ = saved


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: List[str]) -> Dict[str, float]:
    """Each leaf's |‖prog‖ − ‖ref‖| over the reference's norm of that leaf
    or of the median leaf, whichever is larger."""
    ordered = sorted(ref[k] for k in keep)
    median = ordered[len(ordered) // 2]
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
            for k in keep}
