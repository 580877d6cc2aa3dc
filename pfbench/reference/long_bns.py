"""The plain reference of the long-BNS v4 cells.

The frozen copy's LongBNSNPEv4 (pfbench/reference/frozen/models/long_bns.py,
the plain spline in every layer), built from the release's own files
(calibration.json for the sizes, params.msgpack for the weights), served on
the frozen copy of the trigger grid that the release was trained on. Its
encoder computes in float32 with TF32 off and its flow's hidden layers in
bf16, as the configuration states.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from pfbench.reference.frozen.models import long_bns as lb
from pfbench.reference.frozen.train.checkpoints import flax_to_state_dict
from pfbench.reference.frozen.utils.msgpack_lite import unpackb
from pfbench.reference.npe import event_quantiles


def load_release(release_dir, device):
    """-> (model on `device`, its trigger grid)."""
    release_dir = Path(release_dir)
    cal = json.loads((release_dir / "calibration.json").read_text())["config"]
    model = lb.build_model(cal)
    model.load_state_dict(flax_to_state_dict(unpackb(
        (release_dir / "params.msgpack").read_bytes())), strict=True)
    return model.to(device).eval(), lb.load_stored_grid(cal["tokens"])


@torch.no_grad()
def sample(model, grid: dict, strain, trig, z: torch.Tensor):
    """Whitened FD strain [B, D, cut], the triggers [B, 1 + D] and base
    draws z [B, n, 11] -> physical draws [B, n, 11]."""
    dev = z.device
    h = torch.as_tensor(strain, device=dev)
    tr = torch.as_tensor(trig, device=dev)
    tok = lb.trigger_tokens(h, grid, tr[:, 0], tr[:, 1:])
    theta, _ = model.sample_raw(tok, tr, z.shape[1], z=z)
    return theta


def draw_gaps(model, theta_p, theta_r, trig) -> dict:
    """The gaps between served draws and the reference's, read by
    `npe.event_quantiles`: `draw_gap`, a draw's widest gap over its
    parameters in the model's trigger-relative [-1, 1] coordinates (a
    circular parameter modulo its period 2)."""
    dev = theta_r.device
    tr = torch.as_tensor(trig, device=dev)[:, None, :]
    sc = model.scaler
    yp = sc.normalize(torch.as_tensor(theta_p, device=dev).float(), tr)
    yr = sc.normalize(theta_r.float(), tr)
    d = torch.abs(yp - yr)
    circ = sc.base._consts(dev)[3].clone()
    circ[[0, 1, 8]] = False        # chirp mass, mass ratio, time: linear
    d = torch.where(circ, torch.minimum(d, torch.abs(2.0 - d)), d)
    return event_quantiles("draw_gap", torch.amax(d, dim=-1))
