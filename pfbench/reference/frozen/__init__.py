"""A frozen copy of posteriflow_torch's plain PyTorch code, the benchmark's
reference: as much of the simulator (physics/, prior, data/noise_bank), the
models (LeanNPE, the long-BNS v4 model), the release loader (train/
checkpoints, utils/msgpack_lite) and the trainer's step and optimizer as
the cells, their reference paths and their controls reach, as they stood
when the benchmark was defined. The edits: imports point into this copy;
the flow calls the plain spline of ops/rqs.py (no CUDA kernel); the
process-group paths, the other long-BNS front ends and every writer are
gone; the long-BNS trigger grid the release was trained on is stored
beside models/long_bns.py. Later changes to the program do not reach it.
"""

PARAM_NAMES = (
    "mass_1", "mass_2", "luminosity_distance",
    "ra", "dec", "theta_jn", "psi", "phase",
    "geocent_time", "a1", "a2",
)
