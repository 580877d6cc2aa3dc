"""posteriflow_torch: the PyTorch and CUDA port of posteriflow_tpu for NVIDIA
Hopper GPUs.

The port grows slice by slice beside the JAX package, which stays the
reference each slice is held against. This slice serves a released 15-D
model: raw 3-detector strain -> `inference.prepare_real` -> coherent
encoder -> rank embedding -> coupling-NSF inverse (the rational-quadratic
spline of every layer runs in the hand-written CUDA kernel of
`csrc/rqs.cu`) -> scaler wrap/denormalize -> OOD verdict and refinement
gate -> `PosteriorResult`.

    posteriflow_torch.physics    constants and the numpy design PSDs
    posteriflow_torch.ops        RQS: plain PyTorch version + CUDA kernel
    posteriflow_torch.models     encoder, flow, LeanNPE, PriorityNet
    posteriflow_torch.train      release loader (flax msgpack -> state_dict),
                                 the NPE and PriorityNet trainers
    posteriflow_torch.inference  prepare_real, infer(), OOD, gating, result,
                                 plots, importance sampling, overlap ranking
    posteriflow_torch.core       subtract-and-reinfer decomposition
    posteriflow_torch.evaluation bias, recovery, performance and comparison
                                 metrics, result validation, noise analysis,
                                 decomposition baselines
    posteriflow_torch.tools      the command lines, checkpoint validation
                                 (validate_checkpoint) among them

The package imports torch, numpy and scipy only (matplotlib and bilby
inside the functions that draw or export), so it runs on a machine that
has none of the JAX stack.
"""

__version__ = "0.1.0"

PARAM_NAMES = (
    "mass_1", "mass_2", "luminosity_distance",
    "ra", "dec", "theta_jn", "psi", "phase",
    "geocent_time", "a1", "a2",
)
N_PARAMS = len(PARAM_NAMES)

# The 15-parameter precessing set: the 11 base parameters (a1/a2 read as
# spin magnitudes) plus the precession angles at the reference frequency.
PARAM_NAMES_PRECESSING = PARAM_NAMES + (
    "tilt_1", "tilt_2", "phi_12", "phi_jl",
)
N_PARAMS_PRECESSING = len(PARAM_NAMES_PRECESSING)
