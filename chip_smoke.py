#!/usr/bin/env python3
"""On-card check of posteriflow_torch: serve, train, importance-correct and
decompose overlapping signals with the 15-D flagship release, serve,
validate and train the long-BNS models, train from a YAML config, export
a release the JAX package reads and anchor it against a nested sampler,
train data-parallel and sequence-parallel over a process group, and
train, validate and release the v3 long-BNS front end, and run the
physics checks, waveform entry points, SVD basis, patch transformer,
analysis tools and examples, on NVIDIA GPUs
(one is enough) through the
hand-written CUDA RQS kernels (csrc/rqs.cu: rqs_tile, a
TMA bulk-copy ring of row tiles, one thread per spline, the conditioner's
derivative bias added in the kernel; rqs_grad, its backward, K lanes a
spline).

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  (a) CUDA present (no CPU fallback); the card's name and power limit; TF32
      off for matmuls and cuDNN; build the kernel with nvcc and print what
      `-Xptxas -v` says of every instance (registers, spills): the K = 16
      instances must spill nothing. The noise bank's crop server
      (csrc/bankd.cpp) is built with g++ at the same time.
  (b) the kernel against its plain PyTorch version on raw + bias at the
      flagship sampling shape (N = 131072 rows, D = 7, K = 16), at ragged
      N (641, 5000: a part tile), at importance sampling's 4096 rows and
      at the decompositions' 2048 and 8192 rows (phases r, s), at
      validation's 256 and 102,400 rows (phase v), at the anchor
      request's 3000 rows (phase x), both
      directions, with and without the bias, with tails beyond ±5: out
      and logdet max |Δ| = 0.
  (c) serve 4 requests through `infer` (raw 32 s coloured Gaussian noise per
      detector from the design ASD, 5000 draws, ranks 0, 1, 0, 1); the
      launch counter must grow by one per flow layer per request. The
      served path is then held against the port's plain CPU path on the
      same input and base draws (float32 and the release's bfloat16).
  (d) time one bench-shaped batch (8 events × 16384 draws) with CUDA
      events, the kernel per launch (µs, TB/s, share of its bound) beside
      the plain version; profile the batch, which must hold no add of the
      derivative bias over raw.
  (f) the simulator, card against CPU: the flagship's prior (15-D) and an
      aligned one (11-D), 8 events each, drawn on the CPU and run through
      simulate_batch on both devices with the same draws: each slot's
      whitened FD strain per detector (match and norm), the gate SNR, the
      gated parameters and the strain; and cuFFT's C2R against pocketfft on
      a spectrum whose DC and Nyquist bins carry imaginary parts.
  (g) simulate_batch with the flagship's SimConfig timed by CUDA events at
      B = 8 (bench.py) and B = 128 (the flagship's training batch), with
      its peak memory and its kernel launches under the profiler.
  (h) bench.py's path: simulate 8 events, encode once, draw 8 × 16384; the
      launch counter is zeroed before and read after, and must show one
      launch per flow layer; the sampling call is timed (draws/s).
  (i) one request on a 15-D injection, infer(engine, inject=...): its
      prepare (simulation), encode and sampling times and launches.
  (j) TF32: with the global switches at torch's defaults, the float32
      encoder of npe_r2_best on the card against the CPU (within 1e-4 of
      the largest entry), beside what TF32 on would give.
  (k) under grad on CUDA inputs, the inverse and a bias that requires grad
      raise; the forward runs the forward kernel, and its backward the
      backward kernel, with the plain VJP's gradients.
  (l) the backward kernel rqs_grad against ops/rqs.py rqs_forward_vjp at
      K in {4, 8, 16, 32} and N in {640, 257, 131072} (x on knots, at ±B,
      in the tails; g_logdet zero and not), within 1e-5 of the largest
      entry plus 1e-6; its registers and spills (none at K = 16); its time
      at 640 (the training shape) and 131072 rows beside the plain VJP and
      its bounds, and at 640 rows beside the launch floor (the device time
      of a one-block PyTorch kernel); the wrapper's host time a call; the
      forward kernel's time at the training shape beside its bound.
  (m) training at full width, TrainConfig from the release's meta.json
      (batch 128, bf16 matmuls, no noise bank), weights from the release:
      one fixed CPU-simulated batch of 16 events in float32, loss,
      component norms and every gradient leaf with the kernels against the
      plain spline on the card (1e-4) and against the CPU (the loss 1e-4,
      leaves 1e-2 of their largest entry);
      then 20 steps simulate -> batch_nll -> backward -> clip -> AdamW,
      split by CUDA events, steps/s, events/s, peak memory, MFU, NLL per
      step (finite, step 0 in [-8, -3]; parameters still at step 0 since
      lr(0) = 0, moved at step 1); every step launches 10 forward and 10
      backward spline kernels and no plain spline.
  (n) fit 2 epochs x 5 steps (64 validation events) into a temporary
      directory: history.json with the keys of the release's own JAX
      record, finite gate metrics, ckpt/last and ckpt/best; resume_from
      continues the epochs and the step count; from_checkpoint(best)
      samples on the card.
  (o) importance sampling: infer 5000 draws on a 15-D injection, then
      importance_correct against the phase/time-marginalized likelihood at
      its defaults (pad_block 4096, up to 25 tempered stages of 5
      Metropolis steps): the direct ESS, the ladder, acceptance, log Z, the
      time split (log q, first likelihood batch, moves), peak memory; the
      rqs_tile launches must be 20 + 100·(stages − 1) (20 without the
      ladder) and the plain spline is never called. The same request
      through tools/infer.py --inject --importance must save normalized
      weights. Card against the CPU on 64 θ: both likelihoods within 1e-3
      of 1 + ½‖h_w‖² + |Re⟨d, h_w⟩|, symmetrized_log_q in float32 within
      1e-3 nats. rqs_tile at 4096 rows timed beside its bound and the
      plain version; run_smc_prior on the same likelihood (n = 4096,
      stages capped at 10), which launches no spline.
  (p) the released PriorityNets (priority_v7, priority_v5) on the card
      against the CPU on one make_priority_batch batch (B = 32, dead
      slots): scores, sigma and aux within 1e-4 of the largest live |score|
      plus 1e-5, rank_by_score's order wherever scores differ by more, no
      NaN, dead slots at -1e9.
  (q) the overlap request: a 3-signal precessing injection (network SNRs
      ~50, 22 and 14, mergers 0.9 s and more apart) through
      infer_overlapping (3 ranks x 5000 draws; four warm calls, each rank's
      encode and sampling times), rqs_tile launches exactly 30 a call and
      no plain spline; rank_overlapping with priority_v7 on the card (its
      split: segments, snr_est, net), whose top-1 must be the loudest
      signal; tools/infer.py --inject --n-signals 3 writes rank0..2 and
      ranking.json.
  (r) AHSDPipeline.decompose on that event (max_signals 5, 2048 draws a
      stage): each stage's fit SNR, alpha, quality and residual power
      ratio, 10 rqs_tile launches a stage; the subtractor card against the
      CPU on the same 512 draws (residual within 1e-4 of the strain's
      largest |value|, alpha and fit SNR within 1e-4 relative).
  (s) make_batched_decompose over 8 simulated events (1024 draws, 3
      stages, templates of 128 draws): ms a call by CUDA events,
      n_extracted, peak memory, 30 rqs_tile launches at 8192 rows; rqs_tile
      inverse at 5000 and 8192 rows timed beside its bound.
  (t) tools/priority_eval.py's battery at its defaults (20 x 32) on the
      card: top-1, τ and the close-pair bin within ±0.05, ±0.05 and ±0.07
      of reports/priority_eval_v7.json, beside the loudness fallback and
      the oracle; fit_priority for 50 steps at batch 32 with the v7
      architecture: finite losses, the last 10 below the first 10 on
      average, steps/s.
  (u) the real-noise path on the flagship: a synthetic bank of 16 x 64 s
      segments a detector written by tools/make_noise_bank.py, loaded on
      the card; simulate_batch at real_noise_prob 1 card against CPU on the
      same draws (crops, filters and bands exact, the strain at (f)'s
      tolerances, asd_bands non-zero on kept and zero on dropped
      detectors); 10 train steps of the flagship's own SimConfig
      (real_noise_prob 0.5) with the bank, timed and profiled as (m) is,
      beside (m)'s figures without it, then 12 steps each with and
      without it in turns, and the crops' gather by CUDA events: the real-noise
      share within 4 binomial σ of 0.5, 10 + 10 spline launches a step and no plain
      spline, step 0's NLL in (m)'s band, a non-zero noise_fc1.weight
      gradient (exactly zero in a control step without the bank); the
      native crop server (built with g++ in (a)) serving, its crops/s;
      HostNoiseFeed -> simulate_batch(real_feed=) -> 4 train steps, the
      wait in next() a step, each batch equal to the server's; fit(bank=)
      for 1 epoch of 2 steps: JAX's history keys and select_nll the mean
      of val_nll and real_val_nll.
  (v) checkpoint validation: a port checkpoint of the release (config hash
      b58b05b3ce29, the JAX report's) validated by
      tools/validate_checkpoint.py at reports/val_r7/report.json's size,
      1792 events x 400 draws: exit 0, the nine gates passing, val NLL,
      shuffle ΔNLL, distance correlation, railing and base_conc each within
      4 σ of the report (σ from the port's chunk-to-chunk spread, printed),
      the SBC p-values beside JAX's; exactly 50 rqs_tile launches a chunk
      and 10 a request, the plain spline never; the fitted ood_stats.npz
      against the release's (KS p > 1e-3, medians within 5%), served armed;
      the real-noise domain on (u)'s bank at 256 events (finite, ten gates);
      rqs_tile at 102,400 rows inverse and 256 forward timed beside its
      bound (bit-equal there in (b)); tools/twin_grid.py at its defaults
      (distances within 2e-3 of analysis/twin_grid.json, 320 launches);
      tools/importance_validation.py on two cases with --cross-check
      (converged, corrected Mc median within 2% of the truth). Every
      output goes to a temporary directory.
  (w) the long-BNS family (models/long_bns.py). (w1) rqs_tile<12> and
      rqs_grad<12> (16-lane groups): their registers and spills (none
      allowed), rqs_tile<12> bit-equal to the plain spline at 50, 64, 641,
      20,000 and 131,072 rows and rqs_tile<8> at v1's 50 and 12,800 (D =
      5, both directions, with and without the bias), rqs_grad<12> within
      1e-5 of the largest entry plus 1e-6 of the plain VJP at 64 and
      131,072 rows; µs a launch beside the bound, the launch floor and the
      plain version. (w2) long_bns_v4 served on its stored trigger grid: a
      50-event batch from fixed draws, the NLL on signal and noise-only
      tokens and sample_raw with z given, card against CPU within 1e-3,
      exactly 18 rqs_tile launches, no plain spline. (w3)
      tools/validate_long_bns.py at 2000 x 400 in chunks of 50: exit 0,
      the seven v4 gates, 720 launches, val NLL, signal ΔNLL, mc_sharpen,
      railing and distance correlation within 4σ of
      reports/val_long_bns/report.json, the seconds by part. (w4)
      tools/train_long_bns.py at the release's config (batch 64) from a
      fresh init, 100 steps with an evaluation every 50: a falling NLL,
      6 + 6 launches a step, no plain spline; 20 steps split by CUDA
      events; one step's float32 gradients against the card's plain
      spline (1e-4), the CPU (1e-2 a leaf) and the TF32 guard, as (m).
      (w5) long_bns_v1: its NLL card against CPU on 8 events, its
      validation at 250 x 256 in chunks of 50 beside its
      calibration.json, 90 rqs_tile<8> launches.
  (x) the release path and the anchors, on the flagship. (x1) all 12
      configs/*.yaml through the port's YAML reader into TrainConfigs;
      configs/npe_r6.yaml's equals the release's meta.json but for lr and
      total_steps. (x2) tools/train_npe.py from that YAML (written back by
      save_config with its warmup cut to 2: train_npe sets total_steps to
      epochs x steps, which must exceed the warmup) --init-from the release
      --noise-bank (u)'s bank, 1 epoch x 5 steps, --profile-dir: 10 + 10
      spline launches a step, no plain spline, a trace naming rqs_tile and
      rqs_grad; fit(val_batch_fn=, on_epoch_end=): the hook once an epoch
      after history.json, val_nll equal to batch_nll on the function's
      batch. (x3) tools/export_release.py on that run; the export loaded by
      CheckpointManager.load_release against the checkpoint, NLL and draws
      with fixed z bit-equal; npe_r7_best and priority_v7 loaded on the
      card and exported again byte-equal to the committed files (sha256
      printed); LeanNPE.sample / .nll bit-equal to encode +
      *_from_context. (x4) tools/make_anchors.py --only low_mc_razor at the
      report's nlive 400, maxiter 12000, 3000 draws: the nested run ends by
      dlogz, logZ_IS - logZ_nested in [-3, +12], summary_is mean JS <= 0.75,
      rqs_tile launches exactly 10 for the request + 20 + 100·(stages - 1)
      for importance sampling and none in the nested run; summary_is mean
      width ratio in [0.4, 2.5], or, when the tool's importance correction
      ends degenerate (its heaviest particle >= 0.9 of the weight), the
      ending the JAX package's importance_correct gives on the same draws
      (4 stages, a final hop from below β 0.1; tests/anchor_is_witness.py);
      a 24-row likelihood call timed with its kernel count; rqs_tile
      inverse at 3000 rows beside its bound, after (x2)'s trace. (x5)
      tools/evidence_validation.py Parts A and C: matched-proposal IS within
      0.02 nats of the analytic truth, prior-SMC at n_mcmc 30 within 3 of
      its σ, the nested run at nlive 800 within 0.2 nats. (x6)
      tools/priority_fusion_bound.py at its defaults and at 200 batches:
      each bin of the three channels of the 200-batch run within 3
      binomial σ of its difference from reports/priority_fusion_bound.json
      (or ±0.07, the wider; the report's σ dominates), the defaults run
      printed against ±0.07. Every output goes to a temporary directory.
  (y) data and sequence parallelism, and the rest of long-BNS. (y1) an
      NCCL group of min(cards, 4) ranks, one a card (this process at world
      1), and make_mesh's ('data', 'model') grid. (y2) the flagship's
      make_train_step(mesh=) at batch 128 from the release, 2 steps: at
      world 1 the loss, every gradient leaf and every parameter bit-equal
      to the same steps without a group (above world 1, float32, within
      (m)'s card-against-CPU bars), 10 + 10 launches a step a rank, no
      plain spline, 10 more steps timed beside the unsharded step;
      fit(mesh=) 1 epoch x 5 steps and a resumed epoch: one history.json,
      one checkpoint set. (y3) make_batched_decompose(mesh=) on (s)'s
      events and base draws: bit-equal at world 1, 30 launches at
      8192/world rows a rank. (y4) long_bns_v4 and long_bns_v4_mesh_ft
      through make_sharded_encoder / make_sharded_nll_v4 on a ('data' 1,
      'model' world) mesh, 64 events: bit-equal to the unsharded port at world 1, 6 + 6
      launches; tools/train_long_bns.py --mesh <world> at batch 64 for 20
      steps: a falling NLL, the launches counted. (y5) v3 at JAX's
      defaults: the grid's n_tok and L, the simulator card against CPU on
      the same draws (coherent channels within 2e-2 of the signal's largest
      token, energy within 1e-3 of the largest plus 1e-3, features
      exact), tools/train_long_bns.py --tokens v3 for 100 steps (K = 8, as
      JAX's script builds it), tools/validate_long_bns.py on it at 100 x
      100 (the chirp branch, 18 launches a chunk), tools/release_long_bns.py
      and the release reloaded bit-equal, rqs_tile<8> at v3's 16 and 5000
      rows bit-equal to the plain spline and timed, rqs_grad<8> at 16 rows
      against the plain VJP and timed. (y6) tools/dryrun_multichip.py at n
      = world. (y7) where the machine shows one card: (y2)'s steps
      (float32) and (y4)'s losses (float32 conditioners) at world 2 as two
      gloo processes on that card with CUDA tensors, within (m)'s and
      (w4)'s card-against-CPU bars; (y2)'s fit(mesh=) and (y4)'s
      train_long_bns --mesh 2 there, held as at world 1 (one run written,
      the same history on both ranks, the launches).
  (z) the last slice's modules and tools, each held card against CPU:
      (z1) tools/validate_pipeline_physics, its nine checks passing and
      checks 3, 4, 8, 9 within 1e-4 relative of the CPU's; (z2) the five
      polarization entry points at the flagship's grid, 64 signals each
      (BNS, NSBH, BBH), moduli within 1e-4 of the peak and values within
      the phase-rounding bar of the CPU tests; (z3) build_svd_basis at its
      defaults (512 waveforms, 64 vectors) and project_onto_basis; (z4)
      LightweightTransformerEncoder at its defaults on [64, 3, 16384];
      (z5) tools/generate_dataset --n 512 --batch 256 (the HDF5 write where
      h5py is installed) and its components; (z6) tools/real_noise_test on
      the flagship at 256 events; (z7) tools/precession_robustness at its
      defaults, the noise-free SNRs within 1e-4 relative of
      reports/precession_robustness.json, verdicts, OOD and max |z|
      printed beside JAX's; (z8) tools/probe_context --n-events 1024;
      (z9) tools/frozen_context_heads at batch 64, 40 steps a head: 480 +
      480 launches of rqs_tile<8> / rqs_grad<8> at [64, 7]; (z10)
      tools/benchmark_real_events --events GW150914 with the nested run cut
      to nlive 32, maxiter 12; (z11) examples/explore_data and
      examples/analyze_results (with the importance correction) computed
      on the card; (z12) rqs_tile bit-equal at the new shapes (x [64, 7] at
      K = 8, [4096, 5], [2000, 7], [32768, 7] and [1280, 7] at K = 16) and
      rqs_grad<8>
      at [64, 7], timed beside their bounds. Every spline launch of a new
      path is counted by shape and the plain spline never runs.
  (e) the kernel table and the device as JSON lines; the last line is
      {"ok": true, "device": {...}}.
Every time printed names the card and its power limit.
The script imports torch, numpy and scipy (through the port) only.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

RELEASE = "model_release/npe_r7_best"
SAMPLE_RATE = 4096
DETECTORS = ("H1", "L1", "V1")
N_ROWS, D_TR, K_BINS, TAIL = 131072, 7, 16, 5.0   # flagship sampling shape
RAGGED_ROWS = (641, 5000)                         # a part tile at the end
IS_ROWS = 4096                    # importance_correct's pad_block (phase o)
# the kernel sums and groups as the plain version does, built with
# -fmad=false: both agree bit for bit
TOL_OUT, TOL_LOGDET = 0.0, 0.0
N_REQUESTS, N_SAMPLES = 4, 5000
BENCH_EVENTS, BENCH_DRAWS = 8, 16384              # bench.py:45-46
TRAIN_BATCH = 128                                 # npe_r7_best batch_size
TF32_RELEASE = "model_release/npe_r2_best"        # float32 encoder
# simulator card vs CPU (tests/test_torch_sim_*.py hold the port to JAX
# with the same numbers): match and norm per slot and detector, gate SNR,
# strain to 1e-4 plus 2e-3 of the whitened signal's peak
SIM_MATCH, SIM_NORM, SIM_SNR, SIM_ATOL, SIM_SIG = 1e-5, 1e-5, 1e-5, 1e-4, 2e-3
TF32_TOL = 1e-4
N_REF_DRAWS = 256
# the spline's backward kernel against the plain VJP (not bit-equal: the
# softmax's amax and the order of the sums differ): max|Δ| <= GRAD_REL of
# the reference's largest entry + GRAD_ABS, at these row counts
GRAD_REL, GRAD_ABS = 1e-5, 1e-6
TRAIN_ROWS = TRAIN_BATCH * 5                      # B·S rows a flow layer
GRAD_ROWS = (TRAIN_ROWS, 257, N_ROWS)
# the backward kernel's wrapper at TRAIN_ROWS with the earlier design (one
# thread a spline; its checks made twice, the device set on every launch):
# CUDA events over back-to-back calls, NVIDIA H100 80GB HBM3, 700 W
EARLIER_GRAD_CALL_US = (33.8, 60.6)
HOST_REPS = 200
# the train step in float32, each gradient leaf relative to its largest
# entry after TRAIN_GRAD_ABS of the largest entry of any leaf (leaves whose
# gradient is zero but for rounding, such as attention key biases), worst
# over TRAIN_PARITY_SEEDS. The kernels against the plain spline on the
# card: TRAIN_KERNEL_TOL, loss and leaves. The card against the CPU: the
# loss to TRAIN_LOSS_TOL, norms and leaves to TRAIN_TOL. At a trained
# release the batch gradient is a sum of per-event terms that mostly
# cancel, so the GEMMs' and convs' rounding (in another order in
# cuBLAS/cuDNN than on the CPU) shows in it amplified: on an NVIDIA H100
# 80GB HBM3 at 700 W the worst leaf over the six seeds differs from the CPU
# by 3.9e-3 with the kernels, the same with the plain spline on the card.
# TF32 in the backward moves the leaves by no more than that (1.5e-3 to
# 3.8e-3 against the CPU with trainer.backward's guard lifted and TF32
# allowed), so the guard is held card against card, where the sound runs
# agree to 0 after the allowance and the guard lifted reads 5.4e-5 to
# 6.7e-4 under torch's defaults (cuDNN TF32) and 1.2e-3 to 2.3e-3 with TF32
# allowed for matmuls: TF32_GUARD_TOL.
TRAIN_PARITY_EVENTS, TRAIN_GRAD_ABS = 16, 1e-5
TRAIN_PARITY_SEEDS = tuple(range(21, 27))
TRAIN_KERNEL_TOL, TRAIN_LOSS_TOL, TRAIN_TOL = 1e-4, 1e-4, 1e-2
TF32_GUARD_TOL = 1e-5
TRAIN_STEPS = 20
# importance sampling (phase o): run_smc_prior's stages capped here (40 by
# default) to keep the run short. The card against the port's CPU path on
# IS_REF_THETA parameter sets: each likelihood within IS_LL_TOL of
# 1 + ½‖h_w‖² + |Re⟨d, h_w⟩| (as tests/test_torch_is_likelihood.py holds
# the port to JAX); the symmetrized flow density in float32 with its median
# |Δ| within IS_LOGQ_TOL nats. At the flagship's steep points float32
# itself is off by several 1e-3 nats (the CPU's float32 against a float64
# run of the same flow on the CPU), so the largest |Δ| is held against
# that float64 reference: the card's within the larger of IS_LOGQ_TOL and
# twice the CPU's own.
IS_SMC_STAGES, IS_REF_THETA, IS_SEED = 10, 64, 3
IS_LL_TOL, IS_LOGQ_TOL = 1e-3, 1e-3
TRAIN_NLL0 = (-8.0, -3.0)        # the release's Gaussian val_nll is -5.55
FIT_STEPS, FIT_VAL_EVENTS = 5, 64
# the overlap path, phases (p)-(t). PriorityNet card against CPU (p): the
# released nets on one make_priority_batch batch at the evaluation config
# (B = 32, up to 4 signals, dead slots), scores, sigma and aux within
# PRIORITY_REL of the largest live |score| plus PRIORITY_ABS (as
# tests/test_torch_priority_net.py holds the port to JAX)
PRIORITY_RELEASES = ("model_release/priority_v7", "model_release/priority_v5")
PRIORITY_BATCH, PRIORITY_SEED = 32, 11
PRIORITY_REL, PRIORITY_ABS = 1e-4, 1e-5
# (q)-(r): a 3-signal precessing injection (m1, m2, d, ra, dec, theta_jn,
# psi, phase, t_c, a1, a2, tilt_1, tilt_2, phi_12, phi_jl). On the design
# ASD its network SNRs are about 49.7, 21.7 and 13.5 (checked in the phase:
# each pair differs by a factor of SNR_RATIO_MIN or more) and its mergers
# lie 0.9 s and more apart (MERGER_GAP_MIN); the loudness order
# (Mc^(5/6)/d), which ranks the flow's posteriors, is the SNR order
OVERLAP = (
    (35.0, 28.0, 500.0, 1.2, -0.4, 0.6, 0.9, 2.0, 0.05, 0.5, 0.3, 1.0, 2.1,
     0.7, 3.0),
    (22.0, 18.0, 700.0, 2.6, 0.5, 0.9, 1.7, 0.7, -0.85, 0.3, 0.6, 0.6, 1.4,
     2.2, 1.1),
    (14.0, 11.0, 1200.0, 4.1, 0.9, 0.4, 2.4, 4.4, 0.95, 0.2, 0.4, 2.0, 0.9,
     4.1, 5.2))
OVERLAP_SEED, OVERLAP_REPS = 5, 4
SNR_RATIO_MIN, MERGER_GAP_MIN = 1.5, 0.5
DECOMPOSE_MAX, DECOMPOSE_ROWS = 5, 2048    # AHSDPipeline's n_samples (r)
# (r) again with every stage accepted (quality is clipped to [-1, 2]) and
# a bias corrector of random weights from this seed, so that the card runs
# all DECOMPOSE_MAX stages: the residual fed back and the corrector's branch
FORCED_THRESHOLD, BIAS_SEED = -2.0, 17
# the subtractor card vs CPU on the same draws: the residual within SUB_TOL
# of the strain's largest |value|, alpha and fit SNR within SUB_TOL relative
SUB_TOL = 1e-4
# (s): make_batched_decompose over POD_EVENTS simulated events
POD_EVENTS, POD_SAMPLES, POD_STAGES, POD_TEMPLATES = 8, 1024, 3, 128
# (t): tools/priority_eval.py at its defaults (20 batches of 32, ~500
# multi-signal scenarios) against reports/priority_eval_v7.json (the JAX
# battery on 508 scenarios). The scenarios are fresh torch draws, so each
# figure is an estimate with its own spread. One estimate's σ, binomial
# for the accuracies, sd/√n for τ (sd 0.514 over 516 scenarios in a CPU
# run of the battery): top-1 0.012 (0.917, 508 scenarios), the close-pair
# bin [0, 0.1) 0.034 (0.713, 181 pairs), τ 0.023; the difference of two
# such estimates has √2 that σ (0.017, 0.047, 0.032). So the bands, ±0.05,
# ±0.07 and ±0.05, are 4.1σ, 2.1σ and 2.2σ of one estimate.
EVAL_REF = {"top1": 0.917, "close": 0.713, "tau": 0.812}
EVAL_BAND = {"top1": 0.05, "close": 0.07, "tau": 0.05}
PRIORITY_FIT_STEPS, PRIORITY_FIT_BATCH = 50, 32
# (u) the real-noise path on a synthetic bank of BANK_SEGMENTS 64 s segments
# a detector (tools/make_noise_bank.py --synthetic). Card vs CPU at
# real_noise_prob 1 on BANK_PARITY_EVENTS events with detector dropout
# raised to BANK_PARITY_DROPOUT (so that dropped detectors occur), at (f)'s
# tolerances; the crops, filters and bands exact. BANK_STEPS train steps of
# the flagship's own SimConfig (real_noise_prob 0.5) with the bank on the
# card: the share of real-noise events within BANK_SHARE_SIGMAS binomial σ
# of the probability. FEED_STEPS steps fed by HostNoiseFeed (batch i from
# server seed FEED_SEED·1_000_003 + i); fit with the bank for one epoch of
# BANK_FIT_STEPS steps on BANK_FIT_VAL validation events a domain.
BANK_SEGMENTS, BANK_PARITY_EVENTS, BANK_PARITY_DROPOUT = 16, 16, 0.5
BANK_STEPS, BANK_SHARE_SIGMAS = 10, 4.0
# then BANK_TURNS pairs of steps with and without the bank in turns
# (without, with; with, without; ...), host wall each, for the comparison
BANK_TURNS = 12
FEED_STEPS, FEED_SEED, SERVER_REPS = 4, 6, 5
BANK_FIT_STEPS, BANK_FIT_VAL = 2, 32
# (v) checkpoint validation at reports/val_r7/report.json's own size (7
# chunks of 256 events, 400 draws each). Its statistics are estimates from
# fresh events: each is held within VAL_SIGMAS σ of the JAX report, σ the
# standard error of the difference of two such estimates (the port's
# chunk-to-chunk sd / √chunks, times √2). The fitted ood_stats' distances
# against the release's shipped ones: two-sample KS p > OOD_KS_P, medians
# within OOD_MEDIAN_REL. The real-noise domain on (u)'s bank at
# VAL_REAL_EVENTS events, a mechanics check. The twin grid's distances
# (SNR-rescaled, no noise) within TWIN_DIST_REL of analysis/twin_grid.json
# (the float32 phase gap the simulator tests allow); importance_validation
# on IV_CASES with run_smc_prior capped at IS_SMC_STAGES, each corrected
# chirp-mass median within IV_MC_REL of the truth.
VAL_REPORT = "reports/val_r7/report.json"
VAL_EVENTS, VAL_POST, VAL_CHUNK, VAL_SIGMAS = 1792, 400, 256, 4.0
VAL_STATS = {"val_nll": "val_nll_diag", "shuffle_delta_nll":
             "shuffle_delta_nll", "dist_corr": "dist_corr",
             "spurious_railing": "spurious_railing", "base_conc": "base_conc"}
VAL_HASH = "b58b05b3ce29"
VAL_REQUESTS = 12                  # 6 smoke + 3 glitch+signal + 3 live OOD
OOD_KS_P, OOD_MEDIAN_REL = 1e-3, 0.05
VAL_REAL_EVENTS = 256
TWIN_REPORT, TWIN_DIST_REL = "analysis/twin_grid.json", 2e-3
IV_REPORT = "analysis/importance_validation.json"
IV_CASES, IV_MC_REL = ("gw150914_like", "gw170608_like"), 0.02
DEVICE = "cuda"
# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str):
    if not ok:
        raise SmokeFailure(msg)


def card_name_and_power() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0 and out.stdout.strip() != "",
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0].strip()


def coloured_noise(seed: int, seconds: float = 32.0,
                   sample_rate: int = SAMPLE_RATE) -> dict:
    """{detector: raw strain} of stationary Gaussian noise with the design
    PSD (one-sided S(f): E|X_k|² = N·fs·S(f_k)/2), float64."""
    from posteriflow_torch.physics.psd import psd_for
    n = int(seconds * sample_rate)
    f = np.fft.rfftfreq(n, 1.0 / sample_rate)
    rng = np.random.default_rng(seed)
    out = {}
    for det in DETECTORS:
        amp = np.sqrt(n * sample_rate * psd_for(det, f) / 4.0)
        xf = amp * (rng.standard_normal(f.size)
                    + 1j * rng.standard_normal(f.size))
        out[det] = np.fft.irfft(xf, n=n)
    return out


def rqs_bytes(n: int, d: int, k: int) -> int:
    """Bytes the spline must move: x, raw and the bias read once, out and
    logdet written once (float32)."""
    return 4 * (n * d + n * d * (3 * k - 1) + 3 * k - 1 + n * d + n)


def rqs_ops(n: int, d: int, k: int) -> int:
    """f32 operations of one spline call, counted per (row, dim) from the
    kernel's source: two softmaxes (~6K each), two knot cumsums (~2K
    each), the bias add (3K), K-1 bin compares, 4K selects, two softplus
    and ~50 for the rational-quadratic map and its log-derivative."""
    return n * d * (24 * k + 56)


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `reps` runs, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_ptxas(rqs_cuda):
    """(a) registers and spills of every kernel instance, from the build's
    `-Xptxas -v` output; the K = 16 instances (the flagship's) must not
    spill."""
    insts = rqs_cuda.ptxas_instances(rqs_cuda.KERNEL.build_log)
    check(len(insts) == 4 * len(rqs_cuda.SUPPORTED_BINS),
          f"ptxas reported {len(insts)} kernel instances")
    for i in insts:
        check("registers" in i and "spill_stores" in i,
              f"ptxas report incomplete: {i}")
        print(f"    ptxas: rqs_tile<{i['k']}, "
              f"{'inverse' if i['inverse'] else 'forward'}, "
              f"{'bias' if i['bias'] else 'no bias'}>: {i['registers']} "
              f"registers, {i['stack']} B stack, {i['spill_stores']} B spill "
              f"stores, {i['spill_loads']} B spill loads")
        check(i["k"] != K_BINS or i["spill_stores"] == 0,
              f"K={K_BINS} instance spills: {i}")


def spline_inputs(torch, n: int, seed: int, k: int = K_BINS, d: int = D_TR):
    """As the repo's Pallas parity test draws them: |x| up to 6 (tails
    beyond ±5), raw spline parameters N(0, 0.7²); a bias N(0, 0.5²) over
    all 3K-1 channels."""
    rng = np.random.default_rng(seed)
    n_raw = 3 * k - 1
    x = torch.from_numpy(np.clip(rng.standard_normal((n, d)) * 2.5,
                                 -6.0, 6.0).astype(np.float32)).to(DEVICE)
    raw = torch.from_numpy((rng.standard_normal((n, d, n_raw))
                            * 0.7).astype(np.float32)).to(DEVICE)
    bias = torch.from_numpy((rng.standard_normal(n_raw) * 0.5)
                            .astype(np.float32)).to(DEVICE)
    return x, raw, bias


def phase_kernel_check(torch, plain, rqs_cuda, card):
    """(b) kernel vs plain version at the flagship sampling shape and at
    ragged N, both directions, with and without the bias."""
    errs = {}
    flagship = None
    for n in (N_ROWS, *RAGGED_ROWS, IS_ROWS, DECOMPOSE_ROWS,
              VAL_CHUNK, VAL_CHUNK * VAL_POST,
              POD_EVENTS * POD_SAMPLES, ANCHOR_ROWS):
        x, raw, bias = spline_inputs(torch, n, seed=n)
        if n == N_ROWS:
            flagship = (x, raw, bias)
        frac_tail = float((x.abs() > TAIL).float().mean())
        for b in (None, bias):
            for inverse in (False, True):
                k_out, k_ld = rqs_cuda.KERNEL.launch(
                    x, raw.reshape(n, -1), K_BINS, TAIL, inverse, bias=b)
                p_fn = plain.rqs_inverse if inverse else plain.rqs_forward
                p_out, p_ld = p_fn(x, raw if b is None else raw + b, K_BINS,
                                   TAIL)
                torch.cuda.synchronize()
                e_out = float((k_out - p_out).abs().max())
                e_ld = float((k_ld - p_ld).abs().max())
                name = "inverse" if inverse else "forward"
                print(f"(b) kernel vs plain, {name}, "
                      f"{'bias' if b is not None else 'no bias'}, N={n} "
                      f"D={D_TR} K={K_BINS} (tails: {frac_tail:.4f} of x "
                      f"beyond ±{TAIL:g}): max|Δout| {e_out:.3e} (tol "
                      f"{TOL_OUT:g}), max|Δlogdet| {e_ld:.3e} (tol "
                      f"{TOL_LOGDET:g})")
                check(math.isfinite(e_out) and e_out <= TOL_OUT,
                      f"kernel {name} N={n} out differs by {e_out}")
                check(math.isfinite(e_ld) and e_ld <= TOL_LOGDET,
                      f"kernel {name} N={n} logdet differs by {e_ld}")
                prev = errs.get(name, (0.0, 0.0))
                errs[name] = (max(prev[0], e_out), max(prev[1], e_ld))
    return (*flagship, errs)


def phase_serve(torch, rqs_cuda, engine, card):
    """(c) serve N_REQUESTS requests; the kernel must run once per layer."""
    from posteriflow_torch.inference.pipeline import infer
    layers = engine.cfg.flow_layers
    rqs_cuda.KERNEL.launches = 0
    for i in range(N_REQUESTS):
        before = rqs_cuda.KERNEL.launches
        rank = i % 2
        t0 = time.perf_counter()
        res = infer(engine, strain=coloured_noise(seed=100 + i), rank=rank,
                    n_samples=N_SAMPLES, seed=i)
        wall = time.perf_counter() - t0
        grew = rqs_cuda.KERNEL.launches - before
        rt = res.diagnostics["runtime"]
        print(f"(c) request {i} rank {rank}: {wall * 1e3:.1f} ms wall "
              f"(prepare {rt['prepare'] * 1e3:.1f}, encode "
              f"{rt['encode'] * 1e3:.1f}, sampling {rt['sampling'] * 1e3:.1f})"
              f" [{card}]; verdict {res.verdict}, refine "
              f"{res.gate.get('refine')}, railing "
              f"{res.railing_fraction():.3f}, kernel launches +{grew}")
        check(grew == layers, f"request {i}: kernel launched {grew} times, "
                              f"expected {layers}")
        check(res.samples.shape == (N_SAMPLES, engine.cfg.n_params),
              f"samples shape {res.samples.shape}")
        check(bool(np.isfinite(res.samples).all()), "non-finite samples")
        check(bool(np.isfinite(res.log_prob).all()), "non-finite log_q")
        check(res.verdict in ("HIGH", "MEDIUM", "LOW"),
              f"verdict {res.verdict!r}")
        check(isinstance(res.gate, dict) and "refine" in res.gate,
              "refinement gate missing")
    return rqs_cuda.KERNEL.launches


def phase_reference(torch, engine_cls, state_dict, cfg, card):
    """(c, continued) the card's path against the port's CPU path on the
    same prepared input: the contexts, then both flows on the CPU's context
    with the same base draws."""
    from posteriflow_torch.inference.preprocessing import prepare_real
    prep = prepare_real(coloured_noise(seed=100), psd_bands=cfg.psd_bands)
    z = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, N_REF_DRAWS, cfg.n_params)).astype(np.float32))
    # (context, relative to its largest entry; y; log q). float32: the CPU
    # port agrees with JAX to 1e-6 on the context and 1e-5 on the draws, so
    # 1e-3 on the context and the largest |Δy|. bfloat16: the context as in
    # tests/test_torch_flagship.py; a last-bit flip of one bf16 activation
    # can move a draw far, so the median |Δy| is held to one bf16 step
    # (2^-8) and the median |Δlog q| to 0.1 nat.
    tol = {"float32": (1e-3, 1e-3, 1e-2), "bfloat16": (3e-2, 2 ** -8, 0.1)}
    for dt in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, flow_dtype=dt, encoder_dtype=dt)
        engines = [engine_cls(state_dict, c, device=dev)
                   for dev in (DEVICE, "cpu")]
        ctx = [e.encode(prep.strain[None], prep.asd_bands[None])
               for e in engines]
        outs = []
        for e in engines:
            dev = e.device
            with torch.no_grad():
                full = e.model.full_context(
                    ctx[1].to(dev), torch.zeros(1, dtype=torch.long,
                                                device=dev))
                y, lq = e.model.flow.sample_with_log_prob(z.to(dev),
                                                          full[:, None, :])
            outs.append([t.float().cpu().numpy() for t in (y, lq)])
        cg, cc = (t.float().cpu().numpy() for t in ctx)
        (yg, lg), (yc, lc) = outs
        d_ctx = float(np.abs(cg - cc).max() / max(1.0, np.abs(cc).max()))
        d_y = np.abs(yg - yc)
        d_lq = float(np.median(np.abs(lg - lc)))
        held = float(d_y.max() if dt == "float32" else np.median(d_y))
        t_ctx, t_y, t_lq = tol[dt]
        print(f"(c) card vs CPU, {dt}: max|Δcontext| rel {d_ctx:.3e} (tol "
              f"{t_ctx:g}); flows on one context, {N_REF_DRAWS} draws: "
              f"|Δy| max {d_y.max():.3e} median {np.median(d_y):.3e} (tol "
              f"{t_y:g} on the {'max' if dt == 'float32' else 'median'}), "
              f"median|Δlog q| {d_lq:.3e} (tol {t_lq:g})")
        check(d_ctx <= t_ctx, f"{dt}: context differs by {d_ctx}")
        check(held <= t_y, f"{dt}: samples differ by {held}")
        check(d_lq <= t_lq, f"{dt}: log q differs by {d_lq}")


def phase_bench(torch, plain, rqs_cuda, engine, x, raw, bias, card):
    """(d) one bench-shaped batch, and the kernel alone at its shape."""
    from posteriflow_torch.inference.preprocessing import prepare_real
    preps = [prepare_real(coloured_noise(seed=200 + i),
                          psd_bands=engine.cfg.psd_bands)
             for i in range(BENCH_EVENTS)]
    strain = np.stack([p.strain for p in preps])
    bands = np.stack([p.asd_bands for p in preps])
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    ctx = engine.encode(strain, bands)
    n_draws = BENCH_EVENTS * BENCH_DRAWS

    before = rqs_cuda.KERNEL.launches
    engine.sample_posterior(ctx, 0, BENCH_DRAWS, generator=gen)
    torch.cuda.synchronize()
    per_batch = rqs_cuda.KERNEL.launches - before
    check(per_batch == engine.cfg.flow_layers,
          f"bench batch launched the kernel {per_batch} times")

    enc_ms = cuda_time_ms(lambda: engine.encode(strain, bands), reps=5)
    smp_ms = cuda_time_ms(lambda: engine.sample_posterior(
        ctx, 0, BENCH_DRAWS, generator=gen), reps=5)
    draws_per_s = n_draws / (smp_ms * 1e-3)

    raw2 = raw.reshape(N_ROWS, -1)
    biased = raw + bias
    times = {}
    # the main path's call (bias fused), then the kernel without the bias
    for b in (bias, None):
        for inverse in (True, False):
            name = (("inverse" if inverse else "forward")
                    + ("" if b is not None else " no bias"))
            p_fn = plain.rqs_inverse if inverse else plain.rqs_forward
            p_raw = raw if b is None else biased
            times[name] = (
                cuda_time_ms(lambda: rqs_cuda.KERNEL.launch(
                    x, raw2, K_BINS, TAIL, inverse, bias=b), reps=20),
                cuda_time_ms(lambda: p_fn(x, p_raw, K_BINS, TAIL), reps=5))
    # what this card's memory gives one plain read of raw: the yardstick
    # for the kernel's rate beside the data sheet's 3.35 TB/s
    read_ms = cuda_time_ms(lambda: torch.sum(raw), reps=20)
    read_tb_s = raw.numel() * 4 / (read_ms * 1e-3) / 1e12
    nbytes = rqs_bytes(N_ROWS, D_TR, K_BINS)
    nops = rqs_ops(N_ROWS, D_TR, K_BINS)
    bound_ms = max(nbytes / PEAK_BYTES_PER_S, nops / PEAK_F32_FLOPS) * 1e3
    bound_by = ("bytes" if nbytes / PEAK_BYTES_PER_S >= nops / PEAK_F32_FLOPS
                else "operations")
    print(f"(d) bench batch {BENCH_EVENTS} events x {BENCH_DRAWS} draws "
          f"[{card}]: encode {enc_ms:.3f} ms, sampling {smp_ms:.3f} ms, "
          f"{draws_per_s:.0f} draws/s, kernel launches per batch {per_batch}")
    for name, (k_ms, p_ms) in times.items():
        print(f"(d) rqs {name} N={N_ROWS} D={D_TR} K={K_BINS} [{card}]: "
              f"kernel {k_ms * 1e3:.1f} us/launch, plain {p_ms * 1e3:.1f} us, "
              f"bound {bound_ms * 1e3:.1f} us ({bound_by}: {nbytes} B at "
              f"3.35 TB/s, {nops} f32 ops at 67 TFLOP/s), kernel at "
              f"{nbytes / (k_ms * 1e-3) / 1e12:.3f} TB/s, "
              f"{bound_ms / k_ms:.1%} of its bound")
    print(f"(d) torch.sum over raw ({raw.numel() * 4} B read once) "
          f"[{card}]: {read_ms * 1e3:.1f} us, {read_tb_s:.3f} TB/s; the "
          f"inverse kernel moves its bytes at "
          f"{nbytes / (times['inverse'][0] * 1e-3) / 1e12 / read_tb_s:.1%} "
          f"of that rate")
    return {"encode_ms": enc_ms, "sampling_ms": smp_ms,
            "draws_per_s": draws_per_s, "per_batch": per_batch,
            "times": times, "bound_ms": bound_ms, "bound_by": bound_by,
            "ctx": ctx, "gen": gen}


def phase_profile(torch, engine, bench, card):
    """Device time of one bench batch by kernel (torch.profiler): the busy
    share of the profiled window and the kernels that take most of it; and
    the operators that read a tensor of raw's size, among which no add of
    the derivative bias may be left (the kernel adds it)."""
    from torch.profiler import ProfilerActivity, profile
    flow = engine.model.flow
    n_raw = 3 * flow.num_bins - 1
    raw_numel = (BENCH_EVENTS * BENCH_DRAWS * (flow.features - flow.n_id)
                 * n_raw)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            t0 = time.perf_counter()
            engine.sample_posterior(bench["ctx"], 0, BENCH_DRAWS,
                                    generator=bench["gen"])
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
    except RuntimeError as e:           # no CUPTI on this machine
        print(f"(d) profiler: not available ({e})")
        return
    on_raw, bias_adds = {}, 0
    for e in prof.events():
        shapes = [s for s in (e.input_shapes or []) if isinstance(s, list)
                  and all(isinstance(v, int) for v in s)]
        if any(s and math.prod(s) == raw_numel for s in shapes):
            on_raw[e.name] = on_raw.get(e.name, 0) + 1
            if e.name in ("aten::add", "aten::add_") and [n_raw] in shapes:
                bias_adds += 1
    print(f"(d) operators reading a tensor of raw's {raw_numel} floats "
          f"({raw_numel * 4 / 1e6:.0f} MB) in one batch: "
          f"{dict(sorted(on_raw.items()))}; derivative-bias adds {bias_adds}")
    check(bias_adds == 0, f"{bias_adds} derivative-bias passes over raw left")
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"(d) profile of one sampling batch [{card}]: kernels "
          f"{busy_us / 1e3:.3f} ms of a {window_us / 1e3:.3f} ms window "
          f"(device busy {busy_us / window_us:.1%}, under the profiler); "
          f"{sum(e.count for e in kernels)} launches; top kernels:")
    for e in kernels[:12]:
        print(f"      {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} "
              f"{e.key[:100]}")


def _match(a, b) -> np.ndarray:
    """|<a, b>| / (|a| |b|) over the last axis, complex128."""
    a = a.astype(np.complex128)
    b = b.astype(np.complex128)
    num = np.abs(np.sum(a * np.conj(b), axis=-1))
    den = np.sqrt(np.sum(np.abs(a) ** 2, -1) * np.sum(np.abs(b) ** 2, -1))
    return num / np.maximum(den, 1e-300)


def phase_sim_parity(torch, sim_cfg, card):
    """(f) the port's simulator on the card against the port's CPU path, on
    the same prior draws and event draws."""
    from posteriflow_torch.physics import simulator as tsim
    from posteriflow_torch.physics.psd import default_network_asd
    from posteriflow_torch.physics.whiten import fd_white_to_td
    from posteriflow_torch.prior import sample_batch
    cfgs = {"15-D flagship": sim_cfg,
            "11-D aligned": dataclasses.replace(
                sim_cfg, prior=dataclasses.replace(sim_cfg.prior,
                                                   precessing=False))}
    asd = {d: default_network_asd(device=d) for d in (DEVICE, "cpu")}
    for name, cfg in cfgs.items():
        g = torch.Generator().manual_seed(11)
        params, n_sig = sample_batch(BENCH_EVENTS, cfg.prior, g, "cpu")
        draws = tsim.draw_events((BENCH_EVENTS,), g, "cpu")
        flat = params.reshape(-1, params.shape[-1])
        out = {}
        for dev in (DEVICE, "cpu"):
            d_draws = tsim.SimDraws(*[t.to(dev) for t in draws])
            with torch.no_grad():
                h = tsim.signal_white_fd(flat.to(dev), asd[dev])
                snr = tsim.signal_snr_amp_only(
                    flat.to(dev), asd[dev],
                    decimate=4 if flat.shape[-1] < 15 else 2)
                ev = tsim.simulate_batch(BENCH_EVENTS, cfg, device=dev,
                                         params=params.to(dev),
                                         n_sig=n_sig.to(dev), draws=d_draws)
            out[dev] = (h.cpu().numpy(), snr.cpu().numpy(), ev)
        (hg, sg, eg), (hc, sc, ec) = out[DEVICE], out["cpu"]
        live = np.linalg.norm(hc, axis=-1) > 0
        m = _match(hg, hc)[live]
        norm = np.abs(np.linalg.norm(hg, axis=-1)[live]
                      / np.linalg.norm(hc, axis=-1)[live] - 1.0)
        d_snr = float(np.abs(sg / sc - 1.0).max())
        noise = draws.noise.numpy()
        if cfg.glitch_prob > 0:
            noise = noise + tsim._glitch_burst(draws, cfg.glitch_prob).numpy()
        mask = ec.det_mask.numpy()[..., None] > 0
        sig = np.where(mask, ec.strain.numpy() - noise, 0.0)
        tol = SIM_ATOL + SIM_SIG * np.abs(sig).max(axis=(-2, -1))
        err = np.abs(eg.strain.cpu().numpy() - ec.strain.numpy()).max(
            axis=(-2, -1))
        same_gate = (torch.equal(eg.n_sig.cpu(), ec.n_sig)
                     and torch.equal(eg.params.cpu(), ec.params)
                     and torch.equal(eg.det_mask.cpu(), ec.det_mask))
        print(f"(f) simulator card vs CPU, {name}, B={BENCH_EVENTS} x "
              f"S={cfg.max_signals} slots, n_sig {ec.n_sig.tolist()} "
              f"[{card}]: whitened FD per slot and detector 1-match max "
              f"{1.0 - m.min():.2e} (tol {SIM_MATCH:g}), |norm ratio-1| max "
              f"{norm.max():.2e} (tol {SIM_NORM:g}); gate SNR rel max "
              f"{d_snr:.2e} (tol {SIM_SNR:g}); gate and masks identical "
              f"{same_gate}; strain max|Δ| {err.max():.3e} (tol per event "
              f"{SIM_ATOL:g} + {SIM_SIG:g} x signal peak, at most "
              f"{tol.max():.3e})")
        check(1.0 - m.min() <= SIM_MATCH, f"{name}: whitened FD match")
        check(norm.max() <= SIM_NORM, f"{name}: whitened FD norm")
        check(d_snr <= SIM_SNR, f"{name}: gate SNR differs by {d_snr}")
        check(same_gate, f"{name}: the gate differs between card and CPU")
        check(bool((err <= tol).all()), f"{name}: strain differs by {err}")
        check(bool(torch.isfinite(eg.strain).all()), "non-finite strain")

    # cuFFT's C2R against pocketfft where DC and Nyquist have imaginary parts
    rng = np.random.default_rng(3)
    n = 16384
    x = (rng.standard_normal((3, n // 2 + 1))
         + 1j * rng.standard_normal((3, n // 2 + 1))).astype(np.complex64)
    xt = torch.from_numpy(x)
    raw_card = torch.fft.irfft(xt.to(DEVICE), n=n).cpu()
    raw_cpu = torch.fft.irfft(xt, n=n)
    ours = (fd_white_to_td(xt.to(DEVICE)).cpu() - fd_white_to_td(xt)).abs()
    print(f"(f) irfft with imaginary DC/Nyquist parts, card vs CPU: cuFFT "
          f"C2R as given max|Δ| {float((raw_card - raw_cpu).abs().max()):.3e}"
          f"; fd_white_to_td (imaginary parts zeroed) max|Δ| "
          f"{float(ours.max()):.3e}")
    check(float(ours.max()) <= 1e-4, "fd_white_to_td differs card vs CPU")


def phase_sim_time(torch, sim_cfg, card):
    """(g) simulate_batch at B = 8 and B = 128, flagship SimConfig."""
    from torch.profiler import ProfilerActivity, profile

    from posteriflow_torch.physics.simulator import simulate_batch
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    times = {}
    for b, reps in ((BENCH_EVENTS, 10), (TRAIN_BATCH, 5)):
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_time_ms(lambda: simulate_batch(b, sim_cfg, device=DEVICE,
                                                 generator=gen), reps=reps)
        t0 = time.perf_counter()
        ev = simulate_batch(b, sim_cfg, device=DEVICE, generator=gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(bool(torch.isfinite(ev.strain).all()), "non-finite strain")
        check(tuple(ev.strain.shape) == (b, 3, 16384), "strain shape")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            simulate_batch(b, sim_cfg, device=DEVICE, generator=gen)
            torch.cuda.synchronize()
            window = (time.perf_counter() - t0) * 1e6
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kern)
        n_launch = sum(e.count for e in kern)
        kern.sort(key=lambda e: e.self_device_time_total, reverse=True)
        top = "; ".join(f"{e.self_device_time_total / 1e3:.3f} ms x{e.count} "
                        f"{e.key[:60]}" for e in kern[:5])
        times[b] = ms
        print(f"(g) simulate_batch B={b} (flagship SimConfig) [{card}]: "
              f"{ms:.3f} ms by CUDA events ({reps} runs), {wall:.3f} ms "
              f"wall for one, peak memory {peak:.2f} GiB, "
              f"{n_launch} kernel launches, kernels {busy / 1e3:.3f} ms of "
              f"a {window / 1e3:.3f} ms window under the profiler (device "
              f"busy {busy / window:.1%}); top: {top}")
    return times


def phase_bench_path(torch, rqs_cuda, engine, sim_cfg, card):
    """(h) bench.py's path on the card: simulate → encode → sample."""
    from posteriflow_torch.physics.simulator import simulate_batch
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    rqs_cuda.KERNEL.launches = 0
    t0 = time.perf_counter()
    batch = simulate_batch(BENCH_EVENTS, sim_cfg, device=DEVICE,
                           generator=gen)
    ctx = engine.encode(batch.strain, batch.asd_bands)
    theta, log_q, railed = engine.sample_posterior(ctx, 0, BENCH_DRAWS,
                                                   generator=gen)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = rqs_cuda.KERNEL.launches
    check(launches == engine.cfg.flow_layers,
          f"bench path launched the kernel {launches} times")
    check(tuple(theta.shape) == (BENCH_EVENTS, BENCH_DRAWS,
                                 engine.cfg.n_params), "samples shape")
    check(bool(torch.isfinite(theta).all() and torch.isfinite(log_q).all()),
          "non-finite samples on the simulated batch")
    smp_ms = cuda_time_ms(lambda: engine.sample_posterior(
        ctx, 0, BENCH_DRAWS, generator=gen), reps=5)
    enc_ms = cuda_time_ms(lambda: engine.encode(batch.strain,
                                                batch.asd_bands), reps=5)
    rate = BENCH_EVENTS * BENCH_DRAWS / (smp_ms * 1e-3)
    print(f"(h) bench path simulate -> encode -> sample, {BENCH_EVENTS} "
          f"simulated events (n_sig {batch.n_sig.tolist()}) x {BENCH_DRAWS} "
          f"draws [{card}]: {wall:.1f} ms wall for the first pass; encode "
          f"{enc_ms:.3f} ms, sampling {smp_ms:.3f} ms by CUDA events, "
          f"{rate:.0f} draws/s; kernel launches in the path {launches}; "
          f"railing {float(railed.float().mean()):.4f}")
    return {"launches": launches, "sampling_ms": smp_ms, "draws_per_s": rate,
            "encode_ms": enc_ms}


INJECTION = dict(mass_1=35.0, mass_2=28.0, luminosity_distance=500.0,
                 ra=1.2, dec=-0.4, theta_jn=0.6, psi=0.9, phase=2.0,
                 geocent_time=0.05, a1=0.5, a2=0.3, tilt_1=1.0, tilt_2=2.1,
                 phi_12=0.7, phi_jl=3.0)


def phase_inject(torch, rqs_cuda, engine, card):
    """(i) two requests on a 15-D injection; the second is timed warm."""
    from posteriflow_torch.inference.pipeline import infer
    for i in range(2):
        rqs_cuda.KERNEL.launches = 0
        t0 = time.perf_counter()
        res = infer(engine, inject=[INJECTION], n_samples=N_SAMPLES, seed=i)
        wall = (time.perf_counter() - t0) * 1e3
        launches = rqs_cuda.KERNEL.launches
        rt = res.diagnostics["runtime"]
        print(f"(i) injection request {i} [{card}]: {wall:.1f} ms wall "
              f"(prepare {rt['prepare'] * 1e3:.1f}, encode "
              f"{rt['encode'] * 1e3:.1f}, sampling {rt['sampling'] * 1e3:.1f})"
              f"; verdict {res.verdict}, median m1 "
              f"{float(np.median(res.samples[:, 0])):.1f} (injected "
              f"{INJECTION['mass_1']}), kernel launches {launches}")
        check(launches == engine.cfg.flow_layers,
              f"injection request launched the kernel {launches} times")
        check(res.samples.shape == (N_SAMPLES, engine.cfg.n_params),
              "injection samples shape")
        check(bool(np.isfinite(res.samples).all()
                   and np.isfinite(res.log_prob).all()),
              "non-finite injection samples")
    return launches


def phase_tf32(torch, engine_cls, card):
    """(j) the float32 encoder of npe_r2_best under torch's default TF32
    switches, card against CPU; then with the port's guard lifted and TF32
    on, to show what it guards against."""
    import contextlib

    from posteriflow_torch.inference.preprocessing import prepare_simulated
    from posteriflow_torch.models import encoder as enc_mod
    from posteriflow_torch.models import flow as flow_mod
    from posteriflow_torch.train.checkpoints import load_release
    state_dict, cfg, _ = load_release(TF32_RELEASE)
    check(cfg.encoder_dtype == "float32", "TF32 release is not float32")
    inj = {k: v for k, v in INJECTION.items()
           if k in cfg.param_names}
    prep = prepare_simulated([inj], seed=3, psd_bands=cfg.psd_bands,
                             param_names=cfg.param_names, device="cpu")
    engines = {d: engine_cls(state_dict, cfg, device=d)
               for d in (DEVICE, "cpu")}
    cpu = engines["cpu"].encode(prep.strain[None],
                                prep.asd_bands[None]).numpy()
    scale = float(np.abs(cpu).max())
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        # torch's defaults, not this script's
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
        card_ctx = engines[DEVICE].encode(prep.strain[None],
                                          prep.asd_bands[None])
        d_guard = float(np.abs(card_ctx.cpu().numpy() - cpu).max()) / scale
        torch.backends.cuda.matmul.allow_tf32 = True
        unguarded = (enc_mod.fp32_exact, flow_mod.fp32_exact)
        enc_mod.fp32_exact = flow_mod.fp32_exact = contextlib.nullcontext
        try:
            tf32_ctx = engines[DEVICE].encode(prep.strain[None],
                                              prep.asd_bands[None])
        finally:
            enc_mod.fp32_exact, flow_mod.fp32_exact = unguarded
        d_tf32 = float(np.abs(tf32_ctx.cpu().numpy() - cpu).max()) / scale
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    print(f"(j) TF32: {TF32_RELEASE} (float32 encoder) context card vs CPU "
          f"under torch's default switches (cudnn.allow_tf32=True, "
          f"matmul.allow_tf32=False): max|Δ| {d_guard:.3e} of the largest "
          f"entry (tol {TF32_TOL:g}); with the port's guard lifted and TF32 "
          f"on for convs and matmuls it would be {d_tf32:.3e} [{card}]")
    check(d_guard <= TF32_TOL, f"float32 encoder differs by {d_guard}")


def phase_grad_guard(torch, plain, rqs_cuda):
    """(k) under grad on CUDA inputs: the inverse, and a bias that requires
    grad, raise (no backward); the forward with x and raw requiring grad
    runs the forward kernel and, in backward, the backward kernel; under
    no_grad the inverse runs."""
    x, raw, bias = spline_inputs(torch, 257, seed=4)
    raw.requires_grad_(True)
    try:
        rqs_cuda.rqs_inverse(x, raw, K_BINS, TAIL, bias=bias)
    except RuntimeError as e:
        msg = str(e)
    else:
        raise SmokeFailure("the inverse kernel accepted inputs that require "
                           "grad")
    with torch.no_grad():
        out, _ = rqs_cuda.rqs_inverse(x, raw, K_BINS, TAIL, bias=bias)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), "non-finite output under no_grad")
    try:
        rqs_cuda.rqs_forward(x, raw, K_BINS, TAIL,
                             bias=bias.clone().requires_grad_(True))
    except RuntimeError:
        pass
    else:
        raise SmokeFailure("the forward kernel accepted a bias that "
                           "requires grad")
    xg = x.clone().requires_grad_(True)
    f0, b0 = rqs_cuda.KERNEL.launches, rqs_cuda.GRAD_KERNEL.launches
    out, ld = rqs_cuda.rqs_forward(xg, raw, K_BINS, TAIL, bias=bias)
    (out.square().sum() + ld.sum()).backward()
    torch.cuda.synchronize()
    ref_x, ref_raw = plain.rqs_forward_vjp(x, raw.detach(), 2.0 * out.detach(),
                                           torch.ones_like(ld), K_BINS, TAIL,
                                           bias=bias)
    err = max(grad_err(xg.grad, ref_x), grad_err(raw.grad, ref_raw))
    launched = (rqs_cuda.KERNEL.launches - f0,
                rqs_cuda.GRAD_KERNEL.launches - b0)
    print(f"(k) rqs_inverse on CUDA inputs that require grad raised "
          f"RuntimeError ({msg[:60]}...), so did rqs_forward with a bias "
          f"that requires grad; rqs_forward under grad launched the forward "
          f"and backward kernels {launched}, gradients within {err:.2e} of "
          f"the largest entry of the plain VJP's (tol {GRAD_REL:g} + "
          f"{GRAD_ABS:g} absolute)")
    check(launched == (1, 1), f"forward under grad launched {launched}")
    check(err <= GRAD_REL, f"autograd through the kernels differs by {err}")


def grad_err(got, ref) -> float:
    """max |Δ| relative to the reference's largest |entry|, less the
    absolute allowance GRAD_ABS: <= GRAD_REL passes."""
    d = float((got - ref).abs().max())
    return max(d - GRAD_ABS, 0.0) / max(float(ref.abs().max()), 1e-30)


def rqs_grad_bytes(n: int, d: int, k: int) -> int:
    """Bytes the backward must move: x, raw, the bias, g_out and g_logdet
    read once, g_x and g_raw written once (float32)."""
    r = 3 * k - 1
    return 4 * (n * d + n * d * r + r + n * d + n + n * d + n * d * r)


def rqs_grad_ops(n: int, d: int, k: int) -> int:
    """f32 operations of one backward call, counted per (row, dim) spline
    once (not the copies its K lanes repeat): the forward's recomputation
    (rqs_ops: ~24K + 56), the gradient over the 2K softmax entries (~7
    each: the entry's upstream term, the Jacobian's dot product and the
    difference), the K-1 softplus' (~4 each) and ~80 for the reverse pass
    through the map."""
    return n * d * (24 * k + 56 + 14 * k + 4 * k + 80)


def phase_grad_kernel(torch, plain, rqs_cuda, card):
    """(l) the backward kernel against rqs_forward_vjp at K in {4, 8, 16,
    32} and N in {640, 257, 131072} (D = 7), with x on knots, at ±B, just
    inside and outside, in both tails, g_logdet zero on a third of the
    rows; then its time at the training shape (640) and at 131072 rows."""
    insts = rqs_cuda.ptxas_instances(rqs_cuda.KERNEL.build_log, "rqs_grad")
    check(len(insts) == 2 * len(rqs_cuda.SUPPORTED_BINS),
          f"ptxas reported {len(insts)} backward instances")
    for i in insts:
        print(f"    ptxas: rqs_grad<{i['k']}, "
              f"{'bias' if i['bias'] else 'no bias'}>: {i['registers']} "
              f"registers, {i['stack']} B stack, {i['spill_stores']} B spill "
              f"stores, {i['spill_loads']} B spill loads")
        check(i["k"] != K_BINS or i["spill_stores"] == 0,
              f"K={K_BINS} backward instance spills: {i}")
    worst = {"abs": 0.0, "rel": 0.0}
    for k in rqs_cuda.SUPPORTED_BINS:
        for n in GRAD_ROWS:
            x, raw, g_out, g_ld, bias = grad_inputs(torch, plain, n, k,
                                                    seed=n + k)
            for b in (None, bias):
                ref = plain.rqs_forward_vjp(x, raw, g_out, g_ld, k, TAIL,
                                            bias=b)
                got = rqs_cuda.GRAD_KERNEL.launch(
                    x, raw.reshape(n, -1), g_out, g_ld, k, TAIL, b)
                torch.cuda.synchronize()
                errs = [grad_err(got[0], ref[0]),
                        grad_err(got[1].reshape(ref[1].shape), ref[1])]
                d_abs = max(float((got[0] - ref[0]).abs().max()),
                            float((got[1].reshape(ref[1].shape)
                                   - ref[1]).abs().max()))
                check(all(math.isfinite(e) and e <= GRAD_REL for e in errs),
                      f"backward kernel K={k} N={n} bias={b is not None}: "
                      f"{errs}")
                if k == K_BINS:
                    worst["abs"] = max(worst["abs"], d_abs)
                    worst["rel"] = max(worst["rel"], *errs)
                print(f"(l) rqs_grad K={k} N={n} D={D_TR} "
                      f"{'bias' if b is not None else 'no bias'}: g_x "
                      f"{errs[0]:.2e}, g_raw {errs[1]:.2e} of the largest "
                      f"entry (tol {GRAD_REL:g} + {GRAD_ABS:g}); max|Δ| "
                      f"{d_abs:.3e}")
    times = {}
    for n in (TRAIN_ROWS, N_ROWS):
        x, raw, g_out, g_ld, bias = grad_inputs(torch, plain, n, K_BINS,
                                                seed=7)
        if n == TRAIN_ROWS:
            train_inputs = (x, raw, g_out, g_ld, bias)
        raw2 = raw.reshape(n, -1)
        k_ms = cuda_time_ms(lambda: rqs_cuda.GRAD_KERNEL.launch(
            x, raw2, g_out, g_ld, K_BINS, TAIL, bias), reps=50)
        dev_ms = kernel_device_ms(torch, lambda: rqs_cuda.GRAD_KERNEL.launch(
            x, raw2, g_out, g_ld, K_BINS, TAIL, bias), "rqs_grad")
        p_ms = cuda_time_ms(lambda: plain.rqs_forward_vjp(
            x, raw, g_out, g_ld, K_BINS, TAIL, bias=bias), reps=5)
        nbytes = rqs_grad_bytes(n, D_TR, K_BINS)
        nops = rqs_grad_ops(n, D_TR, K_BINS)
        by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S, nops / PEAK_F32_FLOPS
        bound_ms = max(by_bytes, by_ops) * 1e3
        bound_by = "bytes" if by_bytes >= by_ops else "operations"
        # the kernel's time is its device time where the profiler gives it:
        # at 640 rows the wrapper's host time is longer than the kernel
        times[n] = {"ms": k_ms if dev_ms is None else dev_ms,
                    "ms_from": ("CUDA events" if dev_ms is None
                                else "profiler device time"),
                    "events_ms": k_ms, "plain_ms": p_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by}
        dev_txt = ("not measured" if dev_ms is None
                   else f"{dev_ms * 1e3:.2f} us")
        print(f"(l) rqs_grad<{K_BINS}, bias> N={n} D={D_TR} [{card}]: kernel "
              f"{k_ms * 1e3:.2f} us/launch by CUDA events over back-to-back "
              f"launches (the wrapper's host time included), device time "
              f"a launch {dev_txt} (profiler), plain VJP "
              f"{p_ms * 1e3:.1f} us, "
              f"bound {bound_ms * 1e3:.2f} us ({bound_by}: {nbytes} B at "
              f"3.35 TB/s = {by_bytes * 1e6:.2f} us, {nops} f32 ops at 67 "
              f"TFLOP/s = {by_ops * 1e6:.2f} us), "
              f"{bound_ms / times[n]['ms']:.1%} of its bound")
    floor_ms = kernel_device_ms(torch, lambda: torch.zeros(1, device=DEVICE),
                                "")
    dev_txt = ("not measured" if floor_ms is None
               else f"{floor_ms * 1e3:.2f} us")
    print(f"(l) launch floor [{card}]: a one-block PyTorch kernel "
          f"(torch.zeros(1)) takes {dev_txt} of device time (profiler); "
          f"rqs_grad at N={TRAIN_ROWS} {times[TRAIN_ROWS]['ms'] * 1e3:.2f} "
          f"us, its bound {times[TRAIN_ROWS]['bound_ms'] * 1e3:.2f} us "
          f"(bytes)")
    host = grad_host_us(torch, rqs_cuda, *train_inputs)
    print(f"(l) host time a call at N={TRAIN_ROWS} [{card}], the host clock "
          f"over {HOST_REPS} calls with no synchronisation between them: "
          f"GRAD_KERNEL.launch {host['launch']:.1f} us, "
          f"RqsForwardFn.backward {host['node']:.1f} us, a whole backward "
          f"of one RqsForwardFn through autograd's engine "
          f"{host['backward']:.1f} us "
          f"(the earlier design's wrapper: "
          f"{EARLIER_GRAD_CALL_US[0]}-{EARLIER_GRAD_CALL_US[1]} us a call)")
    x_tr, raw_tr, _, _, bias_tr = train_inputs
    fwd = forward_timing(torch, plain, rqs_cuda, x_tr, raw_tr, bias_tr)
    print(f"(l) rqs_tile<{K_BINS}, forward, bias> N={TRAIN_ROWS} D={D_TR} "
          f"[{card}]: device time a launch "
          + ("not measured" if fwd["ms"] is None
             else f"{fwd['ms'] * 1e3:.2f} us")
          + f" (profiler), {fwd['events_ms'] * 1e3:.2f} us by CUDA events "
          f"over back-to-back launches, plain {fwd['plain_ms'] * 1e3:.1f} us; "
          f"bound {fwd['bound_ms'] * 1e3:.2f} us "
          f"({fwd['bound_by']}: {rqs_bytes(TRAIN_ROWS, D_TR, K_BINS)} B)")
    return {"times": times, "max_abs_err": worst["abs"],
            "max_rel_err": worst["rel"], "launch_floor_ms": floor_ms,
            "host_us": host, "forward_train": fwd}


def grad_host_us(torch, rqs_cuda, x, raw, g_out, g_ld, bias) -> dict:
    """Host µs a call of the backward kernel's wrapper: the host clock over
    HOST_REPS calls with no synchronisation between them (the device takes
    less than the host per call, so nothing waits), after a warm-up call:
    GRAD_KERNEL.launch; RqsForwardFn.backward called directly with the
    saved tensors (its upstream checks and the unchecked launch); and a
    whole backward through autograd's engine of one RqsForwardFn
    (torch.autograd.backward of (out, logdet) with g_out and g_logdet; only
    the backward is on the clock)."""
    from types import SimpleNamespace
    raw2 = raw.reshape(x.shape[0], -1)
    xg = x.clone().requires_grad_(True)
    rg = raw.clone().requires_grad_(True)

    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_REPS):
            fn()
        us = (time.perf_counter() - t0) / HOST_REPS * 1e6
        torch.cuda.synchronize()
        return us

    out = {"launch": per_call(lambda: rqs_cuda.GRAD_KERNEL.launch(
        x, raw2, g_out, g_ld, K_BINS, TAIL, bias))}
    ctx = SimpleNamespace(saved_tensors=(x, raw2, bias),
                          spline=(K_BINS, TAIL))
    with torch.no_grad():
        out["node"] = per_call(
            lambda: rqs_cuda.RqsForwardFn.backward(ctx, g_out, g_ld))
    total = 0.0
    for i in range(HOST_REPS + 1):
        y, ld = rqs_cuda.rqs_forward(xg, rg, K_BINS, TAIL, bias=bias)
        t0 = time.perf_counter()
        torch.autograd.backward((y, ld), (g_out, g_ld))
        if i:                                   # the first call warms up
            total += time.perf_counter() - t0
        xg.grad = rg.grad = None
    torch.cuda.synchronize()
    out["backward"] = total / HOST_REPS * 1e6
    return out


def forward_timing(torch, plain, rqs_cuda, x, raw, bias, inverse=False,
                   k=K_BINS):
    """rqs_tile<K, forward (or inverse), bias> at x's row count: device
    time by the profiler, CUDA events over back-to-back launches, the plain
    version's time and the kernel's bound."""
    n, d = x.shape
    raw2 = raw.reshape(n, -1)

    def fn():
        return rqs_cuda.KERNEL.launch(x, raw2, k, TAIL, inverse, bias=bias)
    nbytes = rqs_bytes(n, d, k)
    nops = rqs_ops(n, d, k)
    by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S, nops / PEAK_F32_FLOPS
    biased = raw + bias
    p_fn = plain.rqs_inverse if inverse else plain.rqs_forward
    return {"ms": kernel_device_ms(torch, fn, "rqs_tile"),
            "events_ms": cuda_time_ms(fn, reps=50),
            "plain_ms": cuda_time_ms(lambda: p_fn(
                x, biased, k, TAIL), reps=5),
            "bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def kernel_device_ms(torch, fn, name: str, reps: int = 20, tries: int = 3):
    """Device time of one launch of the kernel `name` that fn() launches
    ("": any kernel; torch.profiler over `reps` calls; None without
    CUPTI). A small launch is shorter than the host's time to issue it,
    which CUDA events over back-to-back launches measure instead. On the
    card a session now and then reads no kernel at all (once at phase l,
    before any trace, once after phase x2's, three times in a row at phase
    y5 once): such a session runs again, up to `tries` times, and then the
    time is reported as not measured (None), as without CUPTI; every
    caller then prints "not measured" and keeps the CUDA-event time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            evs = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and name in e.key]
        except RuntimeError:
            return None
        count = sum(e.count for e in evs)
        if count:
            return sum(e.self_device_time_total for e in evs) / count / 1e3
    print(f"(profiler) no {name or 'kernel'} launch read in {tries} "
          f"sessions: device time not measured")
    return None


def grad_inputs(torch, plain, n: int, k: int, seed: int, d: int = D_TR):
    """Card inputs of the backward: x, raw as spline_inputs draws them at
    K, upstream g_out N(0, 1) and g_logdet N(0, 1) with every third row 0,
    a bias; the first rows put x on its own spline's knots, at ±B, just
    inside and just outside."""
    rng = np.random.default_rng(seed)
    r = 3 * k - 1
    x = torch.from_numpy(np.clip(rng.standard_normal((n, d)) * 2.5, -6.0,
                                 6.0).astype(np.float32)).to(DEVICE)
    raw = torch.from_numpy((rng.standard_normal((n, d, r)) * 0.7)
                           .astype(np.float32)).to(DEVICE)
    bias = torch.from_numpy((rng.standard_normal(r) * 0.5)
                            .astype(np.float32)).to(DEVICE)
    g_out = torch.from_numpy(rng.standard_normal((n, d))
                             .astype(np.float32)).to(DEVICE)
    g_ld = rng.standard_normal(n).astype(np.float32)
    g_ld[::3] = 0.0
    g_ld = torch.from_numpy(g_ld).to(DEVICE)
    xk, _, _ = plain._normalize_params(raw[:4] + bias, k, TAIL)
    j = 1 + torch.arange(d, device=DEVICE) % (k - 1)
    x[:4] = torch.gather(xk, -1, j[None, :, None].expand(4, d, 1))[..., 0]
    edge = float(np.nextafter(np.float32(TAIL), np.float32(0)))
    x[4], x[5], x[6], x[7] = TAIL, -TAIL, edge, -float(
        np.nextafter(np.float32(TAIL), np.float32(10)))
    return x, raw, g_out, g_ld, bias


def _to(batch, dev):
    return type(batch)(*[t.to(dev) for t in batch])


def _count_plain(torch, plain):
    """Wrap the plain spline's entry points with a call counter; returns
    (counts, restore)."""
    counts = {"forward": 0, "inverse": 0}
    saved = (plain.rqs_forward, plain.rqs_inverse)

    def counted(name, fn):
        def inner(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return inner
    plain.rqs_forward = counted("forward", saved[0])
    plain.rqs_inverse = counted("inverse", saved[1])

    def restore():
        plain.rqs_forward, plain.rqs_inverse = saved
    return counts, restore


def _leaf_errs(got: dict, ref: dict):
    """(worst leaf's max|Δ| over its largest |entry|, after TRAIN_GRAD_ABS
    of the largest entry of any leaf; that leaf; the whole gradient's
    |Δ|/|g|)."""
    scale = max(float(g.abs().max()) for g in ref.values())
    worst, name = 0.0, ""
    for n, g in ref.items():
        d = float((got[n] - g).abs().max())
        rel = max(d - TRAIN_GRAD_ABS * scale, 0.0) / max(
            float(g.abs().max()), 1e-30)
        if rel > worst:
            worst, name = rel, n
    d2 = sum(float(((got[n] - g).double() ** 2).sum()) for n, g in ref.items())
    g2 = sum(float((g.double() ** 2).sum()) for g in ref.values())
    return worst, name, math.sqrt(d2 / g2)


def _set_switches(torch, switches):
    torch.set_float32_matmul_precision(switches[0])
    torch.backends.cudnn.allow_tf32 = switches[1]


def phase_train_parity(torch, plain, rqs_cuda, cfg, state_dict, card):
    """(m, part 1) fixed batches of TRAIN_PARITY_EVENTS events simulated on
    the CPU, one for each of TRAIN_PARITY_SEEDS, the flagship with its flow
    and encoder in float32: loss, component gradient norms and every
    gradient leaf on the card with the spline kernels forward and backward,
    under torch's default TF32 switches, against the card with the plain
    spline (the kernels' own share) and against the CPU. The TF32 guard of
    trainer.backward: the card under torch's defaults and with TF32 allowed
    for matmuls too (as a caller may set it) against the card with TF32
    off, and the two controls, which lift that guard, held above the same
    tolerance at every seed. The control against the CPU is reported: the
    card-vs-CPU leg cannot see TF32 through the order-of-summation noise."""
    import contextlib

    from posteriflow_torch.models.npe import LeanNPE
    from posteriflow_torch.physics.simulator import simulate_batch
    from posteriflow_torch.train import trainer
    npe32 = dataclasses.replace(cfg.npe, flow_dtype="float32",
                                encoder_dtype="float32")
    kernel_fwd, guard = rqs_cuda.rqs_forward, trainer.fp32_exact
    # (float32 matmul precision, cudnn.allow_tf32)
    defaults, tf32, off = ("highest", True), ("high", True), ("highest", False)
    # label -> (device, switches, plain spline, backward's guard lifted)
    runs = {"kernels": (DEVICE, defaults, False, False),
            "plain on the card": (DEVICE, defaults, True, False),
            "cpu": ("cpu", defaults, False, False),
            "kernels, TF32 off": (DEVICE, off, False, False),
            "kernels, TF32 allowed": (DEVICE, tf32, False, False),
            "control: backward unguarded": (DEVICE, defaults, False, True),
            "control: backward unguarded, TF32 allowed":
                (DEVICE, tf32, False, True)}
    # (run, reference, loss tol, norm and leaf tol, role): "held" at most
    # the tolerances, "control" its mildest seed above the leaf tolerance
    strict = "kernels, TF32 off"
    legs = (("kernels", "plain on the card", TRAIN_KERNEL_TOL,
             TRAIN_KERNEL_TOL, "held"),
            ("kernels", "cpu", TRAIN_LOSS_TOL, TRAIN_TOL, "held"),
            ("kernels", strict, TF32_GUARD_TOL, TF32_GUARD_TOL, "held"),
            ("kernels, TF32 allowed", strict, TF32_GUARD_TOL,
             TF32_GUARD_TOL, "held"),
            ("control: backward unguarded", strict, None, TF32_GUARD_TOL,
             "control"),
            ("control: backward unguarded, TF32 allowed", strict, None,
             TF32_GUARD_TOL, "control"),
            ("control: backward unguarded, TF32 allowed", "cpu", None, None,
             "reported"))

    def run(batch, label):
        dev, switches, plain_spline, unguarded = runs[label]
        _set_switches(torch, switches)
        if plain_spline:
            rqs_cuda.rqs_forward = (lambda x, r, k, tb=TAIL, bias=None:
                                    plain.rqs_forward(x, r + bias, k, tb))
        if unguarded:
            trainer.fp32_exact = contextlib.nullcontext
        try:
            model = LeanNPE(npe32)
            model.load_state_dict(state_dict, strict=True)
            model.to(dev)
            f0 = rqs_cuda.GRAD_KERNEL.launches
            loss = trainer.batch_nll(model, _to(batch, dev))
            trainer.backward(loss)
            launched = rqs_cuda.GRAD_KERNEL.launches - f0
        finally:
            rqs_cuda.rqs_forward, trainer.fp32_exact = kernel_fwd, guard
        return (float(loss.detach()),
                {k: float(v) for k, v in
                 trainer.component_grad_norms(model).items()},
                {n: p.grad.cpu() for n, p in model.named_parameters()},
                launched)

    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    out = {}
    try:
        for seed in TRAIN_PARITY_SEEDS:
            batch = simulate_batch(TRAIN_PARITY_EVENTS, cfg.sim,
                                   device="cpu",
                                   generator=torch.Generator().manual_seed(
                                       seed))
            res = {label: run(batch, label) for label in runs}
            check(res["kernels"][3] == npe32.flow_layers
                  and res["plain on the card"][3] == 0,
                  f"backward kernel launches {res['kernels'][3]} / "
                  f"{res['plain on the card'][3]}")
            for got, ref, tol_loss, tol, role in legs:
                (lg, ng, gg, _), (lr, nr, gr, _) = res[got], res[ref]
                worst, name, glob = _leaf_errs(gg, gr)
                d_loss = abs(lg - lr) / max(1.0, abs(lr))
                d_norm = max(abs(ng[k] - nr[k]) / max(nr[k], 1e-30)
                             for k in nr)
                print(f"(m) train step, seed {seed} (n_sig "
                      f"{batch.n_sig.tolist()}), {got} against {ref} "
                      f"[{card}]: loss {lg:.6f} vs {lr:.6f} (rel "
                      f"{d_loss:.2e}), component grad norms rel max "
                      f"{d_norm:.2e}, gradient |Δ|/|g| {glob:.2e}, worst "
                      f"leaf {worst:.2e} ({name}); "
                      + (f"tol {tol_loss:g} / {tol:g}" if role == "held"
                         else f"control, above {tol:g}"
                         if role == "control" else "reported"))
                if role == "held":
                    check(math.isfinite(lg) and d_loss <= tol_loss,
                          f"train loss, {got} against {ref}, differs by "
                          f"{d_loss}")
                    check(d_norm <= tol, f"component grad norms, {got} "
                                         f"against {ref}, differ by {d_norm}")
                    check(worst <= tol, f"gradient leaf {name}, {got} "
                                        f"against {ref}, differs by {worst}")
                # each leg keeps its worst seed, a control its mildest
                key = f"{got} / {ref}"
                prev = out.get(key, {}).get("leaf")
                if prev is None or ((worst < prev) if role == "control"
                                    else (worst > prev)):
                    out[key] = {"loss": d_loss, "norms": d_norm,
                                "leaf": worst, "leaf_name": name,
                                "global": glob, "seed": seed}
        worst = {k: f"{v['leaf']:.2e}" for k, v in out.items()}
        print(f"(m) over seeds {list(TRAIN_PARITY_SEEDS)}, "
              f"{TRAIN_PARITY_EVENTS} events each, float32, worst leaf of "
              f"each run / reference (a control: its mildest): {worst} "
              f"[{card}]")
        for got, ref, _, tol, role in legs:
            if role == "control":
                ctl = out[f"{got} / {ref}"]["leaf"]
                check(ctl > tol, f"the TF32 guard's tolerance {tol:g} does "
                                 f"not see {got} ({ctl:.2e})")
        # as released (bfloat16 matmuls), under torch's defaults: reported,
        # not held (one flipped bf16 rounding moves a steep NLL's gradient
        # far; float32 is the parity path)
        _set_switches(torch, defaults)
        bf = {}
        for dev in (DEVICE, "cpu"):
            model = LeanNPE(cfg.npe)
            model.load_state_dict(state_dict, strict=True)
            model.to(dev)
            loss = trainer.batch_nll(model, _to(batch, dev))
            trainer.backward(loss)
            bf[dev] = (float(loss.detach()),
                       {n: p.grad.cpu() for n, p in model.named_parameters()})
        _, _, glob = _leaf_errs(bf[DEVICE][1], bf["cpu"][1])
        print(f"(m) the last batch as released ({cfg.npe.flow_dtype} flow, "
              f"{cfg.npe.encoder_dtype} encoder), card against CPU, reported "
              f"only [{card}]: loss {bf[DEVICE][0]:.6f} vs "
              f"{bf['cpu'][0]:.6f}, gradient |Δ|/|g| {glob:.2e}")
    finally:
        _set_switches(torch, saved)
    return out


def build_bank_server(out: dict):
    """(a) build csrc/bankd.cpp with g++ into posteriflow_torch/_build/;
    fills `out` with the library's name, the seconds and success."""
    from posteriflow_torch.data import native_bank
    t0 = time.perf_counter()
    out["library"] = native_bank.library_path().name
    out["ok"] = native_bank.build_native()
    out["seconds"] = time.perf_counter() - t0


def release_state(torch, cfg):
    """A TrainState of `cfg` on the card holding the release's weights."""
    from posteriflow_torch.train.checkpoints import load_release
    from posteriflow_torch.train.loop import _merge_params
    from posteriflow_torch.train.trainer import init_state
    state = init_state(cfg, generator=torch.Generator().manual_seed(0),
                       device=DEVICE)
    merged, kept, total = _merge_params(state.model.state_dict(),
                                        load_release(RELEASE)[0])
    check(kept == total, f"init-from transferred {kept}/{total} leaves")
    state.model.load_state_dict(merged)
    return state


def phase_train_steps(torch, plain, rqs_cuda, cfg, card):
    """(m, part 2) TRAIN_STEPS steps of simulate -> batch_nll -> backward ->
    clip -> AdamW at the flagship's full width, from the release's weights
    (--init-from), timed by part with CUDA events."""
    from posteriflow_torch.physics.simulator import simulate_batch
    from posteriflow_torch.tools.bench_train import (PEAK_BF16_FLOPS,
                                                     flops_per_step)
    from posteriflow_torch.train.trainer import backward, batch_nll
    state = release_state(torch, cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    layers = cfg.npe.flow_layers
    counts, restore = _count_plain(torch, plain)
    nlls, parts, walls, launches = [], [], [], []
    moved = []
    torch.cuda.reset_peak_memory_stats()
    rqs_cuda.KERNEL.launches = rqs_cuda.GRAD_KERNEL.launches = 0
    try:
        for i in range(TRAIN_STEPS):
            before = [p.detach().clone() for p in state.model.parameters()]
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            f0 = rqs_cuda.KERNEL.launches
            b0 = rqs_cuda.GRAD_KERNEL.launches
            t0 = time.perf_counter()
            ev[0].record()
            batch = simulate_batch(cfg.batch_size, cfg.sim, device=DEVICE,
                                   generator=gen)
            ev[1].record()
            state.opt.zero_grad()
            loss = batch_nll(state.model, batch)
            ev[2].record()
            backward(loss)
            ev[3].record()
            state.opt.step()
            ev[4].record()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            parts.append([ev[j].elapsed_time(ev[j + 1]) for j in range(4)])
            nlls.append(float(loss.detach()))
            launches.append((rqs_cuda.KERNEL.launches - f0,
                             rqs_cuda.GRAD_KERNEL.launches - b0))
            moved.append(any(not torch.equal(a, p.detach()) for a, p in
                             zip(before, state.model.parameters())))
    finally:
        restore()
    path = (rqs_cuda.KERNEL.launches, rqs_cuda.GRAD_KERNEL.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the steady state: every step after the first (which builds and warms)
    steady = parts[1:]
    mean = [sum(p[j] for p in steady) / len(steady) for j in range(4)]
    step_ms = sum(walls[1:]) / len(walls[1:])
    steps_per_s = 1e3 / step_ms
    flops = flops_per_step(state, simulate_batch(cfg.batch_size, cfg.sim,
                                                 device=DEVICE,
                                                 generator=gen))
    mfu = flops * steps_per_s / PEAK_BF16_FLOPS
    profile = profile_train_step(torch, state, cfg, gen, card)
    print(f"(m) {TRAIN_STEPS} train steps, batch {cfg.batch_size}, flagship "
          f"15-D (bf16 matmuls as released, weights from {RELEASE}) "
          f"[{card}]: NLL by step {[round(v, 4) for v in nlls]}")
    print(f"(m) step split over steps 2-{TRAIN_STEPS} by CUDA events: "
          f"simulate {mean[0]:.3f} ms, forward {mean[1]:.3f} ms, backward "
          f"{mean[2]:.3f} ms, optimizer {mean[3]:.3f} ms; host wall "
          f"{step_ms:.3f} ms a step (first step {walls[0]:.1f} ms): "
          f"{steps_per_s:.3f} steps/s, {steps_per_s * cfg.batch_size:.1f} "
          f"events/s; peak memory {peak:.2f} GiB; {flops / 1e9:.1f} GFLOP a "
          f"step counted (matmuls and convs, not the spline kernels), MFU "
          f"{mfu:.4%} of the 989 TFLOP/s bf16 peak; spline launches a step "
          f"(forward, backward) {sorted(set(launches))}, plain spline calls "
          f"{counts}; parameters moved at step 0: {moved[0]}, step 1: "
          f"{moved[1]}")
    check(all(math.isfinite(v) for v in nlls), f"non-finite NLL: {nlls}")
    check(TRAIN_NLL0[0] <= nlls[0] <= TRAIN_NLL0[1],
          f"step-0 NLL {nlls[0]} outside {TRAIN_NLL0}")
    check(not moved[0] and moved[1],
          f"parameters moved at steps 0/1: {moved[:2]} (lr(0) is 0)")
    check(all(lc == (layers, layers) for lc in launches),
          f"spline launches by step {launches}, expected {layers} each way")
    check(counts == {"forward": 0, "inverse": 0},
          f"the plain spline ran in the train steps: {counts}")
    return {"nlls": nlls, "split_ms": mean, "step_ms": step_ms,
            "steps_per_s": steps_per_s,
            "events_per_s": steps_per_s * cfg.batch_size, "peak_gib": peak,
            "flops": flops, "mfu": mfu, "profile": profile,
            "launches": path}


def profile_train_step(torch, state, cfg, gen, card, bank=None,
                       label="(m)"):
    """Device time of one train step by kernel (torch.profiler), with
    `bank`'s real noise when given: the busy share of the step's window,
    its launches and the kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    from posteriflow_torch.physics.simulator import simulate_batch
    from posteriflow_torch.train.trainer import train_step
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            train_step(state, simulate_batch(cfg.batch_size, cfg.sim,
                                             device=DEVICE, generator=gen,
                                             bank=bank))
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
    except RuntimeError as e:           # no CUPTI on this machine
        print(f"{label} profiler: not available ({e})")
        return None
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    print(f"{label} profile of one train step [{card}]: kernels "
          f"{busy_us / 1e3:.3f} ms of a {window_us / 1e3:.3f} ms window "
          f"(device busy {busy_us / window_us:.1%}, under the profiler); "
          f"{launches} launches; top kernels:")
    for e in kernels[:10]:
        print(f"      {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} "
              f"{e.key[:100]}")
    return {"busy_ms": busy_us / 1e3, "window_ms": window_us / 1e3,
            "launches": launches}


def phase_fit(torch, rqs_cuda, cfg, card):
    """(n) fit 2 epochs x 5 steps at the flagship's batch from the release,
    then resume 1 epoch from ckpt/last, then serve one event from
    ckpt/best."""
    import tempfile

    from posteriflow_torch.inference.pipeline import InferenceEngine
    from posteriflow_torch.train.loop import fit
    with open(f"{RELEASE}/meta.json") as f:
        jax_keys = {k for k in json.load(f)["metrics"]
                    if not k.startswith("real_")}
    with tempfile.TemporaryDirectory() as tmp:
        rqs_cuda.KERNEL.launches = rqs_cuda.GRAD_KERNEL.launches = 0
        t0 = time.perf_counter()
        _, hist = fit(cfg, tmp, epochs=2, steps_per_epoch=FIT_STEPS,
                      n_val_events=FIT_VAL_EVENTS, init_from=RELEASE,
                      device=DEVICE)
        fit_s = time.perf_counter() - t0
        fit_launches = (rqs_cuda.KERNEL.launches,
                        rqs_cuda.GRAD_KERNEL.launches)
        with open(f"{tmp}/history.json") as f:
            saved = json.load(f)
        ckpt = f"{tmp}/ckpt"
        have = {n: os.path.isdir(f"{ckpt}/{n}") for n in ("last", "best")}
        _, hist2 = fit(cfg, tmp, epochs=1, steps_per_epoch=FIT_STEPS,
                       n_val_events=FIT_VAL_EVENTS,
                       resume_from=f"{ckpt}/last", device=DEVICE)
        eng = InferenceEngine.from_checkpoint(ckpt, "best", device=DEVICE)
        ctx = eng.encode(np.zeros((1, 3, 16384), np.float32),
                         np.zeros((1, 3, eng.cfg.psd_bands), np.float32))
        theta, log_q, _ = eng.sample_posterior(
            ctx, 0, N_SAMPLES, generator=torch.Generator(
                device=DEVICE).manual_seed(0))
        torch.cuda.synchronize()
    gate = ("spurious_railing", "base_conc", "cov90_mean",
            "cov90_highsnr_mean", "sbc_pass_frac", "val_nll", "train_nll")
    finite = all(math.isfinite(h[k]) for h in hist for k in gate)
    print(f"(n) fit 2 epochs x {FIT_STEPS} steps, batch {cfg.batch_size}, "
          f"{FIT_VAL_EVENTS} validation events, from {RELEASE} [{card}]: "
          f"{fit_s:.1f} s; val_nll {[round(h['val_nll'], 4) for h in hist]}, "
          f"gate {[h['gate_passed'] for h in hist]}, lr_step "
          f"{[h['lr_step'] for h in hist]}; spline launches (forward, "
          f"backward) {fit_launches}; history keys as JAX's "
          f"{set(saved[-1]) == jax_keys}; checkpoints {have}; resumed to "
          f"epochs {[h['epoch'] for h in hist2]} lr_step "
          f"{[h['lr_step'] for h in hist2]}; from_checkpoint(best) drew "
          f"{tuple(theta.shape)}")
    check(set(saved[-1]) == jax_keys,
          f"history keys {sorted(set(saved[-1]) ^ jax_keys)} differ")
    check(finite, "non-finite gate metrics")
    check(all(have.values()), f"checkpoints missing: {have}")
    check([h["epoch"] for h in hist2] == [1, 2, 3]
          and hist2[-1]["lr_step"] == 3 * FIT_STEPS,
          f"resume did not continue: {[(h['epoch'], h['lr_step']) for h in hist2]}")
    check(tuple(theta.shape) == (1, N_SAMPLES, eng.cfg.n_params)
          and bool(torch.isfinite(theta).all() and torch.isfinite(log_q).all()),
          "from_checkpoint samples")
    return {"launches": fit_launches, "seconds": fit_s}


def _ll_scale(torch, theta: np.ndarray, strain: np.ndarray) -> np.ndarray:
    """1 + ½‖h_w‖² + |Re⟨d, h_w⟩| per θ, float64 on the host."""
    from posteriflow_torch.physics.simulator import (design_asd,
                                                     signal_white_fd)
    h = signal_white_fd(torch.from_numpy(theta), design_asd("cpu")).numpy()
    h = h.astype(np.complex128)
    d = (np.fft.rfft(strain.astype(np.float64), axis=-1)
         / np.sqrt(strain.shape[-1] / 2.0))
    return (1.0 + 0.5 * np.sum(np.abs(h) ** 2, axis=(1, 2))
            + np.abs(np.sum(np.real(d[None] * np.conj(h)), axis=(1, 2))))


def profile_sweep(torch, imp, engine, ctx, log_l, theta, card):
    """One SMC stage's sweep (5 Metropolis steps at theta's rows) timed on
    the host clock and under torch.profiler (device busy share, launches,
    the kernels that take most of it), and one likelihood batch and one
    symmetrized flow density at those rows by CUDA events."""
    from torch.profiler import ProfilerActivity, profile
    n = theta.shape[0]
    ll = log_l(theta).astype(np.float64)
    lp = imp.host_log_prior(device=DEVICE)(theta).astype(np.float64)
    lg0 = imp.symmetrized_log_q(engine, ctx, 0, theta, pad_block=n)
    lg0 = lg0.cpu().numpy().astype(np.float64)
    x = imp._to_slow(theta.astype(np.float64), marg=True)
    chol = np.linalg.cholesky((2.38 ** 2 / x.shape[1]) * np.cov(x.T))
    move = imp._make_fused_move(engine, ctx, 0, log_l.core, marg=True)
    args = (theta.astype(np.float64), ll, lp, lg0, np.zeros(n), 0.5, chol)
    move(*args, 1)                                       # warm
    t0 = time.perf_counter()
    move(*args, 2)
    sweep_s = time.perf_counter() - t0
    t = torch.as_tensor(theta, device=DEVICE)
    ll_ms = cuda_time_ms(lambda: log_l.core(t), reps=3)
    lq_ms = cuda_time_ms(lambda: imp.symmetrized_log_q(
        engine, ctx, 0, t, pad_block=n), reps=3)
    print(f"(o) one sweep of 5 steps at {n} rows [{card}]: {sweep_s:.3f} s "
          f"on the host clock; a likelihood batch {ll_ms:.2f} ms, a "
          f"symmetrized flow density {lq_ms:.2f} ms (CUDA events)")
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            move(*args, 3)
            window_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
    except RuntimeError as e:           # no CUPTI on this machine
        print(f"(o) profiler: not available ({e})")
        return {"sweep_s": sweep_s, "ll_ms": ll_ms, "lq_ms": lq_ms}
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    rqs_us = sum(e.self_device_time_total for e in kernels
                 if "rqs_tile" in e.key)
    print(f"(o) profile of one sweep [{card}]: kernels {busy_us / 1e3:.3f} "
          f"ms of a {window_us / 1e3:.3f} ms window (device busy "
          f"{busy_us / window_us:.1%}, under the profiler); {launches} "
          f"launches; rqs_tile {rqs_us / 1e3:.3f} ms; top kernels:")
    for e in kernels[:10]:
        print(f"      {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} "
              f"{e.key[:100]}")
    return {"sweep_s": sweep_s, "ll_ms": ll_ms, "lq_ms": lq_ms,
            "busy_ms": busy_us / 1e3, "window_ms": window_us / 1e3,
            "launches": launches}


def phase_importance(torch, plain, rqs_cuda, engine, engine_cls, state_dict,
                     cfg, card):
    """(o) importance-correct a flagship request on the card: infer 5000
    draws on a 15-D injection, then importance_correct against the
    marginalized likelihood at its defaults (pad_block 4096, 25 stages of
    5 Metropolis steps), every flow density in rqs_tile; the same through
    tools/infer.py; the card against the CPU; the kernel at 4096 rows; the
    prior SMC on the same likelihood."""
    import tempfile
    from pathlib import Path

    from posteriflow_torch.inference import importance as imp
    from posteriflow_torch.inference.pipeline import infer
    from posteriflow_torch.inference.preprocessing import prepare_simulated
    from posteriflow_torch.models.flow import DTYPES
    from posteriflow_torch.prior import PriorConfig
    from posteriflow_torch.tools import infer as infer_cli
    t_phase = time.perf_counter()
    layers = engine.cfg.flow_layers
    prep = prepare_simulated([INJECTION], seed=IS_SEED,
                             psd_bands=cfg.psd_bands,
                             param_names=cfg.param_names, device=DEVICE)
    res = infer(engine, data=prep, n_samples=N_SAMPLES, seed=IS_SEED)
    ctx = engine.encode(prep.strain[None], prep.asd_bands[None])
    log_l = imp.make_marginalized_log_likelihood(prep.strain, device=DEVICE)
    counts, restore = _count_plain(torch, plain)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rqs_cuda.KERNEL.launches = 0
        t0 = time.perf_counter()
        is_res = imp.importance_correct(engine, ctx[0], 0, res.samples,
                                        res.log_prob, res.railed, log_l,
                                        marginalized=True, seed=IS_SEED)
        wall = time.perf_counter() - t0
        launches = rqs_cuda.KERNEL.launches
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        restore()
    ran = is_res.beta_ladder is not None
    # one padded call per mass ordering for the kept draws, then n_mcmc
    # steps x 2 orderings a sweep, one sweep a stage but the last
    expected = 2 * layers + (5 * 2 * layers * (is_res.n_stages - 1)
                             if ran else 0)
    diag = is_res.diagnostics
    sec = diag["seconds"]
    n_kept = int((~res.railed).sum())
    print(f"(o) importance_correct, {N_SAMPLES} draws ({n_kept} kept) of a "
          f"15-D injection, marginalized likelihood, pad_block {IS_ROWS} "
          f"[{card}]: direct ESS {diag['direct_ess']:.2f} (efficiency "
          f"{diag['direct_efficiency']:.4f}); ladder "
          f"{'ran' if ran else 'not needed'}: {is_res.n_stages} stages, "
          f"beta {is_res.beta_ladder}, acceptance {is_res.mcmc_acceptance},"
          f" converged {is_res.converged}; log Z/L(0) "
          f"{is_res.log_evidence_ratio:.4f}; final ESS {is_res.ess:.1f} of "
          f"{len(is_res.samples)}")
    print(f"(o) importance_correct {wall:.3f} s wall [{card}]: log q "
          f"{sec['log_q']:.3f} s, first likelihood batch "
          f"{sec['likelihood']:.3f} s, moves {sec['moves']:.3f} s, the rest "
          f"(prior, KDE, host ladder) "
          f"{wall - sec['log_q'] - sec['likelihood'] - sec['moves']:.3f} s; "
          f"peak memory {peak:.2f} GiB; rqs_tile launches {launches} "
          f"(expected {expected}), plain spline calls {counts}")
    check(launches == expected, f"importance path launched rqs_tile "
                                f"{launches} times, expected {expected}")
    check(counts == {"forward": 0, "inverse": 0},
          f"the plain spline ran on the importance path: {counts}")
    w = is_res.weights
    check(bool(np.isfinite(is_res.samples).all())
          and is_res.samples.shape[1] == engine.cfg.n_params,
          "importance samples")
    check(bool(np.isfinite(w).all()) and abs(float(w.sum()) - 1.0) < 1e-6
          and 0.0 < is_res.ess <= len(w), "importance weights")
    check(math.isfinite(is_res.log_evidence_ratio), "log evidence")

    # the card against the port's CPU path on the same θ
    theta = np.concatenate([prep.truth, is_res.samples]).astype(
        np.float32)[:IS_REF_THETA]
    scale = _ll_scale(torch, theta, prep.strain)
    for make in (imp.make_log_likelihood,
                 imp.make_marginalized_log_likelihood):
        got = make(prep.strain, device=DEVICE)(theta).astype(np.float64)
        ref = make(prep.strain, device="cpu")(theta).astype(np.float64)
        gap = float(np.max(np.abs(got - ref) / scale))
        print(f"(o) {make.__name__} card vs CPU on {len(theta)} θ: max "
              f"|Δ|/(1 + ½‖h‖² + |Re<d,h>|) {gap:.3e} (tol {IS_LL_TOL:g}); "
              f"max |Δ| {np.max(np.abs(got - ref)):.3e} nats")
        check(gap <= IS_LL_TOL, f"{make.__name__}: card vs CPU {gap}")
    # the flow's density in float32 on the card and on the CPU, and in
    # float64 on the CPU (the reference) on one context
    ctx_cpu = ctx[0].float().cpu()
    lq = {}
    for name, dev, dt in (("card", DEVICE, "float32"), ("cpu", "cpu",
                                                        "float32"),
                          ("float64", "cpu", "float64")):
        e = engine_cls(state_dict, dataclasses.replace(cfg, flow_dtype=dt),
                       device=dev)
        e.model.to(DTYPES[dt])
        lq[name] = imp.symmetrized_log_q(e, ctx_cpu, 0, theta,
                                         pad_block=IS_REF_THETA
                                         ).cpu().double().numpy()
    d_lq = np.abs(lq["card"] - lq["cpu"])
    e_card = float(np.abs(lq["card"] - lq["float64"]).max())
    e_cpu = float(np.abs(lq["cpu"] - lq["float64"]).max())
    print(f"(o) symmetrized_log_q float32 card vs CPU on {len(theta)} θ: "
          f"median |Δ| {np.median(d_lq):.3e} nats (tol {IS_LOGQ_TOL:g}), "
          f"max {d_lq.max():.3e}; against the float64 CPU reference: card "
          f"max |Δ| {e_card:.3e}, CPU float32 {e_cpu:.3e} (the card held to "
          f"the larger of {IS_LOGQ_TOL:g} and twice the CPU's)")
    check(np.median(d_lq) <= IS_LOGQ_TOL,
          f"symmetrized_log_q card vs CPU: median {np.median(d_lq)}")
    check(e_card <= max(IS_LOGQ_TOL, 2.0 * e_cpu),
          f"symmetrized_log_q card vs float64: {e_card} (CPU {e_cpu})")

    profile_sweep(torch, imp, engine, ctx[0], log_l,
                  is_res.samples[:IS_ROWS].astype(np.float32), card)

    # the kernel at the sweep's shape
    x, raw, bias = spline_inputs(torch, IS_ROWS, seed=IS_ROWS + 1)
    fwd = forward_timing(torch, plain, rqs_cuda, x, raw, bias)
    print(f"(o) rqs_tile<{K_BINS}, forward, bias> N={IS_ROWS} D={D_TR} "
          f"[{card}]: device time a launch "
          + ("not measured" if fwd["ms"] is None
             else f"{fwd['ms'] * 1e3:.2f} us")
          + f" (profiler), {fwd['events_ms'] * 1e3:.2f} us by CUDA events "
          f"over back-to-back launches, plain {fwd['plain_ms'] * 1e3:.1f} us; "
          f"bound {fwd['bound_ms'] * 1e3:.2f} us ({fwd['bound_by']}: "
          f"{rqs_bytes(IS_ROWS, D_TR, K_BINS)} B)")

    # the flow-independent sampler on the same likelihood: no spline
    rqs_cuda.KERNEL.launches = 0
    t0 = time.perf_counter()
    smc = imp.run_smc_prior(log_l, n=IS_ROWS, seed=IS_SEED,
                            max_stages=IS_SMC_STAGES,
                            prior_cfg=PriorConfig(precessing=True))
    smc_s = time.perf_counter() - t0
    print(f"(o) run_smc_prior n={IS_ROWS}, max_stages capped at "
          f"{IS_SMC_STAGES} (40 by default) to keep the run short "
          f"[{card}]: {smc.n_stages} stages, beta {smc.beta_ladder}, "
          f"converged {smc.converged}, log Z/L(0) "
          f"{smc.log_evidence_ratio:.4f} ("
          + ("" if smc.converged else "partial, ")
          + f"against IS {is_res.log_evidence_ratio:.4f}), {smc_s:.3f} s, "
          f"rqs_tile launches {rqs_cuda.KERNEL.launches}")
    check(rqs_cuda.KERNEL.launches == 0, "run_smc_prior launched a spline")
    check(math.isfinite(smc.log_evidence_ratio)
          and bool(np.isfinite(smc.weights).all()), "run_smc_prior output")

    # the command line: the same request, saved with its weights
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cli_res = infer_cli.main([
            "--ckpt", RELEASE, "--inject", "--inject-params",
            json.dumps([INJECTION]), "--importance", "--n-samples",
            str(N_SAMPLES), "--seed", str(IS_SEED), "--device", DEVICE,
            "--out", tmp])
        cli_s = time.perf_counter() - t0
        w = np.load(Path(tmp) / "weights.npy")
        samples = np.load(Path(tmp) / "samples.npy")
    print(f"(o) tools/infer.py --inject --importance [{card}]: {cli_s:.3f} s;"
          f" saved {len(w)} weights summing to {float(w.sum()):.9f}, "
          f"ESS {cli_res.diagnostics['importance']['ess']:.1f}, "
          f"{cli_res.diagnostics['importance']['n_stages']} stages")
    check(len(w) == len(samples) and bool((w >= 0).all())
          and abs(float(w.sum()) - 1.0) < 1e-6, "saved weights")
    print(f"(o) phase done in {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]")
    return {"launches": launches, "forward": fwd, "seconds": wall,
            "peak_gib": peak}


def phase_priority(torch, card):
    """(p) the released PriorityNets on the card against the CPU on one
    scenario batch with dead slots: scores, sigma, aux, the order, NaN."""
    from posteriflow_torch.models.priority_net import rank_by_score
    from posteriflow_torch.train.train_priority import (PriorityTrainConfig,
                                                        load_priority_net,
                                                        make_priority_batch)
    cfg = dataclasses.replace(PriorityTrainConfig(),
                              batch_size=PRIORITY_BATCH)
    gen = torch.Generator(device=DEVICE).manual_seed(PRIORITY_SEED)
    segs, cand, mask, _, _, snr_est = make_priority_batch(cfg, gen, DEVICE)
    live = (mask > 0).cpu()
    n_dead = int((~live).sum())
    check(n_dead > 0, "the priority batch has no dead slot")
    out = {}
    for rel in PRIORITY_RELEASES:
        name = rel.rsplit("/", 1)[1]
        outs = {}
        for dev in (DEVICE, "cpu"):
            net = load_priority_net(rel, device=dev)
            args = [t.to(dev) for t in (segs, cand, mask)]
            with torch.no_grad():
                outs[dev] = [t.cpu() for t in net(
                    *args, with_aux=True, snr_est=snr_est.to(dev))]
            if dev == DEVICE:
                with torch.no_grad():
                    net_ms = cuda_time_ms(lambda: net(
                        *args, snr_est=snr_est), reps=10)
        (sg, qg, ag), (sc, qc, ac) = outs[DEVICE], outs["cpu"]
        tol = PRIORITY_REL * float(sc[live].abs().max()) + PRIORITY_ABS
        errs = {k: float((a - b).abs().max()) for k, a, b in (
            ("score", sg, sc), ("sigma", qg, qc), ("aux", ag, ac))}
        finite = all(bool(torch.isfinite(t).all())
                     for t in outs[DEVICE] + outs["cpu"])
        # every pair of live slots whose CPU scores differ by more than
        # tol keeps its order in rank_by_score of the card's scores
        pos = torch.argsort(rank_by_score(sg, mask.cpu()), dim=-1)
        must = (live[:, :, None] & live[:, None, :]
                & (sc[:, :, None] - sc[:, None, :] > tol))
        swapped = int((must & (pos[:, :, None] > pos[:, None, :])).sum())
        dead_ok = bool((sg[~live] == -1e9).all())
        print(f"(p) {name} card vs CPU, B={PRIORITY_BATCH} (live "
              f"{int(live.sum())}, dead {n_dead}) [{card}]: max|Δ| score "
              f"{errs['score']:.3e}, sigma {errs['sigma']:.3e}, aux "
              f"{errs['aux']:.3e} (tol {tol:.3e}); ordered pairs apart by "
              f"more than tol swapped {swapped} of {int(must.sum())}; all "
              f"finite {finite}; dead slots -1e9 {dead_ok}; forward "
              f"{net_ms:.3f} ms (CUDA events)")
        check(all(e <= tol for e in errs.values()),
              f"{name}: card vs CPU {errs} above {tol}")
        check(swapped == 0 and finite and dead_ok, f"{name}: order, NaN "
                                                   f"or dead slots")
        out[name] = {"errs": errs, "tol": tol, "ms": net_ms}
    return out


def _overlap_truth(torch):
    """The injection of (q)-(r) with its network SNRs, checked against
    its stated properties."""
    from posteriflow_torch.physics.simulator import (design_asd,
                                                     signal_snr_amp_only)
    from posteriflow_torch.prior import loudness
    theta = torch.tensor(OVERLAP, device=DEVICE)
    snr = signal_snr_amp_only(theta, design_asd(DEVICE)).cpu().numpy()
    loud = loudness(theta[:, 0], theta[:, 1], theta[:, 2]).cpu().numpy()
    t_c = theta[:, 8].cpu().numpy()
    n = len(OVERLAP)
    ratio = min(max(snr[i], snr[j]) / min(snr[i], snr[j])
                for i in range(n) for j in range(i + 1, n))
    gap = min(abs(t_c[i] - t_c[j]) for i in range(n) for j in range(i + 1,
                                                                   n))
    check(ratio >= SNR_RATIO_MIN and gap > MERGER_GAP_MIN
          and list(np.argsort(-snr)) == list(np.argsort(-loud))
          == list(range(n)), f"overlap injection: SNRs {snr}, loudness "
                             f"{loud}, merger gap {gap}")
    return snr, ratio, gap


def ranking_split(torch, net, results, strain) -> dict:
    """rank_overlapping's three steps run apart, host clock, the card
    synchronized after each: the medians and segments on the host, the
    SNR estimate of the medians and the net's forward on the card."""
    from posteriflow_torch.inference.ranking import extract_segments
    from posteriflow_torch.physics.simulator import (design_asd,
                                                     signal_snr_amp_only)
    t0 = time.perf_counter()
    medians = np.stack([r.median() for r in results])
    segs = extract_segments(strain, medians[:, 8])
    t_seg = time.perf_counter()
    with torch.no_grad():
        med = torch.as_tensor(medians, dtype=torch.float32, device=DEVICE)
        snr_est = signal_snr_amp_only(med, design_asd(DEVICE))[None]
        torch.cuda.synchronize()
        t_snr = time.perf_counter()
        scores, _sigma = net(torch.as_tensor(segs, device=DEVICE)[None],
                             med[None], torch.ones((1, len(results)),
                                                   device=DEVICE),
                             snr_est=snr_est)
        scores.cpu()
    t_net = time.perf_counter()
    return {"segments": t_seg - t0, "snr_est": t_snr - t_seg,
            "net": t_net - t_snr}


def phase_overlap(torch, plain, rqs_cuda, engine, cfg, card):
    """(q) infer_overlapping on the 3-signal injection (3 ranks of
    N_SAMPLES draws), timed warm; rank_overlapping with priority_v7 on the
    card; tools/infer.py --inject --n-signals 3."""
    import tempfile
    from pathlib import Path

    from posteriflow_torch.inference.pipeline import infer_overlapping
    from posteriflow_torch.inference.preprocessing import prepare_simulated
    from posteriflow_torch.inference.ranking import rank_overlapping
    from posteriflow_torch.tools import infer as infer_cli
    from posteriflow_torch.train.train_priority import load_priority_net
    t_phase = time.perf_counter()
    snr, ratio, gap = _overlap_truth(torch)
    n_sig, layers = len(OVERLAP), engine.cfg.flow_layers
    prep = prepare_simulated(np.asarray(OVERLAP, np.float32),
                             seed=OVERLAP_SEED, psd_bands=cfg.psd_bands,
                             param_names=cfg.param_names, device=DEVICE)
    kw = dict(data=prep, n_signals=n_sig, n_samples=N_SAMPLES,
              seed=OVERLAP_SEED)
    infer_overlapping(engine, **kw)                           # warm
    counts, restore = _count_plain(torch, plain)
    walls, launches = [], []
    try:
        for _ in range(OVERLAP_REPS):
            rqs_cuda.KERNEL.launches = 0
            t0 = time.perf_counter()
            results = infer_overlapping(engine, **kw)
            walls.append(time.perf_counter() - t0)
            launches.append(rqs_cuda.KERNEL.launches)
            rt = [r.diagnostics["runtime"] for r in results]
            print(f"(q) infer_overlapping, {n_sig} ranks x {N_SAMPLES} "
                  f"draws [{card}]: {walls[-1] * 1e3:.1f} ms wall; per rank"
                  f" encode / sampling ms "
                  + ", ".join(f"{x['encode'] * 1e3:.1f} / "
                              f"{x['sampling'] * 1e3:.1f}" for x in rt)
                  + f"; rqs_tile launches {launches[-1]}")
    finally:
        restore()
    check(launches == [n_sig * layers] * OVERLAP_REPS,
          f"overlap request launched rqs_tile {launches} times, expected "
          f"{n_sig * layers} a call")
    check(counts == {"forward": 0, "inverse": 0},
          f"the plain spline ran on the overlap path: {counts}")
    for r, res in enumerate(results):
        check(res.samples.shape == (N_SAMPLES, engine.cfg.n_params)
              and bool(np.isfinite(res.samples).all()), f"rank {r} samples")
    med = np.stack([r.median() for r in results])

    net = load_priority_net(PRIORITY_RELEASES[0], device=DEVICE)
    rank_overlapping(results, prep.strain, priority_model=net,
                     device=DEVICE)                           # warm
    t0 = time.perf_counter()
    order, scores = rank_overlapping(results, prep.strain,
                                     priority_model=net, device=DEVICE)
    rank_s = time.perf_counter() - t0
    split = ranking_split(torch, net, results, prep.strain)
    loudest = int(np.argmax(snr))
    print(f"(q) injection network SNRs {np.round(snr, 2).tolist()} (pairwise"
          f" ratio >= {ratio:.2f}), mergers {[o[8] for o in OVERLAP]} s "
          f"(apart by >= {gap:.2f} s); rank medians m1 "
          f"{np.round(med[:, 0], 2).tolist()}, d "
          f"{np.round(med[:, 2], 1).tolist()}, t_c "
          f"{np.round(med[:, 8], 3).tolist()}")
    print(f"(q) rank_overlapping with priority_v7 [{card}]: order {order}, "
          f"scores {[round(s, 4) for s in scores]}; {rank_s * 1e3:.2f} ms "
          f"(segments {split['segments'] * 1e3:.2f}, snr_est "
          f"{split['snr_est'] * 1e3:.2f}, net {split['net'] * 1e3:.2f}); "
          f"k-rank wall (infer_overlapping, {n_sig} ranks) median "
          f"{np.median(walls) * 1e3:.1f} ms of {OVERLAP_REPS}, with the "
          f"ranking {(np.median(walls) + rank_s) * 1e3:.1f} ms")
    check(sorted(order) == list(range(n_sig))
          and all(math.isfinite(s) for s in scores), "ranking output")
    check(order[0] == loudest, f"top-1 {order[0]} is not the loudest "
                               f"signal by network SNR ({loudest})")

    with tempfile.TemporaryDirectory() as tmp:
        rqs_cuda.KERNEL.launches = 0
        t0 = time.perf_counter()
        infer_cli.main(["--ckpt", RELEASE, "--inject", "--n-signals",
                        str(n_sig), "--n-samples", str(N_SAMPLES), "--seed",
                        str(OVERLAP_SEED), "--device", DEVICE, "--out", tmp])
        cli_s = time.perf_counter() - t0
        cli_launches = rqs_cuda.KERNEL.launches
        ranking = json.loads((Path(tmp) / "ranking.json").read_text())
        shapes = [np.load(Path(tmp) / f"rank{r}" / "samples.npy").shape
                  for r in range(n_sig)]
    print(f"(q) tools/infer.py --inject --n-signals {n_sig} [{card}]: "
          f"{cli_s:.3f} s; ranking.json {ranking}; rank dirs {shapes}; "
          f"rqs_tile launches {cli_launches}")
    check(sorted(ranking["order"]) == list(range(n_sig))
          and len(ranking["scores"]) == n_sig
          and all(math.isfinite(s) for s in ranking["scores"])
          and shapes == [(N_SAMPLES, engine.cfg.n_params)] * n_sig
          and cli_launches == n_sig * layers, "tools/infer.py --n-signals")
    print(f"(q) phase done in {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]")
    return {"launches": launches[0], "walls": walls, "rank_s": rank_s,
            "split": split, "order": order, "prep": prep}


def phase_decompose(torch, plain, rqs_cuda, engine, prep, card):
    """(r) AHSDPipeline.decompose on the (q) event; the subtractor card
    against the CPU on the same draws."""
    from posteriflow_torch.core.bias_corrector import BiasCorrector
    from posteriflow_torch.core.pipeline import TEMPLATE_DRAWS, AHSDPipeline
    from posteriflow_torch.core.subtractor import AdaptiveSubtractor
    from posteriflow_torch.inference.pipeline import infer
    layers = engine.cfg.flow_layers
    pipe = AHSDPipeline(engine, max_signals=DECOMPOSE_MAX,
                        n_samples=DECOMPOSE_ROWS)
    pipe.decompose(prep, seed=OVERLAP_SEED)                    # warm
    counts, restore = _count_plain(torch, plain)
    try:
        rqs_cuda.KERNEL.launches = 0
        t0 = time.perf_counter()
        out = pipe.decompose(prep, seed=OVERLAP_SEED)
        wall = time.perf_counter() - t0
        launches = rqs_cuda.KERNEL.launches
    finally:
        restore()
    n_st = len(out["stages"])
    for st in out["stages"]:
        print(f"(r) stage {st['stage']}: fit SNR {st['fit_snr']:.3f}, alpha "
              f"{st['alpha']:.4f}, quality {st['quality']:.4f}, template SNR"
              f" {st['template_snr']:.3f}, residual power ratio "
              f"{st['residual_power_ratio']:.6f}, accepted {st['accepted']}")
    print(f"(r) AHSDPipeline.decompose, max_signals {DECOMPOSE_MAX}, "
          f"{pipe.n_samples} draws a stage [{card}]: n_extracted "
          f"{out['n_extracted']} in {n_st} stages, {wall:.3f} s wall "
          f"({wall / n_st * 1e3:.1f} ms a stage); rqs_tile launches "
          f"{launches} (expected {layers * n_st}), plain spline calls "
          f"{counts}")
    check(launches == layers * n_st, f"decompose launched rqs_tile "
                                     f"{launches} times for {n_st} stages")
    check(counts == {"forward": 0, "inverse": 0},
          f"the plain spline ran in the decomposition: {counts}")
    check(all(math.isfinite(st[k]) for st in out["stages"]
              for k in ("fit_snr", "alpha", "quality",
                        "residual_power_ratio")), "stage statistics")


    corrector = BiasCorrector(scaler=engine.scaler, device=DEVICE)
    corrector.init(torch.Generator().manual_seed(BIAS_SEED))
    forced = AHSDPipeline(engine, bias_corrector=corrector,
                          max_signals=DECOMPOSE_MAX,
                          quality_threshold=FORCED_THRESHOLD,
                          n_samples=DECOMPOSE_ROWS)
    counts, restore = _count_plain(torch, plain)
    try:
        rqs_cuda.KERNEL.launches = 0
        t0 = time.perf_counter()
        all_out = forced.decompose(prep, seed=OVERLAP_SEED)
        all_wall = time.perf_counter() - t0
        all_launches = rqs_cuda.KERNEL.launches
    finally:
        restore()
    corrected = [bool(r.diagnostics.get("bias_corrected"))
                 for r in all_out["results"]]
    for st in all_out["stages"]:
        print(f"(r) every stage accepted, stage {st['stage']}: fit SNR "
              f"{st['fit_snr']:.3f}, alpha {st['alpha']:.4f}, quality "
              f"{st['quality']:.4f}, residual power ratio "
              f"{st['residual_power_ratio']:.6f}")
    print(f"(r) AHSDPipeline.decompose, quality threshold "
          f"{FORCED_THRESHOLD:g}, a bias corrector of random weights (seed "
          f"{BIAS_SEED}) [{card}]: n_extracted {all_out['n_extracted']}, "
          f"bias corrected by stage {corrected}, {all_wall:.3f} s wall "
          f"({all_wall / DECOMPOSE_MAX * 1e3:.1f} ms a stage); rqs_tile "
          f"launches {all_launches} (expected {layers * DECOMPOSE_MAX}), "
          f"plain spline calls {counts}")
    check(all_out["n_extracted"] == DECOMPOSE_MAX
          and len(all_out["stages"]) == DECOMPOSE_MAX,
          f"forced decompose ran {len(all_out['stages'])} stages")
    check(all_launches == layers * DECOMPOSE_MAX,
          f"forced decompose launched rqs_tile {all_launches} times")
    check(counts == {"forward": 0, "inverse": 0},
          f"the plain spline ran in the forced decomposition: {counts}")
    check(corrected == [False] + [True] * (DECOMPOSE_MAX - 1),
          f"the bias corrector ran at stages {corrected}")
    check(all(math.isfinite(st[k]) for st in all_out["stages"]
              for k in ("fit_snr", "alpha", "quality",
                        "residual_power_ratio"))
          and all(bool(np.isfinite(r.samples).all())
                  for r in all_out["results"]), "forced stage statistics")

    draws = infer(engine, data=prep, n_samples=pipe.n_samples,
                  seed=OVERLAP_SEED).samples[:TEMPLATE_DRAWS]
    got = AdaptiveSubtractor(device=DEVICE).subtract(prep.strain, draws)
    t0 = time.perf_counter()
    ref = AdaptiveSubtractor(device="cpu").subtract(prep.strain, draws)
    cpu_s = time.perf_counter() - t0
    sub_ms = cuda_time_ms(lambda: AdaptiveSubtractor(
        device=DEVICE).subtract(prep.strain, draws), reps=3)
    peak = float(np.abs(prep.strain).max())
    d_res = float(np.abs(got["residual"] - ref["residual"]).max()) / peak
    d_alpha = abs(got["alpha"] - ref["alpha"]) / abs(ref["alpha"])
    d_fit = abs(got["fit_snr"] - ref["fit_snr"]) / abs(ref["fit_snr"])
    print(f"(r) AdaptiveSubtractor card vs CPU on {len(draws)} draws "
          f"[{card}]: max|Δresidual| / max|strain| {d_res:.3e}, alpha "
          f"{d_alpha:.3e}, fit SNR {d_fit:.3e} relative (tol {SUB_TOL:g}); "
          f"alpha {got['alpha']:.4f}, fit SNR {got['fit_snr']:.3f}, quality"
          f" {got['quality']:.4f}; {sub_ms:.2f} ms on the card (CUDA "
          f"events), {cpu_s:.3f} s on the CPU")
    check(d_res <= SUB_TOL and d_alpha <= SUB_TOL and d_fit <= SUB_TOL,
          "subtractor card vs CPU")
    return {"launches": launches, "stages": n_st, "wall": wall,
            "n_extracted": out["n_extracted"], "sub_ms": sub_ms,
            "forced_launches": all_launches, "forced_wall": all_wall}


def phase_batched_decompose(torch, plain, rqs_cuda, engine, train_cfg,
                            sim_cfg, card):
    """(s) make_batched_decompose over POD_EVENTS simulated events; the
    spline kernel at the overlap paths' row counts."""
    from posteriflow_torch.core.pod import make_batched_decompose
    from posteriflow_torch.physics.simulator import simulate_batch
    layers = engine.cfg.flow_layers
    gen = torch.Generator(device=DEVICE).manual_seed(OVERLAP_SEED)
    ev = simulate_batch(POD_EVENTS, sim_cfg, device=DEVICE, generator=gen)
    decompose = make_batched_decompose(
        train_cfg, n_samples=POD_SAMPLES, max_stages=POD_STAGES,
        n_template_draws=POD_TEMPLATES)

    def run():
        return decompose(engine.model, ev.strain, ev.asd_bands,
                         generator=gen)
    run()                                                     # warm
    rows = []
    launch = rqs_cuda.KERNEL.launch

    def recording(x, *a, **k):
        rows.append(int(x.shape[0]))
        return launch(x, *a, **k)
    counts, restore = _count_plain(torch, plain)
    rqs_cuda.KERNEL.launch = recording
    try:
        rqs_cuda.KERNEL.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = run()
        torch.cuda.synchronize()
        launches = rqs_cuda.KERNEL.launches
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        rqs_cuda.KERNEL.launch = launch
        restore()
    call_ms = cuda_time_ms(run, reps=3, warmup=0)
    expected = POD_STAGES * layers
    print(f"(s) batched decompose, {POD_EVENTS} events (n_sig "
          f"{ev.n_sig.tolist()}) x {POD_SAMPLES} draws, {POD_STAGES} "
          f"stages, templates of {POD_TEMPLATES} draws [{card}]: "
          f"{call_ms:.2f} ms a call (CUDA events, 3 calls); n_extracted "
          f"{out['n_extracted'].tolist()}; quality by stage "
          f"{np.round(out['quality'].cpu().numpy(), 3).tolist()}; peak "
          f"memory {peak:.2f} GiB; rqs_tile launches {launches} (expected "
          f"{expected}) at rows {sorted(set(rows))}; plain spline calls "
          f"{counts}")
    check(launches == expected and rows == [POD_EVENTS * POD_SAMPLES]
          * expected, f"batched decompose: {launches} launches at {rows}")
    check(counts == {"forward": 0, "inverse": 0},
          f"the plain spline ran in the batched decomposition: {counts}")
    check(bool(torch.isfinite(out["median"]).all()
               and torch.isfinite(out["final_residual"]).all()),
          "batched decompose output")
    timing = {}
    for n in (N_SAMPLES, POD_EVENTS * POD_SAMPLES):
        x, raw, bias = spline_inputs(torch, n, seed=n + 2)
        timing[n] = forward_timing(torch, plain, rqs_cuda, x, raw, bias,
                                   inverse=True)
        t = timing[n]
        print(f"(s) rqs_tile<{K_BINS}, inverse, bias> N={n} D={D_TR} "
              f"[{card}]: device time a launch "
              + ("not measured" if t["ms"] is None
                 else f"{t['ms'] * 1e3:.2f} us")
              + f" (profiler), {t['events_ms'] * 1e3:.2f} us by CUDA events"
              f" over back-to-back launches, plain {t['plain_ms'] * 1e3:.1f}"
              f" us; bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}: "
              f"{rqs_bytes(n, D_TR, K_BINS)} B at 3.35 TB/s: x, raw and the "
              f"bias read, out and logdet written)")
    return {"launches": launches, "call_ms": call_ms, "peak_gib": peak,
            "n_extracted": out["n_extracted"].tolist(), "timing": timing}


def phase_priority_quality(torch, card):
    """(t) the evaluation battery at its defaults on the card against the
    JAX report's figures; then fit_priority at the v7 architecture."""
    import tempfile

    from posteriflow_torch.tools import priority_eval
    from posteriflow_torch.train.train_priority import (PriorityTrainConfig,
                                                        fit_priority,
                                                        load_priority_net)
    net = load_priority_net(PRIORITY_RELEASES[0], device=DEVICE)
    t0 = time.perf_counter()
    rep = priority_eval.evaluate(net, device=DEVICE)
    eval_s = time.perf_counter() - t0
    got = {"top1": rep["top1"], "tau": rep["kendall_tau"],
           "close": rep["pairwise_acc_by_target_sep"]["[0.0,0.1)"]}
    n, n_close = rep["n_scenarios"], rep["pairs_by_target_sep"]["[0.0,0.1)"]
    sigma = {"top1": math.sqrt(got["top1"] * (1 - got["top1"]) / n),
             "close": math.sqrt(got["close"] * (1 - got["close"]) / n_close),
             "tau": rep["kendall_tau_sd"] / math.sqrt(n)}
    print(f"(t) priority_eval, priority_v7, {n} scenarios [{card}]: "
          f"{eval_s:.2f} s; "
          + "; ".join(f"{k} {got[k]:.4f} (JAX report {EVAL_REF[k]}, band "
                      f"±{EVAL_BAND[k]}, this estimate's σ {sigma[k]:.4f})"
                      for k in ("top1", "tau", "close"))
          + f" ({n_close} close pairs); fallback top-1 "
          f"{rep['fallback_top1']:.4f}, τ {rep['fallback_kendall_tau']:.4f};"
          f" oracle top-1 {rep['oracle_top1']:.4f}, close pairs "
          f"{rep['oracle_pairwise_acc_by_target_sep']['[0.0,0.1)']:.4f}; "
          f"rank-uncertainty corr {rep['uncertainty_error_corr']:.4f}")
    for k in got:
        check(abs(got[k] - EVAL_REF[k]) <= EVAL_BAND[k],
              f"priority_eval {k} {got[k]} outside {EVAL_REF[k]} ± "
              f"{EVAL_BAND[k]}")

    cfg = PriorityTrainConfig(batch_size=PRIORITY_FIT_BATCH, use_dt=True,
                              residual_snr=True, close_boost=2.0,
                              mine_pool=2)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _, hist = fit_priority(tmp, cfg, steps=PRIORITY_FIT_STEPS,
                               eval_every=1, device=DEVICE)
        fit_s = time.perf_counter() - t0
    losses = [h["loss"] for h in hist]
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    rate = PRIORITY_FIT_STEPS / fit_s
    print(f"(t) fit_priority, v7 architecture (use_dt, residual_snr, close "
          f"boost 2, mine_pool 2), batch {PRIORITY_FIT_BATCH}, "
          f"{PRIORITY_FIT_STEPS} steps [{card}]: {fit_s:.2f} s, "
          f"{rate:.2f} steps/s (each with its evaluation batch: "
          f"eval_every 1); loss first-10 mean {first:.4f}, last-10 mean "
          f"{last:.4f}; top-1 at the end {hist[-1]['top1_acc']:.3f}")
    check(all(math.isfinite(v) for v in losses) and last < first,
          f"fit_priority: losses {losses}")
    return {"eval": got, "sigma": sigma, "eval_s": eval_s,
            "steps_per_s": rate}


def _bank_parity(torch, bank, bank_cpu, sim_cfg, card):
    """(u, part 1) simulate_batch with the bank at real_noise_prob 1 on the
    card against the CPU, on the same draws made on the CPU."""
    from posteriflow_torch.data.noise_bank import RealNoiseDraws
    from posteriflow_torch.physics import simulator as tsim
    from posteriflow_torch.prior import sample_batch
    cfg = dataclasses.replace(sim_cfg, real_noise_prob=1.0,
                              det_dropout=BANK_PARITY_DROPOUT)
    b = BANK_PARITY_EVENTS
    g = torch.Generator().manual_seed(13)
    params, n_sig = sample_batch(b, cfg.prior, g, "cpu")
    draws = tsim.draw_events((b,), g, "cpu")
    real = tsim.draw_real((b,), g, "cpu", bank_cpu)
    out = {}
    for dev, bk in ((DEVICE, bank), ("cpu", bank_cpu)):
        d_real = tsim.RealDraws(real.use_u.to(dev), RealNoiseDraws(
            *[t.to(dev) for t in real.crop]))
        with torch.no_grad():
            ev = tsim.simulate_batch(
                b, cfg, device=dev, params=params.to(dev),
                n_sig=n_sig.to(dev), draws=tsim.SimDraws(
                    *[t.to(dev) for t in draws]), bank=bk,
                real_draws=d_real)
            crops = tsim.real_noise(d_real, bk)
        out[dev] = (ev, crops)
    (eg, cg), (ec, cc) = out[DEVICE], out["cpu"]
    crops_equal = all(torch.equal(x.cpu(), y)
                      for x, y in zip(cg[1:], cc[1:]))
    noise = cc.noise.numpy()
    if cfg.glitch_prob > 0:
        noise = noise + tsim._glitch_burst(draws, cfg.glitch_prob).numpy()
    mask = ec.det_mask.numpy()[..., None] > 0
    sig = np.where(mask, ec.strain.numpy() - noise, 0.0)
    tol = SIM_ATOL + SIM_SIG * np.abs(sig).max(axis=(-2, -1))
    err = np.abs(eg.strain.cpu().numpy() - ec.strain.numpy()).max(
        axis=(-2, -1))
    same_gate = (torch.equal(eg.n_sig.cpu(), ec.n_sig)
                 and torch.equal(eg.params.cpu(), ec.params)
                 and torch.equal(eg.det_mask.cpu(), ec.det_mask))
    bands = eg.asd_bands.cpu()
    kept = eg.det_mask.cpu() > 0
    live = bands.abs().amax(-1)
    bands_ok = bool((live[kept] > 0).all() and (live[~kept] == 0).all())
    print(f"(u) bank batch card vs CPU, flagship 15-D at real_noise_prob 1, "
          f"dropout {BANK_PARITY_DROPOUT}, B={b}, n_sig {ec.n_sig.tolist()}, "
          f"{int((~kept).sum())} detectors dropped [{card}]: crops, filters "
          f"and bands identical {crops_equal}; gate and masks identical "
          f"{same_gate}; asd_bands identical "
          f"{torch.equal(bands, ec.asd_bands)}, non-zero on every kept and "
          f"zero on every dropped detector {bands_ok}; strain max|Δ| "
          f"{err.max():.3e} (tol per event {SIM_ATOL:g} + {SIM_SIG:g} x the "
          f"re-coloured signal's peak, at most {tol.max():.3e})")
    check(crops_equal, "bank crops differ between card and CPU")
    check(same_gate, "bank batch: the gate differs between card and CPU")
    check(torch.equal(bands, ec.asd_bands), "asd_bands differ card vs CPU")
    check(bands_ok and bool((~kept).any()),
          f"asd_bands by detector {live.tolist()}, kept {kept.tolist()}")
    check(bool((err <= tol).all()), f"bank batch strain differs by {err}")
    check(bool(torch.isfinite(eg.strain).all()), "non-finite strain")


def _real_events(batch) -> int:
    """Events whose noise was real: non-zero bands on a kept detector."""
    return int((batch.asd_bands.abs().amax(dim=(1, 2)) > 0).sum())


def _bank_steps(torch, plain, rqs_cuda, cfg, bank, card, no_bank):
    """(u, part 2) BANK_STEPS train steps of the flagship's SimConfig with
    the device bank, from the release's weights, timed as (m) is; then a
    control step's gradient without the bank."""
    from posteriflow_torch.data.noise_bank import (draw_real_noise,
                                                   real_noise_from_draws)
    from posteriflow_torch.physics.simulator import simulate_batch
    from posteriflow_torch.train.trainer import (backward, batch_nll,
                                                 train_step)
    state = release_state(torch, cfg)
    fc1 = state.model.encoder.noise_fc1.weight
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    layers = cfg.npe.flow_layers
    counts, restore = _count_plain(torch, plain)
    nlls, parts, walls, launches, grads, real = [], [], [], [], [], 0
    torch.cuda.reset_peak_memory_stats()
    rqs_cuda.KERNEL.launches = rqs_cuda.GRAD_KERNEL.launches = 0
    try:
        for _ in range(BANK_STEPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            f0 = rqs_cuda.KERNEL.launches
            b0 = rqs_cuda.GRAD_KERNEL.launches
            t0 = time.perf_counter()
            ev[0].record()
            batch = simulate_batch(cfg.batch_size, cfg.sim, device=DEVICE,
                                   generator=gen, bank=bank)
            ev[1].record()
            state.opt.zero_grad()
            loss = batch_nll(state.model, batch)
            ev[2].record()
            backward(loss)
            ev[3].record()
            state.opt.step()
            ev[4].record()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            parts.append([ev[j].elapsed_time(ev[j + 1]) for j in range(4)])
            nlls.append(float(loss.detach()))
            launches.append((rqs_cuda.KERNEL.launches - f0,
                             rqs_cuda.GRAD_KERNEL.launches - b0))
            grads.append(float(fc1.grad.abs().max()))
            real += _real_events(batch)
    finally:
        restore()
    path = (rqs_cuda.KERNEL.launches, rqs_cuda.GRAD_KERNEL.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    state.opt.zero_grad()
    control = simulate_batch(cfg.batch_size, cfg.sim, device=DEVICE,
                             generator=gen)
    backward(batch_nll(state.model, control))
    ctrl = float(fc1.grad.abs().max())
    state.opt.zero_grad()
    turns = {"without": [], "with": []}
    for r in range(BANK_TURNS):
        for kind in (("without", "with") if r % 2 == 0
                     else ("with", "without")):
            t0 = time.perf_counter()
            train_step(state, simulate_batch(
                cfg.batch_size, cfg.sim, device=DEVICE, generator=gen,
                bank=bank if kind == "with" else None))
            torch.cuda.synchronize()
            turns[kind].append((time.perf_counter() - t0) * 1e3)
    crop_draws = draw_real_noise((cfg.batch_size,), bank, gen)
    crop_ms = cuda_time_ms(lambda: real_noise_from_draws(bank, crop_draws),
                           reps=20)
    # what the crops must move: the float16 reads and float32 writes of
    # the crops, the filters' and bands' reads and writes
    crop_bytes = cfg.batch_size * 3 * (16384 * (2 + 4) + (
        bank.recolor.shape[-1] + bank.asd_bands.shape[-1]) * 4 * 2)
    steady = parts[1:]
    mean = [sum(p[j] for p in steady) / len(steady) for j in range(4)]
    step_ms = sum(walls[1:]) / len(walls[1:])
    n_ev = BANK_STEPS * cfg.batch_size
    p = cfg.sim.real_noise_prob
    share = real / n_ev
    sigma = math.sqrt(p * (1.0 - p) / n_ev)
    profile = profile_train_step(torch, state, cfg, gen, card, bank=bank,
                                 label="(u)")
    m_split = no_bank["split_ms"]
    m_prof = no_bank["profile"]
    m_busy = (f"{m_prof['busy_ms'] / m_prof['window_ms']:.1%}" if m_prof
              else "not measured")
    busy = (f"{profile['busy_ms'] / profile['window_ms']:.1%}" if profile
            else "not measured")
    print(f"(u) {BANK_STEPS} train steps with the device bank, flagship "
          f"SimConfig (real_noise_prob {p}), batch {cfg.batch_size}, from "
          f"{RELEASE} [{card}]: NLL by step {[round(v, 4) for v in nlls]}; "
          f"real-noise events {real}/{n_ev} = {share:.4f} "
          f"({(share - p) / sigma:+.2f} σ); spline launches a step "
          f"(forward, backward) {sorted(set(launches))}, plain spline calls "
          f"{counts}; |grad noise_fc1.weight| max by step "
          f"{[f'{v:.3e}' for v in grads]}, in a control step without the "
          f"bank {ctrl!r}")
    print(f"(u) step split over steps 2-{BANK_STEPS} by CUDA events, with "
          f"the bank [without it, (m)]: simulate {mean[0]:.3f} "
          f"[{m_split[0]:.3f}] ms, forward {mean[1]:.3f} [{m_split[1]:.3f}], "
          f"backward {mean[2]:.3f} [{m_split[2]:.3f}], optimizer "
          f"{mean[3]:.3f} [{m_split[3]:.3f}]; host wall {step_ms:.3f} "
          f"[{no_bank['step_ms']:.3f}] ms a step: {1e3 / step_ms:.3f} "
          f"[{no_bank['steps_per_s']:.3f}] steps/s; peak memory {peak:.2f} "
          f"[{no_bank['peak_gib']:.2f}] GiB; device busy {busy} [{m_busy}] "
          f"under the profiler")
    med = {k: float(np.median(v)) for k, v in turns.items()}
    won = sum(a < b for a, b in zip(turns["with"], turns["without"]))
    print(f"(u) in turns, {BANK_TURNS} train steps each, host wall a step "
          f"with the bank {[round(v, 1) for v in turns['with']]} ms "
          f"(median {med['with']:.3f}), without "
          f"{[round(v, 1) for v in turns['without']]} ms (median "
          f"{med['without']:.3f}): ratio {med['with'] / med['without']:.4f}, "
          f"the bank's step the faster of its pair {won}/{BANK_TURNS}; "
          f"the batch's crops (real_noise_from_draws, B={cfg.batch_size}) "
          f"{crop_ms * 1e3:.1f} µs by CUDA events against "
          f"{crop_bytes / PEAK_BYTES_PER_S * 1e6:.1f} µs to move "
          f"{crop_bytes / 1e6:.1f} MB [{card}]")
    check(all(math.isfinite(v) for v in nlls), f"non-finite NLL: {nlls}")
    check(TRAIN_NLL0[0] <= nlls[0] <= TRAIN_NLL0[1],
          f"step-0 NLL with the bank {nlls[0]} outside {TRAIN_NLL0}")
    check(abs(share - p) <= BANK_SHARE_SIGMAS * sigma,
          f"real-noise share {share} is {(share - p) / sigma:.2f} σ from {p}")
    check(all(lc == (layers, layers) for lc in launches),
          f"spline launches by step {launches}, expected {layers} each way")
    check(counts == {"forward": 0, "inverse": 0},
          f"the plain spline ran in the bank steps: {counts}")
    check(all(v > 0 for v in grads), f"noise_fc1.weight gradient {grads}")
    check(ctrl == 0.0, f"noise_fc1.weight gradient without a bank {ctrl}")
    return {"state": state, "launches": path, "nlls": nlls,
            "split_ms": mean, "step_ms": step_ms,
            "steps_per_s": 1e3 / step_ms, "peak_gib": peak,
            "profile": profile, "share": share, "turns_ms": med,
            "crop_ms": crop_ms}


def _feed_steps(torch, plain, rqs_cuda, state, cfg, bank_dir, card):
    """(u, part 3) the native crop server and HostNoiseFeed ->
    simulate_batch(real_feed=) -> FEED_STEPS train steps."""
    from posteriflow_torch.data.host_feed import HostNoiseFeed
    from posteriflow_torch.data.native_bank import NativeBankServer
    from posteriflow_torch.physics.simulator import simulate_batch
    from posteriflow_torch.train.trainer import backward, batch_nll
    b = cfg.batch_size
    server = NativeBankServer(bank_dir)
    native = server.native
    check(native, "the native crop server did not load")
    server.sample(seed=0, n_events=b)                  # pages the bank in
    t0 = time.perf_counter()
    for r in range(SERVER_REPS):
        server.sample(seed=r + 1, n_events=b)
    crops_per_s = SERVER_REPS * b * 3 / (time.perf_counter() - t0)
    layers = cfg.npe.flow_layers
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    waits, walls, nlls, launches, noises, real = [], [], [], [], [], 0
    counts, restore = _count_plain(torch, plain)
    rqs_cuda.KERNEL.launches = rqs_cuda.GRAD_KERNEL.launches = 0
    try:
        with HostNoiseFeed(bank_dir, batch_size=b,
                           psd_bands=cfg.sim.psd_bands, seed=FEED_SEED,
                           device=DEVICE) as feed:
            for _ in range(FEED_STEPS):
                f0 = rqs_cuda.KERNEL.launches
                b0 = rqs_cuda.GRAD_KERNEL.launches
                t0 = time.perf_counter()
                rf = feed.next()
                t1 = time.perf_counter()
                batch = simulate_batch(b, cfg.sim, device=DEVICE,
                                       generator=gen, real_feed=rf)
                state.opt.zero_grad()
                loss = batch_nll(state.model, batch)
                backward(loss)
                state.opt.step()
                torch.cuda.synchronize()
                waits.append((t1 - t0) * 1e3)
                walls.append((time.perf_counter() - t0) * 1e3)
                nlls.append(float(loss.detach()))
                launches.append((rqs_cuda.KERNEL.launches - f0,
                                 rqs_cuda.GRAD_KERNEL.launches - b0))
                noises.append(rf[0])
                real += _real_events(batch)
    finally:
        restore()
    path = (rqs_cuda.KERNEL.launches, rqs_cuda.GRAD_KERNEL.launches)
    same = [np.array_equal(n.cpu().numpy(), server.sample(
        seed=FEED_SEED * 1_000_003 + i, n_events=b)[0])
        for i, n in enumerate(noises)]
    server.close()
    print(f"(u) native crop server (native {native}) [{card}]: "
          f"{crops_per_s:.0f} crops/s of 16384 samples ({b} events x 3 "
          f"detectors a call, 4 threads); HostNoiseFeed (depth 2, pinned "
          f"buffers, its own stream) -> simulate_batch(real_feed=) -> "
          f"{FEED_STEPS} train steps: next() waited "
          f"{[round(w, 3) for w in waits]} ms, step walls "
          f"{[round(w, 1) for w in walls]} ms, NLL "
          f"{[round(v, 4) for v in nlls]}, real-noise events {real}/"
          f"{FEED_STEPS * b}; spline launches a step {sorted(set(launches))}"
          f", plain spline calls {counts}; each batch equal to the server's "
          f"crops at its seed {same}")
    check(all(same), f"host feed batches differ from the server's: {same}")
    check(all(math.isfinite(v) for v in nlls), f"non-finite NLL: {nlls}")
    check(all(lc == (layers, layers) for lc in launches),
          f"spline launches by feed step {launches}")
    check(counts == {"forward": 0, "inverse": 0},
          f"the plain spline ran in the feed steps: {counts}")
    return {"launches": path, "waits_ms": waits, "crops_per_s": crops_per_s}


def _bank_fit(torch, rqs_cuda, cfg, bank, card):
    """(u, part 4) fit(bank=) for one epoch from the release."""
    import tempfile

    from posteriflow_torch.train.loop import fit
    with open(f"{RELEASE}/meta.json") as f:
        jax_keys = set(json.load(f)["metrics"])
    with tempfile.TemporaryDirectory() as tmp:
        rqs_cuda.KERNEL.launches = rqs_cuda.GRAD_KERNEL.launches = 0
        t0 = time.perf_counter()
        fit(cfg, tmp, epochs=1, steps_per_epoch=BANK_FIT_STEPS,
            n_val_events=BANK_FIT_VAL, init_from=RELEASE, device=DEVICE,
            bank=bank)
        fit_s = time.perf_counter() - t0
        path = (rqs_cuda.KERNEL.launches, rqs_cuda.GRAD_KERNEL.launches)
        with open(f"{tmp}/history.json") as f:
            rec = json.load(f)[-1]
    mean = 0.5 * (rec["val_nll"] + rec["real_val_nll"])
    print(f"(u) fit(bank=) 1 epoch x {BANK_FIT_STEPS} steps, "
          f"{BANK_FIT_VAL} validation events a domain, from {RELEASE} "
          f"[{card}]: {fit_s:.1f} s; val_nll {rec['val_nll']:.4f}, "
          f"real_val_nll {rec['real_val_nll']:.4f}, select_nll "
          f"{rec['select_nll']:.4f}; real_dist_corr "
          f"{rec['real_dist_corr']:.4f}; spline launches (forward, "
          f"backward) {path}; history keys as JAX's {set(rec) == jax_keys}")
    check(set(rec) == jax_keys,
          f"history keys {sorted(set(rec) ^ jax_keys)} differ")
    check(math.isfinite(rec["real_val_nll"]), "non-finite real_val_nll")
    check(abs(rec["select_nll"] - mean) <= 1e-12 * max(1.0, abs(mean)),
          f"select_nll {rec['select_nll']} is not the mean {mean}")
    return {"launches": path, "seconds": fit_s}


def phase_bank(torch, plain, rqs_cuda, cfg, card, no_bank, bank_dir):
    """(u) the real-noise path on the flagship at full width, on a
    synthetic bank written to bank_dir (which phase v reads again)."""
    from posteriflow_torch.data.noise_bank import load_noise_bank
    from posteriflow_torch.tools import make_noise_bank
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    make_noise_bank.main(["--out", bank_dir, "--synthetic",
                          str(BANK_SEGMENTS)])
    made_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bank = load_noise_bank(bank_dir, psd_bands=cfg.sim.psd_bands,
                           device=DEVICE)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    bank_cpu = load_noise_bank(bank_dir, psd_bands=cfg.sim.psd_bands,
                               device="cpu")
    print(f"(u) bank: tools/make_noise_bank.py --synthetic "
          f"{BANK_SEGMENTS} in {made_s:.2f} s; on the card "
          f"{tuple(bank.segments.shape)} float16 "
          f"({bank.segments.numel() * 2 / 1e6:.1f} MB) + filters "
          f"{bank.recolor.numel() * 4 / 1e6:.2f} MB, loaded in "
          f"{load_s:.2f} s [{card}]")
    check(tuple(bank.segments.shape)
          == (3, BANK_SEGMENTS, 64 * SAMPLE_RATE),
          f"bank shape {tuple(bank.segments.shape)}")
    _bank_parity(torch, bank, bank_cpu, cfg.sim, card)
    steps = _bank_steps(torch, plain, rqs_cuda, cfg, bank, card,
                        no_bank)
    feed = _feed_steps(torch, plain, rqs_cuda, steps.pop("state"), cfg,
                       bank_dir, card)
    fitted = _bank_fit(torch, rqs_cuda, cfg, bank, card)
    print(f"(u) phase done in {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]")
    return {"steps": steps, "feed": feed, "fit": fitted}


def sigma_of_difference(per_chunk) -> float:
    """σ of the difference of two estimates over as many events, from the
    port's chunk-to-chunk spread: sd / √chunks, times √2."""
    vals = np.asarray(per_chunk, dtype=np.float64)
    return float(vals.std(ddof=1)) / math.sqrt(len(vals)) * math.sqrt(2.0)


def _val_stats(record: dict, report: dict, ref: dict, card):
    """(v) each averaged statistic against the JAX report within
    VAL_SIGMAS σ of the difference of two estimates."""
    rows = []
    for key, per_chunk in VAL_STATS.items():
        sigma = sigma_of_difference([c[per_chunk] for c in record["chunks"]])
        got, want = report["metrics"][key], ref["metrics"][key]
        rows.append((key, got, want, sigma, abs(got - want) / sigma))
    print(f"(v) statistics against {VAL_REPORT} (JAX, {ref['metrics']['n_events']}"
          f" x {ref['metrics']['n_post']}) [{card}]: "
          + "; ".join(f"{k} {g:.4f} vs {w:.4f} (σ of the difference "
                      f"{s:.4f}: {z:.2f} σ)" for k, g, w, s, z in rows))
    m, rm = report["metrics"], ref["metrics"]
    print(f"(v) coverage violations 50/90 {m['cov50_violations']}/"
          f"{m['cov90_violations']} (JAX {rm['cov50_violations']}/"
          f"{rm['cov90_violations']}); SBC pass {m['sbc_pass_frac']:.4f} "
          f"(JAX {rm['sbc_pass_frac']}); KS p by parameter (port, JAX): "
          + ", ".join(f"{k} {m['sbc_ks_p'][k]:.5f}/{rm['sbc_ks_p'][k]:.5f}"
                      for k in m["sbc_ks_p"]))
    print(f"(v) smoke |t_c| errors "
          f"{[round(t['tc_abs_err'], 4) for t in m['smoke_tests']]} (max "
          f"{m['smoke_tc_max_abs_err']:.4f}, JAX "
          f"{rm['smoke_tc_max_abs_err']:.4f}); live OOD "
          f"{[(c['case'], c['verdict'], round(c['ood_percentile'], 2), c['refine']) for c in m['ood_live']]}"
          f"; glitch+signal "
          f"{[(c['det'], c['verdict'], round(c['tc_abs_err'], 4), round(c['mc_frac_err'], 4), c['handled']) for c in m['glitch_signal']]}")
    for key, got, want, sigma, z in rows:
        check(math.isfinite(z) and z <= VAL_SIGMAS,
              f"{key} {got} is {z:.2f} σ from JAX's {want} (σ {sigma})")
    return {k: {"port": g, "jax": w, "sigma": s, "z": z}
            for k, g, w, s, z in rows}


def _ood_stats_check(ckpt: str, cfg, card):
    """(v) the fitted ood_stats.npz against the release's shipped one, and
    a training checkpoint served armed with it."""
    from scipy.stats import ks_2samp

    from posteriflow_torch.inference.pipeline import InferenceEngine
    got = np.load(f"{ckpt}/ood_stats.npz")
    ref = np.load(f"{RELEASE}/ood_stats.npz")
    shapes = {k: (got[k].shape, ref[k].shape) for k in ref.files}
    ks = ks_2samp(got["val_dists"], ref["val_dists"])
    med, med_ref = float(np.median(got["val_dists"])), float(
        np.median(ref["val_dists"]))
    engine = InferenceEngine.from_checkpoint(ckpt, "best", device=DEVICE)
    print(f"(v) ood_stats.npz keys {sorted(got.files)} (release "
          f"{sorted(ref.files)}), shapes (port, release) {shapes}; val_dists"
          f" against the release's: KS statistic {ks.statistic:.4f}, p "
          f"{ks.pvalue:.4g} (> {OOD_KS_P:g}), medians {med:.4f} and "
          f"{med_ref:.4f} ({med / med_ref - 1:+.4f}); from_checkpoint armed "
          f"{engine.ood_stats is not None} [{card}]")
    check(sorted(got.files) == sorted(ref.files),
          f"ood_stats keys {got.files}")
    check(all(a == b for a, b in shapes.values()),
          f"ood_stats shapes {shapes}")
    check(ks.pvalue > OOD_KS_P, f"val_dists KS p {ks.pvalue}")
    check(abs(med / med_ref - 1.0) <= OOD_MEDIAN_REL,
          f"val_dists median {med} against {med_ref}")
    check(engine.ood_stats is not None
          and engine.ood_stats.mean.shape == (cfg.npe.context_dim,),
          "from_checkpoint did not arm the OOD stats")
    return {"ks_p": float(ks.pvalue), "median": med, "median_ref": med_ref}


def _validate(torch, plain, rqs_cuda, argv, expected, label, card):
    """(v) one run of tools/validate_checkpoint with the launch counter
    zeroed before and read after, and the plain spline counted."""
    from posteriflow_torch.tools import validate_checkpoint
    counts, restore = _count_plain(torch, plain)
    rqs_cuda.KERNEL.launches = 0
    try:
        t0 = time.perf_counter()
        code, report, record = validate_checkpoint.run(argv)
        wall = time.perf_counter() - t0
    finally:
        restore()
    launches = rqs_cuda.KERNEL.launches
    secs = ", ".join(f"{k} {v:.2f}" for k, v in record["seconds"].items())
    print(f"(v) tools/validate_checkpoint {label} [{card}]: exit {code}, "
          f"{wall:.2f} s wall ({secs} s; the report's wall_time_s "
          f"{report['metrics']['wall_time_s']}); rqs_tile launches "
          f"{launches} (expected {expected}), plain spline calls {counts}; "
          f"gates " + ", ".join(f"{c['gate']} {c['value']:.4f} "
                                f"{'PASS' if c['passed'] else 'FAIL'}"
                                for c in report["checks"]))
    check(launches == expected,
          f"validate_checkpoint launched rqs_tile {launches} times, "
          f"expected {expected}")
    check(counts == {"forward": 0, "inverse": 0},
          f"the plain spline ran in validate_checkpoint: {counts}")
    return code, report, record, launches, wall


def _twin_grid(torch, rqs_cuda, ckpt: str, tmp: str, card):
    """(v) tools/twin_grid at its defaults against analysis/twin_grid.json:
    the distances held, the biases printed."""
    from posteriflow_torch.tools import twin_grid
    with open(TWIN_REPORT) as f:
        ref = json.load(f)
    rqs_cuda.KERNEL.launches = 0
    t0 = time.perf_counter()
    got = twin_grid.main(["--ckpt", ckpt, "--out", f"{tmp}/twin_grid.json",
                          "--device", DEVICE])
    wall = time.perf_counter() - t0
    launches = rqs_cuda.KERNEL.launches
    pairs = list(zip(got["grid"], ref["grid"]))
    rel = [abs(g["distance"] / r["distance"] - 1.0) for g, r in pairs]

    def mean_abs(grid, key):
        return float(np.mean([abs(c[key]) for c in grid]))
    print(f"(v) tools/twin_grid {len(got['grid'])} points x 2 twins "
          f"[{card}]: {wall:.2f} s, rqs_tile launches {launches}; distances "
          f"(port/JAX) {[(round(g['distance'], 2), round(r['distance'], 2)) for g, r in pairs]}"
          f", max relative gap {max(rel):.2e} (tol {TWIN_DIST_REL:g}); "
          f"(mc_bias_frac_mean, q_bias_mean) port/JAX "
          f"{[((round(g['mc_bias_frac_mean'], 3), round(g['q_bias_mean'], 3)), (round(r['mc_bias_frac_mean'], 3), round(r['q_bias_mean'], 3))) for g, r in pairs]}"
          f"; mean |mc_bias_frac| {mean_abs(got['grid'], 'mc_bias_frac_mean'):.4f}"
          f" (JAX {mean_abs(ref['grid'], 'mc_bias_frac_mean'):.4f}), mean "
          f"|q_bias| {mean_abs(got['grid'], 'q_bias_mean'):.4f} (JAX "
          f"{mean_abs(ref['grid'], 'q_bias_mean'):.4f}); q_attractor_band "
          f"{got['q_attractor_band']} (JAX {ref['q_attractor_band']}); "
          f"config hash {got['_meta'].get('config_hash')}")
    check(len(pairs) == len(ref["grid"]) == len(got["grid"]),
          f"twin grid has {len(got['grid'])} points")
    check(all(g["mc"] == r["mc"] and abs(g["q"] - r["q"]) < 1e-12
              for g, r in pairs), "twin grid points differ from JAX's")
    check(max(rel) <= TWIN_DIST_REL, f"twin grid distances differ by {rel}")
    check(all(math.isfinite(t[k]) for g in got["grid"] for t in g["twins"]
              for k in ("mc_bias_frac", "q_bias")), "non-finite twin bias")
    check(launches == 2 * len(got["grid"]) * 10,
          f"twin_grid launched rqs_tile {launches} times")
    return {"launches": launches, "seconds": wall}


def _importance_cases(torch, rqs_cuda, ckpt: str, tmp: str, card):
    """(v) tools/importance_validation on IV_CASES with --cross-check,
    run_smc_prior capped at IS_SMC_STAGES."""
    import functools

    from posteriflow_torch.inference import importance as imp
    from posteriflow_torch.tools import importance_validation as iv
    with open(IV_REPORT) as f:
        ref = json.load(f)
    saved = imp.run_smc_prior
    imp.run_smc_prior = functools.partial(saved, max_stages=IS_SMC_STAGES)
    rqs_cuda.KERNEL.launches = 0
    try:
        t0 = time.perf_counter()
        got = iv.main(["--ckpt", ckpt, "--cases", *IV_CASES,
                       "--cross-check", "--no-warmup", "--out",
                       f"{tmp}/importance_validation.json", "--device",
                       DEVICE])
        wall = time.perf_counter() - t0
    finally:
        imp.run_smc_prior = saved
    launches = rqs_cuda.KERNEL.launches
    for case in IV_CASES:
        g, r = got[case], ref[case]
        p = iv.CASES[case]
        truth = (p["mass_1"] * p["mass_2"]) ** 0.6 / (
            p["mass_1"] + p["mass_2"]) ** 0.2
        print(f"(v) importance_validation {case} [{card}]: ESS {g['ess']} "
              f"(JAX {r['ess']}), efficiency {g['efficiency']} "
              f"({r['efficiency']}), stages {g['n_stages']} "
              f"({r['n_stages']}), converged {g['converged']}, ladder "
              f"{g['beta_ladder']} (JAX {r['beta_ladder']}), log Z "
              f"{g['log_evidence_ratio']} ({r['log_evidence_ratio']}), "
              f"corrected Mc median {g['corrected_mc_median']} (truth "
              f"{truth:.3f}, JAX {r['corrected_mc_median']}), {g['wall_s']} "
              f"s; smc_prior (capped at {IS_SMC_STAGES} stages) "
              f"{g['smc_prior']['n_stages']} stages, converged "
              f"{g['smc_prior']['converged']}, logz_gap_vs_flow_is "
              f"{g['smc_prior']['logz_gap_vs_flow_is']} (JAX "
              f"{r['smc_prior']['logz_gap_vs_flow_is']}), "
              f"{g['smc_prior']['wall_s']} s")
        check(g["converged"] and g["ess"] > 0,
              f"{case}: converged {g['converged']}, ESS {g['ess']}")
        check(abs(g["corrected_mc_median"] / truth - 1.0) <= IV_MC_REL,
              f"{case}: corrected Mc median {g['corrected_mc_median']} "
              f"against {truth}")
    print(f"(v) importance_validation {len(IV_CASES)} cases: {wall:.2f} s, "
          f"rqs_tile launches {launches} [{card}]")
    return {"launches": launches, "seconds": wall}


def phase_validate(torch, plain, rqs_cuda, cfg, card, bank_dir):
    """(v) checkpoint validation of a port checkpoint of the flagship at
    the JAX report's size, its OOD stats, the real-noise domain, the
    spline at the validation shapes, the twin grid and the importance
    battery."""
    from posteriflow_torch.train.checkpoints import CheckpointManager
    from posteriflow_torch.utils.provenance import artifact_meta
    t_phase = time.perf_counter()
    with open(VAL_REPORT) as f:
        ref = json.load(f)
    layers = cfg.npe.flow_layers
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = f"{tmp}/ckpt"
        CheckpointManager(ckpt).save("best", release_state(torch, cfg), cfg)
        meta = artifact_meta(f"{ckpt}/best")
        print(f"(v) port checkpoint of {RELEASE} under a temporary "
              f"directory: config_hash {meta.get('config_hash')} (the "
              f"report's {ref['_meta']['config_hash']})")
        check(meta.get("config_hash") == VAL_HASH == ref["_meta"][
            "config_hash"], f"config hash {meta.get('config_hash')}")

        n_chunks = -(-VAL_EVENTS // VAL_CHUNK)
        code, report, record, launches, wall = _validate(
            torch, plain, rqs_cuda,
            ["--ckpt", ckpt, "--n-events", str(VAL_EVENTS), "--n-post",
             str(VAL_POST), "--out", f"{tmp}/val", "--device", DEVICE],
            n_chunks * 5 * layers + VAL_REQUESTS * layers,
            f"{VAL_EVENTS} x {VAL_POST}", card)
        stats = _val_stats(record, report, ref, card)
        checks = report["checks"]
        check(code == 0 and report["passed"]
              and len(checks) == 9 and all(c["passed"] for c in checks),
              f"validation failed: exit {code}, "
              f"{[c['gate'] for c in checks if not c['passed']]}")
        check(report["metrics"]["n_events"] == VAL_EVENTS,
              f"n_events {report['metrics']['n_events']}")
        ood = _ood_stats_check(ckpt, cfg, card)

        r_code, r_report, _, r_launches, r_wall = _validate(
            torch, plain, rqs_cuda,
            ["--ckpt", ckpt, "--n-events", str(VAL_REAL_EVENTS),
             "--noise-bank", bank_dir, "--out", f"{tmp}/val_real",
             "--device", DEVICE],
            (5 + 3) * layers + VAL_REQUESTS * layers,
            f"--noise-bank (u's synthetic bank) --n-events "
            f"{VAL_REAL_EVENTS}", card)
        rm = r_report["metrics"]
        gates = [c["gate"] for c in r_report["checks"]]
        print(f"(v) real-noise domain on the synthetic bank, a mechanics "
              f"check (JAX's GWOSC bank is not committed) [{card}]: "
              f"real_val_nll {rm['real_val_nll']:.4f}, real_dist_corr "
              f"{rm['real_dist_corr']:.4f}, real_shuffle_delta_nll "
              f"{rm['real_shuffle_delta_nll']:.4f}, real_gaussian_nll_gap "
              f"{rm['real_gaussian_nll_gap']:.4f} (JAX on its bank "
              f"{ref['metrics']['real_gaussian_nll_gap']:.4f}, not held); "
              f"exit {r_code}")
        check(all(math.isfinite(rm[k]) for k in (
            "real_val_nll", "real_dist_corr", "real_shuffle_delta_nll")),
            "non-finite real-noise metrics")
        check("real_gaussian_nll_gap" in gates and len(gates) == 10,
              f"real-noise run's gates {gates}")

        timing = {}
        for n, inverse in ((VAL_CHUNK * VAL_POST, True), (VAL_CHUNK, False)):
            x, raw, bias = spline_inputs(torch, n, seed=n)
            t = forward_timing(torch, plain, rqs_cuda, x, raw, bias,
                               inverse=inverse)
            timing[n] = t
            print(f"(v) rqs_tile<{K_BINS}, "
                  f"{'inverse' if inverse else 'forward'}, bias> at {n} rows"
                  f" [{card}]: "
                  + ("not measured" if t["ms"] is None
                     else f"{t['ms'] * 1e3:.2f} us")
                  + f" (profiler), {t['events_ms'] * 1e3:.2f} us by CUDA "
                  f"events back to back, plain {t['plain_ms'] * 1e3:.1f} us;"
                  f" bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}: "
                  f"{rqs_bytes(n, D_TR, K_BINS)} B)")

        twin = _twin_grid(torch, rqs_cuda, ckpt, tmp, card)
        iv = _importance_cases(torch, rqs_cuda, ckpt, tmp, card)
    print(f"(v) phase done in {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]")
    return {"launches": launches, "real_launches": r_launches,
            "wall_s": wall, "real_wall_s": r_wall, "stats": stats,
            "ood": ood, "timing": timing, "twin": twin, "iv": iv,
            "seconds": record["seconds"]}


# (w) the long-BNS family. Its flows transform LB_D = 11 - 6 dimensions.
# long_bns_v4's spline has LB_K = 12 bins, long_bns_v1's LB_V1_K = 8.
# rqs_tile bit-equal to the plain spline at LB_ROWS (w1): v4's validation
# NLL (50 events), a training batch (64), a ragged tile, v4's sampling
# (50 x 400) and a sampling-sized check; v1's at LB_V1_ROWS. rqs_grad<12>
# against the plain VJP at LB_GRAD_ROWS at (l)'s tolerance.
LB_D, LB_K, LB_V1_K = 5, 12, 8
LB_ROWS = (50, 64, 641, 20000, 131072)
LB_GRAD_ROWS = (64, 131072)


def phase_lb_kernels(torch, plain, rqs_cuda, card, v1_rows):
    """(w1) the K = 12 instances' registers and spills (none allowed);
    rqs_tile<12> bit-equal to the plain spline at LB_ROWS and rqs_tile<8>
    at v1's shapes, both directions, with and without the bias; rqs_grad<12>
    against the plain VJP at LB_GRAD_ROWS; the times a launch at the
    long-BNS shapes beside the bound, the launch floor and the plain
    version."""
    log = rqs_cuda.KERNEL.build_log
    for kernel, n_inst in (("rqs_tile", 4), ("rqs_grad", 2)):
        insts = [i for i in rqs_cuda.ptxas_instances(log, kernel)
                 if i["k"] == LB_K]
        check(len(insts) == n_inst,
              f"ptxas reported {len(insts)} {kernel}<{LB_K}> instances")
        for i in insts:
            kind = ("" if "inverse" not in i else
                    ("inverse, " if i["inverse"] else "forward, "))
            print(f"(w1) ptxas: {kernel}<{LB_K}, {kind}"
                  f"{'bias' if i['bias'] else 'no bias'}>: "
                  f"{i['registers']} registers, {i['stack']} B stack, "
                  f"{i['spill_stores']} B spill stores, {i['spill_loads']} "
                  f"B spill loads")
            check(i["spill_stores"] == 0 and i["spill_loads"] == 0,
                  f"{kernel}<{LB_K}> spills: {i}")
    shapes = [(n, LB_K) for n in LB_ROWS] + [(n, LB_V1_K) for n in v1_rows]
    tile_err = {LB_K: 0.0, LB_V1_K: 0.0}
    for n, k in shapes:
        x, raw, bias = spline_inputs(torch, n, seed=n + k, k=k, d=LB_D)
        for b in (None, bias):
            for inverse in (False, True):
                k_out, k_ld = rqs_cuda.KERNEL.launch(
                    x, raw.reshape(n, -1), k, TAIL, inverse, bias=b)
                p_fn = plain.rqs_inverse if inverse else plain.rqs_forward
                p_out, p_ld = p_fn(x, raw if b is None else raw + b, k, TAIL)
                torch.cuda.synchronize()
                e_out = float((k_out - p_out).abs().max())
                e_ld = float((k_ld - p_ld).abs().max())
                print(f"(w1) rqs_tile<{k}, "
                      f"{'inverse' if inverse else 'forward'}, "
                      f"{'bias' if b is not None else 'no bias'}> N={n} "
                      f"D={LB_D}: max|Δout| {e_out:.3e}, max|Δlogdet| "
                      f"{e_ld:.3e} (tol 0)")
                check(e_out == 0.0 and e_ld == 0.0,
                      f"rqs_tile<{k}> N={n} inverse={inverse} bias="
                      f"{b is not None} differs from the plain spline: "
                      f"{e_out}, {e_ld}")
                tile_err[k] = max(tile_err[k], e_out, e_ld)
    worst = {"abs": 0.0, "rel": 0.0}
    for n in LB_GRAD_ROWS:
        x, raw, g_out, g_ld, bias = grad_inputs(torch, plain, n, LB_K,
                                                seed=n + 3, d=LB_D)
        for b in (None, bias):
            ref = plain.rqs_forward_vjp(x, raw, g_out, g_ld, LB_K, TAIL,
                                        bias=b)
            got = rqs_cuda.GRAD_KERNEL.launch(x, raw.reshape(n, -1), g_out,
                                              g_ld, LB_K, TAIL, b)
            torch.cuda.synchronize()
            errs = [grad_err(got[0], ref[0]),
                    grad_err(got[1].reshape(ref[1].shape), ref[1])]
            d_abs = max(float((got[0] - ref[0]).abs().max()),
                        float((got[1].reshape(ref[1].shape)
                               - ref[1]).abs().max()))
            worst["abs"] = max(worst["abs"], d_abs)
            worst["rel"] = max(worst["rel"], *errs)
            print(f"(w1) rqs_grad<{LB_K}, "
                  f"{'bias' if b is not None else 'no bias'}> N={n} "
                  f"D={LB_D}: g_x {errs[0]:.2e}, g_raw {errs[1]:.2e} of the "
                  f"largest entry (tol {GRAD_REL:g} + {GRAD_ABS:g}); "
                  f"max|Δ| {d_abs:.3e}")
            check(all(math.isfinite(e) and e <= GRAD_REL for e in errs),
                  f"rqs_grad<{LB_K}> N={n} bias={b is not None}: {errs}")
    floor_ms = kernel_device_ms(torch, lambda: torch.zeros(1, device=DEVICE),
                                "")
    times = {}
    for n, k, inverse in ((50, LB_K, False), (64, LB_K, False),
                          (20000, LB_K, True), (v1_rows[0], LB_V1_K, False),
                          (v1_rows[1], LB_V1_K, True)):
        x, raw, bias = spline_inputs(torch, n, seed=n, k=k, d=LB_D)
        t = forward_timing(torch, plain, rqs_cuda, x, raw, bias,
                           inverse=inverse, k=k)
        times[(n, k, inverse)] = t
        print(f"(w1) rqs_tile<{k}, {'inverse' if inverse else 'forward'}, "
              f"bias> N={n} D={LB_D} [{card}]: device time a launch "
              + ("not measured" if t["ms"] is None
                 else f"{t['ms'] * 1e3:.2f} us")
              + f" (profiler), {t['events_ms'] * 1e3:.2f} us by CUDA events "
              f"over back-to-back launches, plain {t['plain_ms'] * 1e3:.1f} "
              f"us; bound {t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}: "
              f"{rqs_bytes(n, LB_D, k)} B); launch floor "
              + ("not measured" if floor_ms is None
                 else f"{floor_ms * 1e3:.2f} us"))
    n = LB_GRAD_ROWS[0]
    x, raw, g_out, g_ld, bias = grad_inputs(torch, plain, n, LB_K, seed=9,
                                            d=LB_D)
    raw2 = raw.reshape(n, -1)

    def grad_fn():
        return rqs_cuda.GRAD_KERNEL.launch(x, raw2, g_out, g_ld, LB_K, TAIL,
                                           bias)
    nbytes, nops = rqs_grad_bytes(n, LB_D, LB_K), rqs_grad_ops(n, LB_D, LB_K)
    by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S, nops / PEAK_F32_FLOPS
    g = {"ms": kernel_device_ms(torch, grad_fn, "rqs_grad"),
         "events_ms": cuda_time_ms(grad_fn, reps=50),
         "plain_ms": cuda_time_ms(lambda: plain.rqs_forward_vjp(
             x, raw, g_out, g_ld, LB_K, TAIL, bias=bias), reps=5),
         "bound_ms": max(by_bytes, by_ops) * 1e3,
         "bound_by": "bytes" if by_bytes >= by_ops else "operations",
         "max_abs_err": worst["abs"], "max_rel_err": worst["rel"]}
    print(f"(w1) rqs_grad<{LB_K}, bias> N={n} D={LB_D} [{card}]: device "
          f"time a launch "
          + ("not measured" if g["ms"] is None else f"{g['ms'] * 1e3:.2f} us")
          + f" (profiler), {g['events_ms'] * 1e3:.2f} us by CUDA events, "
          f"plain VJP {g['plain_ms'] * 1e3:.1f} us; bound "
          f"{g['bound_ms'] * 1e3:.3f} us ({g['bound_by']}: {nbytes} B)")
    return {"times": times, "grad": g, "launch_floor_ms": floor_ms,
            "tile_err": tile_err}


# (w2)-(w5): long_bns_v4 served (a LB_SERVE_EVENTS-event batch from fixed
# draws), validated at reports/val_long_bns/report.json's own 2000 x 400 in
# chunks of 50, trained LB_TRAIN_STEPS steps at its batch of 64 with an
# evaluation every LB_TRAIN_EVAL; long_bns_v1 card vs CPU on LB_V1_PARITY
# events (its 2048-token attention is slow on the CPU) and validated at
# LB_V1_EVENTS x LB_V1_POST in chunks of LB_V1_CHUNK (near its
# calibration.json's 256 x 256; the float32 scores of a chunk take 6.7 GB).
# The card against the CPU within LB_SERVE_TOL, relative to the larger of 1
# and the largest |value| (phase c's 1e-3); the statistics within
# VAL_SIGMAS σ of the JAX report, σ from the port's chunks as in (v).
LB_RELEASE, LB_V1_RELEASE = "model_release/long_bns_v4", \
    "model_release/long_bns_v1"
LB_REPORT = "reports/val_long_bns/report.json"
LB_SERVE_EVENTS, LB_SERVE_DRAWS, LB_SERVE_TOL = 50, 400, 1e-3
LB_SERVE_REPS = 5           # warm requests timed after the counted one
LB_EVENTS, LB_POST, LB_CHUNK = 2000, 400, 50
LB_STATS = {"val_nll": "nll", "signal_delta_nll": "delta",
            "mc_sharpen": "mc_sharpen", "spurious_railing": "railing",
            "dist_corr": "dist_corr"}
LB_TRAIN_STEPS, LB_TRAIN_EVAL, LB_TRAIN_BATCH = 100, 50, 64
LB_TIMED_STEPS = 20
LB_V1_PARITY, LB_V1_EVENTS, LB_V1_POST, LB_V1_CHUNK = 8, 250, 256, 50


def _lb_release(torch, path, device):
    from posteriflow_torch.train.checkpoints import load_long_bns
    model, cal, grid = load_long_bns(path, device=device)
    model.eval()
    return model, cal, grid


def _rel(a, b) -> float:
    """max |a - b| over the larger of 1 and the largest |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


def _f32_conditioners(torch, model):
    """The flow's conditioners switched to float32 matmuls (as (c) and (m)
    hold the flagship in float32)."""
    from posteriflow_torch.models.flow import Conditioner
    for mod in model.modules():
        if isinstance(mod, Conditioner):
            mod.compute_dtype = torch.float32
    return model


def _lb_request(torch, model, grid, draws, z):
    """One v4 request on given draws: the tokens with and without the
    signal, the per-event NLL on both (the model's forward is their mean),
    sample_raw with z given; also the labels and both contexts."""
    from posteriflow_torch.models import long_bns as lb
    with torch.no_grad():
        tok, theta, trig = lb.simulate_long_bns_v4_from_draws(draws, grid)
        tok0, _, _ = lb.simulate_long_bns_v4_from_draws(draws, grid, 0.0)
        y_lab = model.scaler.normalize(theta, trig)
        ctx, ctx0 = model.context(tok, trig), model.context(tok0, trig)
        nll = -model.flow.log_prob(y_lab, ctx)
        nll0 = -model.flow.log_prob(y_lab, ctx0)
        th_s, y = model.sample_raw(tok, trig, z=z)
    return {k: v.cpu().numpy() for k, v in (
        ("tok", tok), ("y_lab", y_lab), ("ctx", ctx), ("ctx0", ctx0),
        ("nll", nll), ("nll0", nll0), ("y", y), ("theta", th_s))}


def _lb_flow_on(torch, flow, y_lab, ctx, ctx0, z, dev):
    """The flow alone on given labels and contexts: (NLL, noise-only NLL,
    draws y from z)."""
    t = [torch.from_numpy(a).to(dev) for a in (y_lab, ctx, ctx0)]
    with torch.no_grad():
        y, _ = flow.sample_with_log_prob(z, t[1][:, None, :])
        return {"nll": (-flow.log_prob(t[0], t[1])).cpu().numpy(),
                "nll0": (-flow.log_prob(t[0], t[2])).cpu().numpy(),
                "y": y.cpu().numpy()}


def phase_lb_serve(torch, plain, rqs_cuda, card):
    """(w2) long_bns_v4 served on its stored grid: one request of
    LB_SERVE_EVENTS events from fixed draws (made on the CPU), timed warm
    on the host clock (its outputs come back to the host): the counted
    request and LB_SERVE_REPS more after it, each printed; the NLL on
    the signal tokens and on the noise-only tokens, sample_raw with z
    given; exactly 18 rqs_tile launches (6 + 6 forward, 6 inverse) and no
    plain spline. Card against CPU as (c) holds the flagship: the tokens
    within LB_SERVE_TOL of their largest |value|; as released (bfloat16
    conditioners) the median per-event |ΔNLL| within 0.1 nat and the
    median |Δy| within one bfloat16 step; the contexts within LB_SERVE_TOL
    of their largest |entry|; with float32 conditioners, both flows on the
    CPU's labels and contexts (as (c) runs both on one context: the float32
    chirp phase of the heterodyne and the waveform differs by a few steps
    between the devices, which moves the tokens by ~6e-4 of their largest
    value, and a sampled draw at a steep point of a trained spline carries
    a context's last bits to ~2e-3), the mean NLLs within LB_SERVE_TOL
    (relative to the larger of 1 and the NLL) and the largest |Δy| within
    LB_SERVE_TOL."""
    from posteriflow_torch.models import long_bns as lb
    out = {}
    for dev in ("cpu", DEVICE):
        model, cal, grid = _lb_release(torch, LB_RELEASE, dev)
        draws = lb.draw_long_bns(LB_SERVE_EVENTS, grid["cut"], grid["trunc"],
                                 torch.Generator().manual_seed(21), "cpu")
        draws = lb.LongBNSDraws(*(t.to(dev) for t in draws))
        z = torch.from_numpy(np.random.default_rng(22).standard_normal(
            (LB_SERVE_EVENTS, LB_SERVE_DRAWS, 11)).astype(np.float32)).to(dev)
        _lb_request(torch, model, grid, draws, z)        # warm-up
        counts, restore = _count_plain(torch, plain)
        rqs_cuda.KERNEL.launches = 0
        try:
            t0 = time.perf_counter()
            r = _lb_request(torch, model, grid, draws, z)   # synchronises
            wall = time.perf_counter() - t0
        finally:
            restore()
        launches = rqs_cuda.KERNEL.launches
        walls = [wall]
        for _ in range(LB_SERVE_REPS if dev != "cpu" else 0):
            t0 = time.perf_counter()
            _lb_request(torch, model, grid, draws, z)
            walls.append(time.perf_counter() - t0)
        ref = out.get("cpu", r)
        r.update(wall=wall, launches=launches, plain=dict(counts),
                 f32=_lb_flow_on(torch, _f32_conditioners(torch, model).flow,
                                 ref["y_lab"], ref["ctx"], ref["ctx0"], z,
                                 dev))
        out[dev] = r
        print(f"(w2) long_bns_v4 on {dev}: {LB_SERVE_EVENTS} events, tokens "
              f"{r['tok'].shape} (grid "
              f"{lb.stored_grid_path(cal['tokens']).name}, n_tok "
              f"{grid['n_tok']}), NLL {r['nll'].mean():.5f}, noise-only NLL "
              f"{r['nll0'].mean():.5f} (signal ΔNLL "
              f"{r['nll0'].mean() - r['nll'].mean():.4f}), {LB_SERVE_DRAWS} "
              f"draws an event, {wall * 1e3:.1f} ms (warm requests "
              f"{[round(w * 1e3, 1) for w in walls]} ms, median "
              f"{np.median(walls) * 1e3:.1f}) [{card}]; rqs_tile "
              f"launches {r['launches']}, plain spline {r['plain']}")
    g, c = out[DEVICE], out["cpu"]
    check(g["launches"] == 18, f"(w2) rqs_tile launched {g['launches']} "
                               f"times, expected 18 (6 + 6 + 6)")
    check(g["plain"] == {"forward": 0, "inverse": 0},
          f"(w2) the plain spline ran on the card: {g['plain']}")
    check(all(np.isfinite(g[k]).all() for k in ("tok", "nll", "nll0", "y",
                                                "theta")),
          "(w2) non-finite output on the card")
    gf, cf = g["f32"], c["f32"]
    errs = {"tokens": (_rel(g["tok"], c["tok"]), LB_SERVE_TOL),
            "contexts": (max(_rel(g["ctx"], c["ctx"]),
                             _rel(g["ctx0"], c["ctx0"])), LB_SERVE_TOL),
            "bf16 NLL, median per event": (float(np.median(np.abs(
                g["nll"] - c["nll"]))), 0.1),
            "bf16 noise-only NLL, median per event": (float(np.median(
                np.abs(g["nll0"] - c["nll0"]))), 0.1),
            "bf16 y, median": (float(np.median(np.abs(g["y"] - c["y"]))),
                               2.0 ** -8),
            "f32 NLL": (_rel(gf["nll"].mean(), cf["nll"].mean()),
                        LB_SERVE_TOL),
            "f32 noise-only NLL": (_rel(gf["nll0"].mean(),
                                        cf["nll0"].mean()), LB_SERVE_TOL),
            "f32 y, max": (float(np.abs(gf["y"] - cf["y"]).max()),
                           LB_SERVE_TOL)}
    print(f"(w2) card vs CPU [{card}]: " + "; ".join(
        f"{k} {v:.3e} (tol {t:g})" for k, (v, t) in errs.items())
        + f"; bf16 mean NLL {_rel(g['nll'].mean(), c['nll'].mean()):.3e}, "
        f"noise-only {_rel(g['nll0'].mean(), c['nll0'].mean()):.3e}, "
        f"max |Δy| {np.abs(g['y'] - c['y']).max():.3e} (reported)")
    for k, (v, t) in errs.items():
        check(v <= t, f"(w2) {k} card vs CPU differs by {v}")
    return {"launches": g["launches"],
            "errs": {k: v for k, (v, _) in errs.items()}, "wall": g["wall"]}


def phase_lb_validate(torch, plain, rqs_cuda, card):
    """(w3) tools/validate_long_bns.py on long_bns_v4 at 2000 x 400 in
    chunks of 50: exit 0, the seven gates, exactly 720 rqs_tile launches,
    no plain spline, the statistics within VAL_SIGMAS σ of the JAX report,
    the seconds by part."""
    from posteriflow_torch.tools import validate_long_bns
    ref = json.loads(open(LB_REPORT).read())["metrics"]
    counts, restore = _count_plain(torch, plain)
    rqs_cuda.KERNEL.launches = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            code, report, record = validate_long_bns.run(
                ["--model", LB_RELEASE, "--n-events", str(LB_EVENTS),
                 "--n-post", str(LB_POST), "--chunk", str(LB_CHUNK),
                 "--device", DEVICE, "--out", tmp])
            wall = time.perf_counter() - t0
    finally:
        restore()
    launches = rqs_cuda.KERNEL.launches
    m = report["metrics"]
    n_chunks = LB_EVENTS // LB_CHUNK
    secs = ", ".join(f"{k} {v:.3f}" for k, v in record["seconds"].items())
    print(f"(w3) validate_long_bns {LB_EVENTS} x {LB_POST}, chunks of "
          f"{LB_CHUNK}: exit {code} in {wall:.2f} s [{card}] ({secs} s); "
          f"rqs_tile launches {launches} (expected {18 * n_chunks}); plain "
          f"spline {dict(counts)}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    for c in report["checks"]:
        print(f"(w3)   {c['gate']:<18} {c['value']:.4f} {c['op']} "
              f"{c['threshold']:.4g}: {'PASS' if c['passed'] else 'FAIL'}")
    check(code == 0 and report["passed"], "(w3) long_bns_v4 failed its "
                                          "gates on the card")
    check(len(report["checks"]) == 7, "(w3) not the seven v4 gates")
    check(launches == 18 * n_chunks, f"(w3) rqs_tile launched {launches} "
                                     f"times, expected {18 * n_chunks}")
    check(counts == {"forward": 0, "inverse": 0},
          f"(w3) the plain spline ran: {counts}")
    stats = {}
    for name, key in LB_STATS.items():
        sigma = sigma_of_difference(
            [c[key] if key != "delta" else c["nll_alt"] - c["nll"]
             for c in record["chunks"]])
        z = (m[name] - ref[name]) / sigma
        stats[name] = (m[name], ref[name], sigma, z)
        print(f"(w3)   {name}: {m[name]:.5f} against the JAX report's "
              f"{ref[name]:.5f} ({z:+.2f}σ, σ {sigma:.5f})")
        check(abs(z) <= VAL_SIGMAS, f"(w3) {name} {m[name]} is {z:.2f}σ "
                                    f"from the JAX report's {ref[name]}")
    print(f"(w3)   coverage violations {m['cov50_violations']}/"
          f"{m['cov90_violations']} (JAX {ref['cov50_violations']}/"
          f"{ref['cov90_violations']}), SBC pass {m['sbc_pass_frac']:.3f} "
          f"(KS p {min(m['sbc_ks_p'].values()):.3g}-"
          f"{max(m['sbc_ks_p'].values()):.3g}; JAX "
          f"{min(ref['sbc_ks_p'].values()):.3g}-"
          f"{max(ref['sbc_ks_p'].values()):.3g})")
    return {"launches": launches, "wall": wall, "stats": stats,
            "seconds": record["seconds"]}


def _lb_grads(torch, plain, rqs_cuda, model_sd, batch, dev, switches,
              plain_spline=False, unguarded=False):
    """One full-width v4 loss and its gradient with the flow's conditioners
    in float32 (as (m) holds the flagship): (loss, grads by name, rqs_grad
    launches)."""
    import contextlib

    from posteriflow_torch.models import long_bns as lb
    from posteriflow_torch.train import trainer
    kernel_fwd, guard = rqs_cuda.rqs_forward, trainer.fp32_exact
    _set_switches(torch, switches)
    if plain_spline:
        rqs_cuda.rqs_forward = (lambda x, r, k, tb=TAIL, bias=None:
                                plain.rqs_forward(x, r + bias, k, tb))
    if unguarded:
        trainer.fp32_exact = contextlib.nullcontext
    try:
        model = lb.LongBNSNPEv4(enc={"d_model": 128, "n_layers": 4,
                                     "n_heads": 8, "patch": 4})
        model.load_state_dict(model_sd, strict=True)
        _f32_conditioners(torch, model).to(dev)
        g0 = rqs_cuda.GRAD_KERNEL.launches
        loss = model(*(t.to(dev) for t in batch))
        trainer.backward(loss)
        launched = rqs_cuda.GRAD_KERNEL.launches - g0
    finally:
        rqs_cuda.rqs_forward, trainer.fp32_exact = kernel_fwd, guard
    return (float(loss.detach()),
            {n: p.grad.cpu() for n, p in model.named_parameters()}, launched)


def phase_lb_train(torch, plain, rqs_cuda, card):
    """(w4) tools/train_long_bns.py at the release's config (batch 64, the
    stored grid) from a fresh init for LB_TRAIN_STEPS steps with an
    evaluation every LB_TRAIN_EVAL: the NLL falls, the launches are 6
    forward and 6 backward a step (plus the evaluations' and the
    calibration battery's forward passes), the plain spline never runs;
    then LB_TIMED_STEPS steps split by CUDA events; then one step's
    gradients at full width (float32 conditioners, the release's weights)
    against the card's plain spline, the CPU and the TF32 guard."""
    from posteriflow_torch.models import long_bns as lb
    from posteriflow_torch.tools import train_long_bns as tool
    from posteriflow_torch.train import trainer
    counts, restore = _count_plain(torch, plain)
    rqs_cuda.KERNEL.launches = rqs_cuda.GRAD_KERNEL.launches = 0
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            history, cal, run = tool.run_training(
                ["--outdir", tmp, "--steps", str(LB_TRAIN_STEPS),
                 "--batch", str(LB_TRAIN_BATCH), "--eval-every",
                 str(LB_TRAIN_EVAL), "--device", DEVICE])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        restore()
    fwd, bwd = rqs_cuda.KERNEL.launches, rqs_cuda.GRAD_KERNEL.launches
    n_eval = len(history)
    n_cal = max(1, 256 // LB_TRAIN_BATCH)
    want_fwd = 6 * LB_TRAIN_STEPS + 12 * n_eval + 6 * n_cal
    print(f"(w4) train_long_bns {LB_TRAIN_STEPS} steps at batch "
          f"{LB_TRAIN_BATCH} (grid n_tok {run.grid['n_tok']}, "
          f"{cal['config']['n_params']} parameters) in {wall:.2f} s "
          f"[{card}]: history "
          + ", ".join(f"step {h['step']} train {h['train_nll']:.3f} val "
                      f"{h['val_nll']:.3f} ΔNLL {h['signal_delta']:.3f}"
                      for h in history)
          + f"; rqs_tile {fwd} (expected {want_fwd}: 6 a step, 12 an "
          f"evaluation, 6 a calibration chunk), rqs_grad {bwd} (expected "
          f"{6 * LB_TRAIN_STEPS}); plain spline {dict(counts)}; calibration "
          f"cov violations {cal['cov50_violations']}/"
          f"{cal['cov90_violations']}, SBC {cal['sbc_pass_frac']:.3f}")
    check(fwd == want_fwd and bwd == 6 * LB_TRAIN_STEPS,
          f"(w4) launches {fwd} / {bwd}")
    check(counts == {"forward": 0, "inverse": 0},
          f"(w4) the plain spline ran: {counts}")
    check([h["step"] for h in history] == [1, LB_TRAIN_EVAL, LB_TRAIN_STEPS],
          f"(w4) history steps {[h['step'] for h in history]}")
    check(all(math.isfinite(h["train_nll"]) and math.isfinite(h["val_nll"])
              for h in history), "(w4) non-finite NLL")
    check(history[-1]["train_nll"] < history[0]["train_nll"]
          and history[-1]["val_nll"] < history[0]["val_nll"],
          "(w4) the NLL did not fall")

    # the step split by CUDA events, launches a step
    args = tool._parser().parse_args(["--batch", str(LB_TRAIN_BATCH),
                                      "--steps", str(LB_TRAIN_STEPS)])
    timed = tool.setup(args, torch.device(DEVICE))
    ev = {k: [] for k in ("simulate", "forward", "backward", "optimizer")}
    per_step = []
    t_wall = None
    for i in range(LB_TIMED_STEPS + 1):
        if i == 1:
            torch.cuda.synchronize()
            t_wall = time.perf_counter()
        gen = torch.Generator(device=DEVICE).manual_seed(1000 + i)
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        f0, b0 = rqs_cuda.KERNEL.launches, rqs_cuda.GRAD_KERNEL.launches
        marks[0].record()
        batch = timed.batch_fn(gen)
        marks[1].record()
        loss = timed.model(*batch)
        marks[2].record()
        timed.opt.zero_grad()
        trainer.backward(loss)
        marks[3].record()
        timed.opt.step()
        marks[4].record()
        per_step.append((rqs_cuda.KERNEL.launches - f0,
                         rqs_cuda.GRAD_KERNEL.launches - b0))
        if i:
            torch.cuda.synchronize()
            for k, a, b in zip(ev, marks[:-1], marks[1:]):
                ev[k].append(a.elapsed_time(b))
    torch.cuda.synchronize()
    steps_per_s = LB_TIMED_STEPS / (time.perf_counter() - t_wall)
    split = {k: float(np.median(v)) for k, v in ev.items()}
    print(f"(w4) {LB_TIMED_STEPS} steps at batch {LB_TRAIN_BATCH} "
          f"[{card}]: {steps_per_s:.2f} steps/s (host clock, a "
          f"synchronisation a step for the events), medians by CUDA events: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items())
          + f"; launches a step {sorted(set(per_step))}")
    check(set(per_step) == {(6, 6)}, f"(w4) launches a step {per_step}")

    # one step's gradients at full width
    rel, _, _ = _lb_release(torch, LB_RELEASE, "cpu")
    model_sd = rel.state_dict()
    batch = lb.simulate_long_bns_batch_v4(
        LB_TRAIN_BATCH, timed.grid,
        generator=torch.Generator().manual_seed(23), device="cpu")
    defaults, tf32, off = ("highest", True), ("high", True), ("highest", False)
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    try:
        runs = {"kernels": _lb_grads(torch, plain, rqs_cuda, model_sd, batch,
                                     DEVICE, defaults),
                "plain on the card": _lb_grads(torch, plain, rqs_cuda,
                                               model_sd, batch, DEVICE,
                                               defaults, plain_spline=True),
                "cpu": _lb_grads(torch, plain, rqs_cuda, model_sd, batch,
                                 "cpu", defaults),
                "kernels, TF32 off": _lb_grads(torch, plain, rqs_cuda,
                                               model_sd, batch, DEVICE, off),
                "kernels, TF32 allowed": _lb_grads(torch, plain, rqs_cuda,
                                                   model_sd, batch, DEVICE,
                                                   tf32),
                "control: backward unguarded, TF32 allowed": _lb_grads(
                    torch, plain, rqs_cuda, model_sd, batch, DEVICE, tf32,
                    unguarded=True)}
    finally:
        _set_switches(torch, saved)
    check(runs["kernels"][2] == 6 and runs["plain on the card"][2] == 0,
          f"(w4) backward launches {runs['kernels'][2]} / "
          f"{runs['plain on the card'][2]}")
    strict = "kernels, TF32 off"
    legs = (("kernels", "plain on the card", TRAIN_KERNEL_TOL, "held"),
            ("kernels", "cpu", TRAIN_TOL, "held"),
            ("kernels", strict, TF32_GUARD_TOL, "held"),
            ("kernels, TF32 allowed", strict, TF32_GUARD_TOL, "held"),
            ("control: backward unguarded, TF32 allowed", strict,
             TF32_GUARD_TOL, "control"))
    parity = {}
    for got, ref, tol, role in legs:
        (lg, gg, _), (lr, gr, _) = runs[got], runs[ref]
        worst, name, glob = _leaf_errs(gg, gr)
        d_loss = abs(lg - lr) / max(1.0, abs(lr))
        loss_tol = TRAIN_LOSS_TOL if ref == "cpu" else tol
        parity[f"{got} / {ref}"] = worst
        print(f"(w4) one step's gradients at batch {LB_TRAIN_BATCH}, float32 "
              f"conditioners, {got} against {ref} [{card}]: loss {lg:.6f} "
              f"vs {lr:.6f} (rel {d_loss:.2e}), gradient |Δ|/|g| "
              f"{glob:.2e}, worst leaf {worst:.2e} ({name}); "
              + (f"tol {loss_tol:g} / {tol:g}" if role == "held"
                 else f"control, above {tol:g}"))
        if role == "held":
            check(d_loss <= loss_tol, f"(w4) loss, {got} against {ref}: "
                                      f"{d_loss}")
            check(worst <= tol, f"(w4) leaf {name}, {got} against {ref}: "
                                f"{worst}")
        else:
            check(worst > tol, f"(w4) the TF32 guard's tolerance does not "
                               f"see {got} ({worst:.2e})")
    return {"history": history, "launches": (fwd, bwd), "wall": wall,
            "steps_per_s": steps_per_s, "split": split, "parity": parity}


def phase_lb_v1(torch, plain, rqs_cuda, card):
    """(w5) long_bns_v1: its NLL card against CPU on LB_V1_PARITY events,
    then tools/validate_long_bns.py at LB_V1_EVENTS x LB_V1_POST in chunks
    of LB_V1_CHUNK beside its calibration.json's coverage and SBC, and its
    rqs_tile<8> launches (18 a chunk)."""
    from posteriflow_torch.models import long_bns as lb
    from posteriflow_torch.tools import validate_long_bns
    draws = lb.draw_long_bns(LB_V1_PARITY, lb.band_freqs(64.0, 1024.0).size,
                             None, torch.Generator().manual_seed(31), "cpu")
    nll = {}
    for dev in (DEVICE, "cpu"):
        model, _, _ = _lb_release(torch, LB_V1_RELEASE, dev)
        with torch.no_grad():
            tok, theta = lb.simulate_long_bns_from_draws(
                lb.LongBNSDraws(*(None if t is None else t.to(dev)
                                  for t in draws)))
            nll[dev] = float(model(tok, theta))
    d = _rel(nll[DEVICE], nll["cpu"])
    print(f"(w5) long_bns_v1 NLL on {LB_V1_PARITY} events: card "
          f"{nll[DEVICE]:.5f}, CPU {nll['cpu']:.5f} (rel {d:.2e}, tol "
          f"{LB_SERVE_TOL:g}) [{card}]")
    check(d <= LB_SERVE_TOL, f"(w5) v1 NLL card vs CPU differs by {d}")
    cal = json.loads(open(f"{LB_V1_RELEASE}/calibration.json").read())
    counts, restore = _count_plain(torch, plain)
    rqs_cuda.KERNEL.launches = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            code, report, record = validate_long_bns.run(
                ["--model", LB_V1_RELEASE, "--n-events", str(LB_V1_EVENTS),
                 "--n-post", str(LB_V1_POST), "--chunk", str(LB_V1_CHUNK),
                 "--device", DEVICE, "--out", tmp])
            wall = time.perf_counter() - t0
    finally:
        restore()
    launches = rqs_cuda.KERNEL.launches
    n_chunks = -(-LB_V1_EVENTS // LB_V1_CHUNK)
    m = report["metrics"]
    secs = ", ".join(f"{k} {v:.3f}" for k, v in record["seconds"].items())
    print(f"(w5) validate_long_bns on long_bns_v1, {LB_V1_EVENTS} x "
          f"{LB_V1_POST} in chunks of {LB_V1_CHUNK}: exit {code} in "
          f"{wall:.2f} s ({secs} s), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]; "
          f"rqs_tile<8> launches {launches} (expected {18 * n_chunks}), "
          f"plain spline {dict(counts)}")
    print(f"(w5)   val NLL {m['val_nll']:.4f} (calibration's final val "
          f"{cal['final_val_nll']:.4f}), shuffle ΔNLL "
          f"{m['shuffle_delta_nll']:.4f}; coverage violations "
          f"{m['cov50_violations']}/{m['cov90_violations']} (calibration "
          f"{cal['cov50_violations']}/{cal['cov90_violations']} at "
          f"{cal['n_events']} x {cal['n_post']}), SBC pass "
          f"{m['sbc_pass_frac']:.3f} (calibration {cal['sbc_pass_frac']:.3f})"
          f"; gates: " + ", ".join(
              f"{c['gate']} {'PASS' if c['passed'] else 'FAIL'}"
              for c in report["checks"]))
    check(launches == 18 * n_chunks, f"(w5) rqs_tile<8> launched {launches}"
                                     f" times, expected {18 * n_chunks}")
    check(counts == {"forward": 0, "inverse": 0},
          f"(w5) the plain spline ran: {counts}")
    check(all(math.isfinite(m[k]) for k in ("val_nll", "shuffle_delta_nll",
                                            "dist_corr")),
          "(w5) non-finite v1 statistics")
    return {"launches": launches, "wall": wall, "code": code}


# (x) the release path and the anchors. X_CONFIG is the flagship's YAML
# (configs/npe_r6.yaml); tools/train_npe.py sets total_steps to epochs x
# steps, which must exceed the warmup (optax and the port both raise
# otherwise), so (x2) trains from that YAML with its warmup cut to
# X_WARMUP, written by save_config and read back by the port's reader.
# (x4) runs one anchor at analysis/anchors.json's settings; its holds come
# from the JAX report's five anchors (gaps -0.48 to +8.68 nats, mean JS
# 0.42-0.56, width ratios 0.64-1.41) widened for one fresh noise draw.
# (x5) holds the synthetic evidences to their analytic truths. (x6) runs
# the fusion bound at its defaults (10 batches, the report's) and at
# FUSION_BATCHES, and holds each bin of the long run to
# reports/priority_fusion_bound.json within FUSION_SIGMAS binomial σ of the
# difference of the two estimates (or FUSION_BAND, the wider): the
# report's own bins hold 80-274 pairs (σ 0.05 at the close bins), so the
# long run's share of σ is small and ±FUSION_BAND alone would be a 1.4σ
# test of the report's noise. The defaults run is printed against
# ±FUSION_BAND.
X_CONFIG, X_WARMUP, X_STEPS = "configs/npe_r6.yaml", 2, 5
X_HOOK_EPOCHS = 2
X_BATCH_EVENTS, X_DRAWS = 8, 64
PRIORITY_RELEASE = PRIORITY_RELEASES[0]
ANCHOR, ANCHOR_NLIVE, ANCHOR_MAXITER, ANCHOR_ROWS = \
    "low_mc_razor", 400, 12000, 3000
ANCHOR_GAP, ANCHOR_JS_MAX, ANCHOR_WIDTH = (-3.0, 12.0), 0.75, (0.4, 2.5)
# The tool's importance correction of this anchor's draws ends degenerate
# on the card: 4 stages, Metropolis acceptance ~2%, and a relaxed final hop
# from β 0.069 to 1 that hands ~all the weight to the one entry particle
# whose log(L·π/g0) stands ~7 nats above the rest (473 copies of it pass
# the hop's 10% ESS bar). The JAX package's own importance_correct on the
# same entry cloud does the same (tests/anchor_is_witness.py on the CPU:
# ANCHOR_WITNESS's stages, heaviest particle 0.990 of the weight). So the
# width ratio is held on the tool's run when its heaviest particle holds
# less than ANCHOR_DEGENERATE of the weight; when it holds more (every
# 5-95% width is then 0), the run is held to the witnessed ending instead:
# the same number of stages and a final hop from below β 0.1.
ANCHOR_DEGENERATE, ANCHOR_WITNESS = 0.9, {"stages": 4, "heaviest": 0.990}
LIKE_ROWS, LIKE_REPS = 24, 20
EV_IS_TOL, EV_SMC_SIGMAS, EV_NESTED_TOL = 0.02, 3.0, 0.2
EV_REPORT = "analysis/evidence_validation.json"
FUSION_REPORT = "reports/priority_fusion_bound.json"
FUSION_BAND, FUSION_SIGMAS, FUSION_BATCHES = 0.07, 3.0, 200
# the report's pairs a bin: 80 close (its n_pairs_close); 155 and 274 are
# the denominators of its fractions (142/155 and 271/274 for the params
# oracle)
FUSION_REF_PAIRS = {"[0.0,0.1)": 80, "[0.1,0.3)": 155, "[0.3,1.0)": 274}


def phase_configs(card):
    """(x1) every configs/*.yaml through the port's reader; npe_r6.yaml's
    TrainConfig against the flagship's meta.json."""
    import glob

    from posteriflow_torch.utils.config import load_config, parse_yaml
    paths = sorted(glob.glob("configs/*.yaml"))
    t0 = time.perf_counter()
    for p in paths:
        with open(p) as f:
            parse_yaml(f.read(), p)
        load_config(p)
    read_ms = (time.perf_counter() - t0) * 1e3
    a, b = load_config(X_CONFIG), load_config(RELEASE)
    differ = sorted(f.name for f in dataclasses.fields(a)
                    if getattr(a, f.name) != getattr(b, f.name))
    print(f"(x1) {len(paths)} configs/*.yaml read and built into "
          f"TrainConfigs by the port's reader in {read_ms:.1f} ms [{card}]; "
          f"{X_CONFIG} against {RELEASE}/meta.json: differing fields "
          f"{differ} (lr {a.lr} / {b.lr}, total_steps {a.total_steps} / "
          f"{b.total_steps})")
    check(len(paths) == 12, f"{len(paths)} configs")
    check(differ == ["lr", "total_steps"], f"fields differ: {differ}")
    return a


def phase_train_yaml(torch, plain, rqs_cuda, yaml_cfg, card, bank_dir, tmp):
    """(x2) tools/train_npe.py from the YAML with --init-from, the bank and
    --profile-dir; then fit's hooks on the card."""
    from posteriflow_torch.tools import train_npe
    from posteriflow_torch.train import trainer
    from posteriflow_torch.train.loop import fit
    from posteriflow_torch.utils.config import load_config, save_config
    cfg_path = f"{tmp}/x_config.yaml"
    save_config(dataclasses.replace(yaml_cfg, warmup_steps=X_WARMUP),
                cfg_path)
    check(load_config(cfg_path) == dataclasses.replace(
        yaml_cfg, warmup_steps=X_WARMUP), "save_config -> load_config")
    run, trace_dir = f"{tmp}/x_run", f"{tmp}/x_trace"
    per_step = []
    orig = trainer.train_step

    def counted(state, batch, group=None):
        f0, g0 = rqs_cuda.KERNEL.launches, rqs_cuda.GRAD_KERNEL.launches
        out = orig(state, batch, group)
        per_step.append((rqs_cuda.KERNEL.launches - f0,
                         rqs_cuda.GRAD_KERNEL.launches - g0))
        return out
    counts, restore = _count_plain(torch, plain)
    trainer.train_step = counted
    rqs_cuda.KERNEL.launches = rqs_cuda.GRAD_KERNEL.launches = 0
    try:
        t0 = time.perf_counter()
        hist = train_npe.main([
            "--config", cfg_path, "--outdir", run, "--init-from", RELEASE,
            "--noise-bank", bank_dir, "--epochs", "1", "--steps-per-epoch",
            str(X_STEPS), "--profile-dir", trace_dir, "--device", DEVICE])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        trainer.train_step = orig
        restore()
    launches = (rqs_cuda.KERNEL.launches, rqs_cuda.GRAD_KERNEL.launches)
    trace = f"{trace_dir}/trace.json"
    size = os.path.getsize(trace) if os.path.exists(trace) else 0
    names = {}
    if size:
        with open(trace) as f:
            text = f.read()
        names = {k: text.count(k) for k in ("rqs_tile", "rqs_grad")}
    rec = hist[-1]
    print(f"(x2) tools/train_npe.py --config {X_CONFIG} (warmup "
          f"{X_WARMUP}) --init-from {RELEASE} --noise-bank (u's bank) "
          f"--epochs 1 --steps-per-epoch {X_STEPS} --profile-dir [{card}]: "
          f"{wall:.1f} s with the trace on; train_nll {rec['train_nll']:.4f}"
          f", val_nll {rec['val_nll']:.4f}, real_val_nll "
          f"{rec['real_val_nll']:.4f}, lr_step {rec['lr_step']}; spline "
          f"launches a step (forward, backward) {per_step}, the run's "
          f"{launches}, plain spline calls {counts}; trace {size} B naming "
          f"rqs_tile {names.get('rqs_tile', 0)} and rqs_grad "
          f"{names.get('rqs_grad', 0)} times")
    check(per_step == [(10, 10)] * X_STEPS, f"launches a step {per_step}")
    check(counts == {"forward": 0, "inverse": 0}, f"plain spline {counts}")
    check(rec["lr_step"] == X_STEPS and all(math.isfinite(rec[k]) for k in (
        "train_nll", "val_nll", "real_val_nll")), f"record {rec}")
    check(names.get("rqs_tile", 0) > 0 and names.get("rqs_grad", 0) > 0,
          f"trace {trace} ({size} B) names {names}")

    from posteriflow_torch.physics.simulator import simulate_batch
    from posteriflow_torch.train.trainer import batch_nll
    hook_cfg = dataclasses.replace(yaml_cfg, warmup_steps=1,
                                   total_steps=X_HOOK_EPOCHS + 1)
    seen, recs = {}, []

    def val_batch_fn(gen):
        seen["seed"] = gen.initial_seed()
        seen["batch"] = simulate_batch(FIT_VAL_EVENTS, dataclasses.replace(
            hook_cfg.sim, real_noise_prob=0.0), device=DEVICE, generator=gen)
        return seen["batch"]

    def on_epoch_end(r):
        with open(f"{tmp}/x_hook/history.json") as f:
            written = json.load(f)
        recs.append((r, written[-1]["epoch"]))

    state, history = fit(hook_cfg, f"{tmp}/x_hook", epochs=X_HOOK_EPOCHS,
                         steps_per_epoch=1, n_val_events=FIT_VAL_EVENTS,
                         init_from=RELEASE, device=DEVICE,
                         val_batch_fn=val_batch_fn, on_epoch_end=on_epoch_end)
    with torch.no_grad():
        apart = float(batch_nll(state.model, seen["batch"]))
    print(f"(x2) fit(val_batch_fn=, on_epoch_end=), {X_HOOK_EPOCHS} epochs x "
          f"1 step, {FIT_VAL_EVENTS} validation events from the function's "
          f"generator (seed {seen['seed']}) [{card}]: the hook fired "
          f"{len(recs)} times, after history.json held epochs "
          f"{[e for _, e in recs]}; val_nll {history[-1]['val_nll']!r}, "
          f"batch_nll on the function's batch apart {apart!r}")
    check([r for r, _ in recs] == history
          and [e for _, e in recs] == list(range(1, X_HOOK_EPOCHS + 1)),
          "on_epoch_end")
    check(history[-1]["val_nll"] == apart,
          f"val_nll {history[-1]['val_nll']} != {apart}")
    return {"run": run, "launches": launches, "per_step": per_step,
            "wall": wall, "trace_bytes": size}


def _sha(data: bytes) -> str:
    import hashlib
    return hashlib.sha256(data).hexdigest()


def phase_export(torch, train, yaml_cfg, card, tmp):
    """(x3) tools/export_release.py on (x2)'s run; the export against the
    checkpoint on the card; released models re-exported byte for byte;
    LeanNPE.sample / .nll against encode + *_from_context."""
    from posteriflow_torch.physics.simulator import simulate_batch
    from posteriflow_torch.tools import export_release
    from posteriflow_torch.train.checkpoints import (CheckpointManager,
                                                     state_dict_to_flax)
    from posteriflow_torch.train.train_priority import load_priority_net
    from posteriflow_torch.train.trainer import batch_nll
    from posteriflow_torch.utils.config import load_config
    from posteriflow_torch.utils.msgpack_lite import packb
    out = f"{tmp}/x_release"
    t0 = time.perf_counter()
    export_release.main(["--ckpt", f"{train['run']}/ckpt", "--run-dir",
                         train["run"], "--out", out, "--init-from", RELEASE,
                         "--device", DEVICE])
    export_s = time.perf_counter() - t0
    model, cfg, meta = CheckpointManager.load_release(out, device=DEVICE)
    state, _, _ = CheckpointManager(f"{train['run']}/ckpt").restore(
        "best", device=DEVICE)
    ref = state.model.eval()
    sim = dataclasses.replace(cfg.sim, real_noise_prob=0.0)
    gen = torch.Generator(device=DEVICE).manual_seed(41)
    batch = simulate_batch(X_BATCH_EVENTS, sim, device=DEVICE, generator=gen)
    z = torch.randn((X_BATCH_EVENTS, X_DRAWS, cfg.npe.n_params),
                    generator=gen, device=DEVICE)
    rank = torch.zeros(X_BATCH_EVENTS, dtype=torch.long, device=DEVICE)
    with torch.no_grad():
        nll = [batch_nll(m, batch) for m in (model, ref)]
        ctx = [m.encode(batch.strain, batch.asd_bands) for m in (model, ref)]
        draws = [m.sample_from_context(c, rank, X_DRAWS, z=z)[0]
                 for m, c in zip((model, ref), ctx)]
        theta = batch.params[:, 0]
        s_nll = model.nll(batch.strain, theta, rank, batch.asd_bands)
        s_draws = model.sample(batch.strain, 0, X_DRAWS, batch.asd_bands,
                               z=z)
        f_nll = model.nll_from_context(ctx[0], theta, rank)
    torch.cuda.synchronize()
    same_export = bool(torch.equal(nll[0], nll[1])
                       and torch.equal(draws[0], draws[1]))
    same_entry = bool(torch.equal(s_nll, f_nll)
                      and torch.equal(s_draws, draws[0]))
    print(f"(x3) tools/export_release.py on (x2)'s run in {export_s:.2f} s "
          f"[{card}]: meta keys {sorted(meta)}, init_from "
          f"{meta['metrics'].get('init_from')}, files "
          f"{sorted(os.listdir(out))}; CheckpointManager.load_release of the"
          f" export against the checkpoint on the card, {X_BATCH_EVENTS} "
          f"events: batch_nll {float(nll[0])!r} / {float(nll[1])!r}, "
          f"{X_DRAWS} draws with fixed z bit-equal: {same_export}; "
          f"LeanNPE.nll / .sample against encode + *_from_context bit-equal:"
          f" {same_entry}")
    check(same_export, "the export differs from its checkpoint")
    check(same_entry, "LeanNPE.sample / .nll differ from their parts")
    check(cfg == load_config(f"{train['run']}/ckpt/best"),
          "the export's config")

    shas = {}
    for name, (got, path) in {
        "npe_r7_best": (packb(state_dict_to_flax(
            CheckpointManager.load_release(RELEASE, device=DEVICE)[0])),
            f"{RELEASE}/params.msgpack"),
        "priority_v7": (packb(state_dict_to_flax(load_priority_net(
            PRIORITY_RELEASE, device=DEVICE))),
            f"{PRIORITY_RELEASE}/priority_params.msgpack")}.items():
        with open(path, "rb") as f:
            committed = f.read()
        shas[name] = (_sha(got), _sha(committed), len(got))
        print(f"(x3) {name} loaded on the card and exported again: sha256 "
              f"{shas[name][0]} ({len(got)} B), committed "
              f"{shas[name][1]}")
        check(got == committed, f"{name} re-export differs")
    return {"shas": shas, "export_s": export_s}


def _kernel_counts(torch, fn):
    """(kernels, copies and sets) the device runs in one fn() call, by the
    profiler (None without CUPTI)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except RuntimeError:
        return None
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    mem = sum(1 for e in evs if e.name.startswith(("Memcpy", "Memset")))
    return len(evs) - mem, mem


def phase_anchor(torch, plain, rqs_cuda, card, tmp):
    """(x4) one likelihood call at the sampler's 24 rows;
    tools/make_anchors.py on one anchor at the report's settings, the
    launches by part, and the tool's importance correction's cloud."""
    from posteriflow_torch.inference import dynesty_bridge, importance
    from posteriflow_torch.inference.dynesty_bridge import prior_transform
    from posteriflow_torch.inference.importance import \
        make_marginalized_log_likelihood
    from posteriflow_torch.inference.pipeline import InferenceEngine
    from posteriflow_torch.tools import make_anchors
    engine = InferenceEngine.from_checkpoint(RELEASE, device=DEVICE)
    spec = next(s for s in make_anchors.ANCHORS if s["name"] == ANCHOR)
    _, prepared = make_anchors._prepare(engine, spec)
    log_l = make_marginalized_log_likelihood(prepared.strain, device=DEVICE)
    theta = prior_transform(np.random.default_rng(5).uniform(
        size=(LIKE_ROWS, engine.cfg.n_params))).astype(np.float32)
    like_ms = cuda_time_ms(lambda: log_l(theta), reps=LIKE_REPS)
    like_ops = _kernel_counts(torch, lambda: log_l(theta))
    print(f"(x4) one likelihood call at the sampler's {LIKE_ROWS} rows "
          f"(numpy in, numpy out) [{card}]: {like_ms:.3f} ms by CUDA events "
          f"over {LIKE_REPS} calls; "
          + ("device operations not measured" if like_ops is None else
             f"{like_ops[0]} kernels and {like_ops[1]} copies or sets a "
             f"call") + ", before the anchor")

    parts = {}
    run_dynesty, correct = dynesty_bridge.run_dynesty, \
        importance.importance_correct

    def timed(name, fn):
        def inner(*a, **kw):
            n0, t0 = rqs_cuda.KERNEL.launches, time.perf_counter()
            out = fn(*a, **kw)
            parts[name] = (rqs_cuda.KERNEL.launches - n0,
                           time.perf_counter() - t0, out)
            return out
        return inner
    dynesty_bridge.run_dynesty = timed("nested", run_dynesty)
    importance.importance_correct = timed("is", correct)
    counts, restore = _count_plain(torch, plain)
    rqs_cuda.KERNEL.launches = 0
    try:
        rep = make_anchors.main([
            "--only", ANCHOR, "--nlive", str(ANCHOR_NLIVE), "--maxiter",
            str(ANCHOR_MAXITER), "--n-samples", str(ANCHOR_ROWS), "--out",
            f"{tmp}/x_anchors.json", "--device", DEVICE])
    finally:
        dynesty_bridge.run_dynesty = run_dynesty
        importance.importance_correct = correct
        restore()
    total = rqs_cuda.KERNEL.launches
    e = rep["anchors"][ANCHOR]
    ns = parts["nested"][2]
    stages = parts["is"][2].n_stages
    batch = max(1, min(24, ANCHOR_NLIVE // 16))
    iters = (ns["n_like_calls"] - ANCHOR_NLIVE) // (ns["walks"] * batch)
    layers = 10
    want = layers + 2 * layers + 10 * layers * (stages - 1)
    npe_launches = total - parts["nested"][0] - parts["is"][0]
    js, width = e["summary_is"]["mean_js"], e["summary_is"][
        "mean_width_ratio"]
    nested_ms = parts["nested"][1] / (iters * ns["walks"] + 1) * 1e3
    print(f"(x4) tools/make_anchors.py --only {ANCHOR} --nlive "
          f"{ANCHOR_NLIVE} --maxiter {ANCHOR_MAXITER} --n-samples "
          f"{ANCHOR_ROWS} [{card}]: {e['t_total_s']} s (NPE {e['t_npe_s']} "
          f"s, nested {e['t_nested_s']} s, IS {e['is']['t_is_s']:.2f} s); "
          f"nested logZ {e['sampler']['logz']:.3f} after {iters} of "
          f"{ANCHOR_MAXITER // batch} iterations, "
          f"{e['sampler']['n_like_calls']} likelihood rows in "
          f"{iters * ns['walks'] + 1} calls, {nested_ms:.2f} ms a call with "
          f"the sampler's host work"
          f"; IS logZ {e['is']['logz']:.3f} (ESS {e['is']['ess']:.1f}, "
          f"{stages} stages); gap {e['logz_gap_is_minus_sampler']:+.3f} "
          f"nats (band {ANCHOR_GAP}); summary_is mean JS {js:.4f} (<= "
          f"{ANCHOR_JS_MAX}), mean width ratio {width:.4f}; summary_npe "
          f"mean JS {e['summary_npe']['mean_js']:.4f}, width "
          f"{e['summary_npe']['mean_width_ratio']:.4f}; rqs_tile launches "
          f"{total}: request {npe_launches}, nested {parts['nested'][0]}, "
          f"IS {parts['is'][0]} (expected {layers} + {want - layers}); "
          f"plain spline {counts}")
    check(iters < ANCHOR_MAXITER // batch, "the nested run hit maxiter")
    check(ANCHOR_GAP[0] <= e["logz_gap_is_minus_sampler"] <= ANCHOR_GAP[1],
          f"logZ gap {e['logz_gap_is_minus_sampler']}")
    check(js <= ANCHOR_JS_MAX, f"summary_is JS {js}")
    check(parts["nested"][0] == 0 and npe_launches == layers
          and total == want, f"launches {total} ({npe_launches}, "
          f"{parts['nested'][0]}, {parts['is'][0]}), expected {want}")
    check(counts == {"forward": 0, "inverse": 0}, f"plain spline {counts}")

    distinct, heaviest = _cloud_weights(parts["is"][2])
    ladder = parts["is"][2].beta_ladder
    print(f"(x4) the tool's importance correction [{card}]: ladder {ladder}, "
          f"Metropolis acceptance {parts['is'][2].mcmc_acceptance}; "
          f"{distinct} distinct particles, the heaviest holding "
          f"{heaviest:.4f} of the weight ("
          + ("degenerate: held to the JAX package's run on the same draws, "
             f"{ANCHOR_WITNESS}" if heaviest >= ANCHOR_DEGENERATE else
             f"width ratio {width:.4f} held in {ANCHOR_WIDTH}") + ")")
    if heaviest >= ANCHOR_DEGENERATE:
        check(stages == ANCHOR_WITNESS["stages"] and len(ladder) >= 2
              and ladder[-2] < 0.1, f"a degenerate IS cloud that is not "
              f"the witnessed one: ladder {ladder}")
    else:
        check(ANCHOR_WIDTH[0] <= width <= ANCHOR_WIDTH[1],
              f"summary_is width ratio {width}")

    return {"launches": total, "entry": e, "iterations": iters,
            "like_ms": like_ms, "like_ops": like_ops,
            "nested_ms_a_call": nested_ms}


def anchor_rows_timing(torch, plain, rqs_cuda, card):
    """(x4) rqs_tile inverse at the anchor request's rows beside its
    bound, after (x2)'s trace."""
    x, raw, bias = spline_inputs(torch, ANCHOR_ROWS, seed=ANCHOR_ROWS)
    t = forward_timing(torch, plain, rqs_cuda, x, raw, bias, inverse=True)
    print(f"(x4) rqs_tile<{K_BINS}, inverse, bias> at the anchor request's "
          f"{ANCHOR_ROWS} rows [{card}]: "
          + ("not measured" if t["ms"] is None else
             f"{t['ms'] * 1e3:.2f} us")
          + f" (profiler), {t['events_ms'] * 1e3:.2f} us by CUDA events back"
          f" to back, plain {t['plain_ms'] * 1e3:.1f} us; bound "
          f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}: "
          f"{rqs_bytes(ANCHOR_ROWS, D_TR, K_BINS)} B)")
    return t


def _cloud_weights(res):
    """An ISResult -> (its distinct particles, the weight of the heaviest,
    copies summed)."""
    w = np.asarray(res.weights, np.float64)
    _, inv = np.unique(np.asarray(res.samples), axis=0, return_inverse=True)
    mass = np.bincount(inv.ravel(), weights=w / w.sum())
    return int(mass.size), float(mass.max())


def phase_evidence(card, tmp):
    """(x5) tools/evidence_validation.py Parts A and C against the
    analytic truths and the JAX report."""
    from posteriflow_torch.tools import evidence_validation
    with open(EV_REPORT) as f:
        ref = json.load(f)
    t0 = time.perf_counter()
    rep = evidence_validation.main(["--device", DEVICE, "--out",
                                    f"{tmp}/x_evidence.json"])
    wall = time.perf_counter() - t0
    out = {}
    for part in ("synthetic", "synthetic_15d"):
        p = rep[part]
        is_bias = p["is_good_proposal"]["bias"]
        smc = p["prior_smc_vs_walk_length"][-1]
        print(f"(x5) {part} [{card}]: truth logZ {p['truth_logz']:.6f}; "
              f"matched-proposal IS bias {is_bias:+.5f} (JAX "
              f"{ref[part]['is_good_proposal']['bias']:+.5f}, |Δ logz_mean| "
              f"{abs(p['is_good_proposal']['logz_mean'] - ref[part]['is_good_proposal']['logz_mean']):.2e}"
              f"); prior-SMC biases by n_mcmc "
              + ", ".join(f"{r['n_mcmc']}: {r['bias']:+.3f} ± "
                          f"{r['logz_std']:.3f} ({r['wall_s']} s)"
                          for r in p["prior_smc_vs_walk_length"]))
        check(abs(is_bias) <= EV_IS_TOL, f"{part} IS bias {is_bias}")
        check(abs(smc["bias"]) <= EV_SMC_SIGMAS * smc["logz_std"],
              f"{part} prior-SMC at n_mcmc {smc['n_mcmc']}: {smc['bias']} "
              f"beyond {EV_SMC_SIGMAS} x {smc['logz_std']}")
        out[part] = {"is_bias": is_bias, "smc_bias": smc["bias"],
                     "smc_std": smc["logz_std"]}
    nested = rep["synthetic_15d"]["nested_vs_nlive"]
    print(f"(x5) 15-D nested by nlive [{card}]: "
          + ", ".join(f"{r['nlive']}: bias {r['bias']:+.4f} "
                      f"({r['n_like_calls']} rows, {r['wall_s']} s)"
                      for r in nested) + f"; the tool {wall:.1f} s")
    check(abs(nested[-1]["bias"]) <= EV_NESTED_TOL,
          f"nested at nlive {nested[-1]['nlive']}: {nested[-1]['bias']}")
    out["nested"] = nested
    out["wall"] = wall
    return out


def phase_fusion(card, tmp):
    """(x6) tools/priority_fusion_bound.py at its defaults and at
    FUSION_BATCHES against reports/priority_fusion_bound.json."""
    from posteriflow_torch.tools import priority_fusion_bound
    with open(FUSION_REPORT) as f:
        ref = json.load(f)["pairwise_acc_by_target_sep"]
    reps, walls = {}, {}
    for n in (None, FUSION_BATCHES):
        t0 = time.perf_counter()
        reps[n] = priority_fusion_bound.main(
            ["--device", DEVICE, "--out", f"{tmp}/x_fusion_{n}.json"]
            + ([] if n is None else ["--n-batches", str(n)]))
        walls[n] = time.perf_counter() - t0
    got, pairs = (reps[FUSION_BATCHES]["pairwise_acc_by_target_sep"],
                  reps[FUSION_BATCHES]["n_pairs_by_target_sep"])
    bad = []
    for ch in priority_fusion_bound.CHANNELS:
        for b, r in ref[ch].items():
            g, g0 = got[ch][b], reps[None]["pairwise_acc_by_target_sep"][
                ch][b]
            p = 0.5 * (g + r)
            sigma = math.sqrt(p * (1 - p) * (1 / FUSION_REF_PAIRS[b]
                                             + 1 / pairs[b]))
            band = max(FUSION_BAND, FUSION_SIGMAS * sigma)
            print(f"(x6) {ch} {b} [{card}]: {g:.4f} on {pairs[b]} pairs "
                  f"({FUSION_BATCHES} batches; JAX {r:.4f} on "
                  f"{FUSION_REF_PAIRS[b]}), |Δ| {abs(g - r):.4f} held "
                  f"within {band:.4f} (σ of the difference {sigma:.4f}); "
                  f"at the defaults {g0:.4f} on "
                  f"{reps[None]['n_pairs_by_target_sep'][b]} pairs, |Δ| "
                  f"{abs(g0 - r):.4f}, within ±{FUSION_BAND}: "
                  f"{abs(g0 - r) <= FUSION_BAND}")
            if abs(g - r) > band:
                bad.append((ch, b, g, r))
    print(f"(x6) the tool at its defaults ({reps[None]['n_batches']} "
          f"batches) in {walls[None]:.2f} s, at {FUSION_BATCHES} batches in "
          f"{walls[FUSION_BATCHES]:.2f} s [{card}]")
    check(not bad, f"fusion bound bins outside their bands: {bad}")
    return {"got": got, "pairs": pairs, "wall": walls[None],
            "wall_long": walls[FUSION_BATCHES]}



# ── (y) data and sequence parallelism, and the rest of long-BNS ──────────
# The ranks: one a card, at most Y_MAX_WORLD, NCCL; at world 1 the rank is
# this process (a group of one), above it processes spawned per card. The
# sharded paths at world 1 are held bit-equal to the same calls without a
# group. Above world 1, and in (y7)'s two gloo processes on one card, they
# run the float32 variant of each model (where "data" splits a batch, each
# rank rounds its share of a bfloat16 conditioner's weight gradient before
# the sum) and are held to the bars (m) and (w4) hold float32 computations
# of one step on other kernels to (the card against the CPU): the loss
# within TRAIN_LOSS_TOL of the larger of 1 and |loss|, each gradient and
# parameter leaf within TRAIN_TOL of its largest entry after TRAIN_GRAD_ABS
# of the largest entry of any leaf. A rank's smaller batch takes other
# float32 kernels: on the CPU the flagship encoder's context moves by 8e-7
# of its largest entry between 2 and 4 rows, and the flow carries that to
# 6e-5 of the loss and 1.4e-4 of a conditioner's gradient leaf, past the
# CPU tests' bars for their small models (tests/test_torch_dist_*.py).
Y_MAX_WORLD = 4
Y_STEPS, Y_TIMED_STEPS, Y_FIT_STEPS = 2, 10, 5
Y_LB_BATCH, Y_LB_STEPS, Y_LB_EVAL, Y_LB_CAL = 64, 20, 10, 64
Y_V3_STEPS, Y_V3_EVAL, Y_V3_BATCH, Y_V3_CAL = 100, 50, 16, 64
Y_V3_VAL = (100, 100, 50)              # validation: events, draws, chunk
Y_V3_SIM = 4                           # events card against CPU
Y_V3_K = 8           # JAX's LongBNSNPE default: v3 ignores --flow-bins
Y_V3_ROWS = (Y_V3_BATCH, Y_V3_VAL[2] * Y_V3_VAL[1])
Y7_WORLD = 2
Y_PARTS = ("steps", "fit", "decompose", "lb", "lb_train")
Y7_PARTS = ("steps_f32", "fit", "lb_f32", "lb_train")
Y_LB_RELEASES = (LB_RELEASE, "model_release/long_bns_v4_mesh_ft")


def _f32_npe(cfg):
    """cfg with the flagship's flow and encoder matmuls in float32."""
    return dataclasses.replace(cfg, npe=dataclasses.replace(
        cfg.npe, flow_dtype="float32", encoder_dtype="float32"))


def _y_state(torch, cfg, dev):
    """A TrainState of cfg on `dev` holding the release's weights."""
    from posteriflow_torch.train.checkpoints import load_release
    from posteriflow_torch.train.loop import _merge_params
    from posteriflow_torch.train.trainer import init_state
    state = init_state(cfg, generator=torch.Generator().manual_seed(0),
                       device=dev)
    merged, kept, total = _merge_params(state.model.state_dict(),
                                        load_release(RELEASE)[0])
    check(kept == total, f"init-from transferred {kept}/{total} leaves")
    state.model.load_state_dict(merged)
    return state


def y_flagship_steps(torch, plain, rqs_cuda, cfg, mesh, dev, timed=True):
    """(y2) Y_STEPS steps of make_train_step(cfg, mesh=mesh) from the
    release's weights, generators seeded 70, 71, ...: each step's NLL,
    gradient leaves (after the clip) and parameters, its launches; then,
    if `timed`, Y_TIMED_STEPS steps on the host clock."""
    from posteriflow_torch.train.trainer import make_train_step
    state = _y_state(torch, cfg, dev)
    step = make_train_step(cfg, mesh=mesh)
    counts, restore = _count_plain(torch, plain)
    out = {"nll": [], "grads": [], "params": [], "launches": [],
           "steps_per_s": None}
    try:
        for i in range(Y_STEPS + (Y_TIMED_STEPS if timed else 0)):
            if i == Y_STEPS:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            f0, b0 = rqs_cuda.KERNEL.launches, rqs_cuda.GRAD_KERNEL.launches
            m = step(state, torch.Generator(device=dev).manual_seed(70 + i))
            out["launches"].append((rqs_cuda.KERNEL.launches - f0,
                                    rqs_cuda.GRAD_KERNEL.launches - b0))
            if i < Y_STEPS:
                out["nll"].append(float(m["nll"]))
                out["grads"].append({n: p.grad.detach().cpu() for n, p in
                                     state.model.named_parameters()})
                out["params"].append({n: p.detach().cpu() for n, p in
                                      state.model.named_parameters()})
        if timed:
            torch.cuda.synchronize()
            out["steps_per_s"] = Y_TIMED_STEPS / (time.perf_counter() - t0)
    finally:
        restore()
    out["plain"] = dict(counts)
    return out


def y_fit(torch, rqs_cuda, cfg, mesh, dev, outdir):
    """(y2) fit(mesh=) 1 epoch x Y_FIT_STEPS from the release, then
    resumed for one more epoch: the histories and the launches."""
    from posteriflow_torch.train.loop import fit
    f0, b0 = rqs_cuda.KERNEL.launches, rqs_cuda.GRAD_KERNEL.launches
    _, hist = fit(cfg, outdir, epochs=1, steps_per_epoch=Y_FIT_STEPS,
                  n_val_events=FIT_VAL_EVENTS, init_from=RELEASE,
                  device=dev, mesh=mesh)
    launches = (rqs_cuda.KERNEL.launches - f0,
                rqs_cuda.GRAD_KERNEL.launches - b0)
    _, hist2 = fit(cfg, outdir, epochs=1, steps_per_epoch=Y_FIT_STEPS,
                   n_val_events=FIT_VAL_EVENTS, device=dev, mesh=mesh,
                   resume_from=f"{outdir}/ckpt/last")
    return {"hist": hist, "hist2": hist2, "launches": launches}


def y_decompose(torch, plain, rqs_cuda, model, train_cfg, sim_cfg, mesh,
                dev):
    """(y3) make_batched_decompose(mesh=) on (s)'s events and base draws
    (a generator seeded OVERLAP_SEED simulates them, then draws the
    stages' z): the outputs, the launches and their row counts."""
    from posteriflow_torch.core.pod import make_batched_decompose
    from posteriflow_torch.physics.simulator import simulate_batch
    gen = torch.Generator(device=dev).manual_seed(OVERLAP_SEED)
    ev = simulate_batch(POD_EVENTS, sim_cfg, device=dev, generator=gen)
    decompose = make_batched_decompose(
        train_cfg, n_samples=POD_SAMPLES, max_stages=POD_STAGES,
        n_template_draws=POD_TEMPLATES, mesh=mesh)
    rows = []
    launch = rqs_cuda.KERNEL.launch

    def recording(x, *a, **k):
        rows.append(int(x.shape[0]))
        return launch(x, *a, **k)
    counts, restore = _count_plain(torch, plain)
    rqs_cuda.KERNEL.launch = recording
    try:
        out = decompose(model, ev.strain, ev.asd_bands, generator=gen)
        torch.cuda.synchronize()
    finally:
        rqs_cuda.KERNEL.launch = launch
        restore()
    return {"out": {k: v.cpu() for k, v in out.items()}, "rows": rows,
            "plain": dict(counts)}


def _y_lb_batch(torch, grid, dev):
    from posteriflow_torch.models import long_bns as lb
    return lb.simulate_long_bns_batch_v4(
        Y_LB_BATCH, grid, generator=torch.Generator(device=dev).manual_seed(
            31), device=dev)


def y_lb_loss(torch, plain, rqs_cuda, path, mesh, dev, f32=False):
    """(y4) the release at `path` on a Y_LB_BATCH-event v4 batch: its
    context and loss through make_sharded_encoder / make_sharded_nll_v4 on
    `mesh` (the model's own with None), the gradients summed over every
    rank, the launches."""
    from posteriflow_torch.models import long_bns as lb
    from posteriflow_torch.parallel.mesh import all_reduce_grads
    from posteriflow_torch.train.trainer import backward
    model, cal, grid = _lb_release(torch, path, dev)
    if f32:
        _f32_conditioners(torch, model)
    tokens, theta, trig = _y_lb_batch(torch, grid, dev)
    counts, restore = _count_plain(torch, plain)
    f0, b0 = rqs_cuda.KERNEL.launches, rqs_cuda.GRAD_KERNEL.launches
    try:
        if mesh is None:
            with torch.no_grad():
                ctx = model.encoder(tokens)
            loss = model(tokens, theta, trig)
        else:
            _, apply_fn, _ = lb.make_sharded_encoder(
                mesh, tokens.shape[1], tokens.shape[2], cal["enc"])
            with torch.no_grad():
                ctx = apply_fn(model.encoder, tokens)
            loss = lb.make_sharded_nll_v4(mesh, tokens.shape[1], model)(
                model, tokens, theta, trig)
        backward(loss)
        if mesh is not None:
            all_reduce_grads(list(model.parameters()), None)
        torch.cuda.synchronize()
    finally:
        restore()
    return {"ctx": ctx.cpu(), "loss": float(loss.detach()),
            "grads": {n: p.grad.cpu() for n, p in model.named_parameters()},
            "launches": (rqs_cuda.KERNEL.launches - f0,
                         rqs_cuda.GRAD_KERNEL.launches - b0),
            "plain": dict(counts)}


def y_lb_train(torch, plain, rqs_cuda, world, dev, outdir):
    """(y4) tools/train_long_bns.py --mesh world at the release's config
    (batch 64, the stored grid) for Y_LB_STEPS steps, on this rank."""
    from posteriflow_torch.tools import train_long_bns as tool
    counts, restore = _count_plain(torch, plain)
    f0, b0 = rqs_cuda.KERNEL.launches, rqs_cuda.GRAD_KERNEL.launches
    t0 = time.perf_counter()
    try:
        hist, cal, _ = tool.run_training(
            ["--outdir", outdir, "--steps", str(Y_LB_STEPS), "--batch",
             str(Y_LB_BATCH), "--eval-every", str(Y_LB_EVAL),
             "--cal-events", str(Y_LB_CAL), "--cal-post", "64",
             "--mesh", str(world), "--device", str(dev)])
        torch.cuda.synchronize()
    finally:
        restore()
    return {"hist": hist, "cal": cal, "seconds": time.perf_counter() - t0,
            "launches": (rqs_cuda.KERNEL.launches - f0,
                         rqs_cuda.GRAD_KERNEL.launches - b0),
            "plain": dict(counts)}


def y_rank_work(torch, plain, rqs_cuda, world, dev, cfg, train_cfg,
                sim_cfg, tmp, parts, model=None):
    """The parts of (y2)-(y4) named in `parts`, run as one rank: the
    flagship and the decompose on a ('data' world, 'model' 1) mesh, the
    long-BNS losses on ('data' 1, 'model' world). `model` is the served
    flagship for the decompose (the release loaded here when None)."""
    from posteriflow_torch.inference.pipeline import load_model
    from posteriflow_torch.parallel.mesh import make_mesh
    mesh, seq_mesh = make_mesh(), make_mesh(model_parallel=world)
    out = {"mesh": tuple(mesh.shape), "seq_mesh": tuple(seq_mesh.shape)}
    if "steps" in parts:
        out["steps"] = y_flagship_steps(torch, plain, rqs_cuda, cfg, mesh,
                                        dev)
    if "steps_f32" in parts:
        out["steps_f32"] = y_flagship_steps(torch, plain, rqs_cuda,
                                            _f32_npe(cfg), mesh, dev, False)
    if "fit" in parts:
        out["fit"] = y_fit(torch, rqs_cuda, cfg, mesh, dev, f"{tmp}/fit")
    if "decompose" in parts:
        if model is None:
            model = load_model(RELEASE, device=dev).model
        out["decompose"] = y_decompose(torch, plain, rqs_cuda, model,
                                       train_cfg, sim_cfg, mesh, dev)
    for key, f32 in (("lb", False), ("lb_f32", True)):
        if key in parts:
            out[key] = {p: y_lb_loss(torch, plain, rqs_cuda, p, seq_mesh,
                                     dev, f32=f32) for p in Y_LB_RELEASES}
    if "lb_train" in parts:
        out["lb_train"] = y_lb_train(torch, plain, rqs_cuda, world, dev,
                                     f"{tmp}/lb")
    return out


def _y_child(rank, world, cfg, train_cfg, sim_cfg, tmp, parts):
    """A rank spawned for (y) (above world 1, and (y7)) in a group that
    parallel/mesh.run_ranks made: runs its parts of (y2)-(y4) with the
    files they write under tmp/shared, and saves its results to
    tmp/rank<r>.pt."""
    import torch

    from posteriflow_torch.ops import rqs as plain
    from posteriflow_torch.ops import rqs_cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE, torch.cuda.current_device())
    rqs_cuda.KERNEL.load()
    out = y_rank_work(torch, plain, rqs_cuda, world, dev, cfg, train_cfg,
                      sim_cfg, f"{tmp}/shared", parts)
    torch.save(out, f"{tmp}/rank{rank}.pt")


def _y_spawn(torch, world, backend, cfg, train_cfg, sim_cfg, tmp, parts):
    """Run _y_child on `world` new processes (parallel/mesh.run_ranks,
    `backend` on the card(s)); their results by rank."""
    from posteriflow_torch.parallel.mesh import run_ranks
    os.makedirs(f"{tmp}/shared", exist_ok=True)
    check(run_ranks(_y_child, world, DEVICE, (world, cfg, train_cfg, sim_cfg,
                                              tmp, parts),
                    backend=backend, tmpdir=tmp),
          "(y) this process is a rank already: no ranks were spawned")
    return [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
            for r in range(world)]


def _y_bitequal(got: dict, ref: dict) -> bool:
    import torch
    return set(got) == set(ref) and all(torch.equal(got[n], ref[n])
                                        for n in ref)


def _y_hold_steps(got, ref, label, exact):
    """(y2) a rank's steps against the unsharded ones."""
    for i in range(Y_STEPS):
        if exact:
            ok = (got["nll"][i] == ref["nll"][i]
                  and _y_bitequal(got["grads"][i], ref["grads"][i])
                  and _y_bitequal(got["params"][i], ref["params"][i]))
            check(ok, f"{label} step {i}: not bit-equal to the unsharded "
                      f"step ({got['nll'][i]} vs {ref['nll'][i]})")
        else:
            d = abs(got["nll"][i] - ref["nll"][i]) / max(1.0,
                                                         abs(ref["nll"][i]))
            g, gn, _ = _leaf_errs(got["grads"][i], ref["grads"][i])
            p, pn, _ = _leaf_errs(got["params"][i], ref["params"][i])
            print(f"{label} step {i}: NLL {got['nll'][i]:.6f} against "
                  f"{ref['nll'][i]:.6f} ({d:.2e}, tol {TRAIN_LOSS_TOL:g}), "
                  f"worst gradient leaf {g:.2e} ({gn}), parameter leaf "
                  f"{p:.2e} ({pn}), tol {TRAIN_TOL:g}")
            check(d <= TRAIN_LOSS_TOL and g <= TRAIN_TOL and p <= TRAIN_TOL,
                  f"{label} step {i}: {d}, {g}, {p}")
    check(got["plain"] == {"forward": 0, "inverse": 0},
          f"{label}: the plain spline ran: {got['plain']}")


def _y_hold_lb(got, ref, label, exact):
    """(y4) a rank's sharded long-BNS loss against the unsharded one."""
    if exact:
        ok = (got["loss"] == ref["loss"]
              and _y_bitequal({"ctx": got["ctx"], **got["grads"]},
                              {"ctx": ref["ctx"], **ref["grads"]}))
        check(ok, f"{label}: not bit-equal to the unsharded loss "
                  f"({got['loss']} vs {ref['loss']})")
        return
    d = abs(got["loss"] - ref["loss"]) / max(1.0, abs(ref["loss"]))
    c = float((got["ctx"] - ref["ctx"]).abs().max()
              / ref["ctx"].abs().max())
    g, gn, _ = _leaf_errs(got["grads"], ref["grads"])
    print(f"{label}: loss {got['loss']:.6f} against {ref['loss']:.6f} "
          f"({d:.2e}, tol {TRAIN_LOSS_TOL:g}), context {c:.2e} of its "
          f"largest entry (tol 1e-5), worst gradient leaf {g:.2e} ({gn}, tol "
          f"{TRAIN_TOL:g})")
    check(d <= TRAIN_LOSS_TOL and c <= 1e-5 and g <= TRAIN_TOL,
          f"{label}: {d}, {c}, {g}")


def _y_hold_fit(ranks, fit_dir, label, layers, card):
    """(y2) fit(mesh=) on every rank: one history.json and one checkpoint
    set in fit_dir, the resumed epoch after the first, the same histories
    on every rank, Y_FIT_STEPS backward launches a layer a rank."""
    with open(f"{fit_dir}/history.json") as f:
        saved = json.load(f)
    ckpts = sorted(os.listdir(f"{fit_dir}/ckpt"))
    fitted = ranks[0]["fit"]
    print(f"{label} fit(mesh=) 1 epoch x {Y_FIT_STEPS} steps, then resumed "
          f"1, {len(ranks)} rank(s) [{card}]: epochs "
          f"{[h['epoch'] for h in saved]}, lr_step "
          f"{[h['lr_step'] for h in saved]}, val_nll "
          f"{[round(h['val_nll'], 4) for h in saved]}; checkpoints {ckpts}; "
          f"launches in the first epoch a rank "
          f"{[got['fit']['launches'] for got in ranks]}")
    check([h["epoch"] for h in saved] == [1, 2]
          and saved[-1]["lr_step"] == 2 * Y_FIT_STEPS
          and ckpts == ["best", "last"],
          f"{label} fit: {[(h['epoch'], h['lr_step']) for h in saved]} "
          f"{ckpts}")
    check(all(math.isfinite(h["val_nll"]) for h in saved),
          f"{label} fit NLL")
    for r, got in enumerate(ranks):
        val = [h["val_nll"] for h in got["fit"]["hist2"]]
        check(val == [h["val_nll"] for h in saved],
              f"{label} rank {r}'s history {val} is not the one written")
        check(got["fit"]["launches"] == fitted["launches"]
              and fitted["launches"][1] == Y_FIT_STEPS * layers,
              f"{label} rank {r} fit launches {got['fit']['launches']}")
    return fitted["launches"]


def _y_hold_lb_train(ranks, world, label, card):
    """(y4) train_long_bns --mesh world on every rank: a finite, falling
    NLL, 6 + 6 launches a step (plus evaluation and calibration), no
    plain spline, the mesh in calibration.json."""
    n_cal = max(1, Y_LB_CAL // Y_LB_BATCH)
    for r, got in enumerate(ranks):
        lt = got["lb_train"]
        hist = lt["hist"]
        want = (6 * Y_LB_STEPS + 12 * len(hist) + 6 * n_cal, 6 * Y_LB_STEPS)
        check(lt["launches"] == want and lt["plain"] == {"forward": 0,
                                                         "inverse": 0},
              f"{label} rank {r} train launches {lt['launches']} (expected "
              f"{want}), plain {lt['plain']}")
        check(all(math.isfinite(h["train_nll"])
                  and math.isfinite(h["val_nll"]) for h in hist)
              and hist[-1]["val_nll"] < hist[0]["val_nll"],
              f"{label} rank {r}: the NLL did not fall: {hist}")
        check(lt["cal"]["config"]["mesh"] == world,
              f"{label} calibration mesh {lt['cal']['config']['mesh']}")
    lt = ranks[0]["lb_train"]
    print(f"{label} train_long_bns --mesh {world} at batch {Y_LB_BATCH}, "
          f"{Y_LB_STEPS} steps, in {lt['seconds']:.1f} s [{card}]: "
          + ", ".join(f"step {h['step']} train {h['train_nll']:.3f} val "
                      f"{h['val_nll']:.3f}" for h in lt["hist"])
          + f"; launches a rank {[g['lb_train']['launches'] for g in ranks]}"
          f"; calibration mesh {lt['cal']['config']['mesh']}")
    return lt


def phase_mesh(torch, plain, rqs_cuda, engine, train_cfg, sim_cfg, card,
               tmp):
    """(y1)-(y4), (y6), (y7): the process grid, the flagship's
    data-parallel step and fit, the sharded batched decompose, the
    sequence-parallel long-BNS losses and training, dryrun_multichip."""
    import torch.distributed as dist

    from posteriflow_torch.parallel.mesh import init_distributed, make_mesh
    from posteriflow_torch.tools import dryrun_multichip
    world = min(torch.cuda.device_count(), Y_MAX_WORLD)
    cfg = train_cfg
    t0 = time.perf_counter()
    # the unsharded references, in this process
    ref = {"steps": y_flagship_steps(torch, plain, rqs_cuda, cfg, None,
                                     DEVICE),
           "steps_f32": y_flagship_steps(torch, plain, rqs_cuda,
                                         _f32_npe(cfg), None, DEVICE, False),
           "decompose": y_decompose(torch, plain, rqs_cuda, engine.model,
                                    train_cfg, sim_cfg, None, DEVICE),
           "lb": {p: y_lb_loss(torch, plain, rqs_cuda, p, None, DEVICE)
                  for p in Y_LB_RELEASES},
           "lb_f32": {p: y_lb_loss(torch, plain, rqs_cuda, p, None, DEVICE,
                                   f32=True) for p in Y_LB_RELEASES}}
    if world == 1:
        t1 = time.perf_counter()
        init_distributed(f"file://{tmp}/rendezvous", 1, 0, device=DEVICE)
        mesh = make_mesh(world)
        backend = dist.get_backend()
        print(f"(y1) process group: {backend}, world {world} (one a card of "
              f"{torch.cuda.device_count()}), this process as rank 0; mesh "
              f"{mesh.mesh_dim_names} of shape {tuple(mesh.shape)}, up in "
              f"{time.perf_counter() - t1:.2f} s [{card}]")
        check(backend == "nccl", f"(y1) backend {backend}")
        try:
            ranks = [y_rank_work(torch, plain, rqs_cuda, world, DEVICE, cfg,
                                 train_cfg, sim_cfg, tmp, Y_PARTS,
                                 engine.model)]
        finally:
            dist.destroy_process_group()
        shared = tmp
    else:
        print(f"(y1) process group: nccl, world {world} of "
              f"{torch.cuda.device_count()} cards, one process a card "
              f"[{card}]")
        ranks = _y_spawn(torch, world, "nccl", cfg, train_cfg, sim_cfg, tmp,
                         Y_PARTS + ("steps_f32",))
        shared = f"{tmp}/shared"
    exact = world == 1
    layers = cfg.npe.flow_layers
    for r, got in enumerate(ranks):
        _y_hold_steps(got["steps"], ref["steps"], f"(y2) rank {r}", exact)
        if not exact:
            _y_hold_steps(got["steps_f32"], ref["steps_f32"],
                          f"(y2) rank {r}, float32", False)
        check(set(got["steps"]["launches"]) == {(layers, layers)},
              f"(y2) rank {r} launches a step {got['steps']['launches']}")
    st = ranks[0]["steps"]
    print(f"(y2) make_train_step(mesh=) on ('data', 'model') "
          f"{ranks[0]['mesh']} at batch {cfg.batch_size} "
          f"({cfg.batch_size // world} rows a rank), the release's weights, "
          f"{Y_STEPS} steps [{card}]: NLL {st['nll']}, "
          + ("bit-equal to the unsharded steps (loss, every gradient leaf "
             "after the clip, every parameter)" if exact else
             "within (m)'s float32 bars")
          + f"; launches a step a rank {sorted(set(st['launches']))}, plain "
          f"spline {st['plain']}; {st['steps_per_s']:.2f} steps/s over "
          f"{Y_TIMED_STEPS} steps (unsharded in this process "
          f"{ref['steps']['steps_per_s']:.2f})")
    fit_launches = _y_hold_fit(ranks, f"{shared}/fit", "(y2)", layers, card)

    rows = POD_EVENTS * POD_SAMPLES // world
    for r, got in enumerate(ranks):
        d, dr = got["decompose"], ref["decompose"]
        check(d["rows"] == [rows] * POD_STAGES * layers
              and d["plain"] == {"forward": 0, "inverse": 0},
              f"(y3) rank {r}: launches at rows {d['rows']}, plain "
              f"{d['plain']}")
        if exact:
            check(_y_bitequal(d["out"], dr["out"]),
                  "(y3) the sharded decompose differs from (s)'s call")
        else:
            check(all(torch.equal(d["out"][k], dr["out"][k])
                      for k in ("accepted", "n_extracted")),
                  "(y3) accepted flags differ")
    print(f"(y3) make_batched_decompose(mesh=) on ('data', 'model') "
          f"{ranks[0]['mesh']}, (s)'s {POD_EVENTS} events and base draws "
          f"[{card}]: n_extracted "
          f"{ranks[0]['decompose']['out']['n_extracted'].tolist()}, "
          f"{len(ranks[0]['decompose']['rows'])} rqs_tile launches at "
          f"{rows} rows a rank; "
          + ("bit-equal to the unsharded call" if exact
             else "flags equal to the unsharded call"))

    for p in Y_LB_RELEASES:
        for r, got in enumerate(ranks):
            check(got["seq_mesh"] == (1, world),
                  f"(y4) rank {r}: the long-BNS mesh is {got['seq_mesh']}")
            _y_hold_lb(got["lb"][p], ref["lb"][p], f"(y4) {p} rank {r}",
                       exact)
            check(got["lb"][p]["launches"] == (6, 6)
                  and got["lb"][p]["plain"] == {"forward": 0, "inverse": 0},
                  f"(y4) {p} rank {r}: launches {got['lb'][p]['launches']}")
        print(f"(y4) {p} through make_sharded_nll_v4 / make_sharded_encoder "
              f"on ('data', 'model') {ranks[0]['seq_mesh']}, {Y_LB_BATCH} "
              f"events [{card}]: NLL {ranks[0]['lb'][p]['loss']:.6f}, "
              + ("bit-equal to the unsharded port (context, loss, every "
                 "gradient leaf)" if exact else "within (w4)'s float32 bars")
              + f"; launches {ranks[0]['lb'][p]['launches']}")
    lt = _y_hold_lb_train(ranks, world, "(y4)", card)

    out = f"{tmp}/dryrun.json"
    t1 = time.perf_counter()
    dryrun_multichip.dryrun_multichip(world, "cuda", out=out)
    with open(out) as f:
        dry = json.load(f)
    print(f"(y6) dryrun_multichip({world}) on the card(s) in "
          f"{time.perf_counter() - t1:.1f} s [{card}]: nll "
          f"{dry['nll']:.4f}, grad_norm {dry['grad_norm']:.3f}")
    check(math.isfinite(dry["nll"]), f"(y6) {dry}")

    y7 = None
    if torch.cuda.device_count() == 1:
        t1 = time.perf_counter()
        got = _y_spawn(torch, Y7_WORLD, "gloo", cfg, train_cfg, sim_cfg,
                       f"{tmp}/y7", Y7_PARTS)
        for r, g in enumerate(got):
            check(g["mesh"] == (Y7_WORLD, 1)
                  and g["seq_mesh"] == (1, Y7_WORLD),
                  f"(y7) rank {r}: meshes {g['mesh']}, {g['seq_mesh']}")
            _y_hold_steps(g["steps_f32"], ref["steps_f32"],
                          f"(y7) rank {r} flagship, float32", False)
            for p in Y_LB_RELEASES:
                _y_hold_lb(g["lb_f32"][p], ref["lb_f32"][p],
                           f"(y7) rank {r} {p}, float32 conditioners", False)
        check(got[0]["fit"]["launches"] == fit_launches,
              f"(y7) fit launches {got[0]['fit']['launches']}, at world 1 "
              f"{fit_launches}")
        _y_hold_fit(got, f"{tmp}/y7/shared/fit", "(y7)", layers, card)
        y7_lt = _y_hold_lb_train(got, Y7_WORLD, "(y7)", card)
        with open(f"{tmp}/y7/shared/lb/history.json") as f:
            check(json.load(f) == y7_lt["hist"],
                  "(y7) train_long_bns: history.json is not rank 0's")
        y7 = time.perf_counter() - t1
        print(f"(y7) (y2) and (y4) at world {Y7_WORLD}: two gloo processes "
              f"on the one card, CUDA tensors, in {y7:.1f} s [{card}]: the "
              f"steps and losses within (m)'s and (w4)'s float32 bars; fit "
              f"and train_long_bns --mesh {Y7_WORLD} wrote one run each; "
              f"first val NLL {y7_lt['hist'][0]['val_nll']:.6f} against "
              f"{lt['hist'][0]['val_nll']:.6f} at world 1")
    return {"world": world, "ranks": ranks, "ref": ref, "dry": dry,
            "seconds": time.perf_counter() - t0, "y7": y7}


def phase_v3(torch, plain, rqs_cuda, card, tmp):
    """(y5) the v3 chirp front end at JAX's defaults: the grid, the
    simulator card against CPU, tools/train_long_bns.py --tokens v3,
    tools/validate_long_bns.py on the run, tools/release_long_bns.py and
    the release reloaded, rqs_tile<8> at v3's row counts bit-equal to the
    plain spline and timed, rqs_grad<8> at its training rows."""
    from posteriflow_torch.models import long_bns as lb
    from posteriflow_torch.tools import release_long_bns
    from posteriflow_torch.tools import train_long_bns as tool
    from posteriflow_torch.tools import validate_long_bns
    from posteriflow_torch.train.checkpoints import load_long_bns
    t0 = time.perf_counter()
    grid = lb.build_chirp_token_grid()
    grid_s = time.perf_counter() - t0
    draws = lb.draw_long_bns(Y_V3_SIM, grid["cut"], None,
                             torch.Generator().manual_seed(41), "cpu")
    cpu_tok, _ = lb.simulate_long_bns_v3_from_draws(draws, grid)
    card_tok, _ = lb.simulate_long_bns_v3_from_draws(
        lb.LongBNSDraws(draws.theta.to(DEVICE), draws.noise.to(DEVICE),
                        None), grid)
    sig, _ = lb.simulate_long_bns_v3_from_draws(
        lb.LongBNSDraws(draws.theta, torch.zeros_like(draws.noise), None),
        grid)
    card_tok = card_tok.cpu()
    coh = float((card_tok[..., :6] - cpu_tok[..., :6]).abs().max())
    coh_bar = 2e-2 * float(sig[..., :6].abs().max())
    en = float((card_tok[..., 6:9] - cpu_tok[..., 6:9]).abs().max())
    en_bar = 1e-3 * float(cpu_tok[..., 6:9].abs().max()) + 1e-3
    feat = torch.equal(card_tok[..., 9:], cpu_tok[..., 9:])
    print(f"(y5) v3 grid at JAX's defaults (64 s, f_hi 512, alpha 2): n_tok "
          f"{grid['n_tok']}, L {grid['L']}, built in {grid_s:.2f} s on the "
          f"host; {Y_V3_SIM} events card against CPU on the same draws "
          f"[{card}]: coherent channels {coh:.3e} (bar {coh_bar:.3e}), "
          f"energy {en:.3e} (bar {en_bar:.3e}), features exact {feat}")
    check(coh <= coh_bar and en <= en_bar and feat,
          f"(y5) simulator card against CPU: {coh}, {en}")

    run = f"{tmp}/v3"
    counts, restore = _count_plain(torch, plain)
    rqs_cuda.KERNEL.launches = rqs_cuda.GRAD_KERNEL.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    try:
        hist, cal, _ = tool.run_training(
            ["--tokens", "v3", "--outdir", run, "--steps", str(Y_V3_STEPS),
             "--batch", str(Y_V3_BATCH), "--eval-every", str(Y_V3_EVAL),
             "--flow-bins", "12", "--cal-events", str(Y_V3_CAL),
             "--device", DEVICE])
        torch.cuda.synchronize()
    finally:
        restore()
    train_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    fwd, bwd = rqs_cuda.KERNEL.launches, rqs_cuda.GRAD_KERNEL.launches
    n_cal = max(1, Y_V3_CAL // Y_V3_BATCH)
    want = (6 * Y_V3_STEPS + 12 * len(hist) + 6 * n_cal, 6 * Y_V3_STEPS)
    print(f"(y5) train_long_bns --tokens v3 --flow-bins 12 (K = "
          f"{Y_V3_K}: JAX's script builds v3's LongBNSNPE at its default "
          f"bins), batch {Y_V3_BATCH}, {Y_V3_STEPS} steps in "
          f"{train_s:.1f} s [{card}]: "
          + ", ".join(f"step {h['step']} train {h['train_nll']:.3f} val "
                      f"{h['val_nll']:.3f} shuffle Δ {h['shuffle_delta']}"
                      for h in hist)
          + f"; {cal['config']['n_params']} parameters; launches {(fwd, bwd)}"
          f" (expected {want}); plain spline {dict(counts)}; peak memory "
          f"{peak:.2f} GiB")
    check((fwd, bwd) == want and counts == {"forward": 0, "inverse": 0},
          f"(y5) launches {(fwd, bwd)}, plain {counts}")
    check(all(math.isfinite(h["train_nll"]) and math.isfinite(h["val_nll"])
              for h in hist), "(y5) non-finite NLL")

    n_ev, n_post, chunk = Y_V3_VAL
    rqs_cuda.KERNEL.launches = 0
    t1 = time.perf_counter()
    code, report, _ = validate_long_bns.run(
        ["--model", run, "--n-events", str(n_ev), "--n-post", str(n_post),
         "--chunk", str(chunk), "--device", DEVICE, "--out",
         f"{tmp}/v3_val"])
    val_s = time.perf_counter() - t1
    val_launches = rqs_cuda.KERNEL.launches
    print(f"(y5) validate_long_bns on the v3 run at {n_ev} x {n_post} "
          f"[{card}]: exit {code} in {val_s:.2f} s, gates "
          + ", ".join(f"{c['gate']} {c['value']:.3f}"
                      for c in report["checks"])
          + f"; rqs_tile launches {val_launches}")
    check([c["gate"] for c in report["checks"]]
          == list(validate_long_bns.GATES)
          and val_launches == 18 * (n_ev // chunk),
          f"(y5) validation: {report['checks']} {val_launches}")

    code = release_long_bns.main(["--run", run, "--out", f"{tmp}/v3_rel",
                                  "--report", f"{tmp}/none"])
    model, _, _ = load_long_bns(run, device="cpu")
    again, _, _ = load_long_bns(f"{tmp}/v3_rel", device="cpu")
    same = _y_bitequal(again.state_dict(), model.state_dict())
    print(f"(y5) release_long_bns on the v3 run: exit {code}; its "
          f"params.msgpack reloaded bit-equal to the run: {same}")
    check(code == 0 and same, "(y5) release")

    times = {}
    for n in Y_V3_ROWS:
        x, raw, bias = spline_inputs(torch, n, seed=n + 8, k=Y_V3_K, d=LB_D)
        for b in (None, bias):
            for inverse in (False, True):
                k_out, k_ld = rqs_cuda.KERNEL.launch(
                    x, raw.reshape(n, -1), Y_V3_K, TAIL, inverse, bias=b)
                p_fn = plain.rqs_inverse if inverse else plain.rqs_forward
                p_out, p_ld = p_fn(x, raw if b is None else raw + b, Y_V3_K,
                                   TAIL)
                torch.cuda.synchronize()
                err = max(float((k_out - p_out).abs().max()),
                          float((k_ld - p_ld).abs().max()))
                check(err == 0.0, f"(y5) rqs_tile<{Y_V3_K}> N={n} inverse="
                                  f"{inverse} bias={b is not None}: {err}")
        inverse = n != Y_V3_BATCH
        times[n] = forward_timing(torch, plain, rqs_cuda, x, raw, bias,
                                  inverse=inverse, k=Y_V3_K)
        t = times[n]
        print(f"(y5) rqs_tile<{Y_V3_K}, {'inverse' if inverse else 'forward'}"
              f", bias> N={n} D={LB_D} [{card}]: bit-equal to the plain "
              f"spline both ways, with and without the bias; device time a "
              f"launch " + ("not measured" if t["ms"] is None
                            else f"{t['ms'] * 1e3:.2f} us")
              + f" (profiler), {t['events_ms'] * 1e3:.2f} us by CUDA events,"
              f" plain {t['plain_ms'] * 1e3:.1f} us; bound "
              f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}: "
              f"{rqs_bytes(n, LB_D, Y_V3_K)} B)")
    n = Y_V3_BATCH
    x, raw, g_out, g_ld, bias = grad_inputs(torch, plain, n, Y_V3_K, seed=12,
                                            d=LB_D)
    ref = plain.rqs_forward_vjp(x, raw, g_out, g_ld, Y_V3_K, TAIL, bias=bias)
    got = rqs_cuda.GRAD_KERNEL.launch(x, raw.reshape(n, -1), g_out, g_ld,
                                      Y_V3_K, TAIL, bias)
    errs = [grad_err(got[0], ref[0]),
            grad_err(got[1].reshape(ref[1].shape), ref[1])]
    check(all(math.isfinite(e) and e <= GRAD_REL for e in errs),
          f"(y5) rqs_grad<{Y_V3_K}>: {errs}")
    raw2 = raw.reshape(n, -1)

    def grad_fn():
        return rqs_cuda.GRAD_KERNEL.launch(x, raw2, g_out, g_ld, Y_V3_K,
                                           TAIL, bias)
    nbytes, nops = (rqs_grad_bytes(n, LB_D, Y_V3_K),
                    rqs_grad_ops(n, LB_D, Y_V3_K))
    by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S, nops / PEAK_F32_FLOPS
    g = {"ms": kernel_device_ms(torch, grad_fn, "rqs_grad"),
         "events_ms": cuda_time_ms(grad_fn, reps=50),
         "plain_ms": cuda_time_ms(lambda: plain.rqs_forward_vjp(
             x, raw, g_out, g_ld, Y_V3_K, TAIL, bias=bias), reps=5),
         "bound_ms": max(by_bytes, by_ops) * 1e3,
         "bound_by": "bytes" if by_bytes >= by_ops else "operations",
         "max_rel_err": max(errs),
         "max_abs_err": max(float((got[0] - ref[0]).abs().max()),
                            float((got[1].reshape(ref[1].shape)
                                   - ref[1]).abs().max()))}
    print(f"(y5) rqs_grad<{Y_V3_K}, bias> N={n} D={LB_D} [{card}]: g_x, g_raw "
          f"{errs[0]:.2e}, {errs[1]:.2e} of the largest entry; device time "
          + ("not measured" if g["ms"] is None else f"{g['ms'] * 1e3:.2f} us")
          + f" (profiler), {g['events_ms'] * 1e3:.2f} us by CUDA events, "
          f"plain VJP {g['plain_ms'] * 1e3:.1f} us; bound "
          f"{g['bound_ms'] * 1e3:.3f} us ({g['bound_by']}: {nbytes} B)")
    return {"grid": (grid["n_tok"], grid["L"], grid_s), "hist": hist,
            "launches": (fwd, bwd), "val_launches": val_launches,
            "train_s": train_s, "val_s": val_s, "peak_gib": peak,
            "times": times, "grad": g}


# ── (z) the remaining modules and tools ─────────────────────────────────
# Every piece on the card, and held card against CPU on the port: float32
# paths within Z_TOL of the largest entry; a waveform's complex values
# within the larger of 2e-3 of its peak and Z_PSI_STEPS float32 steps of
# its largest in-band |Ψ| (the phase rounding the CPU tests allow against
# JAX: a BNS reaches |Ψ| = 11,473 rad, whose step is 9.8e-4 rad), its
# moduli within Z_TOL of the peak; the flagship's contexts in float32
# within Z_TOL of the largest and its batch NLLs in float32 within (m)'s
# TRAIN_LOSS_TOL (as released, with bfloat16 matmuls, the card and the
# CPU round differently: contexts 5.2e-2 of the largest apart, 16 events'
# NLLs 0.03-0.11 nats on an NVIDIA H100 80GB HBM3; printed); a bfloat16
# flow head's NLL within Z_HEAD_TOL nats (that test's log q bar);
# the SVD's singular values within Z_SVD_REL relative, each vector
# |<b_card, b_cpu>| >= Z_SVD_OVERLAP where its singular value stands more
# than 1% from its neighbours, the leading projector within Z_SVD_PROJ.
# precession_robustness's noise-free SNRs within Z_PREC_REL of
# reports/precession_robustness.json; benchmark_real_events' nested run
# is cut to Z_BRE_NLIVE live points and Z_BRE_MAXITER iterations (its
# defaults 200 and 3000 take minutes of likelihood calls).
Z_TOL = 1e-4
Z_PSI_STEPS = 16
Z_HEAD_TOL = 1e-1
Z_SVD_REL, Z_SVD_OVERLAP, Z_SVD_PROJ = 2e-3, 0.999, 1e-3
Z_PREC_REL = 1e-4
Z_POL_SIGNALS = 64
Z_LTE_BATCH = 64
Z_DATASET = (512, 256)                   # generate_dataset --n, --batch
Z_PROBE_EVENTS = 1024
Z_HEAD_STEPS, Z_HEAD_BATCH = 40, 64
Z_BRE_NLIVE, Z_BRE_MAXITER = 32, 12
Z_HOLD_EVENTS = 16                       # events of a CPU re-run
PREC_RELEASE = "model_release/npe_r3_best"
PREC_REPORT = "reports/precession_robustness.json"
# the new kernel shapes: (rows, D, K, inverse); frozen_context_heads' flows
# transform the flagship's 15 parameters less their 8 identity features;
# precession_robustness samples npe_r3_best's 11 (6 identity) at 4096
# draws, benchmark_real_events the flagship's at 2000; real_noise_test's
# diagnostics sample 256 events x 128 draws and its batch NLLs score 256
# events x 5 slots
Z_SHAPES = ((Z_HEAD_BATCH, 7, 8, False), (4096, 5, K_BINS, True),
            (2000, 7, K_BINS, True), (256 * 128, 7, K_BINS, True),
            (256 * 5, 7, K_BINS, False))


def _z_path(torch, plain, rqs_cuda, label, fn):
    """fn() with the launch counters zeroed before and read after, the
    plain spline counted and each launch's (rows, D, K, inverse) recorded
    -> (fn's result, (rqs_tile, rqs_grad) launches, {shape: count})."""
    from collections import Counter
    shapes = Counter()
    launch, grad = rqs_cuda.KERNEL.launch, rqs_cuda.GRAD_KERNEL._launch

    def rec_launch(x, raw, num_bins, tail, inverse, bias=None):
        shapes[(x.shape[0], x.shape[1], num_bins, bool(inverse))] += 1
        return launch(x, raw, num_bins, tail, inverse, bias)

    def rec_grad(x, raw, g_out, g_ld, num_bins, tail, bias):
        shapes[(x.shape[0], x.shape[1], num_bins, "grad")] += 1
        return grad(x, raw, g_out, g_ld, num_bins, tail, bias)
    counts, restore = _count_plain(torch, plain)
    rqs_cuda.KERNEL.launch, rqs_cuda.GRAD_KERNEL._launch = rec_launch, \
        rec_grad
    rqs_cuda.KERNEL.launches = rqs_cuda.GRAD_KERNEL.launches = 0
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        restore()
        rqs_cuda.KERNEL.launch, rqs_cuda.GRAD_KERNEL._launch = launch, grad
    n = (rqs_cuda.KERNEL.launches, rqs_cuda.GRAD_KERNEL.launches)
    print(f"(z) {label}: rqs_tile launches {n[0]}, rqs_grad {n[1]}; by "
          f"(rows, D, K, direction) {dict(shapes)}; plain spline calls "
          f"{counts}")
    check(counts == {"forward": 0, "inverse": 0},
          f"the plain spline ran on {label}: {counts}")
    check(sum(shapes.values()) == sum(n),
          f"{label}: the recorder saw {sum(shapes.values())} launches of "
          f"{sum(n)}")
    return out, n, dict(shapes)


def _rel_max(got, ref) -> float:
    """max |Δ| over the reference's largest |entry|."""
    got = np.asarray(got, np.float64) if not np.iscomplexobj(got) else got
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)),
                                                 1e-30))


def z_physics(torch, card, tmp):
    """(z1) tools/validate_pipeline_physics on the card: the nine checks
    pass; the deterministic ones (3, 4, 8, 9) card against CPU within
    Z_TOL relative."""
    from posteriflow_torch.tools import validate_pipeline_physics as vpp
    t0 = time.perf_counter()
    got = vpp.run(["--device", DEVICE, "--out", f"{tmp}/vpp.json"])
    wall = time.perf_counter() - t0
    ref = vpp.run(["--device", "cpu"])
    print(f"(z1) validate_pipeline_physics [{card}]: passed "
          f"{got['passed']} in {wall:.2f} s, backend {got['backend']!r}; "
          + "; ".join(f"{c['check']} {'PASS' if c['passed'] else 'FAIL'} "
                      f"{c['detail']}" for c in got["checks"]))
    check(got["passed"] and len(got["checks"]) == 9,
          f"physics validation failed on the card: {got['checks']}")
    check(got["backend"] == f"cuda ({torch.cuda.get_device_name(0)})",
          f"backend {got['backend']!r}")
    worst = 0.0
    for g, r in zip(got["checks"], ref["checks"]):
        if g["check"] in ("inverse_distance_amplitude",
                          "geometric_time_delays",
                          "phenomd_inspiral_consistency",
                          "phenomd_amplitude_peak"):
            for k, v in r["detail"].items():
                worst = max(worst, abs(g["detail"][k] - v) / abs(v))
    print(f"(z1) the deterministic checks card vs CPU: max relative gap "
          f"{worst:.2e} (tol {Z_TOL:g})")
    check(worst <= Z_TOL, f"physics checks card vs CPU {worst}")
    return {"seconds": wall}


def _z_signals(n: int):
    """n signals as columns (m1, m2, chi1, chi2, d_L, theta_jn, phase):
    a quarter BNS, a quarter NSBH, half BBH."""
    rng = np.random.default_rng(16)
    k = n // 4
    m1 = np.concatenate([rng.uniform(1.2, 2.2, k), rng.uniform(5, 15, k),
                         rng.uniform(8, 90, n - 2 * k)])
    m2 = np.concatenate([np.maximum(rng.uniform(0.7, 1.0, k) * m1[:k], 1.0),
                         rng.uniform(1.2, 2.0, k),
                         rng.uniform(0.2, 1.0, n - 2 * k) * m1[2 * k:]])
    m2 = np.minimum(m2, m1)
    cols = np.stack([m1, m2, rng.uniform(-0.5, 0.5, n),
                     rng.uniform(-0.5, 0.5, n), rng.uniform(40, 1000, n),
                     rng.uniform(0, np.pi, n), rng.uniform(0, 2 * np.pi, n)],
                    axis=1).astype(np.float32)
    return cols


def _psi_bars(torch, cols) -> np.ndarray:
    """[n] the complex-value bar of each signal, a share of its peak."""
    from posteriflow_torch.physics.constants import FREQS
    from posteriflow_torch.physics.waveforms.taylorf2 import \
        taylorf2_amp_phase
    f = torch.from_numpy(np.asarray(FREQS, np.float32))
    c = [torch.from_numpy(cols[:, i:i + 1]) for i in (0, 1, 2, 3, 4, 6)]
    _, psi = taylorf2_amp_phase(f, *c)
    psi_max = psi[:, FREQS >= 20.0].abs().amax(dim=1).numpy()
    return np.maximum(2e-3, Z_PSI_STEPS * np.spacing(
        psi_max.astype(np.float32)))


def _hold_complex(label, got, ref, bars):
    """Per signal (rows of [n, ...]): moduli within Z_TOL of the peak,
    values within bars[i] of the peak -> (worst modulus gap, worst
    complex gap over the bar)."""
    got = got.reshape(got.shape[0], -1)
    ref = ref.reshape(ref.shape[0], -1)
    peak = np.abs(ref).max(axis=1)
    mod = np.max(np.abs(np.abs(got) - np.abs(ref)), axis=1) / peak
    val = np.max(np.abs(got - ref), axis=1) / peak
    check(np.all(mod <= Z_TOL), f"{label}: moduli card vs CPU {mod.max()}")
    check(np.all(val <= bars), f"{label}: values card vs CPU "
          f"{(val / bars).max()} of the bar")
    return float(mod.max()), float((val / bars).max())


def z_waveforms(torch, card):
    """(z2) the five polarization entry points at the flagship's grid,
    Z_POL_SIGNALS signals each, card against CPU; their times by CUDA
    events."""
    from posteriflow_torch.physics.constants import FREQS
    from posteriflow_torch.physics.psd import default_network_asd
    from posteriflow_torch.physics.waveforms import (
        imr_stitch_polarizations, phenomd_matter_polarizations,
        phenomd_polarizations, phenomp_polarizations)
    from posteriflow_torch.physics.waveforms.precession import \
        precessing_signal_white_fd
    cols = _z_signals(Z_POL_SIGNALS)
    bars = _psi_bars(torch, cols)
    chi_p = np.random.default_rng(17).uniform(0.0, 0.6, Z_POL_SIGNALS)
    out = {}
    for name, fn in (("phenomd_polarizations", phenomd_polarizations),
                     ("phenomd_matter_polarizations",
                      phenomd_matter_polarizations),
                     ("phenomp_polarizations", phenomp_polarizations),
                     ("imr_stitch_polarizations", imr_stitch_polarizations)):
        def run(dev, fn=fn, name=name):
            f = torch.from_numpy(np.asarray(FREQS, np.float32)).to(dev)
            c = [torch.from_numpy(cols[:, i:i + 1]).to(dev)
                 for i in range(7)]
            kw = ({"chi_p": torch.from_numpy(chi_p[:, None].astype(
                np.float32)).to(dev)} if name == "phenomp_polarizations"
                  else {})
            with torch.no_grad():
                return fn(f, *c, **kw)
        card_hp, card_hc = run(DEVICE)
        ms = cuda_time_ms(lambda: run(DEVICE), reps=5)
        cpu_hp, cpu_hc = run("cpu")
        gaps = [_hold_complex(name, card_h.cpu().numpy(), cpu_h.numpy(),
                              bars)
                for card_h, cpu_h in ((card_hp, cpu_hp), (card_hc, cpu_hc))]
        out[name] = ms
        print(f"(z2) {name} x {Z_POL_SIGNALS} [{card}]: {ms:.3f} ms a call "
              f"(CUDA events); card vs CPU: moduli {max(g[0] for g in gaps):.2e}"
              f" of the peak (tol {Z_TOL:g}), values "
              f"{max(g[1] for g in gaps):.3f} of their bar")
    asd = {dev: default_network_asd(device=dev) for dev in (DEVICE, "cpu")}
    rng = np.random.default_rng(18)
    params = np.stack([cols[:, 0], cols[:, 1], cols[:, 4],
                       rng.uniform(0, 2 * np.pi, Z_POL_SIGNALS),
                       rng.uniform(-1.4, 1.4, Z_POL_SIGNALS), cols[:, 5],
                       rng.uniform(0, np.pi, Z_POL_SIGNALS), cols[:, 6],
                       rng.uniform(-1.5, 1.5, Z_POL_SIGNALS), cols[:, 2],
                       cols[:, 3]], axis=1).astype(np.float32)

    def prec(dev):
        with torch.no_grad():
            return torch.stack([precessing_signal_white_fd(
                torch.from_numpy(p).to(dev), float(c), asd[dev])
                for p, c in zip(params, chi_p)])
    got = prec(DEVICE)
    ms = cuda_time_ms(lambda: prec(DEVICE), reps=2)
    ref = prec("cpu").numpy()
    got = got.cpu().numpy()
    snr = np.sqrt(np.sum(np.abs(got) ** 2, axis=(1, 2)))
    snr_ref = np.sqrt(np.sum(np.abs(ref) ** 2, axis=(1, 2)))
    snr_gap = float(np.max(np.abs(snr - snr_ref) / snr_ref))
    gaps = _hold_complex("precessing_signal_white_fd", got, ref, bars)
    print(f"(z2) precessing_signal_white_fd x {Z_POL_SIGNALS} one at a time "
          f"[{card}]: {ms:.3f} ms the 64; SNRs {snr.min():.2f}-"
          f"{snr.max():.2f}, card vs CPU {snr_gap:.2e} relative (tol 1e-5), "
          f"moduli {gaps[0]:.2e}, values {gaps[1]:.3f} of their bar")
    check(snr_gap <= 1e-5, f"precessing SNR card vs CPU {snr_gap}")
    out["precessing_signal_white_fd"] = ms
    return out


def z_svd(torch, card):
    """(z3) build_svd_basis at its defaults (512 waveforms, 64 vectors) on
    the card and on the CPU from the same draws; project_onto_basis."""
    from posteriflow_torch.models import svd_basis as S
    draws = S.draw_svd_inputs(generator=torch.Generator().manual_seed(0),
                              device="cpu")
    t0 = time.perf_counter()
    b_card, s_card = S.build_svd_basis(
        device=DEVICE, draws=S.SvdDraws(*[t.to(DEVICE) for t in draws]))
    wall = time.perf_counter() - t0
    with torch.no_grad():
        hw_ms = cuda_time_ms(lambda: S.svd_waveforms(
            S.SvdDraws(*[t.to(DEVICE) for t in draws]),
            S.asd_from_psd(S.aligo_psd(S.FREQS), device=DEVICE)), reps=2)
    b_cpu, s_cpu = S.build_svd_basis(device="cpu", draws=draws)
    s_gap = float(np.max(np.abs(s_card - s_cpu) / s_cpu))
    gaps = np.minimum(np.abs(np.diff(s_cpu, prepend=np.inf)),
                      np.abs(np.diff(s_cpu, append=-np.inf))) / s_cpu
    sep = gaps > 0.01
    overlap = np.abs(np.sum(np.conj(b_cpu) * b_card, axis=1))
    pj, pc = b_cpu.T @ np.conj(b_cpu), b_card.T @ np.conj(b_card)
    proj = float(np.linalg.norm(pj - pc) / np.linalg.norm(pj))
    h = torch.from_numpy(np.random.default_rng(19).normal(
        size=(8, b_cpu.shape[1])).astype(np.float32)).to(torch.complex64)
    c_card = S.project_onto_basis(h.to(DEVICE), torch.from_numpy(b_card)
                                  .to(DEVICE)).cpu().numpy()
    c_cpu = S.project_onto_basis(h, torch.from_numpy(b_card)).numpy()
    c_gap = _rel_max(c_card, c_cpu)
    print(f"(z3) build_svd_basis 512 x 64 [{card}]: {wall:.2f} s (the "
          f"waveform stack {hw_ms:.2f} ms by CUDA events, the rest the "
          f"host's complex128 SVD); singular values {s_card[0]:.4f} .. "
          f"{s_card[-1]:.4f}, card vs CPU {s_gap:.2e} relative (tol "
          f"{Z_SVD_REL:g}); {int(sep.sum())} separated vectors, least "
          f"overlap {overlap[sep].min():.6f} (tol {Z_SVD_OVERLAP}); "
          f"projector {proj:.2e} (tol {Z_SVD_PROJ:g}); project_onto_basis "
          f"{c_gap:.2e} (tol {Z_TOL:g})")
    check(s_gap <= Z_SVD_REL, f"SVD singular values card vs CPU {s_gap}")
    check(np.all(overlap[sep] >= Z_SVD_OVERLAP), "SVD vectors card vs CPU")
    check(proj <= Z_SVD_PROJ, f"SVD projector card vs CPU {proj}")
    check(c_gap <= Z_TOL, f"project_onto_basis card vs CPU {c_gap}")
    return {"seconds": wall, "stack_ms": hw_ms}


def z_transformer(torch, card):
    """(z4) LightweightTransformerEncoder at its defaults on a
    [Z_LTE_BATCH, 3, 16384] batch, card against CPU."""
    from posteriflow_torch.models.transformer_encoder import \
        LightweightTransformerEncoder
    torch.manual_seed(0)
    model = LightweightTransformerEncoder().eval()
    x = torch.from_numpy(np.random.default_rng(20).normal(
        0, 1.0, (Z_LTE_BATCH, 3, 16384)).astype(np.float32))
    with torch.no_grad():
        ref = model(x).numpy()
        model.to(DEVICE)
        xd = x.to(DEVICE)
        got = model(xd).cpu().numpy()
        ms = cuda_time_ms(lambda: model(xd), reps=5)
    gap = _rel_max(got, ref)
    print(f"(z4) LightweightTransformerEncoder [{Z_LTE_BATCH}, 3, 16384] "
          f"[{card}]: {ms:.3f} ms a call (CUDA events), out "
          f"{tuple(got.shape)}, card vs CPU {gap:.2e} of the largest (tol "
          f"{Z_TOL:g})")
    check(gap <= Z_TOL, f"LightweightTransformerEncoder card vs CPU {gap}")
    return {"ms": ms}


def z_dataset(torch, card, tmp):
    """(z5) tools/generate_dataset --n 512 --batch 256 (the HDF5 write only
    where h5py is installed); a batch's components card against the CPU
    from the card's parameters."""
    import importlib.util

    from posteriflow_torch.physics.simulator import design_asd
    from posteriflow_torch.tools import generate_dataset as G
    n, batch = Z_DATASET
    write = importlib.util.find_spec("h5py") is not None
    t0 = time.perf_counter()
    if write:
        stats = G.main(["--out", f"{tmp}/ds.h5", "--n", str(n), "--batch",
                        str(batch), "--device", DEVICE])
    else:
        stats = {"n_signals_dist": {}, "snr_sum": 0.0, "generated": 0}
        for rec in G.generate(G.sim_config(), n, batch, 0, False, DEVICE):
            G.tally(stats, rec)
        stats = G.finish(stats, time.perf_counter() - t0)
    wall = time.perf_counter() - t0
    print(f"(z5) generate_dataset --n {n} --batch {batch} [{card}]: "
          + ("written to HDF5" if write else "generated; h5py is not "
             "installed here, so no HDF5 write ran")
          + f" in {wall:.2f} s: {stats}")
    check(stats["generated"] == n and math.isfinite(stats["mean_net_snr"]),
          f"generate_dataset: {stats}")
    rec = next(G.generate(G.sim_config(), 8, 8, 1, True, DEVICE))
    params = torch.from_numpy(rec["params"])
    n_sig = torch.from_numpy(rec["n_sig"]).long()
    ref = G.components(params, n_sig, design_asd("cpu")).float().numpy()
    got = rec["signals"].astype(np.float32)
    peak = np.abs(ref).max(axis=(2, 3), keepdims=True) + 1e-30
    gap = float(np.max(np.abs(got - ref) / peak))
    print(f"(z5) --components on 8 events card vs CPU (float16 storage): "
          f"{gap:.2e} of each slot's peak (tol 3e-3)")
    check(gap <= 3e-3, f"dataset components card vs CPU {gap}")
    return {"seconds": wall, "written": write}


def z_real_noise(torch, plain, rqs_cuda, card, cpu_model, tmp):
    """(z6) tools/real_noise_test on the flagship at its 256 events and a
    synthetic bank; the Gaussian and real-noise NLLs of Z_HOLD_EVENTS of
    its events card against CPU."""
    from posteriflow_torch.inference.pipeline import load_model
    from posteriflow_torch.tools import real_noise_test
    from posteriflow_torch.train.trainer import make_eval_nll
    t0 = time.perf_counter()
    (report, batches), n, shapes = _z_path(
        torch, plain, rqs_cuda, "real_noise_test on npe_r7_best",
        lambda: real_noise_test.run(["--ckpt", RELEASE, "--device", DEVICE,
                                     "--out", f"{tmp}/rn.json"]))
    wall = time.perf_counter() - t0
    cfg = _flagship_cfg()
    eval_nll = make_eval_nll(cfg)
    card_model = load_model(RELEASE, device=DEVICE).model
    f32 = {dev: _f32_model(torch, cfg, dev) for dev in (DEVICE, "cpu")}
    gaps, bf16 = {}, {}
    for name, b in batches.items():
        part = type(b)(*[t[:Z_HOLD_EVENTS] for t in b])
        ref = eval_nll(f32["cpu"], _to(part, "cpu"))
        gaps[name] = (abs(eval_nll(f32[DEVICE], part) - ref)
                      / max(1.0, abs(ref)))
        ref16 = eval_nll(cpu_model, _to(part, "cpu"))
        bf16[name] = abs(eval_nll(card_model, part) - ref16)
    print(f"(z6) real_noise_test [{card}]: {wall:.2f} s; Gaussian NLL "
          f"{report['gaussian_nll']:.4f}, real {report['real_nll']:.4f}, gap "
          f"{report['nll_gap']:+.4f} (gate < 3: "
          f"{report['gap_within_gate']}); dist_corr "
          f"{report['gaussian_dist_corr']:.3f} / "
          f"{report['real_dist_corr']:.3f}, cov90 "
          f"{report['gaussian_cov90']:.3f} / {report['real_cov90']:.3f}; "
          f"{Z_HOLD_EVENTS} events' NLL card vs CPU in float32 {gaps} "
          f"relative (tol {TRAIN_LOSS_TOL:g}, (m)'s loss bar); as released "
          f"(bfloat16 matmuls) {bf16} nats, printed")
    check(all(math.isfinite(report[k]) for k in ("gaussian_nll", "real_nll")),
          "real_noise_test NLL not finite")
    check(max(gaps.values()) <= TRAIN_LOSS_TOL,
          f"real_noise_test card vs CPU {gaps}")
    check(n[1] == 0 and n[0] > 0, f"real_noise_test launches {n}")
    return {"seconds": wall, "launches": n, "shapes": shapes,
            "report": report}


def z_precession(torch, plain, rqs_cuda, card, tmp):
    """(z7) tools/precession_robustness at its defaults (npe_r3_best, chi_p
    0, 0.3, 0.6, 4096 draws): the noise-free SNRs against the JAX report,
    the verdicts, OOD percentiles and max |z| printed beside JAX's; the
    strain card against CPU on the same noise."""
    from posteriflow_torch import PARAM_NAMES
    from posteriflow_torch.physics.psd import default_network_asd
    from posteriflow_torch.tools import precession_robustness as P
    with open(PREC_REPORT) as f:
        ref = json.load(f)
    t0 = time.perf_counter()
    got, n, shapes = _z_path(
        torch, plain, rqs_cuda, "precession_robustness on npe_r3_best",
        lambda: P.main(["--device", DEVICE, "--out", f"{tmp}/prec.json"]))
    wall = time.perf_counter() - t0
    rel = [abs(g["injected_snr"] - r["injected_snr"]) / r["injected_snr"]
           for g, r in zip(got["cases"], ref["cases"])]
    for g, r in zip(got["cases"], ref["cases"]):
        print(f"(z7) chi_p {g['chi_p']}: injected SNR {g['injected_snr']:.4f}"
              f" (JAX {r['injected_snr']:.4f}); verdict {g['verdict']} (JAX "
              f"{r['verdict']}), OOD {g['ood_percentile']:.1f}% (JAX "
              f"{r['ood_percentile']:.1f}%), max|z| {g['max_abs_z']:.2f} (JAX "
              f"{r['max_abs_z']:.2f}), refine {g['refine']} (JAX "
              f"{r['refine']}), {g['wall_s']} s")
    theta = torch.tensor([P._TRUTH[k] for k in PARAM_NAMES],
                         dtype=torch.float32)
    noise = torch.from_numpy(np.random.default_rng(21).normal(
        size=(3, 16384)).astype(np.float32))
    worst = 0.0
    for chi_p in (0.0, 0.3, 0.6):
        with torch.no_grad():
            s_card, snr_card = P.make_strain(
                theta.to(DEVICE), chi_p, default_network_asd(device=DEVICE),
                noise.to(DEVICE))
            s_cpu, snr_cpu = P.make_strain(
                theta, chi_p, default_network_asd(device="cpu"), noise)
        sig_peak = float((s_cpu - noise).abs().max())
        gap = float((s_card.cpu() - s_cpu).abs().max())
        worst = max(worst, gap / sig_peak)
        check(abs(snr_card - snr_cpu) <= 1e-5 * snr_cpu,
              f"precession SNR card vs CPU {snr_card} {snr_cpu}")
    print(f"(z7) precession_robustness [{card}]: {wall:.2f} s; SNRs vs the "
          f"JAX report {max(rel):.2e} relative (tol {Z_PREC_REL:g}); the "
          f"strain card vs CPU {worst:.2e} of the signal's peak (tol 2e-3)")
    check(max(rel) <= Z_PREC_REL, f"injected SNRs against the report {rel}")
    check(worst <= 2e-3, f"precession strain card vs CPU {worst}")
    check(n == (3 * 10, 0), f"precession_robustness launches {n}")
    return {"seconds": wall, "launches": n, "shapes": shapes}


def z_probe(torch, plain, rqs_cuda, card, cpu_model, tmp):
    """(z8) tools/probe_context --n-events 1024 on the flagship; the first
    batch's contexts of Z_HOLD_EVENTS events card against CPU."""
    from posteriflow_torch.inference.pipeline import load_model
    from posteriflow_torch.physics.simulator import simulate_batch
    from posteriflow_torch.tools import probe_context
    t0 = time.perf_counter()
    report, n, _ = _z_path(
        torch, plain, rqs_cuda, "probe_context",
        lambda: probe_context.main(["--ckpt", RELEASE, "--device", DEVICE,
                                    "--n-events", str(Z_PROBE_EVENTS),
                                    "--out", f"{tmp}/probes.json"]))
    wall = time.perf_counter() - t0
    cfg = _flagship_cfg()
    card_model = load_model(RELEASE, device=DEVICE).model
    f32 = {dev: _f32_model(torch, cfg, dev) for dev in (DEVICE, "cpu")}
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    with torch.no_grad():
        b = simulate_batch(probe_context.BATCH, cfg.sim, device=DEVICE,
                           generator=gen)
        strain = b.strain[:Z_HOLD_EVENTS]
        bands = (b.asd_bands[:Z_HOLD_EVENTS] if cfg.npe.uses_asd_bands
                 else None)
        cpu_in = (strain.cpu(), None if bands is None else bands.cpu())
        got = card_model.encode(strain, bands).float().cpu().numpy()
        ref = cpu_model.encode(*cpu_in).float().numpy()
        got32 = f32[DEVICE].encode(strain, bands).cpu().numpy()
        ref32 = f32["cpu"].encode(*cpu_in).numpy()
    gap, gap32 = _rel_max(got, ref), _rel_max(got32, ref32)
    print(f"(z8) probe_context --n-events {Z_PROBE_EVENTS} [{card}]: "
          f"{wall:.2f} s, {report['n_events']} live events; R² "
          + ", ".join(f"{k} {v:+.3f}" for k, v in report["probes"].items())
          + f"; context std {report['context_std_across_events']:.4f}; "
          f"contexts card vs CPU in float32 {gap32:.2e} of the largest (tol "
          f"{Z_TOL:g}); as released (bfloat16 matmuls) {gap:.2e}, printed")
    check(all(math.isfinite(v) for v in report["probes"].values()),
          "probe R² not finite")
    check(gap32 <= Z_TOL, f"contexts card vs CPU in float32 {gap32}")
    check(n == (0, 0), f"probe_context launched spline kernels {n}")
    return {"seconds": wall}


def _f32_model(torch, cfg, dev):
    """The flagship's weights in a LeanNPE whose matmuls run in float32,
    on `dev` in eval mode."""
    from posteriflow_torch.models.npe import LeanNPE
    from posteriflow_torch.train.checkpoints import load_release
    model = LeanNPE(_f32_npe(cfg).npe)
    model.load_state_dict(load_release(RELEASE)[0], strict=True)
    return model.to(dev).eval()


def _flagship_cfg():
    """The flagship's TrainConfig, from its meta.json."""
    from posteriflow_torch.utils.config import load_config
    return load_config(f"{RELEASE}/meta.json")


def z_heads(torch, plain, rqs_cuda, card, tmp):
    """(z9) tools/frozen_context_heads on the flagship at batch
    Z_HEAD_BATCH for Z_HEAD_STEPS steps a head; each head's NLL card
    against CPU at its initial parameters on one batch of contexts."""
    from posteriflow_torch.tools import frozen_context_heads as H
    from posteriflow_torch.train.trainer import init_params
    t0 = time.perf_counter()
    report, n, shapes = _z_path(
        torch, plain, rqs_cuda, "frozen_context_heads",
        lambda: H.main(["--ckpt", RELEASE, "--device", DEVICE, "--steps",
                        str(Z_HEAD_STEPS), "--batch", str(Z_HEAD_BATCH),
                        "--out", f"{tmp}/heads.json"]))
    wall = time.perf_counter() - t0
    per_step = {"nsf_small": 4, "nsf_large": 8, "mdn": 0}
    want = sum(per_step.values()) * Z_HEAD_STEPS
    npe = _flagship_cfg().npe
    rng = np.random.default_rng(22)
    ctx = torch.from_numpy(rng.normal(size=(Z_HEAD_BATCH, npe.context_dim))
                           .astype(np.float32))
    y = torch.from_numpy(rng.uniform(-0.9, 0.9, (Z_HEAD_BATCH, npe.n_params))
                         .astype(np.float32))
    gaps = {}
    for name in H.HEADS:
        head = init_params(H.make_head(name, npe.context_dim, npe.n_params),
                           torch.Generator().manual_seed(3))
        with torch.no_grad():
            # the flows' zero output layers moved, so the splines bend
            for pname, p in head.named_parameters():
                if ".out." in pname:
                    p.add_(0.02 * torch.randn(
                        p.shape, generator=torch.Generator().manual_seed(
                            p.numel())))
            ref = head(ctx, y).numpy()
            got = head.to(DEVICE)(ctx.to(DEVICE), y.to(DEVICE)).cpu().numpy()
        gaps[name] = float(np.max(np.abs(got - ref)))
        if name == "mdn":
            gaps[name] /= max(1.0, float(np.abs(ref).max()))
    print(f"(z9) frozen_context_heads {Z_HEAD_STEPS} steps x batch "
          f"{Z_HEAD_BATCH} a head [{card}]: {wall:.2f} s; "
          + "; ".join(f"{k} NLL {v['initial_nll']:.3f} -> "
                      f"{v['final_nll']:.3f}" for k, v in report["heads"]
                      .items())
          + f"; spread {report['final_nll_spread']:.3f} "
          f"({report['interpretation']}); card vs CPU at one batch: {gaps} "
          f"(mdn relative, tol {Z_TOL:g}; flows nats, tol {Z_HEAD_TOL:g})")
    check(all(math.isfinite(v["final_nll"]) for v in report["heads"].values()),
          "a head's NLL is not finite")
    check(gaps["mdn"] <= Z_TOL, f"MDN head card vs CPU {gaps['mdn']}")
    check(max(gaps["nsf_small"], gaps["nsf_large"]) <= Z_HEAD_TOL,
          f"flow heads card vs CPU {gaps}")
    check(n == (want, want), f"frozen_context_heads launches {n}, expected "
                             f"{want} + {want}")
    check(set(shapes) == {(Z_HEAD_BATCH, 7, 8, False),
                          (Z_HEAD_BATCH, 7, 8, "grad")},
          f"frozen_context_heads kernel shapes {shapes}")
    return {"seconds": wall, "launches": n, "shapes": shapes}


def z_benchmark(torch, plain, rqs_cuda, card, tmp):
    """(z10) tools/benchmark_real_events --events GW150914 on the flagship
    with the nested run cut to Z_BRE_NLIVE / Z_BRE_MAXITER; the
    marginalized likelihood on that injection card against CPU."""
    from posteriflow_torch.inference.pipeline import load_model
    from posteriflow_torch.inference import importance as imp
    from posteriflow_torch.inference.preprocessing import prepare_simulated
    from posteriflow_torch.tools import benchmark_real_events as B
    t0 = time.perf_counter()
    summary, n, shapes = _z_path(
        torch, plain, rqs_cuda, "benchmark_real_events GW150914",
        lambda: B.main(["--ckpt", RELEASE, "--device", DEVICE, "--events",
                        "GW150914", "--nlive", str(Z_BRE_NLIVE),
                        "--maxiter", str(Z_BRE_MAXITER), "--out",
                        f"{tmp}/bre"]))
    wall = time.perf_counter() - t0
    rec = summary["GW150914"]
    from posteriflow_torch.data.gwtc import GWTCLoader
    engine = load_model(RELEASE, device=DEVICE)
    ev = GWTCLoader().get_event("GW150914")
    prep = prepare_simulated([dict(
        mass_1=ev["mass_1"], mass_2=ev["mass_2"],
        luminosity_distance=min(ev["luminosity_distance"], 2100.0), ra=1.5,
        dec=-0.3, theta_jn=0.6, psi=0.4, phase=1.2, geocent_time=0.0,
        a1=0.0, a2=0.0)], seed=5, param_names=engine.cfg.param_names,
        device=DEVICE)
    samples = np.load(f"{tmp}/bre/GW150914/samples.npy")
    theta = np.concatenate([prep.truth, samples]).astype(
        np.float32)[:Z_HOLD_EVENTS]
    scale = _ll_scale(torch, theta, prep.strain)
    got = imp.make_marginalized_log_likelihood(
        prep.strain, device=DEVICE)(theta).astype(np.float64)
    ref = imp.make_marginalized_log_likelihood(
        prep.strain, device="cpu")(theta).astype(np.float64)
    gap = float(np.max(np.abs(got - ref) / scale))
    print(f"(z10) benchmark_real_events GW150914 [{card}]: {wall:.2f} s; NPE "
          f"{rec['t_npe_s']:.3f} s, {rec['nested_sampler']} "
          f"{rec['t_nested_s']:.2f} s at nlive {Z_BRE_NLIVE}, maxiter "
          f"{Z_BRE_MAXITER}; verdict {rec['verdict']}; the marginalized "
          f"likelihood card vs CPU on {len(theta)} θ {gap:.2e} (tol "
          f"{IS_LL_TOL:g})")
    check(gap <= IS_LL_TOL, f"benchmark likelihood card vs CPU {gap}")
    check(n == (10, 0) and shapes == {(2000, 7, K_BINS, True): 10},
          f"benchmark_real_events launches {n}, {shapes}")
    return {"seconds": wall, "launches": n, "shapes": shapes}


def z_examples(torch, plain, rqs_cuda, card, cpu_engine):
    """(z11) examples/explore_data and examples/analyze_results, their
    compute on the card (no plots: the card's machine may lack
    matplotlib), against CPU runs."""
    from posteriflow_torch.examples import analyze_results, explore_data
    from posteriflow_torch.inference.pipeline import (InferenceEngine,
                                                      load_model)
    from posteriflow_torch.physics.simulator import draw_events
    from posteriflow_torch.train.checkpoints import load_release
    t0 = time.perf_counter()
    card_x = explore_data.explore(64, 0, DEVICE)["stats"]
    cpu_x = explore_data.explore(64, 0, "cpu")["stats"]
    print(f"(z11) explore_data 64 events [{card}]: "
          f"{time.perf_counter() - t0:.2f} s with the CPU run; card "
          f"{card_x}; CPU {cpu_x}")
    check(sum(card_x["n_sig_dist"].values()) == 64
          and abs(card_x["whitened_std"] - cpu_x["whitened_std"]) <= 0.05,
          f"explore_data card vs CPU {card_x} {cpu_x}")
    engine = load_model(RELEASE, device=DEVICE)
    draws = draw_events((), torch.Generator().manual_seed(23), "cpu")
    z = torch.from_numpy(np.random.default_rng(24).normal(
        size=(1, 2000, engine.cfg.n_params)).astype(np.float32))
    t0 = time.perf_counter()
    tour, n, shapes = _z_path(
        torch, plain, rqs_cuda, "analyze_results with --importance",
        lambda: analyze_results.analyze(engine, 2000, importance=True,
                                        draws=_to(draws, DEVICE), z=z))
    wall = time.perf_counter() - t0
    # card against CPU in float32 (phase c's bar on the draws); as
    # released, a bfloat16 activation that rounds the other way moves a
    # draw far, so that gap is printed
    ref = analyze_results.analyze(cpu_engine, 2000, draws=draws, z=z)
    bf16 = float(np.median(np.abs(tour["result"].samples
                                  - ref["result"].samples)))
    state_dict = load_release(RELEASE)[0]
    npe32 = dataclasses.replace(engine.cfg, flow_dtype="float32",
                                encoder_dtype="float32")
    s32 = [analyze_results.analyze(
        InferenceEngine(state_dict, npe32, device=dev), 2000,
        draws=_to(draws, dev), z=z)["result"].samples
        for dev in (DEVICE, "cpu")]
    gap = float(np.max(np.abs(s32[0] - s32[1]))
                / max(1.0, np.abs(s32[1]).max()))
    is_res = tour["importance"]
    print(f"(z11) analyze_results [{card}]: {wall:.2f} s with the importance "
          f"correction (ESS {is_res.ess:.1f}, efficiency "
          f"{is_res.efficiency:.3f}, {is_res.n_stages} stages); the 2000 "
          f"draws card vs CPU in float32 {gap:.2e} of the larger of 1 and "
          f"the largest (tol 1e-3, phase c's bar); as released (bfloat16) "
          f"median |Δ| {bf16:.3e}, printed; |median - truth| "
          + ", ".join(f"{k} {v:.3f}" for k, v in zip(
              engine.cfg.param_names[:4], tour["abs_error"][:4])))
    check(gap <= 1e-3, f"analyze_results card vs CPU {gap}")
    check(np.isfinite(is_res.weights).all() and is_res.ess > 0,
          "analyze_results importance weights")
    return {"seconds": wall, "launches": n, "shapes": shapes}


def z_kernels(torch, plain, rqs_cuda, card):
    """(z12) the spline kernels at the new paths' shapes (Z_SHAPES):
    rqs_tile bit-equal to the plain spline both ways, with and without the
    bias, rqs_grad<8> at frozen_context_heads' rows against the plain VJP;
    each shape timed beside its bound and the plain version."""
    times = {}
    for n, d, k, inverse in Z_SHAPES:
        x, raw, bias = spline_inputs(torch, n, seed=n + k + d, k=k, d=d)
        for b in (None, bias):
            for inv in (False, True):
                k_out, k_ld = rqs_cuda.KERNEL.launch(
                    x, raw.reshape(n, -1), k, TAIL, inv, bias=b)
                p_fn = plain.rqs_inverse if inv else plain.rqs_forward
                p_out, p_ld = p_fn(x, raw if b is None else raw + b, k, TAIL)
                torch.cuda.synchronize()
                e = max(float((k_out - p_out).abs().max()),
                        float((k_ld - p_ld).abs().max()))
                check(e == 0.0, f"rqs_tile<{k}> N={n} D={d} inverse={inv} "
                                f"bias={b is not None} differs: {e}")
        t = forward_timing(torch, plain, rqs_cuda, x, raw, bias,
                           inverse=inverse, k=k)
        times[(n, d, k, inverse)] = t
        print(f"(z12) rqs_tile<{k}, {'inverse' if inverse else 'forward'}, "
              f"bias> N={n} D={d} [{card}]: bit-equal to the plain spline "
              f"both ways, with and without the bias; device time a launch "
              + ("not measured" if t["ms"] is None
                 else f"{t['ms'] * 1e3:.2f} us")
              + f" (profiler), {t['events_ms'] * 1e3:.2f} us by CUDA events,"
              f" plain {t['plain_ms'] * 1e3:.1f} us; bound "
              f"{t['bound_ms'] * 1e3:.4f} us ({t['bound_by']}: "
              f"{rqs_bytes(n, d, k)} B)")
    n, d, k = Z_HEAD_BATCH, 7, 8
    x, raw, g_out, g_ld, bias = grad_inputs(torch, plain, n, k, seed=25,
                                            d=d)
    worst = 0.0
    for b in (None, bias):
        ref = plain.rqs_forward_vjp(x, raw, g_out, g_ld, k, TAIL, bias=b)
        got = rqs_cuda.GRAD_KERNEL.launch(x, raw.reshape(n, -1), g_out, g_ld,
                                          k, TAIL, b)
        torch.cuda.synchronize()
        errs = [grad_err(got[0], ref[0]),
                grad_err(got[1].reshape(ref[1].shape), ref[1])]
        worst = max(worst, *errs)
        check(all(math.isfinite(e) and e <= GRAD_REL for e in errs),
              f"rqs_grad<{k}> N={n} D={d}: {errs}")
    raw2 = raw.reshape(n, -1)

    def grad_fn():
        return rqs_cuda.GRAD_KERNEL.launch(x, raw2, g_out, g_ld, k, TAIL,
                                           bias)
    nbytes, nops = rqs_grad_bytes(n, d, k), rqs_grad_ops(n, d, k)
    by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S, nops / PEAK_F32_FLOPS
    g = {"ms": kernel_device_ms(torch, grad_fn, "rqs_grad"),
         "events_ms": cuda_time_ms(grad_fn, reps=50),
         "plain_ms": cuda_time_ms(lambda: plain.rqs_forward_vjp(
             x, raw, g_out, g_ld, k, TAIL, bias=bias), reps=5),
         "bound_ms": max(by_bytes, by_ops) * 1e3,
         "bound_by": "bytes" if by_bytes >= by_ops else "operations",
         "max_rel_err": worst}
    print(f"(z12) rqs_grad<{k}, bias> N={n} D={d} [{card}]: within "
          f"{worst:.2e} of the plain VJP's largest entry (tol {GRAD_REL:g} + "
          f"{GRAD_ABS:g}); device time a launch "
          + ("not measured" if g["ms"] is None else f"{g['ms'] * 1e3:.2f} us")
          + f" (profiler), {g['events_ms'] * 1e3:.2f} us by CUDA events, "
          f"plain VJP {g['plain_ms'] * 1e3:.1f} us; bound "
          f"{g['bound_ms'] * 1e3:.4f} us ({g['bound_by']}: {nbytes} B)")
    return {"times": times, "grad": g}


def phase_rest(torch, plain, rqs_cuda, card, tmp):
    """(z) the modules and tools of the last slice, z1-z12."""
    from posteriflow_torch.inference.pipeline import InferenceEngine
    from posteriflow_torch.train.checkpoints import load_npe
    t0 = time.perf_counter()
    cpu_model, _ = load_npe(RELEASE, device="cpu")
    cpu_engine = InferenceEngine.from_checkpoint(RELEASE, device="cpu")
    out = {"physics": z_physics(torch, card, tmp),
           "waveforms": z_waveforms(torch, card),
           "svd": z_svd(torch, card),
           "transformer": z_transformer(torch, card),
           "dataset": z_dataset(torch, card, tmp),
           "real_noise": z_real_noise(torch, plain, rqs_cuda, card,
                                      cpu_model, tmp),
           "precession": z_precession(torch, plain, rqs_cuda, card, tmp),
           "probe": z_probe(torch, plain, rqs_cuda, card, cpu_model, tmp),
           "heads": z_heads(torch, plain, rqs_cuda, card, tmp),
           "benchmark": z_benchmark(torch, plain, rqs_cuda, card, tmp),
           "examples": z_examples(torch, plain, rqs_cuda, card, cpu_engine),
           "kernels": z_kernels(torch, plain, rqs_cuda, card)}
    out["seconds"] = time.perf_counter() - t0
    print(f"(z) the last slice's phase done in {out['seconds']:.1f} s "
          f"[{card}]")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 2
    try:
        from posteriflow_torch.inference.pipeline import (InferenceEngine,
                                                          load_model)
        from posteriflow_torch.ops import rqs as plain
        from posteriflow_torch.ops import rqs_cuda
        from posteriflow_torch.train.checkpoints import load_release
    except ImportError as e:
        print(f"chip_smoke: posteriflow_torch is not importable ({e}); run "
              f"from the repository root", file=sys.stderr)
        return 3
    try:
        t_start = time.perf_counter()
        card = card_name_and_power()
        print(card)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"(a) torch {torch.__version__} cuda {torch.version.cuda}, "
              f"device {torch.cuda.get_device_name(0)}; "
              f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
              f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
        t0 = time.perf_counter()
        bank_build = {}
        bank_thread = threading.Thread(target=build_bank_server,
                                       args=(bank_build,))
        bank_thread.start()             # g++ beside nvcc
        rqs_cuda.KERNEL.load()
        built = rqs_cuda.KERNEL.build_seconds
        bank_thread.join()
        print(f"(a) kernel library {rqs_cuda.library_path().name} ready in "
              f"{time.perf_counter() - t0:.2f} s ("
              f"{'nvcc %.2f s' % built if built is not None else 'cached'})"
              f" [{card}]; crop server {bank_build['library']} built by g++ "
              f"in {bank_build['seconds']:.2f} s: {bank_build['ok']}")
        check(bank_build["ok"], "the crop server csrc/bankd.cpp did not "
                                "build (the compiler's output is logged)")
        phase_ptxas(rqs_cuda)

        x, raw, bias, errs = phase_kernel_check(torch, plain, rqs_cuda,
                                                card)

        state_dict, cfg, meta = load_release(RELEASE)
        engine = load_model(RELEASE, device=DEVICE)
        launches = phase_serve(torch, rqs_cuda, engine, card)
        phase_reference(torch, InferenceEngine, state_dict, cfg, card)
        bench = phase_bench(torch, plain, rqs_cuda, engine, x, raw, bias,
                            card)
        phase_profile(torch, engine, bench, card)

        from posteriflow_torch.physics.simulator import sim_config_from_dict
        sim_cfg = sim_config_from_dict(meta["config"]["sim"])
        phase_sim_parity(torch, sim_cfg, card)
        sim_ms = phase_sim_time(torch, sim_cfg, card)
        path = phase_bench_path(torch, rqs_cuda, engine, sim_cfg, card)
        inj_launches = phase_inject(torch, rqs_cuda, engine, card)
        phase_tf32(torch, InferenceEngine, card)
        phase_grad_guard(torch, plain, rqs_cuda)
        grad = phase_grad_kernel(torch, plain, rqs_cuda, card)

        from posteriflow_torch.utils.config import load_config
        train_cfg = load_config(f"{RELEASE}/meta.json")
        parity = phase_train_parity(torch, plain, rqs_cuda, train_cfg,
                                    state_dict, card)
        train = phase_train_steps(torch, plain, rqs_cuda, train_cfg, card)
        fitted = phase_fit(torch, rqs_cuda, train_cfg, card)
        imp = phase_importance(torch, plain, rqs_cuda, engine,
                               InferenceEngine, state_dict, cfg, card)
        t0 = time.perf_counter()
        priority = phase_priority(torch, card)
        overlap = phase_overlap(torch, plain, rqs_cuda, engine, cfg, card)
        decomp = phase_decompose(torch, plain, rqs_cuda, engine,
                                 overlap["prep"], card)
        pod = phase_batched_decompose(torch, plain, rqs_cuda, engine,
                                      train_cfg, sim_cfg, card)
        quality = phase_priority_quality(torch, card)
        print(f"(p)-(t) overlap phases done in "
              f"{time.perf_counter() - t0:.1f} s [{card}]")
        with tempfile.TemporaryDirectory() as tmp:
            bank = phase_bank(torch, plain, rqs_cuda, train_cfg, card, train,
                              f"{tmp}/bank")
            val = phase_validate(torch, plain, rqs_cuda, train_cfg, card,
                                 f"{tmp}/bank")
            t0 = time.perf_counter()
            lbk = phase_lb_kernels(torch, plain, rqs_cuda, card,
                                   (LB_V1_CHUNK, LB_V1_CHUNK * LB_V1_POST))
            lbs = phase_lb_serve(torch, plain, rqs_cuda, card)
            lbv = phase_lb_validate(torch, plain, rqs_cuda, card)
            lbt = phase_lb_train(torch, plain, rqs_cuda, card)
            lb1 = phase_lb_v1(torch, plain, rqs_cuda, card)
            lb_s = time.perf_counter() - t0
            print(f"(w) long-BNS phases done in {lb_s:.1f} s [{card}]")
            t0 = time.perf_counter()
            yaml_cfg = phase_configs(card)
            xt = phase_train_yaml(torch, plain, rqs_cuda, yaml_cfg, card,
                                  f"{tmp}/bank", tmp)
            phase_export(torch, xt, yaml_cfg, card, tmp)
            x_rows = anchor_rows_timing(torch, plain, rqs_cuda, card)
            xa = phase_anchor(torch, plain, rqs_cuda, card, tmp)
            xv = phase_evidence(card, tmp)
            phase_fusion(card, tmp)
            x_s = time.perf_counter() - t0
            print(f"(x) release-path and anchor phases done in {x_s:.1f} s "
                  f"[{card}]")
            t0 = time.perf_counter()
            for d in ("y", "y5"):
                os.makedirs(f"{tmp}/{d}")
            ym = phase_mesh(torch, plain, rqs_cuda, engine, train_cfg,
                            sim_cfg, card, f"{tmp}/y")
            y5 = phase_v3(torch, plain, rqs_cuda, card, f"{tmp}/y5")
            y_s = time.perf_counter() - t0
            print(f"(y) parallelism and v3 phases done in {y_s:.1f} s "
                  f"[{card}]")
            os.makedirs(f"{tmp}/z")
            zr = phase_rest(torch, plain, rqs_cuda, card, f"{tmp}/z")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    y_st = ym["ranks"][0]["steps"]
    y_fit_l = ym["ranks"][0]["fit"]["launches"]
    y_lb_l = tuple(sum(ym["ranks"][0]["lb"][p]["launches"][j]
                       for p in Y_LB_RELEASES) for j in (0, 1))
    y_lbt = ym["ranks"][0]["lb_train"]
    k_ms, p_ms = bench["times"]["inverse"]
    f_ms, fp_ms = bench["times"]["forward"]
    kernels = [{
        "name": "rqs_tile<16, inverse, bias> (RQS spline, sampling)",
        "route": "cuda",
        "source": "posteriflow_torch/csrc/rqs.cu",
        "replaces": "posteriflow_tpu/ops/pallas_rqs.py:118",
        "launches": path["launches"],
        "launches_by_path": {"simulate-encode-sample (h)": path["launches"],
                             f"serve {N_REQUESTS} requests (c)": launches,
                             "injection request (i)": inj_launches,
                             f"train {TRAIN_STEPS} steps (m)":
                                 train["launches"][0],
                             "fit 2 epochs + resume 1 (n)":
                                 fitted["launches"][0],
                             "importance correction (o)": imp["launches"],
                             f"overlap request, {len(OVERLAP)} ranks x "
                             f"{N_SAMPLES} rows (q)": overlap["launches"],
                             f"AHSDPipeline.decompose, {decomp['stages']} "
                             f"stages x 2048 rows (r)": decomp["launches"],
                             f"batched decompose, {POD_STAGES} stages x "
                             f"{POD_EVENTS * POD_SAMPLES} rows (s)":
                                 pod["launches"],
                             f"train {BANK_STEPS} steps with the device "
                             f"bank (u)": bank["steps"]["launches"][0],
                             f"train {FEED_STEPS} steps from the host feed "
                             f"(u)": bank["feed"]["launches"][0],
                             f"fit(bank=) 1 epoch x {BANK_FIT_STEPS} "
                             f"steps (u)": bank["fit"]["launches"][0],
                             f"validate_checkpoint {VAL_EVENTS} x "
                             f"{VAL_POST} (v)": val["launches"],
                             f"validate_checkpoint --noise-bank "
                             f"{VAL_REAL_EVENTS} (v)": val["real_launches"],
                             "twin_grid 4 x 4 x 2 twins (v)":
                                 val["twin"]["launches"],
                             f"importance_validation {len(IV_CASES)} cases "
                             f"(v)": val["iv"]["launches"],
                             f"train_npe --config {X_CONFIG} 1 epoch x "
                             f"{X_STEPS} steps with the bank (x2)":
                                 xt["launches"][0],
                             f"one anchor, {ANCHOR_ROWS} draws and their "
                             f"importance correction (x4)": xa["launches"],
                             f"make_train_step(mesh=) {Y_STEPS} + "
                             f"{Y_TIMED_STEPS} steps, rank 0 of "
                             f"{ym['world']} (y2)": sum(
                                 f for f, _ in y_st["launches"]),
                             f"fit(mesh=) 1 epoch x {Y_FIT_STEPS} steps, "
                             f"rank 0 (y2)": y_fit_l[0],
                             f"make_batched_decompose(mesh=), rank 0 (y3)":
                                 len(ym["ranks"][0]["decompose"]["rows"]),
                             "real_noise_test, 256 events (z6)":
                                 zr["real_noise"]["launches"][0],
                             "precession_robustness on npe_r3_best, 3 x "
                             "4096 draws (z7)":
                                 zr["precession"]["launches"][0],
                             "benchmark_real_events GW150914 (z10)":
                                 zr["benchmark"]["launches"][0],
                             "analyze_results with the importance "
                             "correction (z11)":
                                 zr["examples"]["launches"][0]},
        "max_abs_err": max(errs["inverse"][0], errs["forward"][0]),
        "max_abs_err_logdet": max(errs["inverse"][1], errs["forward"][1]),
        "ms": k_ms, "plain_ms": p_ms,
        "forward_ms": f_ms, "forward_plain_ms": fp_ms,
        "no_bias_ms": bench["times"]["inverse no bias"][0],
        "forward_no_bias_ms": bench["times"]["forward no bias"][0],
        "bound_ms": bench["bound_ms"], "bound_by": bench["bound_by"],
        f"rows_{TRAIN_ROWS}_forward_bias": grad["forward_train"],
        f"rows_{IS_ROWS}_forward_bias": imp["forward"],
        f"rows_{N_SAMPLES}": pod["timing"][N_SAMPLES],
        f"rows_{POD_EVENTS * POD_SAMPLES}":
            pod["timing"][POD_EVENTS * POD_SAMPLES],
        f"rows_{VAL_CHUNK * VAL_POST}_inverse_bias":
            val["timing"][VAL_CHUNK * VAL_POST],
        f"rows_{VAL_CHUNK}_forward_bias": val["timing"][VAL_CHUNK],
        f"rows_{ANCHOR_ROWS}_inverse_bias": x_rows,
        **{f"rows_{n}_d{d}_{'inverse' if inv else 'forward'}_bias":
           zr["kernels"]["times"][(n, d, k, inv)]
           for n, d, k, inv in Z_SHAPES if k == K_BINS},
        "library_ms": None,
    }, {
        "name": "rqs_grad<16, bias> (RQS spline backward, training)",
        "route": "cuda",
        "source": "posteriflow_torch/csrc/rqs.cu",
        "replaces": "posteriflow_tpu/models/flow.py:96",
        "launches": train["launches"][1],
        "launches_by_path": {f"train {TRAIN_STEPS} steps (m)":
                                 train["launches"][1],
                             "fit 2 epochs + resume 1 (n)":
                                 fitted["launches"][1],
                             f"train {BANK_STEPS} steps with the device "
                             f"bank (u)": bank["steps"]["launches"][1],
                             f"train {FEED_STEPS} steps from the host feed "
                             f"(u)": bank["feed"]["launches"][1],
                             f"fit(bank=) 1 epoch x {BANK_FIT_STEPS} "
                             f"steps (u)": bank["fit"]["launches"][1],
                             f"train_npe --config {X_CONFIG} 1 epoch x "
                             f"{X_STEPS} steps with the bank (x2)":
                                 xt["launches"][1],
                             f"make_train_step(mesh=) {Y_STEPS} + "
                             f"{Y_TIMED_STEPS} steps, rank 0 of "
                             f"{ym['world']} (y2)": sum(
                                 b for _, b in y_st["launches"]),
                             f"fit(mesh=) 1 epoch x {Y_FIT_STEPS} steps, "
                             f"rank 0 (y2)": y_fit_l[1]},
        "max_abs_err": grad["max_abs_err"],
        "max_rel_err": grad["max_rel_err"],
        "train_step_vs_plain": parity["kernels / plain on the card"],
        "ms": grad["times"][TRAIN_ROWS]["ms"],
        "ms_from": grad["times"][TRAIN_ROWS]["ms_from"],
        "events_ms": grad["times"][TRAIN_ROWS]["events_ms"],
        "plain_ms": grad["times"][TRAIN_ROWS]["plain_ms"],
        "bound_ms": grad["times"][TRAIN_ROWS]["bound_ms"],
        "bound_by": grad["times"][TRAIN_ROWS]["bound_by"],
        f"rows_{N_ROWS}": grad["times"][N_ROWS],
        "launch_floor_ms": grad["launch_floor_ms"],
        "host_us_a_call": grad["host_us"],
        "library_ms": None,
    }]
    t_inv = lbk["times"][(20000, LB_K, True)]
    t_f50 = lbk["times"][(50, LB_K, False)]
    t_f64 = lbk["times"][(64, LB_K, False)]
    t_v1 = lbk["times"][(LB_V1_CHUNK * LB_V1_POST, LB_V1_K, True)]
    t_v1f = lbk["times"][(LB_V1_CHUNK, LB_V1_K, False)]
    kernels += [{
        "name": f"rqs_tile<{LB_K}, inverse|forward, bias> (long_bns_v4's "
                f"spline)",
        "route": "cuda",
        "source": "posteriflow_torch/csrc/rqs.cu",
        "replaces": "posteriflow_tpu/ops/pallas_rqs.py:118",
        "launches": lbv["launches"],
        "launches_by_path": {
            f"validate_long_bns {LB_EVENTS} x {LB_POST} (w3)":
                lbv["launches"],
            f"one {LB_SERVE_EVENTS}-event request (w2)": lbs["launches"],
            f"train_long_bns {LB_TRAIN_STEPS} steps with evaluations and "
            f"calibration (w4)": lbt["launches"][0],
            f"make_sharded_nll_v4 on both v4 releases, rank 0 (y4)":
                y_lb_l[0],
            f"train_long_bns --mesh {ym['world']} {Y_LB_STEPS} steps, "
            f"rank 0 (y4)": y_lbt["launches"][0]},
        "max_abs_err": lbk["tile_err"][LB_K],
        "ms": t_inv["ms"] if t_inv["ms"] is not None else t_inv["events_ms"],
        "ms_from": ("profiler device time, inverse at 20000 rows"
                    if t_inv["ms"] is not None else "CUDA events"),
        "plain_ms": t_inv["plain_ms"],
        "bound_ms": t_inv["bound_ms"], "bound_by": t_inv["bound_by"],
        "rows_50_forward": t_f50, "rows_64_forward": t_f64,
        "library_ms": None,
    }, {
        "name": f"rqs_grad<{LB_K}, bias> (long_bns_v4's spline backward, "
                f"16-lane groups)",
        "route": "cuda",
        "source": "posteriflow_torch/csrc/rqs.cu",
        "replaces": "posteriflow_tpu/models/flow.py:96",
        "launches": lbt["launches"][1],
        "launches_by_path": {f"train_long_bns {LB_TRAIN_STEPS} steps (w4)":
                             lbt["launches"][1],
                             f"make_sharded_nll_v4 on both v4 releases, "
                             f"rank 0 (y4)": y_lb_l[1],
                             f"train_long_bns --mesh {ym['world']} "
                             f"{Y_LB_STEPS} steps, rank 0 (y4)":
                                 y_lbt["launches"][1]},
        "max_abs_err": lbk["grad"]["max_abs_err"],
        "max_rel_err": lbk["grad"]["max_rel_err"],
        "ms": (lbk["grad"]["ms"] if lbk["grad"]["ms"] is not None
               else lbk["grad"]["events_ms"]),
        "events_ms": lbk["grad"]["events_ms"],
        "plain_ms": lbk["grad"]["plain_ms"],
        "bound_ms": lbk["grad"]["bound_ms"],
        "bound_by": lbk["grad"]["bound_by"],
        "train_step_vs_plain": lbt["parity"]["kernels / plain on the card"],
        "library_ms": None,
    }, {
        "name": f"rqs_tile<{LB_V1_K}, inverse|forward, bias> (long_bns_v1's "
                f"spline)",
        "route": "cuda",
        "source": "posteriflow_torch/csrc/rqs.cu",
        "replaces": "posteriflow_tpu/ops/pallas_rqs.py:118",
        "launches": lb1["launches"],
        "launches_by_path": {
            f"validate_long_bns on long_bns_v1, {LB_V1_EVENTS} x "
            f"{LB_V1_POST} (w5)": lb1["launches"],
            f"train_long_bns --tokens v3 {Y_V3_STEPS} steps with "
            f"evaluations and calibration (y5)": y5["launches"][0],
            f"validate_long_bns on the v3 run, {Y_V3_VAL[0]} x "
            f"{Y_V3_VAL[1]} (y5)": y5["val_launches"],
            f"frozen_context_heads, 2 flow heads x {Z_HEAD_STEPS} steps "
            f"(z9)": zr["heads"]["launches"][0]},
        "max_abs_err": lbk["tile_err"][LB_V1_K],
        "ms": t_v1["ms"] if t_v1["ms"] is not None else t_v1["events_ms"],
        "ms_from": (f"profiler device time, inverse at "
                    f"{LB_V1_CHUNK * LB_V1_POST} rows"
                    if t_v1["ms"] is not None else "CUDA events"),
        "plain_ms": t_v1["plain_ms"],
        "bound_ms": t_v1["bound_ms"], "bound_by": t_v1["bound_by"],
        f"rows_{LB_V1_CHUNK}_forward": t_v1f,
        f"rows_{Y_V3_ROWS[0]}_forward_v3": y5["times"][Y_V3_ROWS[0]],
        f"rows_{Y_V3_ROWS[1]}_inverse_v3": y5["times"][Y_V3_ROWS[1]],
        f"rows_{Z_HEAD_BATCH}_d7_forward_heads": zr["kernels"]["times"][
            (Z_HEAD_BATCH, 7, 8, False)],
        "library_ms": None,
    }, {
        "name": f"rqs_grad<{Y_V3_K}, bias> (the v3 model's spline "
                f"backward, 8-lane groups)",
        "route": "cuda",
        "source": "posteriflow_torch/csrc/rqs.cu",
        "replaces": "posteriflow_tpu/models/flow.py:96",
        "launches": y5["launches"][1],
        "launches_by_path": {
            f"train_long_bns --tokens v3 {Y_V3_STEPS} steps (y5)":
                y5["launches"][1],
            f"frozen_context_heads, 2 flow heads x {Z_HEAD_STEPS} steps "
            f"(z9)": zr["heads"]["launches"][1]},
        "max_abs_err": y5["grad"]["max_abs_err"],
        "max_rel_err": y5["grad"]["max_rel_err"],
        "ms": (y5["grad"]["ms"] if y5["grad"]["ms"] is not None
               else y5["grad"]["events_ms"]),
        "events_ms": y5["grad"]["events_ms"],
        "plain_ms": y5["grad"]["plain_ms"],
        "bound_ms": y5["grad"]["bound_ms"],
        "bound_by": y5["grad"]["bound_by"],
        f"rows_{Z_HEAD_BATCH}_d7_heads": zr["kernels"]["grad"],
        "library_ms": None,
    }]
    print(f"(e) done in {time.perf_counter() - t_start:.1f} s [{card}]; "
          f"draws/s {bench['draws_per_s']:.0f} (noise batch, d), "
          f"{path['draws_per_s']:.0f} (simulated batch, h); simulate_batch "
          f"{sim_ms[BENCH_EVENTS]:.3f} ms at B={BENCH_EVENTS}, "
          f"{sim_ms[TRAIN_BATCH]:.3f} ms at B={TRAIN_BATCH}; training "
          f"{train['steps_per_s']:.3f} steps/s, {train['events_per_s']:.1f} "
          f"events/s at batch {train_cfg.batch_size}; importance "
          f"correction {imp['seconds']:.3f} s (peak {imp['peak_gib']:.2f} "
          f"GiB); overlap request (3 ranks) "
          f"{np.median(overlap['walls']) * 1e3:.1f} ms + ranking "
          f"{overlap['rank_s'] * 1e3:.2f} ms; decompose "
          f"{decomp['wall'] / decomp['stages'] * 1e3:.1f} ms a stage; "
          f"batched decompose {pod['call_ms']:.1f} ms a call; priority_eval "
          f"top-1 {quality['eval']['top1']:.4f}, close pairs "
          f"{quality['eval']['close']:.4f}; training with the bank "
          f"{bank['steps']['steps_per_s']:.3f} steps/s, host feed wait "
          f"{max(bank['feed']['waits_ms'][1:]):.3f} ms a step at most "
          f"after the first; validation at {VAL_EVENTS} x {VAL_POST} "
          f"{val['wall_s']:.2f} s; long_bns_v4 validation at {LB_EVENTS} x "
          f"{LB_POST} {lbv['wall']:.2f} s, training "
          f"{lbt['steps_per_s']:.2f} steps/s at batch {LB_TRAIN_BATCH}; "
          f"long_bns_v1 validation at {LB_V1_EVENTS} x {LB_V1_POST} "
          f"{lb1['wall']:.2f} s; train_npe from the YAML {xt['wall']:.1f} s "
          f"(trace on); anchor {ANCHOR} {xa['entry']['t_total_s']} s "
          f"(nested {xa['entry']['t_nested_s']} s, a {LIKE_ROWS}-row "
          f"likelihood call {xa['like_ms']:.3f} ms), logZ gap "
          f"{xa['entry']['logz_gap_is_minus_sampler']:+.3f}; evidence "
          f"validation {xv['wall']:.1f} s; phase x {x_s:.1f} s; "
          f"data-parallel training at world {ym['world']} "
          f"{y_st['steps_per_s']:.2f} steps/s; v3 training "
          f"{y5['train_s']:.1f} s for {Y_V3_STEPS} steps (peak "
          f"{y5['peak_gib']:.2f} GiB); phase y {y_s:.1f} s; phase z "
          f"{zr['seconds']:.1f} s (build_svd_basis 512 x 64 "
          f"{zr['svd']['seconds']:.2f} s, frozen_context_heads "
          f"{zr['heads']['seconds']:.2f} s, precession_robustness "
          f"{zr['precession']['seconds']:.2f} s)")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
