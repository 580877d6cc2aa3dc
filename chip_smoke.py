#!/usr/bin/env python3
"""On-card check of posteriflow_torch: serve the 15-D flagship release on one
NVIDIA GPU through the hand-written CUDA RQS kernel (csrc/rqs.cu: a TMA
bulk-copy ring of row tiles, one thread per spline, the conditioner's
derivative bias added in the kernel).

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  (a) CUDA present (no CPU fallback); the card's name and power limit; TF32
      off for matmuls and cuDNN; build the kernel with nvcc and print what
      `-Xptxas -v` says of every instance (registers, spills): the K = 16
      instances must spill nothing.
  (b) the kernel against its plain PyTorch version on raw + bias at the
      flagship sampling shape (N = 131072 rows, D = 7, K = 16) and at ragged
      N (641, 5000: a part tile), both directions, with and without the
      bias, with tails beyond ±5: out and logdet max |Δ| = 0.
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
  (k) the spline kernel refuses inputs that require grad under grad.
  (e) the kernel table and the device as JSON lines; the last line is
      {"ok": true, "device": {...}}.
Every time printed names the card and its power limit.
The script imports torch, numpy and scipy (through the port) only.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np

RELEASE = "model_release/npe_r7_best"
SAMPLE_RATE = 4096
DETECTORS = ("H1", "L1", "V1")
N_ROWS, D_TR, K_BINS, TAIL = 131072, 7, 16, 5.0   # flagship sampling shape
RAGGED_ROWS = (641, 5000)                         # a part tile at the end
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


def spline_inputs(torch, n: int, seed: int):
    """As the repo's Pallas parity test draws them: |x| up to 6 (tails
    beyond ±5), raw spline parameters N(0, 0.7²); a bias N(0, 0.5²) over
    all 3K-1 channels."""
    rng = np.random.default_rng(seed)
    n_raw = 3 * K_BINS - 1
    x = torch.from_numpy(np.clip(rng.standard_normal((n, D_TR)) * 2.5,
                                 -6.0, 6.0).astype(np.float32)).to(DEVICE)
    raw = torch.from_numpy((rng.standard_normal((n, D_TR, n_raw))
                            * 0.7).astype(np.float32)).to(DEVICE)
    bias = torch.from_numpy((rng.standard_normal(n_raw) * 0.5)
                            .astype(np.float32)).to(DEVICE)
    return x, raw, bias


def phase_kernel_check(torch, plain, rqs_cuda, card):
    """(b) kernel vs plain version at the flagship sampling shape and at
    ragged N, both directions, with and without the bias."""
    errs = {}
    flagship = None
    for n in (N_ROWS, *RAGGED_ROWS):
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


def phase_grad_guard(torch, rqs_cuda):
    """(k) the kernel has no backward: inputs that require grad, under
    grad, raise; under no_grad the same call runs."""
    x, raw, bias = spline_inputs(torch, 257, seed=4)
    raw.requires_grad_(True)
    try:
        rqs_cuda.rqs_inverse(x, raw, K_BINS, TAIL, bias=bias)
    except RuntimeError as e:
        msg = str(e)
    else:
        raise SmokeFailure("the kernel accepted inputs that require grad")
    with torch.no_grad():
        out, _ = rqs_cuda.rqs_inverse(x, raw, K_BINS, TAIL, bias=bias)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), "non-finite output under no_grad")
    print(f"(k) grad guard: rqs_inverse on CUDA inputs that require grad "
          f"raised RuntimeError ({msg[:60]}...); under no_grad it ran")


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
        rqs_cuda.KERNEL.load()
        built = rqs_cuda.KERNEL.build_seconds
        print(f"(a) kernel library {rqs_cuda.library_path().name} ready in "
              f"{time.perf_counter() - t0:.2f} s ("
              f"{'nvcc %.2f s' % built if built is not None else 'cached'})"
              f" [{card}]")
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
        phase_grad_guard(torch, rqs_cuda)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

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
                             "injection request (i)": inj_launches},
        "max_abs_err": max(errs["inverse"][0], errs["forward"][0]),
        "max_abs_err_logdet": max(errs["inverse"][1], errs["forward"][1]),
        "ms": k_ms, "plain_ms": p_ms,
        "forward_ms": f_ms, "forward_plain_ms": fp_ms,
        "no_bias_ms": bench["times"]["inverse no bias"][0],
        "forward_no_bias_ms": bench["times"]["forward no bias"][0],
        "bound_ms": bench["bound_ms"], "bound_by": bench["bound_by"],
        "library_ms": None,
    }]
    print(f"(e) done in {time.perf_counter() - t_start:.1f} s [{card}]; "
          f"draws/s {bench['draws_per_s']:.0f} (noise batch, d), "
          f"{path['draws_per_s']:.0f} (simulated batch, h); simulate_batch "
          f"{sim_ms[BENCH_EVENTS]:.3f} ms at B={BENCH_EVENTS}, "
          f"{sim_ms[TRAIN_BATCH]:.3f} ms at B={TRAIN_BATCH}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
