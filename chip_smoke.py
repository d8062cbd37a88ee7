#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``pint_tpu_torch``) on one GPU.

Run from the repo root on a machine with an NVIDIA H100::

    python3 chip_smoke.py

Phases, each reported on its own line; any failure exits non-zero and
the closing ``{"ok": true, ...}`` line is not printed:

1. the card's name and power limit (nvidia-smi);
2. build of every hand-written kernel from ``pint_tpu_torch/csrc``
   (K1-K11, K11b and the wide forms K5w/K5bw, one nvcc per source, all started
   together), with its time;
3. kernel K1 (exact fixed-point phase) against its plain PyTorch
   version run on the CPU: 10^6 random (F0, t) pairs plus poison cases,
   ``n`` and the bits of ``frac`` identical;
4. the 10k-TOA, 400-epoch GLS fit of the B1855-like DD pulsar with
   ECORR and red noise (``pint_tpu_torch/data/b1855_epochs_10k.npz``)
   through ``GLSFitter(..., device="cuda").fit_toas(maxiter=3)``, held
   to the JAX CPU answer the fixture carries; launch counts of K1 and
   K2 during the fit (both > 0); cold and warm wall time; a profiler
   breakdown of a warm fit;
5. kernel K2 (fixed-order segment sums) against its plain version on
   the CPU at N = 10^4, K_e = 400, M in {1, 10, 61}: bit identity, and
   bit identity from run to run on the card;
6. K1 and K2 timed at the fit's shapes, and the fit's torch-route rows
   (Kepler solve, capacity Cholesky, GLS solve, delay/phase fold): calls
   per warm fit, device time per call, kernels per call, bound;
7. the GW path on the 68-pulsar, 500-TOA array
   (``pint_tpu_torch/data/pta68_500.npz``): ``OptimalStatistic(pairs,
   nmodes=14)``, ``compute()``, ``noise_marginalized`` over 32 draws,
   ``common_process().lnlike(-13.7, 13/3)`` and the 16 x 16
   ``lnlike_grid``, each held to the JAX answer the case carries;
   launch counts of K1, K3, K4 and K5 during the path (all > 0); cold and
   warm wall time, grid points/s, peak device memory and the device
   busy share of one warm grid;
8. kernel K3 (ragged per-pulsar weighted gram) against its plain
   version on the card, at the case's shapes and at 68 pulsars x 10^4
   rows x width 92: within 1e-13 of each entry's sum of |terms|, and
   bit-identical from run to run; its time beside the padded
   ``torch.einsum`` and the bound, its kernels per call, ptxas's
   registers and spills (a spill fails the phase) and blocks per SM;
9. kernel K4 (OS pair stage) against its plain version at the OS's
   shapes, in the same way, with ptxas's report (a spill fails the
   phase); the library yardstick is the two matmuls Z diag(phihat) Z^T
   and V V^T on prescaled inputs, printed beside the same two with the
   phihat scaling inside the timed call;
9a. ``crn dense``: the dense CRN path on the same array,
    ``CommonProcess(pairs, nmodes=14, kron=False)``: ``lnlike`` at the
    three points of ``pint_tpu_torch/data/crn_dense_answers.npz``
    within 1e-10 of JAX's dense answers, the case's point under the
    monopole and dipole ORFs within ``tolerances.GW_SINGULAR_REL``, the
    16 x 16 ``lnlike_grid`` within 1e-10 of the case's JAX kron grid and
    of the card's own kron grid; launches of K1, K3 and K11 during the
    path (K11 > 0, K3 = 0: a dense instance builds no kron stacks); cold
    and warm wall, grid points/s, peak memory, busy share, device time
    per point against the capacity Cholesky's bound;
9b. ``k11``: K11 (the dense capacity G0 + phi^-1) against its plain
    version at the path's full width (4 points, and the grid's chunk of
    9) and at P = 12, G = 512:
    S per point relative to its largest entry and logdet phi within
    ``tolerances.crn_capacity_limit`` of the GW blocks' kappa,
    bit-identical run to run; its time beside the plain version, the
    batched cholesky_ex + cholesky_inverse of the (G m2, P, P) blocks
    and the bound; the capacity Cholesky's time and bound; ptxas's
    report (a spill fails the phase);
9c. ``kron append``: ``kron_gram_append`` of 25 rows to one pulsar
    against K3 over the extended stack, within ``KERNEL_SUM_REL`` of
    each entry's sum of |terms|, every other pulsar untouched; its time;
9d. ``dd``: every ``pint_tpu_torch.dd`` function on 10^6 seeded CUDA
    inputs, bit-identical to the same calls on CPU tensors; add, mul and
    div timed;
9e. ``pta batch``: ``PTABatch`` over the heterogeneous 68-pulsar,
    500-TOA array of ``pint_tpu_torch/data/pta68_500_batch.npz``
    (isolated and DD members alternating, EFAC/EQUAD/ECORR, 30-mode red
    noise): ``residuals``, ``residuals_shared``, ``chisq``, ``fit_wls(3)``
    and ``fit_gls(3)`` held to the JAX answers it carries (residuals
    1e-11 s, chi^2 at fixed values ``tolerances.pta_chi2_limit``, values
    (less one ulp) and sigma within ``fit_tolerances`` of each member's
    condition, the
    fitted chi^2 within its conditioning part plus ``pta_chi2_limit``)
    and to the port's single-pulsar WLS and GLS fits of every member on
    the card (F0 within 5e-10 Hz, chi^2 within 1e-8 relative); the
    isolated members' placeholder binary parameters unmoved; launches of
    K1, K2, K7, K8 on the path (K1, K7 > 0; K2 = K8 = 0); per batched
    fit call at 68 and 8 members those launches and the ATen ops (equal)
    and the profiler's kernels outside cuSOLVER's SVD and eigh, which
    run one factorization a member (fewer than 60 more at 68); cold and
    warm walls, pulsar
    fits/s, the 68 single fits' walls, busy share, device time by group
    and peak memory; ``pta homogeneous``: ``fit_gls(3)`` over the GW
    array's 68 pulsars (no superset, nb = 61) against the port's
    ``GLSFitter`` member by member, with its walls;
10. the Bayesian GWB posterior on the same array
    (``GWBPosterior(CommonProcess(pairs, nmodes=14))``, 138 dimensions:
    the GWB's (log10 A, gamma) and every pulsar's TNREDAMP, TNREDGAM):
    a production ``run_nuts`` of 16 chains, 16 warmup and 16 sampling
    draws in chunks of 16, 12 leapfrog steps, from the generator seeded
    0 -- launch counts of K1, K3, K5, K5b and K6 during the path (K5,
    K5b > 0, K6 = 13 a draw), warm chain-draws/s, gradients/s and ms per
    leapfrog
    step, the busy share of one warm draw (a 1-draw chunk), peak device
    memory, accept rate, divergences and the median log10 A against the
    grid peak;
11. the posterior against the JAX answers of
    ``pint_tpu_torch/data/pta68_500_hmc.npz``: lnprob at 8 theta within
    1e-10 relative, the gradient within 1e-10 of max|g|, -inf outside
    the prior; a 4-chain, 4-draw ``run_nuts`` with JAX's draws injected:
    positions within 1e-7 of the scales, lnprob and step sizes within
    1e-9 relative, the same accept decisions;
11a. ``hmc dense``: the same posterior over the dense path
    (``GWBPosterior(CommonProcess(pairs, nmodes=14, kron=False))``, K =
    6188): lnprob and its gradient at the 8 theta against JAX's kron
    answers and the card's own kron posterior, at the 2 theta of
    ``pint_tpu_torch/data/pta68_500_hmc_dense.npz`` against JAX's dense
    answers (1e-10 relative; 1e-10 of max|g|), -inf outside the prior,
    the injected-draw run against JAX's (the limits of 11, the same
    accept decisions); launches of K1, K3, K5, K5b, K11, K11b during the
    path (K11, K11b > 0; K3, K5, K5b = 0); one gradient at 4 chains: its
    wall, peak memory, busy share and device time by group (K11, K11b,
    potrf, the Cholesky backward's solves and products);
11b. ``k11b``: K11b (the backward of K11) against its plain version at
    the dense posterior's own inputs at 4 and 8 chains and at P = 12,
    G = 512, within ``tolerances.crn_capacity_bwd_limit`` of each
    entry's sum of |terms|, bit-identical run to run; its time beside
    the plain version and the bound (no PyTorch call computes it); K11
    with a row of noise weights a point against its plain version, and
    with equal rows bit-identical to K11 with the one shared row;
    ptxas's report (a spill fails the phase);
12. kernels K5 and K5b (per-pulsar capacity stage and its backward)
    against their plain versions on the card at the case's grams with
    16 chains of perturbed red-noise weights: within
    ``tolerances.KRON_PULSAR_REL`` per output, bit-identical from run
    to run, times beside the batched cholesky_ex + cholesky_solve +
    matmul and the plain backward (its autograd beside it), K5's
    kernels per call, ptxas
    reports of K5 and K5b (a spill fails the phase), K5's blocks per SM
    and waves, K5b's shared bytes; K6 (the transition's elementwise
    work, 13 launches a draw) against its plain stages in turn on the
    same states, draws and gradients over three draws (warmup to
    warmup, warmup to sampling, sampling), after each: the same accept
    decisions, every state within 4 ulp, bit-identical run to run; one draw's time on a state updated in place;
13. ``ingest``: ``get_model_and_toas`` on the committed
    ``pint_tpu_torch/data/b1855_like.par`` and ``b1855_epochs_10k.tim``,
    cold, held to the JAX table of ``b1855_epochs_10k_answers.npz``:
    ticks, TZR ticks, parsed columns and flags identical, the geometry
    bit for bit or within ``tolerances.INGEST_GEOMETRY_REL``, the prefit
    residuals on the card within 1e-11 s;
14. ``fit_par_tim``: ``GLSFitter`` and ``WLSFitter`` (maxiter=3) from
    those TOAs on the card, held to JAX's values, uncertainties, chi^2
    per iteration, final chi^2 and n_truncated with the
    conditioning-aware limits; launches of K1, K2 and K7 during each
    fit; cold and warm walls, TOAs/s, busy share of a warm fit;
15. ``k7`` (WLS whitening pass) against its plain version at the WLS
    fit's own (r, J, sigma), at N = 10^4, P = 11 (one cooperative
    launch) and at the WLS grid's 256 x 10^4 x 8 (two launches): rw,
    and Jn where the norms are equal, bit-identical, the rest within
    ``tolerances.WLS_WHITEN_REL``, bit-identical run to run; time,
    plain time, bound and ptxas report at the latter two;
16. ``pulse numbers``: the two cases of
    ``pint_tpu_torch/data/pn_answers.npz`` -- a 40-TOA gap case with 1 us
    of white noise under TRACK -2, its pulse numbers from
    ``compute_pulse_numbers`` on the
    card (equal to JAX's), fitted by ``WLSFitter`` from F0 + 1e-7 Hz
    (2.6 turns of drift across the 300-day gap), and corpus spin-000
    with a ``PHASE 0.3`` command, fitted from its par -- prefit and
    postfit residuals within 1e-11 s of JAX's, values, uncertainties and
    chi^2 per iteration within the conditioning-aware fit limits;
17. ``grid gls`` / ``grid wls``: the 16 x 16 chi^2 grids of the par/tim
    case through ``grid.make_grid_fn`` (GLS over (M2, SINI); WLS over
    (F0, F1) on ``b1855_white.par``), held to the JAX answers of
    ``b1855_grid_answers.npz`` (chi^2 within
    ``tolerances.REFIT_CHI2_REL``, refit values within the fit rows'
    conditioning-aware limits less one ulp); launches of
    K1, K2, K7, K8 during the grid call (those of its path > 0) and per
    call at G = 256 and G = 16 (equal); cold and warm wall, points/s,
    busy share and device time by group (the factorization's kernels
    named), peak device memory;
18. ``k8``: K8 (Woodbury chi^2 against a prebuilt factor) against its
    plain version at the GLS grid's own residuals (G = 256, N = 10^4,
    K = 461) and at the GLS chain's G = 16 (the first 16 of them):
    within ``tolerances.WOODBURY_PRE_REL`` of sum r^2/n, bit-identical
    run to run; time beside the plain version, the library composite
    (dense U^T (R/n)^T + solve_triangular) and the bound at each, the
    launch plan, ptxas's registers and spills of its three kernels (a
    spill fails the phase); ``grid kernels``: K1 and K2 at the
    grids' batched shapes against their plain versions, timed;
19. ``downhill``: ``DownhillGLSFitter`` and ``DownhillWLSFitter`` from
    the exported start (SINI = 0.995), held to JAX's iteration count,
    ``converged``, each iteration's lambda, chi^2 per iteration
    (``tolerances.REFIT_CHI2_REL``), values and uncertainties; and from
    SINI = 0.99, whose last step is decided at the noise floor, held to
    the iteration count, ``converged`` and chi^2 per iteration, its
    lambdas and values printed beside JAX's from 0.99 and one ulp either
    side; the first step halved; launches of K1, K2, K7 during each fit;
20. ``wide case``: ``pint_tpu_torch/data/pta4_wide.npz`` (4 pulsars,
    100 red-noise modes, nb = 203) -- ``lnlike``, a 2 x 2 grid and the
    posterior's value_and_grad at 4 theta on the card against the JAX
    answers it carries; launches of the wide forms K5w and K5bw (> 0);
21. ``k5 wide``: K5w and K5bw against their plain versions at the wide
    path's own inputs (the common process's noise weights, 1 x 4
    pulsars, and the posterior's at its 4 theta), at the wide case's
    grams with 16 chains and at nb = 470, m2 = 28 with 16 chains x 4
    pulsars and 16 chains x 68 pulsars (an HMC gradient's capacity
    stage on a NANOGrav-width array whose pulsars carry ECORR epochs):
    within ``tolerances.KRON_PULSAR_REL``, bit-identical run to run, L's
    upper triangle zero, no ptxas spill; times beside the library calls
    (the backward's: the plain backward, autograd of the plain forward
    beside it) and bounds, shared bytes, blocks per SM and waves (the
    kernels line takes the posterior's 4-theta row, the shape at which
    K5bw runs on the path);
22. ``mcmc gls`` / ``mcmc wls``: the timing posterior of the par/tim
    case (``BayesianTiming``: the par with ECORR and red noise fixed;
    the white par), its model fitted on the card and then set to JAX's
    fitted bits (the card's fit held to JAX's first), sampled by
    ``run_chain`` with 32 walkers x 200 steps and JAX's draws, held to
    ``b1855_mcmc_answers.npz`` up to the first near tie decided
    otherwise than in JAX (``tolerances.chain_parting_step``; the whole
    chain when there is none): positions bit-identical, every accept
    decision the same, lnp within ``tolerances.mcmc_lnp_limit``, the
    acceptance fraction; the Kepler depth JAX chose; launches of K1, K2,
    K7, K8, K9 (K9 = 3 per step, one per gap between posterior calls);
    cold and warm wall, posterior evaluations per second, busy share,
    peak memory;
23. ``k9``: a whole step of K9 (three launches) against the plain
    propose and accept in turn at the GLS chain's first step (32 x 10),
    at 8192 x 64 and at 32768 x 40, past one wave of co-resident
    blocks: bit-identical and bit-identical run to run; the time of a
    step and of its middle launch on buffers updated in place, the plain
    step's and the bound;
    ``mcmc autocorr``: ``EnsembleSampler.run_mcmc_autocorr`` on a 2-D
    Gaussian from the generator: converged, variance within 15 %;
24. ``stream gls`` / ``stream wls``: the streaming appends of the
    par/tim case (the par; the white par) in the 10842 bucket:
    ``fit_toas(maxiter=3)``, ``stream_prepare()`` and
    ``append_refit(night, maxiter=3)`` for the 11 nights of
    ``pint_tpu_torch/data/b1855_stream_nights.tim`` (10 clean, one with
    two rows 50 us off), held to ``b1855_stream_answers.npz`` night by
    night up to the first triage near tie decided otherwise: mode,
    verdict, quarantined rows and captures (the recapture after the 8th
    refit) equal to JAX's, chi^2 within
    ``tolerances.stream_chi2_limit``, values and uncertainties within
    ``tolerances.stream_fit_tolerances`` (the fit limits of JAX's refit
    condition number, grown by its centering ratio); the final values
    within 0.05 sigma of the port's own from-scratch fit, which is held
    to JAX's; launches of K1, K2, K7, K10 at the capture and per night
    (K10: one per incremental append and one per capture); the capture
    wall, the median append latency over nights 1-9, the cold
    from-scratch prepare + fit of the merged data, the busy share of one
    append, peak memory;
25. ``k10``: K10 against its plain version at the GLS and WLS captures'
    own inputs and at the GLS fold's shape (32 x 473 onto the packed
    moments): within ``tolerances.stream_moments_limit``,
    bit-identical run to run; time beside the plain version, one
    ``torch.addmm`` (A w precomputed), the same with A w formed inside
    the timed call, and the bound;
26. the ``kernels`` JSON line: per kernel its launches on its main path
    (the fit for K1 and K2, the WLS fit from par/tim for K7, the GLS
    grid for K8, the GW path for K3 and K4, the HMC run for K5, K5b and
    K6, the wide case for K5w and K5bw, the GLS chain for K9, the GLS
    stream for K10, the dense CRN path for K11, the dense posterior for
    K11b; K10's times at the
    fold's shape, K11's at the grid's chunk of 9 points), error
    against the plain version, time, plain-version
    time, bound, and the library call's time where one PyTorch call
    computes the same function.

Kernel times are device times per call (CUDA events around 50 calls
queued behind a sleep kernel, after a warm-up, :func:`queued_ms`) at
the shapes the main path gives each kernel; the profiler's kernel sum
and the per-call time with the host's enqueue (CUDA events around a
loop) are printed beside them.
Inputs stay in L2 between calls where they fit, as they do inside the
path.  Long outputs go to chiprun_out/.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback
import warnings
from functools import partial

import numpy as np

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, FP64
#: FLOP/s outside the tensor cores (elementwise work) and on them
#: (GEMM-shaped work: grams, dot products over pairs, factorizations)
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12
FP64_TC_FLOPS = 67e12

OUT_DIR = "chiprun_out"


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=200, warmup=10):
    """Mean device time of ``fn`` [ms] from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps=50, warmup=5):
    """(mean device time of ``fn`` [ms], kernels per call): the summed
    durations of the kernels it launches, from the profiler (CUPTI),
    without the host's enqueue gaps.  (None, 0) when the profiler
    records no kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA]
    us = sum(e.self_device_time_total for e in ev)
    n = sum(e.count for e in ev)
    return (us / reps / 1e3 if us > 0 else None), n / reps


def queued_ms(fn, reps=50, warmup=5):
    """Device time of ``fn`` per call [ms]: CUDA events around ``reps``
    calls that the host enqueues while a sleep kernel holds the card, so
    the card runs them back to back whatever the host's enqueue costs
    (a call that reads the device inside waits for the sleep, and then
    its host time counts)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / 3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # ~2e9 cycles/s at the H100's top clock; a longer sleep only waits
    torch.cuda._sleep(int(2e9 * (1.5 * reps * host_s + 2e-3)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps=50):
    """(device ms per call, how it was measured): :func:`queued_ms`
    over ``reps`` calls (few enough that their launches fit the card's
    launch queue, ~10^3, or the host paces them again).
    The profiler's per-kernel sum is printed beside it: for a kernel
    launched back to back from its ctypes library it reads low (K5:
    1/50 and then 3/10 of the time that events, its in-path profile and
    the enqueue loop agree on), so it is not the measure."""
    prof_ms, _ = device_ms(fn)
    return queued_ms(fn, reps), f"events, queued (profiler: {prof_ms!r} ms)"


def trace_kernels(prof, label):
    """({kernel name: [device µs summed, launches]}, span µs) from the
    kernel records of ``prof``'s exported chrome trace (CUPTI's activity
    records of every kernel the card ran in the window, whoever launched
    it); the span runs from the first kernel's start to the last one's
    end.  The sleep kernel that queues a window is left out."""
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, f"{label}_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    os.remove(path)
    by_name, lo, hi = {}, float("inf"), float("-inf")
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel" \
                and "spin_kernel" not in e["name"]:
            tot = by_name.setdefault(e["name"], [0.0, 0])
            tot[0] += float(e["dur"])
            tot[1] += 1
            lo = min(lo, float(e["ts"]))
            hi = max(hi, float(e["ts"]) + float(e["dur"]))
    return by_name, max(hi - lo, 0.0)


def bound_ms(n_bytes, n_flops, flops_per_s=FP64_FLOPS):
    """(least time [ms], what bounds it) at the published peaks;
    ``flops_per_s`` is FP64_TC_FLOPS for GEMM-shaped work."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_f = n_flops / flops_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def phase_card():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"nvidia-smi failed: {e}") from e
    log(out)
    return out


def phase_build():
    from pint_tpu_torch import _cuda
    from pint_tpu_torch.fixedpoint import K1
    from pint_tpu_torch.gw.hmc import K6
    from pint_tpu_torch.gw.os import K4
    from pint_tpu_torch.linalg import K2, K3, K5, K7, K8, K10, K11
    from pint_tpu_torch.sampler import K9

    t0 = time.time()
    libs = _cuda.build([k.source for k in (K1, K2, K3, K4, K5, K6, K7,
                                           K8, K9, K10, K11)])
    dt = time.time() - t0
    log(f"build: {len(libs)} kernels in {dt:.2f} s -> "
        f"{sorted(str(p) for p in libs.values())}")


def phase_k1():
    """K1 vs its plain version on the CPU: bit identity."""
    import torch

    from pint_tpu_torch import fixedpoint as fp

    rng = np.random.default_rng(12345)
    n = 1_000_000
    f0 = rng.uniform(1.0, 2048.0, n)
    # signed ticks inside the guard |F0 t| < 2^43 turns and int64
    tmax = np.minimum(2.0**62, 0.999 * 2.0**43 / f0 * 2.0**32)
    ticks = np.round(rng.uniform(-1.0, 1.0, n) * tmax).astype(np.int64)
    # a realistic millisecond-pulsar block: 186 Hz, +/- 20 yr
    k = n // 10
    f0[:k] = 186.49408156698235 + rng.normal(0, 1e-9, k)
    ticks[:k] = np.round(rng.uniform(-6.4e8, 6.4e8, k) * 2**32) \
        .astype(np.int64)
    # poison cases (F0 <= 0, F0 >= 2048, non-finite F0) and in-range
    # edges: int64-edge ticks, F0 quantizing to 0, F0 just under 2048
    cases = [(0.0, 2**40), (-1.0, 2**40), (2048.0, 2**40),
             (4096.0, 2**40), (np.nan, 2**40), (np.inf, 2**40),
             (-np.inf, 2**40), (1.0, 1 << 62), (1.0, -(1 << 62)),
             (2047.0, (1 << 63) - 1), (1e-300, 5),
             (np.nextafter(2048.0, 0.0), 2**40)]
    pois = np.array([c[0] for c in cases])
    pt = np.array([c[1] for c in cases], dtype=np.int64)
    f0 = np.concatenate([f0, pois])
    ticks = np.concatenate([ticks, pt])
    f0_c, t_c = torch.tensor(f0), torch.tensor(ticks)
    n_ref, frac_ref = fp.phase_f0_t_plain(f0_c, t_c)
    dev = torch.device("cuda")
    n_k, frac_k = fp.phase_f0_t_cuda(f0_c.to(dev), t_c.to(dev))
    torch.cuda.synchronize()
    n_k, frac_k = n_k.cpu(), frac_k.cpu()
    same_n = torch.equal(n_k, n_ref)
    same_bits = torch.equal(frac_k.view(torch.int64),
                            frac_ref.view(torch.int64))
    n_poison = int(torch.isnan(frac_ref).sum())
    finite = ~torch.isnan(frac_ref)
    err = float(torch.max(torch.abs(frac_k[finite] - frac_ref[finite])))
    log(f"k1: {len(f0)} (F0, t) pairs, {n_poison} poisoned; n identical "
        f"{same_n}, frac bits identical {same_bits}, max |dfrac| {err}")
    if not (same_n and same_bits):
        raise AssertionError("K1 differs from its plain version")
    return err


def phase_k2(su):
    """K2 vs its plain version on the CPU at the fit's shapes: bit
    identity, and run-to-run identity on the card."""
    import torch

    from pint_tpu_torch.linalg import segment_sum_cuda, segment_sum_plain

    rng = np.random.default_rng(7)
    n = su.seg.numel()
    perm_c, off_c = su.perm.cpu(), su.offsets.cpu()
    worst = 0.0
    for m in (1, 10, 61):
        x = torch.tensor(rng.standard_normal((n, m)) * 1e6)
        ref = segment_sum_plain(x, perm_c, off_c)
        xd = x.cuda()
        a = segment_sum_cuda(xd, su.perm, su.offsets)
        b = segment_sum_cuda(xd, su.perm, su.offsets)
        torch.cuda.synchronize()
        a, b = a.cpu(), b.cpu()
        same = torch.equal(a.view(torch.int64), ref.view(torch.int64))
        rerun = torch.equal(a.view(torch.int64), b.view(torch.int64))
        err = float(torch.max(torch.abs(a - ref)))
        worst = max(worst, err)
        log(f"k2: N={n} K_e={su.k_e} M={m}: bits identical to plain "
            f"{same}, run-to-run identical {rerun}, max |d| {err}")
        if not (same and rerun):
            raise AssertionError(f"K2 differs at M={m}")
    return worst


def phase_fit(arrays, model, toas, tzr):
    """The 10k fit on the card, held to the fixture's JAX answer."""
    import copy

    import torch

    from pint_tpu_torch import tolerances as tol
    from pint_tpu_torch.fitter import GLSFitter
    from pint_tpu_torch.fixedpoint import K1
    from pint_tpu_torch.linalg import K2
    from pint_tpu_torch.residuals import Residuals

    free = [str(p) for p in arrays["free_params"]]
    start_values = dict(model.values)

    # prefit residuals
    r = Residuals(toas, copy.deepcopy(model), tzr, device="cuda")
    pre = r.time_resids
    d_pre = float(np.max(np.abs(pre - arrays["ref_prefit_time_resids"])))
    log(f"fit: prefit time residuals max |d| vs JAX {d_pre:.3e} s "
        f"(tolerance {tol.PREFIT_S:g} s), {r.ecorr_segment_cols} ECORR "
        f"epochs")
    if not (d_pre <= tol.PREFIT_S):
        raise AssertionError("prefit residuals disagree")

    # the main path: counts reset just before, read just after
    K1.launches = 0
    K2.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    f = GLSFitter(toas, model, tzr, device="cuda")
    chi2 = f.fit_toas(maxiter=3)
    torch.cuda.synchronize()
    cold_s = time.time() - t0
    launches = {"K1": K1.launches, "K2": K2.launches}
    log(f"fit: launches during the fit {launches}")

    vals = [model.values[k] for k in free]
    uncs = [model.uncertainties[k] for k in free]
    errs = tol.fit_errors(vals, uncs, f.chi2_iters,
                          arrays["ref_fitted_values"],
                          arrays["ref_uncertainties"],
                          arrays["ref_chi2_iters"])
    tols = tol.fit_tolerances(f.fit_health["cond_log10"])
    log(f"fit: chi2 per iteration {f.chi2_iters} (JAX "
        f"{arrays['ref_chi2_iters'].tolist()}), final {chi2!r}, health "
        f"{f.fit_health}")
    log("fit: observed " + json.dumps(errs) + " tolerances "
        + json.dumps(tols) + " nominal " + json.dumps(
            {"values_sigma": tol.VALUES_SIGMA, "chi2_rel": tol.CHI2_REL,
             "unc_rel": tol.UNC_REL}))
    per_param = {k: [float((v - rv) / ru), float(u / ru - 1.0)]
                 for k, v, u, rv, ru in zip(
                     free, vals, uncs, arrays["ref_fitted_values"],
                     arrays["ref_uncertainties"])}
    log("fit: per parameter [dvalue/sigma, dsigma/sigma] "
        + json.dumps(per_param))
    bad = [k for k in errs if not (errs[k] <= tols[k])]
    if bad:
        raise AssertionError(f"fit disagrees with JAX on {bad}")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the path never ran: {launches}")

    # warm: same fitter, values reset, fit again
    def warm():
        model.values.update(start_values)
        f.fit_toas(maxiter=3)
        torch.cuda.synchronize()

    t0 = time.time()
    reps = 3
    for _ in range(reps):
        warm()
    warm_s = (time.time() - t0) / reps
    log(f"fit: wall time cold {cold_s:.3f} s (fitter build + first fit), "
        f"warm {warm_s:.3f} s per fit_toas(maxiter=3), "
        f"{len(toas) / warm_s:.1f} TOAs/s")
    profile_breakdown(warm, warm_s, "fit")
    return launches, f, start_values


def profile_breakdown(fn, wall_s, label):
    """Device time by kernel over one warm call of ``fn``
    (torch.profiler); returns (device busy share of its wall time,
    device ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        wall = time.time() - t0
    from torch.autograd import DeviceType

    ka = prof.key_averages()
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    rows = sorted(kernels, key=lambda e: -e.self_device_time_total)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"{label}_profile.txt"), "w") as fh:
        fh.write(ka.table(sort_by="self_device_time_total", row_limit=40))
    top = [(e.key[:60], round(e.self_device_time_total / 1e3, 3), e.count)
           for e in rows[:8]]
    busy = dev_us / 1e6 / wall
    log(f"profile: one warm {label}, wall {wall:.3f} s (unprofiled "
        f"{wall_s:.3f} s), device busy {dev_us / 1e3:.3f} ms "
        f"({busy * 100:.2f}% of wall); top kernels "
        f"[name, ms, calls] {json.dumps(top)}")
    return busy, dev_us / 1e3


def trace_breakdown(fn, wall_s, label, groups):
    """Device time by kernel over one warm call of ``fn`` from the
    profiler's trace (a chrome trace parsed here: the profiler's own
    ``key_averages`` takes minutes on the ~10^5 kernels of one HMC
    draw).  Returns (device busy share of the profiled wall, device ms,
    each group's share of the device time); the top kernels go to
    ``chiprun_out/{label}_profile.txt``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        wall = time.time() - t0
    t0 = time.time()
    by_name, _ = trace_kernels(prof, label)
    dev_us = sum(v[0] for v in by_name.values())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    with open(os.path.join(OUT_DIR, f"{label}_profile.txt"), "w") as fh:
        fh.write(f"{label}: device {dev_us / 1e3:.3f} ms over wall "
                 f"{wall:.3f} s; kernel, ms, launches\n")
        for name, (us, n) in rows[:60]:
            fh.write(f"{us / 1e3:12.3f} {n:8d}  {name}\n")
    busy = dev_us / 1e6 / wall
    top = [(k[:60], round(v[0] / 1e3, 3), v[1]) for k, v in rows[:8]]
    shares = {g: sum(v[0] for k, v in by_name.items()
                     if any(n in k.lower() for n in names))
              / max(dev_us, 1e-30) for g, names in groups.items()}
    log(f"profile: one warm {label}, wall {wall:.3f} s (unprofiled "
        f"{wall_s:.3f} s), device busy {dev_us / 1e3:.3f} ms "
        f"({busy * 100:.2f}% of wall), {sum(v[1] for v in by_name.values())}"
        f" kernels, trace parsed in {time.time() - t0:.1f} s; top kernels "
        f"[name, ms, launches] {json.dumps(top)}; device time by group "
        + json.dumps(shares))
    return busy, dev_us / 1e3, shares


def phase_kernel_table(f, launches, k1_err, k2_err):
    """Time each kernel, its plain version and the library call at the
    fit's shapes."""
    import torch

    from pint_tpu_torch import fixedpoint as fp
    from pint_tpu_torch.linalg import (segment_sum_cuda, segment_sum_plain)

    prep = f.prepared
    dt_ticks = prep.ctx["Spindown"]["dt_ticks"]
    f0 = torch.tensor(prep.model.values["F0"], dtype=torch.float64,
                      device="cuda")
    n = dt_ticks.numel()
    n_k, frac_k = fp.phase_f0_t_cuda(f0, dt_ticks)
    n_p, frac_p = fp.phase_f0_t_plain(f0.cpu(), dt_ticks.cpu())
    if not (torch.equal(n_k.cpu(), n_p) and torch.equal(
            frac_k.cpu().view(torch.int64), frac_p.view(torch.int64))):
        raise AssertionError("K1 differs from its plain version at the "
                             "fit's TOAs")
    log(f"k1: bit-identical to the plain version at the fit's {n} TOAs")
    k1 = partial(fp.phase_f0_t_cuda, f0, dt_ticks)
    k1p = partial(fp.phase_f0_t_plain, f0, dt_ticks)
    k1_ms, how = kernel_ms(k1)
    k1_plain_ms, _ = kernel_ms(k1p)
    log(f"k1 times at N={n}: kernel {k1_ms} ms, plain {k1_plain_ms} ms "
        f"({how}); per call with the host's enqueue: kernel "
        f"{cuda_ms(k1)} ms, plain {cuda_ms(k1p)} ms (events)")
    b1, by1 = bound_ms(24 * n + 8, 4 * n)
    rows = [{
        "name": "phase_f0_t", "route": "cuda",
        "source": "pint_tpu_torch/csrc/phase_f0_t.cu",
        "replaces": "pint_tpu/fixedpoint.py:110",
        "launches": launches["K1"], "max_abs_err": k1_err,
        "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": b1,
        "bound_by": by1, "library_ms": None}]

    su = f.resids._U_ext
    rng = np.random.default_rng(3)
    per_m = {}
    for m in (1, 10, 61):
        x = torch.tensor(rng.standard_normal((su.seg.numel(), m)),
                         device="cuda")
        seg64 = su.seg.to(torch.int64)
        k_e = su.k_e
        kern = partial(segment_sum_cuda, x, su.perm, su.offsets)
        plain_fn = partial(segment_sum_plain, x, su.perm, su.offsets)

        def lib_fn(x=x, m=m):
            return torch.zeros((k_e + 1, m), dtype=torch.float64,
                               device="cuda").index_add_(0, seg64, x)
        ms, how = kernel_ms(kern)
        plain, _ = kernel_ms(plain_fn)
        lib, _ = kernel_ms(lib_fn)
        enqueue_ms = cuda_ms(kern)
        nbytes = x.numel() * 8 + su.perm.numel() * 4 \
            + su.offsets.numel() * 4 + k_e * m * 8
        b, by = bound_ms(nbytes, su.perm.numel() * m)
        per_m[m] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                    "bound_ms": b, "bound_by": by, "timed_by": how,
                    "kernel_per_call_with_enqueue_ms": enqueue_ms}
    log("k2 times by width M: " + json.dumps(per_m))
    r61 = per_m[61]
    rows.append({
        "name": "segment_sum_fixed_order", "route": "cuda",
        "source": "pint_tpu_torch/csrc/segment_sum.cu",
        "replaces": "pint_tpu/linalg.py:191",
        "launches": launches["K2"], "max_abs_err": k2_err,
        "ms": r61["ms"], "plain_ms": r61["plain_ms"],
        "bound_ms": r61["bound_ms"], "bound_by": r61["bound_by"],
        "library_ms": r61["library_ms"]})
    return rows


def phase_torch_rows(f, start_values):
    """The fit's torch-route rows of the kernel table (q2 rows 3, 5, 6,
    8): calls per warm fit from ``start_values`` (counted by wrapping
    each function for one fit), device time and kernels per call at the
    fit's shapes, and the bound."""
    import torch

    import pint_tpu_torch.fitter as tfit
    import pint_tpu_torch.linalg as tl
    import pint_tpu_torch.models.binary.base as bbase
    from pint_tpu_torch.models.binary.kepler import kepler_eccentric_anomaly
    from pint_tpu_torch.models.timing_model import PreparedModel

    prep = f.prepared
    counts = {"kepler": 0, "cholesky": 0, "gls": 0, "fold": 0}
    patches = [(bbase, "kepler_eccentric_anomaly", "kepler"),
               (tl, "cho_factor", "cholesky"),
               (tfit, "gls_normal_solve", "gls"),
               (PreparedModel, "_phase_raw_at", "fold")]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]

    def counting(fn, key):
        def wrapped(*a, **k):
            counts[key] += 1
            return fn(*a, **k)
        return wrapped

    try:
        for obj, name, key in patches:
            setattr(obj, name, counting(getattr(obj, name), key))
        f.model.values.update(start_values)
        f.fit_toas(maxiter=3)
        torch.cuda.synchronize()
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)

    n = len(f.toas)
    values = prep.values_dict()
    data = f._fit_data
    gram = data["noise_gram"]
    sigma, phi, U = data["noise_sigma"], data["noise_phi"], f.resids._U_ext
    vec = torch.stack([values[k] for k in f._traced_free])
    r, J = f._rj(vec, values, data)
    n_par, k = J.shape[1], gram.shape[0]
    k_dense = U.pre.shape[1] + U.post.shape[1]
    depth = next(c["kepler_iters"] for c in prep.ctx.values()
                 if "kepler_iters" in c)
    g = torch.Generator(device="cuda").manual_seed(1)
    mean_anom = torch.rand(n, generator=g, device="cuda",
                           dtype=torch.float64) * 6.283185307179586
    ecc = torch.tensor(2.17e-5, dtype=torch.float64, device="cuda")
    nb = n_par + k
    # (fn, bytes, operations, peak): the factorizations are GEMM-shaped
    rows = {
        "3 kepler": (lambda: kepler_eccentric_anomaly(mean_anom, ecc, depth),
                     16 * n, n * (2 + 8 * depth), FP64_FLOPS),
        "5 capacity cholesky": (lambda: tl.cho_factor(gram),
                                16 * k * k, k**3 / 3, FP64_TC_FLOPS),
        "6 gls_normal_solve": (
            lambda: tl.gls_normal_solve(r, J, sigma, U, phi, gram=gram,
                                        with_health=True),
            8 * (n * n_par + 2 * n + n * k_dense + k * k + nb * nb),
            2 * n * n_par * (n_par + k_dense + 1) + n * n_par
            + 10 / 3 * nb**3, FP64_TC_FLOPS),
        "8 delay/phase fold": (
            lambda: prep._phase_raw_at(values, prep.batch, prep.ctx,
                                       prep.tzr_batch, prep.tzr_ctx),
            n * (8 * 3 + 24 * 3 + 16), None, FP64_FLOPS),
    }
    out = {}
    for (name, (fn, nbytes, nflops, peak)), key in zip(
            rows.items(), ("kepler", "cholesky", "gls", "fold")):
        ms, kern = device_ms(fn, reps=20, warmup=3)
        if ms is None:
            ms = cuda_ms(fn, reps=20)
        if nflops is None:
            # the fold's operations: at least one per TOA in each of its
            # elementwise kernels
            nflops = n * kern
        b, by = bound_ms(nbytes, nflops, peak)
        out[name] = {"calls_per_fit": counts[key], "ms": ms,
                     "kernels_per_call": kern, "bytes": nbytes,
                     "operations": nflops, "bound_ms": b,
                     "bound_by": by, "plain_ms": None, "library_ms": None}
    log(f"torch rows at the fit's shapes (N={n}, K={k}, n_par={n_par}, "
        f"Kepler depth {depth}): " + json.dumps(out))
    return out


def phase_gw(arrays, pairs):
    """The GW path on the 68-pulsar case, held to its JAX answers."""
    import torch

    from pint_tpu_torch import tolerances as tol
    from pint_tpu_torch.fixedpoint import K1
    from pint_tpu_torch.gw.os import K4, OptimalStatistic
    from pint_tpu_torch.linalg import K2, K3, K5

    kernels = {"K1": K1, "K2": K2, "K3": K3, "K4": K4, "K5": K5}
    nmodes = int(arrays["ref_nmodes"])
    amps, gams = arrays["ref_draws_log10_amp"], arrays["ref_draws_gamma"]
    la, ga = (float(x) for x in arrays["ref_lnlike_point"])
    grid_a, grid_g = arrays["ref_grid_log10_amp"], arrays["ref_grid_gamma"]
    n_pts = grid_a.size * grid_g.size

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t0

    def run_path(ost):
        res, t_os = timed(ost.compute)
        marg, t_marg = timed(lambda: ost.noise_marginalized(amps, gams))
        crn = ost.common_process()
        lnl, t_lnl = timed(lambda: crn.lnlike(la, ga))
        surf, t_grid = timed(lambda: crn.lnlike_grid(grid_a, grid_g))
        return (res, marg, lnl, surf, crn), {
            "compute_s": t_os, "noise_marginalized_32_s": t_marg,
            "lnlike_s": t_lnl, "lnlike_grid_256_s": t_grid}

    # the main path: counts reset just before, read just after
    for k in kernels.values():
        k.launches = 0
    ost, t_build = timed(lambda: OptimalStatistic(pairs, nmodes=nmodes,
                                                  device="cuda"))
    (res, marg, lnl, surf, crn), cold = run_path(ost)
    launches = {n: k.launches for n, k in kernels.items()}
    cold["build_s"] = t_build
    log(f"gw: launches during the path {launches}")

    errs = {
        "os_ahat2": abs(res.ahat2 / float(arrays["ref_os_ahat2"]) - 1),
        "os_snr": abs(res.snr / float(arrays["ref_os_snr"]) - 1),
        "os_sigma_ahat2": abs(res.sigma_ahat2
                              / float(arrays["ref_os_sigma_ahat2"]) - 1),
        "os_rho": tol.vector_rel(res.rho, arrays["ref_os_rho"]),
        "os_sig": tol.vector_rel(res.sig, arrays["ref_os_sig"]),
        "marg_ahat2": tol.vector_rel(marg[0], arrays["ref_marg_ahat2"]),
        "marg_snr": tol.vector_rel(marg[1], arrays["ref_marg_snr"]),
        "marg_sigma_ahat2": tol.vector_rel(
            marg[2], arrays["ref_marg_sigma_ahat2"]),
        "lnlike": abs(lnl / float(arrays["ref_lnlike"]) - 1),
        "grid": float(np.max(np.abs(surf / arrays["ref_grid_lnlike"]
                                    - 1))),
    }
    tols = {k: (tol.GW_LNLIKE_REL if k in ("lnlike", "grid")
                else tol.GW_OS_REL) for k in errs}
    peak_at = [int(i) for i in np.unravel_index(np.argmax(surf),
                                                 surf.shape)]
    log(f"gw: OS ahat2 {res.ahat2!r} (JAX {float(arrays['ref_os_ahat2'])!r})"
        f", snr {res.snr!r}, sigma_ahat2 {res.sigma_ahat2!r}; lnlike "
        f"{lnl!r} (JAX {float(arrays['ref_lnlike'])!r}); grid max "
        f"{float(np.max(surf))!r} at (log10 A, gamma) = "
        f"({grid_a[peak_at[0]]}, {grid_g[peak_at[1]]})")
    log("gw: observed relative errors " + json.dumps(errs)
        + " tolerances " + json.dumps(tols))
    bad = [k for k in errs if not (errs[k] <= tols[k])]
    if bad:
        raise AssertionError(f"GW path disagrees with JAX on {bad}")
    if not all(launches[k] > 0 for k in ("K1", "K3", "K4", "K5")):
        raise AssertionError(f"a kernel of the GW path never ran: "
                             f"{launches}")

    # warm: the same engines again (the build once more, for its time)
    _, warm_build = timed(lambda: OptimalStatistic(pairs, nmodes=nmodes,
                                                   device="cuda"))
    _, warm = run_path(ost)
    warm["build_s"] = warm_build
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    _, t_grid = timed(lambda: crn.lnlike_grid(grid_a, grid_g))
    peak = torch.cuda.max_memory_allocated()
    log("gw: wall time cold " + json.dumps(cold) + " warm "
        + json.dumps(warm))
    log(f"gw: lnlike_grid {n_pts} points in {t_grid:.4f} s warm = "
        f"{n_pts / t_grid:.1f} points/s, {crn.grid_chunk()} points per "
        f"batch; peak device memory {peak / 2**30:.3f} GiB during the "
        f"grid ({base_mem / 2**30:.3f} GiB held before it)")
    # the trace, not key_averages: a grid's ~10^4 MAGMA launches took
    # the profiler's own summary minutes
    busy, dev_ms, _ = trace_breakdown(
        lambda: crn.lnlike_grid(grid_a, grid_g), t_grid, "grid",
        {"MAGMA batched getrf": ["batched"], "K5": ["kron_pulsar"],
         "ATen elementwise": ["at::native"]})
    # one point's least work: the LU of its (P m2)^2 system and one
    # solve; reads the per-pulsar m, the ORF and the spectrum
    pm = crn.n_pulsars * 2 * crn.nmodes
    m2 = 2 * crn.nmodes
    b, by = bound_ms(8 * (crn.n_pulsars * (m2 * m2 + m2)
                          + crn.n_pulsars**2 + m2),
                     2 / 3 * pm**3 + 2 * pm**2, FP64_TC_FLOPS)
    log(f"gw: grid device time per point {dev_ms / n_pts!r} ms (all "
        f"kernels of one warm grid), bound {b!r} ms ({by}; the LU of "
        f"{pm}^2 and one solve at the fp64 tensor-core peak)")
    return {"launches": launches, "ost": ost, "cold": cold, "warm": warm,
            "grid_points_per_s": n_pts / t_grid, "peak_bytes": peak,
            "grid_busy": busy, "surf": surf}


def _check_sum_bound(name, got, again, plain, abs_sum):
    """got vs plain within KERNEL_SUM_REL * abs_sum per entry; got and
    again bit-identical.  Returns max |got - plain|."""
    import torch

    from pint_tpu_torch import tolerances as tol

    same = torch.equal(got.view(torch.int64), again.view(torch.int64))
    diff = torch.abs(got - plain)
    ratio = float(torch.max(diff / torch.clamp(abs_sum, min=1e-300)))
    ok = bool(torch.all(diff <= tol.KERNEL_SUM_REL * abs_sum))
    err = float(torch.max(diff))
    log(f"{name}: run-to-run bit-identical {same}, max |kernel - plain| "
        f"{err!r}, max |d| / sum|terms| {ratio!r} (limit "
        f"{tol.KERNEL_SUM_REL:g})")
    if not (same and ok):
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def synthetic_stack(n_psr, n_rows, nb, m2, seed=0):
    """A uniform RaggedStack of random rows on the card."""
    import torch

    from pint_tpu_torch.linalg import RaggedStack

    w = nb + m2 + 1
    g = torch.Generator(device="cuda").manual_seed(seed)
    t = torch.randn(n_psr * n_rows * w, generator=g, device="cuda",
                    dtype=torch.float64)
    sigma = 1e-6 * (0.5 + torch.rand(n_psr * n_rows, generator=g,
                                     device="cuda", dtype=torch.float64))
    rows = torch.arange(n_psr + 1, device="cuda") * n_rows
    return RaggedStack(t=t, sigma=sigma, row_off=rows, t_off=rows * w,
                       nb=torch.full((n_psr,), nb, dtype=torch.int32,
                                     device="cuda"),
                       nb_host=(nb,) * n_psr, m2=m2)


def build_report(kernel, names, occupancy=None, *occ_args):
    """ptxas's registers and spills for the kernels of ``kernel``'s
    source whose names contain one of ``names``, and the blocks per SM
    the occupancy query gives (where the source has one); raises if
    ptxas reported nothing or a spill."""
    from pint_tpu_torch import _cuda

    rep = _cuda.ptxas_report(_cuda.build_log(kernel.source) or "")
    ptx = {n: v for n, v in rep.items() if any(k in n for k in names)}
    if len(ptx) != len(names):
        raise AssertionError(f"no ptxas report for {names} in {kernel.source}")
    spills = {n: v for n, v in ptx.items()
              if v.get("spill_stores", 0) or v.get("spill_loads", 0)}
    if spills:
        raise AssertionError(f"ptxas spills in {kernel.source}: {spills}")
    if occupancy is None:
        return {"ptxas": ptx}
    return {"ptxas": ptx, "blocks_per_sm": kernel.call(occupancy, *occ_args)}


def phase_k3(st_case):
    """K3 against its plain version on the card at the case's shapes and
    at 10^4 rows per pulsar; times beside the padded einsum."""
    import dataclasses

    import torch

    from pint_tpu_torch.linalg import (K3, k3_row_splits, kron_gram_cuda,
                                       kron_gram_plain)

    out = {}
    for label, st in (("case", st_case),
                      ("n10k", synthetic_stack(68, 10_000, 63, 28))):
        g1, l1 = kron_gram_cuda(st)
        g2, l2 = kron_gram_cuda(st)
        gp, lp = kron_gram_plain(st)
        ga, _ = kron_gram_plain(dataclasses.replace(st, t=st.t.abs()))
        la = torch.stack([torch.sum(torch.abs(torch.log(s**2)))
                          for s in torch.split(st.sigma, st.n_rows)])
        torch.cuda.synchronize()
        err = max(_check_sum_bound(f"k3 {label} gram", g1, g2, gp, ga),
                  _check_sum_bound(f"k3 {label} ld_white", l1, l2, lp, la))
        n_rows = st.n_rows
        widths = [nb + st.m2 + 1 for nb in st.nb_host]
        nbytes = 8 * (st.t.numel() + st.sigma.numel() + g1.numel()
                      + l1.numel())
        # per row: w weighted entries, a multiply-add per entry i <= j,
        # 1/sigma^2 and log sigma^2
        nflops = sum(n * (w * (w + 1) + w + 4)
                     for n, w in zip(n_rows, widths))
        b, by = bound_ms(nbytes, nflops, FP64_TC_FLOPS)
        ms, how = kernel_ms(lambda: kron_gram_cuda(st))
        plain, _ = kernel_ms(lambda: kron_gram_plain(st))
        lib = None
        if len(set(n_rows)) == 1 and len(set(widths)) == 1:
            t3 = st.t.view(st.n_psr, n_rows[0], widths[0])
            w2 = (1.0 / st.sigma**2).view(st.n_psr, n_rows[0])
            lib, _ = kernel_ms(lambda: torch.einsum("pni,pn,pnj->pij",
                                                    t3, w2, t3))
        out[label] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                      "bound_ms": b, "bound_by": by, "max_abs_err": err,
                      "timed_by": how, "bytes": nbytes, "flops": nflops,
                      "per_call_with_enqueue_ms":
                          cuda_ms(lambda: kron_gram_cuda(st), reps=20),
                      # the launcher issues the partial and reduce passes
                      "kernels_per_call": 2,
                      "pass1_blocks": sum(len(k3_row_splits(n))
                                          for n in n_rows),
                      **build_report(K3, ("kron_gram_partial",
                                          "kron_gram_reduce"),
                                     "kron_gram_occupancy", st.nb_max,
                                     st.m2)}
        log(f"k3 {label}: P={st.n_psr} rows {n_rows[0]}..{max(n_rows)} "
            f"widths {min(widths)}..{max(widths)}: " + json.dumps(out[label]))
    return out


def phase_k4(ost):
    """K4 against its plain version at the OS's shapes; times beside two
    library yardsticks: the bare two matmuls Z diag(phihat) Z^T and V V^T
    on prescaled inputs, and the same with the phihat scaling inside the
    timed call."""
    import torch

    from pint_tpu_torch.gw.os import K4, os_pairs_cuda, os_pairs_plain
    from pint_tpu_torch.linalg import kron_pulsar_terms

    _, z, M, _ = kron_pulsar_terms(ost.kron_data.gram,
                                   ost.kron_data.phi_noise)
    ph = ost._phihat
    ii, jj = (torch.as_tensor(x, device="cuda") for x in (ost._ii, ost._jj))
    n_pairs = ii.numel()
    n1, d1 = os_pairs_cuda(z, M, ph)
    n2, d2 = os_pairs_cuda(z, M, ph)
    np_, dp = os_pairs_plain(z, M, ph, ii, jj)
    na, da = os_pairs_plain(z.abs(), M.abs(), ph.abs(), ii, jj)
    torch.cuda.synchronize()
    err = max(_check_sum_bound("k4 num", n1, n2, np_, na),
              _check_sum_bound("k4 den", d1, d2, dp, da))
    p, m2 = z.shape
    nbytes = 8 * (z.numel() + M.numel() + ph.numel() + 2 * n_pairs)
    # phihat z and phihat^1/2 M phihat^1/2 once per pulsar, then a dot
    # product of length m2 (num) and m2^2 (den) per pair
    nflops = p * (2 * m2 * m2 + m2) + n_pairs * 2 * (m2 * m2 + m2)
    b, by = bound_ms(nbytes, nflops, FP64_TC_FLOPS)
    zp = z * ph
    sq = torch.sqrt(ph)
    V = (sq[:, None] * M * sq[None, :]).reshape(p, m2 * m2)

    def lib():
        return zp @ z.T, V @ V.T

    def lib_scaled():
        s = torch.sqrt(ph)
        v = (s[:, None] * M * s[None, :]).reshape(p, m2 * m2)
        return (z * ph) @ z.T, v @ v.T
    ms, how = kernel_ms(lambda: os_pairs_cuda(z, M, ph))
    plain, _ = kernel_ms(lambda: os_pairs_plain(z, M, ph, ii, jj))
    lib_ms, _ = kernel_ms(lib)
    lib_scaled_ms, _ = kernel_ms(lib_scaled)
    out = {"ms": ms, "plain_ms": plain, "library_ms": lib_ms,
           "library_scaled_ms": lib_scaled_ms,
           "bound_ms": b, "bound_by": by, "max_abs_err": err,
           "timed_by": how, "n_pairs": n_pairs, "m2": m2,
           "blocks": sum(1 for r in range(0, p, 16) for c in range(0, p, 8)
                         if r < c + 7),
           "per_call_with_enqueue_ms": cuda_ms(
               lambda: os_pairs_cuda(z, M, ph)),
           **build_report(K4, ("os_pairs_kernel",))}
    log("k4 at the OS's shapes: " + json.dumps(out))
    return out


#: the production run of the HMC phase (16 chains, 16 + 16 draws; 32 + 32
#: until the par/tim and wide-case phases needed the time)
HMC_RUN = dict(n_chains=16, num_warmup=16, num_samples=16, chunk=16,
               num_leapfrog=12)


def phase_hmc(pta_arrays, pairs):
    """The HMC main path on the 68-pulsar case: posterior build and a
    production ``run_nuts``; launch counts, warm rates, busy share, peak
    memory, and the sanity checks (finite draws, acceptance > 0.05)."""
    import torch

    from pint_tpu_torch.fixedpoint import K1
    from pint_tpu_torch.gw.common import CommonProcess
    from pint_tpu_torch.gw.hmc import K6, GWBPosterior, run_nuts
    from pint_tpu_torch.linalg import K3, K5, K5B

    kernels = {"K1": K1, "K3": K3, "K5": K5, "K5b": K5B, "K6": K6}
    nmodes = int(pta_arrays["ref_nmodes"])
    c, chunk, n_leap = (HMC_RUN[k] for k in ("n_chains", "chunk",
                                             "num_leapfrog"))
    # the main path: counts reset just before, read just after
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    post = GWBPosterior(CommonProcess(pairs, nmodes=nmodes, device="cuda"))
    torch.cuda.synchronize()
    t_build = time.time() - t0
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.time()
    res = run_nuts(post, generator=gen, seed=0, **HMC_RUN)
    t_run = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {n: k.launches for n, k in kernels.items()}
    log(f"hmc: launches during the path {launches} (ndim {post.ndim}, "
        f"{c} chains, {HMC_RUN['num_warmup']} + {HMC_RUN['num_samples']} "
        f"draws, {n_leap} leapfrog steps)")
    warm = res.chunk_seconds[1:]
    t_chunk = float(np.mean(warm))
    rates = {
        "build_s": t_build, "run_s": t_run,
        "chunk_s": res.chunk_seconds,
        "chain_draws_per_s": c * chunk / t_chunk,
        "chain_gradients_per_s": c * chunk * n_leap / t_chunk,
        "batched_gradients_per_s": chunk * n_leap / t_chunk,
        "ms_per_leapfrog_step": t_chunk / (chunk * n_leap) * 1e3,
        "peak_gib": peak / 2**30, "held_before_gib": base_mem / 2**30}
    log("hmc: warm rates (chunks 2..) " + json.dumps(rates))
    grid = pta_arrays["ref_grid_lnlike"]
    ia, ig = np.unravel_index(np.argmax(grid), grid.shape)
    peak_a = float(pta_arrays["ref_grid_log10_amp"][ia])
    med_a = float(np.median(res.samples[..., 0]))
    log(f"hmc: accept rate {res.accept_rate!r}, divergences "
        f"{res.divergences}, step sizes {res.step_size.tolist()}, median "
        f"log10 A {med_a!r} (grid peak {peak_a} at gamma "
        f"{float(pta_arrays['ref_grid_gamma'][ig])}), median gamma "
        f"{float(np.median(res.samples[..., 1]))!r}")
    if not (np.all(np.isfinite(res.samples))
            and np.all(np.isfinite(res.warmup_samples))):
        raise AssertionError("hmc: a draw is not finite")
    if not res.accept_rate > 0.05:
        raise AssertionError(f"hmc: acceptance {res.accept_rate} <= 0.05")
    if not all(launches[k] > 0 for k in ("K5", "K5b", "K6")):
        raise AssertionError(f"a kernel of the HMC path never ran: "
                             f"{launches}")
    n_draws = HMC_RUN["num_warmup"] + HMC_RUN["num_samples"]
    if launches["K6"] != (n_leap + 1) * n_draws:
        raise AssertionError(f"hmc: K6 launched {launches['K6']} times, "
                             f"not {n_leap + 1} a draw")
    # one warm draw more (a 1-draw chunk, 12 leapfrog steps), profiled
    # from where the run ended: a 16-draw chunk's trace (~10^5 kernels)
    # takes the profiler longer to reduce than this script may run
    x_last = res.samples[-1]
    eps = float(np.median(res.step_size))

    def one_draw():
        run_nuts(post, generator=gen, x0=x_last, n_chains=c,
                 num_warmup=0, num_samples=1, chunk=1,
                 num_leapfrog=n_leap, step_size0=eps)
        torch.cuda.synchronize()
    t0 = time.time()
    one_draw()
    t_draw = time.time() - t0
    busy, dev_ms, shares = trace_breakdown(
        one_draw, t_draw, "hmc", groups={
            "K5": ["kron_pulsar_fwd"], "K5b": ["kron_pulsar_bwd"],
            "K6": ["nuts_"],
            "MAGMA batched getrf": ["batched"],
            "cuBLAS batched trsm and gemm": ["batch_trsm", "xmma_gemm"],
            "ATen elementwise": ["at::native"]})
    log(f"hmc: one warm draw device {dev_ms!r} ms, busy "
        f"{busy * 100:.2f}% of its wall, {dev_ms / (n_leap + 1)!r} ms of "
        f"device time per gradient ({n_leap} leapfrog steps and the "
        f"start's gradient)")
    rates.update({"busy": busy, "device_ms_per_draw": dev_ms,
                  "shares": shares})
    return {"launches": launches, "post": post, "rates": rates}


def phase_hmc_parity(post, ref):
    """The posterior at full width against the JAX answers: lnprob and
    its gradient at 8 theta, and an injected-draw trajectory."""
    import torch

    from pint_tpu_torch import tolerances as tol
    from pint_tpu_torch.gw.hmc import run_nuts

    if post.param_names != [str(n) for n in ref["param_names"]] \
            or not np.array_equal(post.bounds, ref["bounds"]) \
            or not np.array_equal(post.scales, ref["scales"]) \
            or not np.array_equal(post.initial_chains(4, seed=0),
                                  ref["x0"]):
        raise AssertionError("hmc parity: layout, bounds, scales or "
                             "starts differ from JAX")
    th = torch.as_tensor(ref["theta"], device="cuda")
    lnp, g = (a.cpu().numpy() for a in post.value_and_grad(th))
    fin = np.isfinite(ref["lnprob"])
    lnp_rel = float(np.max(np.abs(lnp[fin] / ref["lnprob"][fin] - 1)))
    grad_rel = max(float(np.max(np.abs(g[i] - ref["grad"][i]))
                         / np.max(np.abs(ref["grad"][i])))
                   for i in np.flatnonzero(fin))
    oob = bool(np.all(lnp[~fin] == -np.inf)) and bool(np.any(~fin))
    log(f"hmc parity: lnprob at {int(fin.sum())} theta max rel "
        f"{lnp_rel!r} (limit {tol.GW_LNLIKE_REL:g}), gradient max |d| / "
        f"max |g| {grad_rel!r} (limit {tol.HMC_GRAD_REL:g}), outside the "
        f"prior -inf {oob}; lnprob {lnp.tolist()}")
    kw = {k: int(ref[f"run_{k}"]) for k in (
        "n_chains", "num_warmup", "num_samples", "chunk", "num_leapfrog",
        "seed")}
    res = run_nuts(post, draws=(ref["draw_z"], ref["draw_n_steps"],
                                ref["draw_u"]), **kw)
    sc = post.scales
    errs = {
        "samples_scales": float(np.max(np.abs(
            (res.samples - ref["run_samples"]) / sc))),
        "warmup_scales": float(np.max(np.abs(
            (res.warmup_samples - ref["run_warmup_samples"]) / sc))),
        "lnp_rel": float(np.max(np.abs(res.lnprob / ref["run_lnprob"]
                                       - 1))),
        "step_size_rel": float(np.max(np.abs(
            res.step_size / ref["run_step_size"] - 1)))}
    same = bool(np.array_equal(res.accepted, ref["run_accepted"]))
    log(f"hmc parity: injected-draw run {kw}: largest deviations "
        + json.dumps(errs) + f" (limits {tol.HMC_PATH_SCALES:g} in scales, "
        f"{tol.HMC_LNP_REL:g} rel); accept decisions identical {same} "
        f"({res.accepted.astype(int).tolist()}); accept rate "
        f"{res.accept_rate!r} (JAX {float(ref['run_accept_rate'])!r})")
    bad = [k for k, v in errs.items() if not v <= (
        tol.HMC_PATH_SCALES if k.endswith("scales") else tol.HMC_LNP_REL)]
    if not (lnp_rel <= tol.GW_LNLIKE_REL and grad_rel <= tol.HMC_GRAD_REL
            and oob and same and not bad):
        raise AssertionError(f"hmc parity fails: lnprob {lnp_rel}, grad "
                             f"{grad_rel}, oob {oob}, accepts {same}, {bad}")
    return {"lnp_rel": lnp_rel, "grad_rel": grad_rel, **errs}


def _bits_equal(a, b):
    import torch

    return all(torch.equal(x.view(torch.int64), y.view(torch.int64))
               for x, y in zip(a, b))


def phase_k5(post):
    """K5 and K5b against their plain versions on the card at the
    case's grams, 16 chains of perturbed red-noise weights."""
    import torch

    from pint_tpu_torch import tolerances as tol
    from pint_tpu_torch.linalg import (K5, K5B, kron_pulsar_bwd_cuda,
                                       kron_pulsar_bwd_plain,
                                       kron_pulsar_cuda, kron_pulsar_plain)

    rng = np.random.default_rng(5)
    c = HMC_RUN["n_chains"]
    th = np.repeat(post.center()[None], c, axis=0)
    th[:, 2:] += rng.uniform(-0.5, 0.5, th[:, 2:].shape)
    phi = post.phi_noise_at(torch.as_tensor(th, device="cuda")).contiguous()
    pre = post.gram
    a = kron_pulsar_cuda(pre, phi)
    b = kron_pulsar_cuda(pre, phi)
    p = kron_pulsar_plain(pre, phi)
    cots = [torch.as_tensor(rng.standard_normal(t.shape), device="cuda")
            for t in a[:4]]
    ga = kron_pulsar_bwd_cuda(phi, a[4], a[5], *cots)
    gb = kron_pulsar_bwd_cuda(phi, a[4], a[5], *cots)
    gp = kron_pulsar_bwd_plain(phi, a[4], a[5], *cots)
    torch.cuda.synchronize()
    names = ("chi2", "x", "m", "ld")
    errs = {n: tol.vector_rel(x.cpu().numpy(), y.cpu().numpy())
            for n, x, y in zip(names, a[:4], p[:4])}
    errs["grad_phi"] = tol.vector_rel(ga.cpu().numpy(), gp.cpu().numpy())
    rerun = _bits_equal(a, b) and _bits_equal((ga,), (gb,))
    # conditioning of the capacity matrices, diagonally equilibrated
    cap = pre.g_uu + torch.diag_embed(1.0 / torch.clamp(phi, min=1e-30))
    d = torch.sqrt(torch.diagonal(cap, dim1=-2, dim2=-1))
    ev = torch.linalg.eigvalsh(cap / (d[..., :, None] * d[..., None, :]))
    kappa = float(torch.max(ev[..., -1] / ev[..., 0]))
    log(f"k5: {c} chains x {phi.shape[1]} pulsars, nb {phi.shape[2]}, "
        f"m2 {pre.g_ff.shape[-1]}: kernel vs plain (vector_rel) "
        + json.dumps(errs) + f" (limit {tol.KRON_PULSAR_REL:g}); "
        f"run-to-run bit-identical {rerun}; max kappa of the equilibrated "
        f"capacity {kappa!r}")
    if not (rerun and all(v <= tol.KRON_PULSAR_REL for v in errs.values())):
        raise AssertionError("K5/K5b disagree with their plain versions")
    out = k5_times(pre, phi, a, p, cots, ga, gp, ("k5", "k5b"))
    nb, m2 = phi.shape[2], pre.g_ff.shape[-1]
    out["k5"].update(build_report(K5, ("kron_pulsar_fwd_kernel",),
                                  "kron_pulsar_fwd_occupancy", nb, m2))
    out["k5"]["waves"] = out["k5"]["blocks"] / (
        out["k5"]["blocks_per_sm"]
        * torch.cuda.get_device_properties(0).multi_processor_count)
    out["k5b"].update(build_report(K5B, ("kron_pulsar_bwd_kernel",)))
    out["k5b"]["shared_bytes"] = K5B.call("kron_pulsar_bwd_smem", nb, m2)
    for label in ("k5", "k5b"):
        log(f"{label} at {c} chains: " + json.dumps(out[label]))
    return out


def k5_times(pre, phi, a, p, cots, ga, gp, labels, reps=50):
    """{forward label: row, backward label: row} of the per-pulsar stage
    at (pre, phi): the kernels' times (the launchers choose the narrow
    or the wide form by shape) beside their plain versions, the library
    calls (batched cholesky_ex + cholesky_solve + matmul; autograd of
    the plain forward), the bounds and the largest |kernel - plain|.
    ``a``/``p`` are the kernel's and the plain forward's outputs,
    ``ga``/``gp`` the backward's for the cotangents ``cots``."""
    import torch

    from pint_tpu_torch.linalg import (kron_pulsar_bwd_cuda,
                                       kron_pulsar_bwd_plain,
                                       kron_pulsar_cuda, kron_pulsar_plain)

    b_, p_, nb = phi.shape
    m2 = pre.g_ff.shape[-1]
    r = 1 + m2
    nblk = b_ * p_
    # g_uu is symmetric: the function needs its lower triangle once, and
    # G = Z^T Z its upper half (M's, beside chi2's and x's products)
    fwd_bytes = 8 * (sum(t.numel() for t in pre) - pre.g_uu.numel()
                     + p_ * nb * (nb + 1) // 2 + phi.numel()
                     + sum(t.numel() for t in a))
    fwd_flops = nblk * (nb**3 / 3 + 2 * nb * nb * r + nb * m2 * (m2 + 1)
                        + 2 * nb * m2 + 4 * nb)
    # both backward forms read only L's lower triangle
    bwd_bytes = 8 * (phi.numel() + nblk * nb * (nb + 1) // 2
                     + a[5].numel() + sum(t.numel() for t in cots)
                     + ga.numel())
    bwd_flops = nblk * (nb**3 / 3 + 2 * nb * m2 * m2 + 4 * nb * m2
                        + nb * nb + 12 * nb)
    fb, fby = bound_ms(fwd_bytes, fwd_flops, FP64_TC_FLOPS)
    bb, bby = bound_ms(bwd_bytes, bwd_flops, FP64_TC_FLOPS)
    cap = (pre.g_uu + torch.diag_embed(
        1.0 / torch.clamp(phi, min=1e-30))).contiguous()
    rhs = torch.cat([pre.b_u[..., None], pre.g_uf], dim=-1).expand(
        b_, p_, nb, r).contiguous()
    g_fu = pre.g_uf.transpose(-1, -2)

    def lib_fwd():
        L, _ = torch.linalg.cholesky_ex(cap)
        X = torch.cholesky_solve(rhs, L)
        return g_fu @ X[..., 1:]
    phi_r = phi.clone().requires_grad_(True)
    outs = list(kron_pulsar_plain(pre, phi_r)[:4])

    def lib_bwd():
        return torch.autograd.grad(outs, phi_r, cots, retain_graph=True)
    out = {}
    for label, kern, plain, lib, bnd, by, err in (
            (labels[0], partial(kron_pulsar_cuda, pre, phi),
             partial(kron_pulsar_plain, pre, phi), lib_fwd, fb, fby,
             max(float(torch.max(torch.abs(x - y)))
                 for x, y in zip(a[:4], p[:4]))),
            (labels[1], partial(kron_pulsar_bwd_cuda, phi, a[4], a[5],
                                *cots),
             partial(kron_pulsar_bwd_plain, phi, a[4], a[5], *cots),
             lib_bwd, bb, bby, float(torch.max(torch.abs(ga - gp))))):
        ms, how = kernel_ms(kern, reps)
        plain_ms, _ = kernel_ms(plain, reps)
        lib_ms, _ = kernel_ms(lib, reps)
        out[label] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": bnd, "bound_by": by, "max_abs_err": err,
                      "timed_by": how,
                      "per_call_with_enqueue_ms": cuda_ms(kern, reps=20),
                      "kernels_per_call": 1, "blocks": nblk}
    # the backward's library yardstick is the plain backward itself (one
    # solve_triangular(L, I) and elementwise sums), autograd beside it
    bwd = out[labels[1]]
    bwd["library_autograd_ms"] = bwd["library_ms"]
    bwd["library_ms"] = bwd["plain_ms"]
    return out


def _ulps(a, b):
    """max |a - b| in units of the spacing at b (equal values, including
    equal infinities, are 0 ulp)."""
    import torch

    a, b = a.double(), b.double()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    sp = torch.abs(torch.nextafter(b, torch.full_like(b, float("inf"))) - b)
    d = torch.where(same, torch.zeros_like(a), torch.abs(a - b) / sp)
    return float(torch.max(d))


#: K6's shape on the HMC run's path: chains, coordinates, leapfrog steps
K6_SHAPE = (HMC_RUN["n_chains"], 138, HMC_RUN["num_leapfrog"])


def _k6_inputs(draws=3):
    """(new_state, draws, grads) of K6's checks at ``K6_SHAPE``:
    ``new_state()`` a fresh NutsState on the card, each draw's (z,
    n_steps, u) and its n_leap gradients (lnp_n, gn), from one seed."""
    import torch

    from pint_tpu_torch.gw import hmc

    c, nd, n_leap = K6_SHAPE
    dev = torch.device("cuda")
    rng = np.random.default_rng(6)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)
    inv_mass = t(rng.uniform(0.16, 0.25, nd))
    x0 = t(rng.standard_normal((c, nd)))
    g0 = t(rng.standard_normal((c, nd)) * 30)
    lnp0 = t(4.1e5 + rng.standard_normal(c))
    zs = [(t(rng.standard_normal((c, nd))),
           torch.as_tensor(rng.integers(1, n_leap + 1, c), device=dev),
           t(rng.uniform(0, 1, c))) for _ in range(draws)]
    grads = [[(t(4.1e5 + 3 * rng.standard_normal(c)),
               t(rng.standard_normal((c, nd)) * 30)) for _ in range(n_leap)]
             for _ in range(draws)]

    def new_state():
        return hmc.NutsState(x0.clone(), g0.clone(), lnp0.clone(), inv_mass,
                             0.05)
    return new_state, zs, grads


def _k6_timed_state():
    """The state a timed K6 draw runs on, updated in place: draw 1's
    random numbers and its first gradient, fixed."""
    new_state, draws, grads = _k6_inputs()
    st = new_state()
    st.z.copy_(draws[1][0])
    st.n_steps.copy_(draws[1][1])
    st.u.copy_(draws[1][2])
    st.lnp_n.copy_(grads[1][0][0])
    st.gn.copy_(grads[1][0][1])
    return st


def phase_k6():
    """K6 against its plain version on the card: the same states, draws
    and gradients, three draws ((adapting, adapting_next) = (T, T),
    (T, F), (F, F)), 16 chains x 138 coordinates, held after every draw;
    then one draw's 13 launches timed on a state updated in place."""
    import torch

    from pint_tpu_torch import tolerances as tol
    from pint_tpu_torch.gw import hmc

    c, nd, n_leap = K6_SHAPE
    new_state, draws, grads = _k6_inputs()

    def kernel_draw(st, d, adapting, adapting_next, it, grad=True):
        # the draw as run_nuts runs it: n_leap + 1 launches
        hmc.nuts_draw_start(st)
        for i in range(n_leap):
            if grad:
                st.lnp_n.copy_(grads[d][i][0])
                st.gn.copy_(grads[d][i][1])
            if i + 1 < n_leap:
                hmc.nuts_leap_next(st, i)
        hmc.nuts_draw_finish(st, n_leap - 1, adapting, adapting_next, 0.8,
                             it)

    def plain_draw(st, d, adapting, adapting_next, it, grad=True):
        for i in range(n_leap):
            hmc.nuts_leap_pre_plain(st, i)
            if grad:
                st.lnp_n.copy_(grads[d][i][0])
                st.gn.copy_(grads[d][i][1])
            hmc.nuts_leap_post_plain(st, i)
        hmc.nuts_draw_end_plain(st, adapting, adapting_next, 0.8, it)

    def set_draw(st, d):
        st.z.copy_(draws[d][0])
        st.n_steps.copy_(draws[d][1])
        st.u.copy_(draws[d][2])
    sk, sk2, sp = new_state(), new_state(), new_state()
    worst = {}
    same_acc = rerun = True
    hmc.K6.launches = 0
    for d in range(3):
        for st, fn in ((sk, kernel_draw), (sk2, kernel_draw),
                       (sp, plain_draw)):
            set_draw(st, d)
            fn(st, d, d < 2, d + 1 < 2, d)
        torch.cuda.synchronize()
        same_acc &= bool(torch.equal(sk.accepted, sp.accepted))
        rerun &= all(
            torch.equal(a.view(torch.int64), b.view(torch.int64))
            if a.dtype == torch.float64 else torch.equal(a, b)
            for a, b in zip(sk.tensors(), sk2.tensors()))
        for name in ("x", "g", "lnp", "p1", "x1", "g1", "lnp1", "xn", "ph",
                     "eps", "eps_used", "log_eps", "log_eps_bar", "hbar",
                     "acc"):
            worst[name] = max(worst.get(name, 0.0),
                              _ulps(getattr(sk, name), getattr(sp, name)))
    launches = hmc.K6.launches
    n_acc = int(sk.accepted.sum())
    log(f"k6: {c} chains x {nd} coordinates, 3 draws (warmup to warmup, "
        f"warmup to sampling, sampling): accept decisions identical "
        f"{same_acc} ({n_acc}/{c} accepted in the last), bit-identical "
        f"run to run {rerun}, launches {launches} ({n_leap + 1} a draw); "
        f"max ulps kernel vs plain " + json.dumps(worst) + f" (limit {tol.K6_ULPS})")
    if not (same_acc and rerun and launches == 6 * (n_leap + 1)
            and all(v <= tol.K6_ULPS for v in worst.values())):
        raise AssertionError("K6 disagrees with its plain version")
    # one draw's elementwise work on a state updated in place (the
    # gradient inputs fixed), non-adapting
    st_k, st_p = _k6_timed_state(), _k6_timed_state()
    per = c * nd
    # the draw's bytes: z, x, g (read), 12 gradients and lnp_n, xn and ph
    # written 12 times, x1, p1, g1 (written, read at the end), x, g
    # (accepted copies), the per-chain scalars
    nbytes = 8 * (per * (3 + 2 * n_leap + 2) + c * (n_leap + 14) + nd)
    nflops = per * (8 * n_leap + 10)
    b, by = bound_ms(nbytes, nflops)
    one = partial(kernel_draw, st_k, 1, False, False, 5, False)
    # 13 launches a call: 50 calls keep the queue under ~10^3 launches
    ms, how = kernel_ms(one)
    plain_ms, _ = kernel_ms(partial(plain_draw, st_p, 1, False, False, 5,
                                    False), reps=10)
    out = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
           "bound_ms": b, "bound_by": by, "timed_by": how,
           "max_abs_err": float(torch.max(torch.abs(sk.x - sp.x))),
           "launches_per_draw": n_leap + 1,
           "per_call_with_enqueue_ms": cuda_ms(one, reps=20)}
    out.update(build_report(hmc.K6, ("nuts_pre0_kernel",
                                     "nuts_post_pre_kernel",
                                     "nuts_post_end_kernel")))
    log(f"k6 one draw ({n_leap + 1} launches): " + json.dumps(out))
    return out


def phase_ingest():
    """``get_model_and_toas(par, tim)`` on the committed B1855-like par
    and 10k tim, cold, held to the JAX table stored beside them: ticks
    exact, the parsed columns exact, the geometry bit for bit or within
    ``tolerances.INGEST_GEOMETRY_REL``; the prefit residuals on the card
    within ``tolerances.PREFIT_S`` of JAX's."""
    import torch

    from pint_tpu_torch import tolerances as tol
    from pint_tpu_torch.convert import (B1855_PAR, B1855_TIM,
                                        B1855_TIM_ANSWERS, load_arrays)
    from pint_tpu_torch.models.builder import get_model_and_toas
    from pint_tpu_torch.residuals import Residuals

    ref = load_arrays(B1855_TIM_ANSWERS)
    t0 = time.time()
    model, toas = get_model_and_toas(str(B1855_PAR), str(B1855_TIM))
    table = toas.to_table()
    cold_s = time.time() - t0
    if model.free_params != [str(p) for p in ref["free_params"]]:
        raise AssertionError("ingest: free parameters differ from JAX")
    ticks_same = bool(np.array_equal(table.ticks, ref["toa_ticks"]))
    exact = {k: bool(np.array_equal(getattr(table, k), ref[f"toa_{k}"]))
             for k in ("freq_mhz", "error_us", "mjd_float")}
    flags_same = all(
        np.array_equal(n, ref[f"toa_flag_{k}_names"])
        and np.array_equal(i, ref[f"toa_flag_{k}_index"])
        for k, (n, i) in table.flags.items())
    geom = {k: {"bit_identical": bool(np.array_equal(
                    getattr(table, k), ref[f"toa_{k}"])),
                "vector_rel": tol.vector_rel(getattr(table, k),
                                             ref[f"toa_{k}"])}
            for k in ("ssb_obs_pos", "ssb_obs_vel", "obs_sun_pos")}
    tzr = model.component("AbsPhase").make_tzr_toas(model, toas)
    tzr_same = bool(np.array_equal(tzr.ticks, ref["tzr_ticks"]))
    torch.cuda.synchronize()
    r = Residuals(toas, model, device="cuda")
    d_pre = float(np.max(np.abs(r.time_resids
                                - ref["prefit_time_resids"])))
    log(f"ingest: {len(table)} TOAs, cold get_model_and_toas + table "
        f"{cold_s:.3f} s ({len(table) / cold_s:.1f} TOAs/s); ticks "
        f"identical {ticks_same}, TZR ticks identical {tzr_same}, parsed "
        f"columns identical {exact}, flags identical {flags_same}; "
        f"geometry " + json.dumps(geom) + f" (limit "
        f"{tol.INGEST_GEOMETRY_REL:g}); prefit residuals on the card max "
        f"|d| vs JAX {d_pre:.3e} s (limit {tol.PREFIT_S:g} s)")
    if not (ticks_same and tzr_same and all(exact.values()) and flags_same
            and all(g["vector_rel"] <= tol.INGEST_GEOMETRY_REL
                    for g in geom.values())
            and d_pre <= tol.PREFIT_S):
        raise AssertionError("ingest disagrees with JAX")
    return model, toas, ref, cold_s


def phase_fit_par_tim(model, toas, ref):
    """GLS and WLS fits (maxiter=3) from the ingested par and tim on the
    card, held to JAX's answers with the conditioning-aware limits;
    launches of K1, K2 and K7 during each fit; cold and warm walls,
    TOAs/s and the busy share of a warm fit."""
    import copy

    import torch

    from pint_tpu_torch import tolerances as tol
    from pint_tpu_torch.fitter import GLSFitter, WLSFitter
    from pint_tpu_torch.fixedpoint import K1
    from pint_tpu_torch.linalg import K2, K7

    kernels = {"K1": K1, "K2": K2, "K7": K7}
    free = [str(p) for p in ref["free_params"]]
    out = {}
    for name, cls in (("gls", GLSFitter), ("wls", WLSFitter)):
        m = copy.deepcopy(model)
        start = dict(m.values)
        # the main path: counts reset just before, read just after
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        f = cls(toas, m, device="cuda")
        chi2 = f.fit_toas(maxiter=3)
        torch.cuda.synchronize()
        cold_s = time.time() - t0
        launches = {n: k.launches for n, k in kernels.items()}
        cond = f.fit_health["cond_log10"]
        if name == "wls":
            cond = tol.wls_normal_cond_log10(cond)
        tols = tol.fit_tolerances(cond)
        errs = tol.fit_errors(
            [m.values[k] for k in free], [m.uncertainties[k] for k in free],
            f.chi2_iters, ref[f"{name}_values"], ref[f"{name}_uncertainties"],
            ref[f"{name}_chi2_iters"])
        errs["final_chi2_rel"] = abs(chi2 / float(ref[f"{name}_final_chi2"])
                                     - 1.0)
        tols["final_chi2_rel"] = tols["chi2_rel"]
        ntr = (f.fit_health["n_truncated"], int(ref[f"{name}_n_truncated"]))

        def warm(f=f, m=m, start=start):
            m.values.update(start)
            f.fit_toas(maxiter=3)
            torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(3):
            warm()
        warm_s = (time.time() - t0) / 3
        busy, dev_ms = profile_breakdown(warm, warm_s, f"fit_{name}")
        out[name] = {"launches": launches, "cold_s": cold_s,
                     "warm_s": warm_s, "toas_per_s": len(toas) / warm_s,
                     "busy": busy, "device_ms": dev_ms, "fitter": f}
        log(f"fit_par_tim {name}: launches {launches}; chi2 per iteration "
            f"{f.chi2_iters} (JAX {ref[f'{name}_chi2_iters'].tolist()}); "
            f"n_truncated {ntr[0]} (JAX {ntr[1]}), health {f.fit_health}; "
            f"observed " + json.dumps(errs) + " tolerances "
            + json.dumps(tols) + f"; wall cold {cold_s:.3f} s, warm "
            f"{warm_s:.3f} s, {len(toas) / warm_s:.1f} TOAs/s, busy "
            f"{busy * 100:.2f}%")
        bad = [k for k in errs if not errs[k] <= tols[k]]
        if bad or ntr[0] != ntr[1]:
            raise AssertionError(f"{name} fit disagrees with JAX on {bad} "
                                 f"(n_truncated {ntr})")
        need = ("K1", "K2", "K7") if name == "wls" else ("K1", "K2")
        if not all(launches[k] > 0 for k in need):
            raise AssertionError(f"a kernel of the {name} fit never ran: "
                                 f"{launches}")
    return out


def phase_pulse_numbers(ref):
    """The two cases of ``pn_answers.npz`` on the card: the gap case
    under TRACK -2 (pulse numbers from ``compute_pulse_numbers``, then a
    WLS fit from F0 + 1e-7 Hz) and corpus spin-000 with a PHASE command
    (nearest tracking after the offset), each held to JAX: the pulse
    numbers equal, prefit and postfit residuals within
    ``tolerances.PREFIT_S``, values, uncertainties and chi^2 per
    iteration within the conditioning-aware fit limits."""
    import tempfile

    import torch

    from pint_tpu_torch import tolerances as tol
    from pint_tpu_torch.fitter import WLSFitter
    from pint_tpu_torch.fixedpoint import K1
    from pint_tpu_torch.linalg import K7
    from pint_tpu_torch.models.builder import get_model
    from pint_tpu_torch.toa import get_TOAs

    out, bad = {}, []
    with tempfile.TemporaryDirectory() as d:
        for k in ("gap", "phase"):
            par, tim = os.path.join(d, k + ".par"), os.path.join(d, k + ".tim")
            for path, key in ((par, "_par"), (tim, "_tim")):
                with open(path, "w") as f:
                    f.write(str(ref[k + key]))
            model = get_model(par)
            toas = get_TOAs(tim)
            row = {}
            if k + "_pn" in ref:
                pn = toas.compute_pulse_numbers(model, device="cuda")
                row["pn_equal"] = bool(np.array_equal(pn, ref[k + "_pn"]))
            model.values["F0"] = float(ref[k + "_start"])
            K1.launches = K7.launches = 0
            f = WLSFitter(toas, model, device="cuda")
            prefit = f.resids.time_resids
            t0 = time.perf_counter()
            f.fit_toas(maxiter=3)
            torch.cuda.synchronize()
            row["fit_s"] = time.perf_counter() - t0
            row["launches"] = {"K1": K1.launches, "K7": K7.launches}
            postfit = f.resids.time_resids
            free = [str(x) for x in ref[k + "_free"]]
            lim = tol.fit_tolerances(tol.wls_normal_cond_log10(
                f.fit_health["cond_log10"]))
            err = tol.fit_errors(
                [model.values[p] for p in free],
                [model.uncertainties[p] for p in free], f.chi2_iters,
                ref[k + "_values"], ref[k + "_sigmas"],
                ref[k + "_chi2_iters"])
            row.update(
                track_mode=f.resids.track_mode, n_toas=len(toas),
                prefit_s=float(np.max(np.abs(prefit - ref[k + "_prefit"]))),
                postfit_s=float(np.max(np.abs(postfit
                                              - ref[k + "_postfit"]))),
                errors=err, limits=lim, prefit_limit_s=tol.PREFIT_S)
            ok = (row.get("pn_equal", True)
                  and row["prefit_s"] <= tol.PREFIT_S
                  and row["postfit_s"] <= tol.PREFIT_S
                  and all(err[q] <= lim[q] for q in err))
            log(f"pulse numbers {k}: " + json.dumps(row))
            if not ok:
                bad.append(k)
            out[k] = row
    if bad:
        raise AssertionError(f"pulse-number cases off JAX's answers: {bad}")
    return out


def phase_k7(f_wls):
    """K7 against wls_whiten_plain on the card: at the WLS fit's own
    (r, J, sigma), at N = 10^4, P = 11 (the fit's shape: one cooperative
    launch) and at the WLS grid's 256 points of N = 10^4, P = 8 against
    the fit's sigma (two launches); rw, and Jn where the norms are
    equal, bit-identical to plain, run-to-run bit identity; time, plain
    time and bound at the latter two."""
    import torch

    from pint_tpu_torch import tolerances as tol
    from pint_tpu_torch.linalg import K7, wls_whiten_cuda, wls_whiten_plain

    vec = torch.tensor([f_wls.model.values[k] for k in f_wls._traced_free],
                       dtype=torch.float64, device="cuda")
    base = f_wls.prepared.values_dict()
    r, J = f_wls._rj(vec, base, f_wls._fit_data)
    sigma = f_wls._fit_data["noise_sigma"]
    rng = np.random.default_rng(11)

    def synthetic(g, n, p, err):
        lead = (g,) if g > 1 else ()
        return (torch.tensor(rng.standard_normal(lead + (n,)) * 1e-6,
                             device="cuda"),
                torch.tensor(rng.standard_normal(lead + (n, p))
                             * 10.0 ** rng.uniform(-8, 8, p),
                             device="cuda"), err)

    n = 10_000
    cases = {"fit": (r.detach(), J.detach(), sigma),
             "n10k_p11": synthetic(1, n, 11, torch.tensor(
                 rng.uniform(0.5, 2.0, n) * 1e-6, device="cuda")),
             "grid_256": synthetic(256, sigma.numel(), 8, sigma)}
    errs, same = {}, True
    for label, args in cases.items():
        a = wls_whiten_cuda(*args)
        b = wls_whiten_cuda(*args)
        q = wls_whiten_plain(*args)
        torch.cuda.synchronize()
        eq = torch.all(a[2] == q[2], dim=-1)
        same = (same and _bits_equal(a, b) and torch.equal(a[0], q[0])
                and torch.equal(a[1][eq], q[1][eq]))
        errs[label] = {nm: tol.vector_rel(x.cpu().numpy(), y.cpu().numpy())
                       for nm, x, y in zip(("rw", "Jn", "norms", "chi2"),
                                           a, q)}
    log(f"k7: vs plain (vector_rel) " + json.dumps(errs) + f" (limit "
        f"{tol.WLS_WHITEN_REL:g}; rw, and Jn at equal norms, "
        f"bit-identical); run-to-run bit-identical {same}; fit shape "
        f"{tuple(J.shape)}")
    if not (same and all(v <= tol.WLS_WHITEN_REL for e in errs.values()
                         for v in e.values())):
        raise AssertionError("K7 disagrees with its plain version")
    out = {}
    for label in ("n10k_p11", "grid_256"):
        args = cases[label]
        g = args[0].shape[0] if args[0].dim() == 2 else 1
        n, p = args[1].shape[-2:]
        max_abs = max(float(torch.max(torch.abs(x - y)))
                      for x, y in zip(wls_whiten_cuda(*args),
                                      wls_whiten_plain(*args)))
        ms, how = kernel_ms(partial(wls_whiten_cuda, *args))
        plain_ms, _ = kernel_ms(partial(wls_whiten_plain, *args))
        # J, r in and Jn, rw out a point, the norms and chi^2, err once
        b, by = bound_ms(8 * (g * (2 * n * p + 2 * n + p + 1) + n),
                         g * (3 * n * p + 4 * n))
        coop = K7.call("wls_whiten_cooperative", g, n, p)
        row = {"shape": [g, n, p], "ms": ms, "plain_ms": plain_ms,
               "library_ms": None, "bound_ms": b, "bound_by": by,
               "max_abs_err": max_abs, "timed_by": how,
               "cooperative": coop, "kernels_per_call": 1 if coop else 2,
               "tiles": K7.call("wls_whiten_tiles", n, p),
               "per_call_with_enqueue_ms": cuda_ms(partial(wls_whiten_cuda,
                                                           *args))}
        log(f"k7 {label}: " + json.dumps(row))
        out[label] = row
    del cases
    rep = build_report(K7, ("wls_whiten_coop", "wls_whiten_tile_sums",
                            "wls_whiten_apply"))
    log("k7 ptxas: " + json.dumps(rep))
    out.update(out.pop("n10k_p11"))
    out.update(rep)
    return out


#: the chi^2 grids of the par/tim case: gridded names, and the par
GRID_NAMES = {"gls": ["M2", "SINI"], "wls": ["F0", "F1"]}
#: device-time groups of a grid call (kernel names, lower case)
GRID_GROUPS = {"eigh": ["syev", "sytrd", "stedc", "ormtr", "orgtr"],
               "svd": ["gesvd", "gesdd", "svd"], "K1": ["phase_f0_t"],
               "K2": ["segment_sum"], "K7": ["wls_whiten"],
               "K8": ["woodbury_"], "gemm": ["gemm", "gemv"]}


def refit_limits(kind, model, toas):
    """fit_tolerances of a grid's refit (the gridded parameters frozen)
    from one fit at the par's values on the card, and the refit's
    uncertainties."""
    import copy

    from pint_tpu_torch import tolerances as tol
    from pint_tpu_torch.fitter import GLSFitter, WLSFitter

    m = copy.deepcopy(model)
    m.free_params = [p for p in m.free_params if p not in GRID_NAMES[kind]]
    f = (GLSFitter if kind == "gls" else WLSFitter)(toas, m, device="cuda")
    f.fit_toas(maxiter=3)
    cond = f.fit_health["cond_log10"]
    if kind == "wls":
        cond = tol.wls_normal_cond_log10(cond)
    return tol.fit_tolerances(cond), m.uncertainties, cond


def phase_grid(kind, model, toas, ref):
    """A 16 x 16 chi^2 grid of the par/tim case on the card (GLS over
    (M2, SINI) or WLS over (F0, F1) on the white par), held to the JAX
    answers of ``b1855_grid_answers.npz``: chi^2 within
    ``tolerances.REFIT_CHI2_REL`` (the nominal 1e-8 and JAX's own
    movement with one more step printed beside), the refit values within
    the fit rows' conditioning-aware limits less one ulp
    (``tolerances.values_sigma_ulp``); launches of each kernel of the
    path during the grid call (all > 0) and per call at G = 256 and
    G = 16 (equal); cold and warm wall, points/s, busy share and the
    device time by group, peak device memory."""
    import torch

    from pint_tpu_torch import grid
    from pint_tpu_torch import tolerances as tol
    from pint_tpu_torch.fixedpoint import K1
    from pint_tpu_torch.linalg import K2, K7, K8

    names = GRID_NAMES[kind]
    kernels = {"K1": K1, "K2": K2, "K7": K7, "K8": K8}
    need = ("K1", "K2", "K8") if kind == "gls" else ("K1", "K7")
    pts = ref[f"{kind}_points"]
    # the main path: counts reset just before, read just after
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    fn, fit_params, part = grid.make_grid_fn(
        toas, model, names, n_steps=int(ref["n_steps"]), device="cuda")
    chi2, fitted = fn(pts)
    torch.cuda.synchronize()
    cold_s = time.time() - t0
    launches = {n: k.launches for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    if fit_params != [str(p) for p in ref[f"{kind}_fit_params"]]:
        raise AssertionError(f"grid {kind}: refit parameters differ")
    lim, unc, cond = refit_limits(kind, model, toas)
    chi2_np, fitted_np = chi2.cpu().numpy(), fitted.cpu().numpy()
    errs = {"chi2_rel": float(np.max(np.abs(chi2_np / ref[f"{kind}_chi2"]
                                            - 1))),
            "values_sigma": tol.values_sigma_ulp(
                fitted_np, ref[f"{kind}_fitted"],
                [unc[k] for k in fit_params])}
    tols = {"chi2_rel": tol.REFIT_CHI2_REL,
            "values_sigma": lim["values_sigma"]}
    per_call = {}
    for g in (len(pts), 16):
        before = {n: k.launches for n, k in kernels.items()}
        fn(pts[:g])
        per_call[g] = {n: k.launches - before[n] for n, k in kernels.items()}

    def warm():
        fn(pts)
        torch.cuda.synchronize()

    t0 = time.time()
    reps = 3
    for _ in range(reps):
        warm()
    warm_s = (time.time() - t0) / reps
    busy, dev_ms, shares = trace_breakdown(warm, warm_s, f"grid_{kind}",
                                           GRID_GROUPS)
    with open(os.path.join(OUT_DIR, f"grid_{kind}_profile.txt")) as fh:
        routes = sorted({ln.split(None, 2)[2][:80] for ln in fh
                         if ln[:1] == " " and any(
                             w in ln.lower() for w in
                             GRID_GROUPS["eigh"] + GRID_GROUPS["svd"])})
    out = {"launches": launches, "per_call": per_call, "cold_s": cold_s,
           "warm_s": warm_s, "points_per_s": len(pts) / warm_s,
           "busy": busy, "device_ms": dev_ms, "shares": shares,
           "peak_gib": peak / 2**30, "errs": errs, "tols": tols,
           "cond_log10": cond, "chi2_nominal_1e-8_held":
               errs["chi2_rel"] <= tol.CHI2_REL,
           "jax_chi2_one_more_step_rel": float(np.max(np.abs(
               ref[f"{kind}_chi2_next"] / ref[f"{kind}_chi2"] - 1))),
           "partition": {k: v for k, v in part.items()
                         if k in ("n_linear", "n_nonlinear", "n_frozen")}}
    log(f"grid {kind}: {len(pts)} points over {names}, refit {fit_params}; "
        + json.dumps({k: v for k, v in out.items()
                      if k not in ("shares",)})
        + "; device time by group " + json.dumps(shares)
        + "; factorization kernels " + json.dumps(routes))
    bad = [k for k in errs if not errs[k] <= tols[k]]
    if bad:
        raise AssertionError(f"grid {kind} disagrees with JAX on {bad}")
    if not all(launches[k] > 0 for k in need):
        raise AssertionError(f"a kernel of the {kind} grid never ran: "
                             f"{launches}")
    if per_call[len(pts)] != per_call[16]:
        raise AssertionError(f"grid {kind}: launches depend on the number "
                             f"of points: {per_call}")
    if kind == "gls" and per_call[16]["K8"] != 1:
        raise AssertionError(f"grid gls: K8 should serve the final chi^2 "
                             f"alone: {per_call}")
    out.update(fn=fn, names=names, fit_params=fit_params, pts=pts,
               fitted=fitted)
    return out


def grid_residuals(g):
    """(G, N) time residuals at a grid's points and refit values."""
    import torch

    resids = g["fn"].resids
    base = resids.prepared.values_dict()

    def one(p, v):
        values = dict(base)
        values.update({n: p[i] for i, n in enumerate(g["names"])})
        values.update({n: v[i] for i, n in enumerate(g["fit_params"])})
        return resids.time_resids_at(values)

    return torch.func.vmap(one)(torch.as_tensor(g["pts"], device="cuda"),
                                g["fitted"])


def phase_k8(g):
    """K8 against its plain version at the GLS grid's own (G, N, K) and
    at the GLS chain's G = 16: the residuals at the grid's 256 refit
    points (and the first 16 of them, the chain's walkers per half-move
    at the same N and K) against the par's Woodbury factor; within
    ``tolerances.WOODBURY_PRE_REL`` of sum r^2/n, bit-identical run to
    run; time beside the plain version, the library composite (dense
    U^T (R/n)^T and solve_triangular) and the bound at each."""
    import torch

    from pint_tpu_torch import linalg as tl
    from pint_tpu_torch import tolerances as tol

    resids = g["fn"].resids
    base = resids.prepared.values_dict()
    with torch.no_grad():
        R_all = grid_residuals(g).contiguous()
        sigma = resids.sigma_at(base)
        U, phi = resids._noise_basis_phi_at(base)
        pre = tl.woodbury_precompute(sigma, U, phi)
    n = R_all.shape[1]
    parts = tl._basis_parts(U, n, R_all.device)
    Ud = tl.su_to_dense(U)
    L = pre.chol_lower
    k_pre, k_e, k_post = (parts[0].shape[1], parts[2].numel() - 1,
                          parts[3].shape[1])
    k, kd, n_perm = k_pre + k_e + k_post, k_pre + k_post, parts[1].numel()
    out = {}
    for label, R in (("grid", R_all), ("chain", R_all[:16].contiguous())):
        gn = R.shape[0]
        args = (R, pre.nvec) + tuple(parts) + (pre.chol_upper,)
        a = tl.woodbury_chi2_pre_cuda(*args)
        b = tl.woodbury_chi2_pre_cuda(*args)
        p = tl.woodbury_chi2_pre_plain(*args)
        torch.cuda.synchronize()
        scale = torch.sum(R * R / pre.nvec, dim=1)
        rel = float(torch.max(torch.abs(a - p) / scale))
        rerun = _bits_equal((a,), (b,))
        log(f"k8 {label}: G={gn}, N={n}, K={k} ({kd} dense, {k_e} "
            f"epochs): vs plain {rel!r} of sum r^2/n (limit "
            f"{tol.WOODBURY_PRE_REL:g}); run-to-run bit-identical {rerun}; "
            f"chi2 {float(a.min())!r} .. {float(a.max())!r}; plan "
            f"{tl.k8_plan(gn, n, k_pre, k_e, k_post)}")
        if not (rerun and rel <= tol.WOODBURY_PRE_REL):
            raise AssertionError(f"K8 disagrees with its plain version at "
                                 f"the {label}'s G = {gn}")

        def library(R=R):
            y = R / pre.nvec
            z = torch.linalg.solve_triangular(L, Ud.T @ y.T, upper=False)
            return torch.sum(R * y, dim=1) - torch.sum(z * z, dim=0)

        lib_rel = float(torch.max(torch.abs(library() - p) / scale))
        ms, how = kernel_ms(partial(tl.woodbury_chi2_pre_cuda, *args))
        plain_ms, _ = kernel_ms(partial(tl.woodbury_chi2_pre_plain, *args))
        lib_ms, _ = kernel_ms(library)
        # L: its lower triangle, all that the kernels read of it
        nbytes = (8 * (gn * n + n + n * kd + k * (k + 1) // 2 + gn)
                  + 4 * (n_perm + k_e + 1))
        # the dense product U_d^T (R/n)^T and the substitution are GEMM-
        # and TRSM-shaped (the tensor-core peak); the rest is
        # elementwise, and enters at its time on the tensor-core scale
        tc_flops = gn * (2 * n * kd + k * k)
        ew_flops = gn * (3 * n + n_perm + 2 * k)
        bnd, by = bound_ms(nbytes, tc_flops + ew_flops * FP64_TC_FLOPS
                           / FP64_FLOPS, FP64_TC_FLOPS)
        row = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "library_rel": lib_rel, "bound_ms": bnd, "bound_by": by,
               "max_abs_err": float(torch.max(torch.abs(a - p))),
               "rel_of_sum_r2n": rel, "timed_by": how, "G": gn, "N": n,
               "K": k, "per_call_with_enqueue_ms": cuda_ms(
                   partial(tl.woodbury_chi2_pre_cuda, *args), reps=20)}
        out[label] = row
        log(f"k8 {label} times: " + json.dumps(row))
    rep = build_report(tl.K8, ("woodbury_rhs_kernel",
                               "woodbury_reduce_kernel",
                               "woodbury_solve_kernel"))
    log("k8 ptxas: " + json.dumps(rep))
    out.update(rep)
    return out


def phase_grid_kernels(g):
    """K1 and K2 at the grids' batched shapes: K1 over G F0 values
    against the ticks, K2 over the G P columns of the GLS step's U^T
    (J w); each against its plain version (K1 on the card, K2 on the
    CPU: the plain version's ``index_add`` on the card adds with
    atomics, in no fixed order), with time, plain time, bound and
    library.  K7 at the WLS grid's shape is ``phase_k7``'s."""
    import torch

    from pint_tpu_torch import fixedpoint as fp
    from pint_tpu_torch import linalg as tl

    prep = g["fn"].resids.prepared
    dt = prep.ctx["Spindown"]["dt_ticks"]
    n, gn = dt.numel(), len(g["pts"])
    rng = np.random.default_rng(21)
    f0 = torch.tensor(prep.model.values["F0"] + rng.normal(0, 1e-10, gn),
                      device="cuda")[:, None]
    nk, fk = fp.phase_f0_t_cuda(f0, dt)
    np_, fp_ = fp.phase_f0_t_plain(f0, dt)
    if not (torch.equal(nk, np_) and _bits_equal((fk,), (fp_,))):
        raise AssertionError("batched K1 differs from its plain version")
    out = {}
    b, by = bound_ms(16 * gn * n + 8 * (n + gn), 4 * gn * n)
    out["k1"] = {"shape": [gn, n], "bound_ms": b, "bound_by": by,
                 "library_ms": None}
    out["k1"]["ms"], out["k1"]["timed_by"] = kernel_ms(
        partial(fp.phase_f0_t_cuda, f0, dt))
    out["k1"]["plain_ms"], _ = kernel_ms(partial(fp.phase_f0_t_plain, f0,
                                                 dt))

    su = g["fn"].resids._U_ext
    m = gn * len(g["fit_params"])
    x = torch.tensor(rng.standard_normal((n, m)), device="cuda")
    a = tl.segment_sum_cuda(x, su.perm, su.offsets)
    ref = tl.segment_sum_plain(x.cpu(), su.perm.cpu(), su.offsets.cpu())
    if not _bits_equal((a.cpu(),), (ref,)):
        raise AssertionError("K2 at the grid's width differs from plain")
    seg64 = su.seg.to(torch.int64)

    def lib2():
        return torch.zeros((su.k_e + 1, m), dtype=torch.float64,
                           device="cuda").index_add_(0, seg64, x)

    b, by = bound_ms(8 * n * m + 4 * (su.perm.numel() + su.k_e + 1)
                     + 8 * su.k_e * m, su.perm.numel() * m)
    out["k2"] = {"shape": [n, m], "bound_ms": b, "bound_by": by}
    out["k2"]["ms"], out["k2"]["timed_by"] = kernel_ms(
        partial(tl.segment_sum_cuda, x, su.perm, su.offsets))
    out["k2"]["plain_ms"], _ = kernel_ms(
        partial(tl.segment_sum_plain, x, su.perm, su.offsets))
    out["k2"]["library_ms"], _ = kernel_ms(lib2)
    log("grid kernels (K1, K2 at the grids' batched shapes): "
        + json.dumps(out))
    return out


def phase_downhill(model, white, toas, ref):
    """DownhillGLSFitter (the par) and DownhillWLSFitter (the white par)
    on the card from the exported start (SINI = 0.995), held to JAX's:
    the same iteration count, ``converged`` and lambdas, the accepted
    chi^2 per iteration within ``tolerances.REFIT_CHI2_REL``, values and
    uncertainties within the conditioning-aware limits; the first step
    halved; launches of K1, K2, K7 during each fit; wall.  Then from
    SINI = 0.99, whose last iteration proposes a step at the noise
    floor: held to the iteration count, ``converged`` and chi^2 per
    iteration; the lambdas and the values' distance from JAX printed
    beside JAX's own from one ulp either side of the start."""
    import copy

    import torch

    from pint_tpu_torch import tolerances as tol
    from pint_tpu_torch.downhill import DownhillGLSFitter, DownhillWLSFitter
    from pint_tpu_torch.fixedpoint import K1
    from pint_tpu_torch.linalg import K2, K7

    kernels = {"K1": K1, "K2": K2, "K7": K7}
    out = {}
    for case, whole in (("downhill", True), ("downhill99", False)):
        start = {str(k): float(v) for k, v in ref[case + "_start"]}
        for name, cls, m0 in (("gls", DownhillGLSFitter, model),
                              ("wls", DownhillWLSFitter, white)):
            m = copy.deepcopy(m0)
            m.values.update(start)
            p = f"{case}_{name}_"
            free = [str(k) for k in ref[p + "free_params"]]
            # the main path: counts reset just before, read just after
            for k in kernels.values():
                k.launches = 0
            torch.cuda.synchronize()
            t0 = time.time()
            f = cls(toas, m, device="cuda")
            chi2 = f.fit_toas()
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = {n: k.launches for n, k in kernels.items()}
            cond = f.fit_health["cond_log10"]
            if name == "wls":
                cond = tol.wls_normal_cond_log10(cond)
            tols = tol.fit_tolerances(cond)
            errs = tol.fit_errors(
                [m.values[k] for k in free],
                [m.uncertainties[k] for k in free], f.chi2_iters,
                ref[p + "values"], ref[p + "uncertainties"],
                ref[p + "chi2_iters"])
            errs["final_chi2_rel"] = abs(chi2 / float(ref[p + "final_chi2"])
                                         - 1)
            tols["chi2_rel"] = tols["final_chi2_rel"] = tol.REFIT_CHI2_REL
            same = {"n_iter": [len(f.chi2_iters), int(ref[p + "n_iter"])],
                    "converged": [f.converged, bool(ref[p + "converged"])]}
            held = ("chi2_rel", "final_chi2_rel")
            if whole:
                same["lambdas"] = [f.step_lambdas,
                                   ref[p + "lambdas"].tolist()]
                held = tuple(errs)
            else:
                errs["jax_ulp_values_sigma"] = float(
                    ref[p + "ulp_values_sigma"])
                errs["jax_ulp_chi2_rel"] = float(ref[p + "ulp_chi2_rel"])
            out[f"{case} {name}"] = {"launches": launches, "wall_s": wall,
                                     "errs": errs,
                                     "lambdas": f.step_lambdas}
            log(f"{case} {name}: start {start}; step lambdas "
                f"{f.step_lambdas} (JAX {ref[p + 'lambdas'].tolist()}"
                + ("" if whole else ", JAX one ulp either side "
                   + str(ref[p + "ulp_lambdas"].tolist()))
                + f"); chi2 per iteration {f.chi2_iters} (JAX "
                f"{ref[p + 'chi2_iters'].tolist()}); " + json.dumps(same)
                + "; observed " + json.dumps(errs) + "; held "
                + json.dumps({k: tols[k] for k in held})
                + f" (chi2 nominal {tol.CHI2_REL:g} held "
                f"{errs['chi2_rel'] <= tol.CHI2_REL}); launches {launches}; "
                f"wall {wall:.3f} s")
            bad = [k for k in held if not errs[k] <= tols[k]]
            if bad or any(a != b for a, b in same.values()):
                raise AssertionError(f"{case} {name} disagrees with JAX: "
                                     f"{bad} {same}")
            if not f.step_lambdas[0] < 1.0:
                raise AssertionError(f"{case} {name}: the first step was "
                                     "not halved")
            need = ("K1", "K2") if name == "gls" else ("K1", "K7")
            if not all(launches[k] > 0 for k in need):
                raise AssertionError(f"a kernel of {case} {name} never ran: "
                                     f"{launches}")
    return out


def synthetic_grams(n_psr, nb, m2, seed, n_rows=None):
    """KronGram of ``n_psr`` random pulsars of width nb (+ m2 GW
    columns) over ``n_rows`` rows, on the card."""
    import torch

    from pint_tpu_torch.linalg import KronGram

    rng = np.random.default_rng(seed)
    n = n_rows or nb + 100
    t = rng.standard_normal((n_psr, n, nb + m2 + 1))
    w = rng.uniform(0.5, 2.0, (n_psr, n)) * 1e12
    g = np.matmul((t * w[..., None]).transpose(0, 2, 1), t)
    u, f = slice(0, nb), slice(nb, nb + m2)
    return KronGram(*(torch.tensor(a.copy(), device="cuda") for a in (
        g[:, u, u], g[:, u, f], g[:, f, f], g[:, u, -1], g[:, f, -1],
        g[:, -1, -1], rng.standard_normal(n_psr))))


def phase_wide_case():
    """The wide PTA case (``pint_tpu_torch/data/pta4_wide.npz``) on the
    card: lnlike, the 2 x 2 grid and the posterior's value_and_grad
    against the JAX answers it carries; launches of K5w and K5bw during
    the path (both > 0)."""
    import torch

    from pint_tpu_torch import tolerances as tol
    from pint_tpu_torch.convert import (PTA4_WIDE, load_arrays,
                                        pta_case_from_arrays)
    from pint_tpu_torch.gw.common import CommonProcess
    from pint_tpu_torch.gw.hmc import GWBPosterior
    from pint_tpu_torch.linalg import K5, K5B, K5BW, K5W

    arrays = load_arrays(PTA4_WIDE)
    pairs = pta_case_from_arrays(arrays)
    kernels = {"K5": K5, "K5b": K5B, "K5w": K5W, "K5bw": K5BW}
    # the main path: counts reset just before, read just after
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    crn = CommonProcess(pairs, nmodes=int(arrays["ref_nmodes"]),
                        device="cuda")
    la, ga = (float(x) for x in arrays["ref_lnlike_point"])
    lnl = crn.lnlike(la, ga)
    surf = crn.lnlike_grid(arrays["ref_grid_log10_amp"],
                           arrays["ref_grid_gamma"])
    post = GWBPosterior(crn)
    lnp, g = (a.cpu().numpy() for a in post.value_and_grad(
        torch.as_tensor(arrays["ref_theta"], device="cuda")))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {n: k.launches for n, k in kernels.items()}
    nb, m2 = post.gram.g_uu.shape[-1], post.gram.g_ff.shape[-1]
    ref_g = arrays["ref_grad"]
    errs = {
        "lnlike": abs(lnl / float(arrays["ref_lnlike"]) - 1),
        "grid": float(np.max(np.abs(surf / arrays["ref_grid_lnlike"] - 1))),
        "lnprob": float(np.max(np.abs(lnp / arrays["ref_lnprob"] - 1))),
        "grad": max(float(np.max(np.abs(g[i] - ref_g[i])
                                 / np.max(np.abs(ref_g[i]))))
                    for i in range(len(ref_g)))}
    tols = {"lnlike": tol.GW_LNLIKE_REL, "grid": tol.GW_LNLIKE_REL,
            "lnprob": tol.GW_LNLIKE_REL, "grad": tol.HMC_GRAD_REL}
    log(f"wide case: {len(pairs)} pulsars, nb {nb}, m2 {m2}; launches "
        f"during the path {launches}; vs JAX " + json.dumps(errs)
        + " limits " + json.dumps(tols) + f"; wall {wall:.3f} s")
    if any(not errs[k] <= tols[k] for k in errs):
        raise AssertionError("the wide case disagrees with JAX")
    if not (launches["K5w"] > 0 and launches["K5bw"] > 0):
        raise AssertionError(f"a wide kernel never ran: {launches}")
    return {"launches": launches, "post": post, "crn": crn,
            "theta": arrays["ref_theta"]}


def k5_wide_cases(post, theta, kd=None):
    """{label: (grams, phi)} at which the wide forms are checked and
    timed: the posterior's weights at the wide case's 4 theta ("path
    b4", nb = 203, m2 = 28, the shape at which K5bw runs on the path);
    with the common process's data ``kd``, its noise weights ("path
    b1", which ``lnlike`` and the grid reduce once) and the wide case's
    grams with 16 chains of perturbed red-noise weights ("16 chains");
    nb = 470, m2 = 28 at 16 chains x 4 pulsars ("nb470", a pulsar of
    400 ECORR epochs and 30 red-noise modes) and at 16 chains x 68
    pulsars ("nb470 x68": an HMC gradient's capacity stage on a
    NANOGrav-width array whose pulsars carry ECORR epochs), from
    ``synthetic_grams``."""
    import torch

    rng = np.random.default_rng(9)
    c = HMC_RUN["n_chains"]
    th = np.repeat(post.center()[None], c, axis=0)
    th[:, 2:] += rng.uniform(-0.5, 0.5, th[:, 2:].shape)
    cases = {}
    if kd is not None:
        cases["path b1"] = (kd.gram, kd.phi_noise[None].contiguous())
    cases["path b4"] = (post.gram, post.phi_noise_at(torch.as_tensor(
        theta, device="cuda")).contiguous())
    if kd is not None:
        cases["16 chains"] = (post.gram, post.phi_noise_at(
            torch.as_tensor(th, device="cuda")).contiguous())
    for label, n_psr, seed in (("nb470", 4, 470), ("nb470 x68", 68, 68)):
        cases[label] = (synthetic_grams(n_psr, 470, 28, seed=seed),
                        torch.tensor(10.0 ** rng.uniform(
                            -16, -12, (c, n_psr, 470)), device="cuda"))
    return cases


#: (case of k5_wide_cases, calls a timing) of k5_wide_times
K5_WIDE_TURNS = (("path b4", 50), ("nb470", 20), ("nb470 x68", 5))


def k5_wide_times():
    """K5w and K5bw of the imported ``pint_tpu_torch`` under
    ``queued_ms``, for ``tools/torch_turns.py``: at the shapes of
    ``K5_WIDE_TURNS`` (after :func:`phase_wide_case`), the forward
    (``k5w_ms``), the backward on its L and X for random cotangents
    (``k5bw_ms``), the plain backward (the backward's yardstick) and
    the plain forward, and each kernel's blocks per SM where the
    package's library reports them."""
    import torch

    from pint_tpu_torch import linalg as tl

    torch.backends.cuda.matmul.allow_tf32 = False
    wide = phase_wide_case()
    cases = k5_wide_cases(wide["post"], wide["theta"])
    rng = np.random.default_rng(14)
    out = {}
    for label, reps in K5_WIDE_TURNS:
        pre, phi = cases[label]
        a = tl.kron_pulsar_cuda(pre, phi)
        cots = [torch.as_tensor(rng.standard_normal(t.shape), device="cuda")
                for t in a[:4]]
        b, p, nb = phi.shape
        bwd = (phi, a[4], a[5], *cots)
        row = {"chains": b, "pulsars": p, "nb": nb, "m2": pre.g_ff.shape[-1],
               "reps": reps,
               "k5w_ms": queued_ms(partial(tl.kron_pulsar_cuda, pre, phi),
                                   reps),
               "k5bw_ms": queued_ms(partial(tl.kron_pulsar_bwd_cuda, *bwd),
                                    reps),
               "plain_bwd_ms": queued_ms(
                   partial(tl.kron_pulsar_bwd_plain, *bwd), reps),
               "plain_fwd_ms": queued_ms(
                   partial(tl.kron_pulsar_plain, pre, phi), reps)}
        try:
            row["blocks_per_sm"] = [
                tl.K5W.call("kron_pulsar_wide_occupancy", nb, d)
                for d in (0, 1)]
        except AttributeError:  # an earlier library has no such query
            row["blocks_per_sm"] = None
        out[label] = row
        del a, bwd, cots
        torch.cuda.empty_cache()
    return out


def phase_k5_wide(wide):
    """K5w and K5bw against their plain versions on the card at every
    shape of :func:`k5_wide_cases`: bit identity run to run, ptxas
    report (a spill fails the phase), times beside the library calls
    and the bound, shared bytes, blocks per SM and waves."""
    import torch

    from pint_tpu_torch import tolerances as tol
    from pint_tpu_torch.linalg import (K5W, k5_wide_panel,
                                       kron_pulsar_bwd_cuda,
                                       kron_pulsar_bwd_plain,
                                       kron_pulsar_cuda, kron_pulsar_plain)

    cases = k5_wide_cases(wide["post"], wide["theta"], wide["crn"].kron_data)
    rng = np.random.default_rng(10)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for label, (pre, phi) in cases.items():
        a = kron_pulsar_cuda(pre, phi)
        b = kron_pulsar_cuda(pre, phi)
        p = kron_pulsar_plain(pre, phi)
        cots = [torch.as_tensor(rng.standard_normal(t.shape), device="cuda")
                for t in a[:4]]
        ga = kron_pulsar_bwd_cuda(phi, a[4], a[5], *cots)
        gb = kron_pulsar_bwd_cuda(phi, a[4], a[5], *cots)
        gp = kron_pulsar_bwd_plain(phi, a[4], a[5], *cots)
        torch.cuda.synchronize()
        names = ("chi2", "x", "m", "ld", "L", "X")
        errs = {n: tol.vector_rel(x, y) for n, x, y in zip(names, a, p)}
        errs["grad_phi"] = tol.vector_rel(ga, gp)
        rerun = _bits_equal(a, b) and _bits_equal((ga,), (gb,))
        upper = bool(torch.all(torch.triu(a[4], diagonal=1) == 0))
        del b, gb
        b_, p_, nb = phi.shape
        m2 = pre.g_ff.shape[-1]
        log(f"k5 wide {label}: {b_} chains x {p_} pulsars, nb {nb}, m2 "
            f"{m2}, panel {k5_wide_panel(nb)}: kernel vs plain "
            "(vector_rel) " + json.dumps(errs) + f" (limit "
            f"{tol.KRON_PULSAR_REL:g}); run-to-run bit-identical {rerun}; "
            f"L's upper triangle zero {upper}")
        if not (rerun and upper and all(v <= tol.KRON_PULSAR_REL
                                        for v in errs.values())):
            raise AssertionError(f"K5w/K5bw disagree at {label}")
        reps = 10 if b_ * p_ < 256 else 3
        rows = k5_times(pre, phi, a, p, cots, ga, gp,
                        (f"k5w {label}", f"k5bw {label}"), reps=reps)
        for bwd, (name, row) in enumerate(rows.items()):
            row["shared_bytes"] = K5W.call("kron_pulsar_wide_smem", nb, bwd)
            row["blocks_per_sm"] = K5W.call("kron_pulsar_wide_occupancy",
                                            nb, bwd)
            row["waves"] = row["blocks"] / (row["blocks_per_sm"] * sms)
            log(f"{name}: " + json.dumps(row))
        out.update(rows)
        del a, p, ga, gp, cots
        torch.cuda.empty_cache()
    rep = build_report(K5W, tuple(
        f"kron_pulsar_{d}_wide_kernelILi{bs}E" for d in ("fwd", "bwd")
        for bs in (8, 16, 32)))
    log("k5 wide ptxas: " + json.dumps(rep))
    return out


#: the ensemble chains of the par/tim case: par, fitter, chain length
MCMC_GROUPS = {"K1": ["phase_f0_t"], "K2": ["segment_sum"],
               "K8": ["woodbury_"], "K8 rhs": ["woodbury_rhs"],
               "K8 reduce": ["woodbury_reduce"],
               "K8 solve": ["woodbury_solve"], "K9": ["stretch_"],
               "gemm": ["gemm", "gemv"]}


def _kepler_iters(prepared):
    """The Newton depth of a prepared model's Kepler solve."""
    for sub in prepared.ctx.values():
        if isinstance(sub, dict) and "kepler_iters" in sub:
            return int(sub["kepler_iters"])
    return None


def phase_mcmc(kind, model, toas, ref):
    """The timing posterior's ensemble chain on the card (``gls``: the
    par, ECORR and red noise fixed; ``wls``: the white par), held to the
    JAX answers of ``b1855_mcmc_answers.npz``: the model fitted on the
    card and held to JAX's fit (values and uncertainties within the
    conditioning-aware fit limits), then set to JAX's fitted bits so
    both hold the same priors; the Kepler depth JAX chose, and the ECC
    prior box inside its class; ``BayesianTiming`` and ``run_chain`` of
    32 walkers x 200 steps with JAX's draws.  Up to the first near tie
    decided otherwise than in JAX (``tolerances.chain_parting_step``;
    the whole chain when there is none): positions bit-identical, every
    decision the same, lnp within ``tolerances.mcmc_lnp_limit``; over
    the whole chain, the acceptance fraction.  Launches of K1, K2, K7,
    K8, K9 during the chain (K9 = 3 per step); cold and warm wall,
    posterior evaluations per second (walkers x steps / wall,
    bench_mcmc's unit), busy share and device time by group of a warm
    20-step chain, peak memory."""
    import copy

    import torch

    from pint_tpu_torch import tolerances as tol
    from pint_tpu_torch.bayesian import BayesianTiming
    from pint_tpu_torch.fitter import GLSFitter, WLSFitter
    from pint_tpu_torch.fixedpoint import K1
    from pint_tpu_torch.linalg import K2, K7, K8
    from pint_tpu_torch.models.binary.kepler import newton_iters_for
    from pint_tpu_torch.sampler import K9, decision_margins, run_chain

    names = [str(n) for n in ref[f"{kind}_param_names"]]
    m = copy.deepcopy(model)
    f = (GLSFitter if kind == "gls" else WLSFitter)(toas, m, device="cuda")
    f.fit_toas(maxiter=3)
    if list(m.free_params) != names:
        raise AssertionError(f"mcmc {kind}: free parameters differ")
    cond = f.fit_health["cond_log10"]
    fit_tols = tol.fit_tolerances(
        tol.wls_normal_cond_log10(cond) if kind == "wls" else cond)
    jv, ju = ref[f"{kind}_values"], ref[f"{kind}_uncertainties"]
    fit_errs = {
        "values_sigma": float(np.max(np.abs(
            np.array([m.values[n] for n in names]) - jv) / ju)),
        "unc_rel": float(np.max(np.abs(
            np.array([m.uncertainties[n] for n in names]) / ju - 1.0)))}
    if any(fit_errs[k] > fit_tols[k] for k in fit_errs):
        raise AssertionError(f"mcmc {kind}: the card's fit {fit_errs} "
                             f"against JAX's, limits {fit_tols}")
    for n, v, u in zip(names, ref[f"{kind}_values"],
                       ref[f"{kind}_uncertainties"]):
        m.values[n] = float(v)
        m.uncertainties[n] = float(u)
    bt = BayesianTiming(m, toas, device="cuda")
    depth = _kepler_iters(bt.prepared)
    box = [bt.priors["ECC"].lo, bt.priors["ECC"].hi]
    box_depth = newton_iters_for(max(abs(e) for e in box))
    if not (depth == int(ref[f"{kind}_kepler_iters"]) == box_depth
            and np.array_equal(box, ref[f"{kind}_ecc_box"])):
        raise AssertionError(f"mcmc {kind}: Kepler depth {depth}, JAX "
                             f"{ref[f'{kind}_kepler_iters']}, ECC box "
                             f"{box} needs {box_depth}")
    sx = torch.tensor(ref[f"{kind}_spread_x"], device="cuda")
    with torch.no_grad():
        lnp_s = torch.func.vmap(bt.lnposterior)(sx).cpu().numpy()
    spread_ok = tol.mcmc_lnp_ok(lnp_s, ref[f"{kind}_lnpost_cho"])
    x0 = ref[f"{kind}_x0"]
    nsteps = int(ref["nsteps"])
    draws = tuple(ref[f"{kind}_draw_{k}"] for k in ("u", "idx", "uacc"))
    kernels = {"K1": K1, "K2": K2, "K7": K7, "K8": K8, "K9": K9}

    def chain(n=nsteps):
        with torch.no_grad():
            out = run_chain(bt.lnposterior, x0, n, device="cuda",
                            draws=tuple(d[:n] for d in draws))
        torch.cuda.synchronize()
        return out

    # the main path: counts reset just before, read just after
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = chain()
    cold_s = time.time() - t0
    launches = {n: k.launches for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    margin, lnp_prop, before = decision_margins(out, draws)
    tie = tol.near_ties(margin, lnp_prop, before).any(axis=(1, 2))
    upto = tol.chain_parting_step(margin, lnp_prop, before, out["accepted"],
                                  ref[f"{kind}_accepted"])
    jc, jl = ref[f"{kind}_chain"], ref[f"{kind}_lnp"]
    same_steps = np.all(np.abs(out["chain"] - jc) <= tol.MCMC_POSITION_ULPS
                        * np.spacing(np.abs(jc)), axis=(1, 2))
    first_diff = int(np.argmin(same_steps)) if not same_steps.all() else None
    pos_ok = bool(same_steps[:upto].all())
    dec_ok = bool(np.array_equal(out["accepted"][:upto],
                                 ref[f"{kind}_accepted"][:upto]))
    lnp_ok = tol.mcmc_lnp_ok(out["lnp"][:upto], jl[:upto])
    fin = np.isfinite(jl[:upto])
    lnp_err = float(np.max(np.abs(out["lnp"][:upto] - jl[:upto])[fin]
                           / tol.mcmc_lnp_limit(jl[:upto][fin])))
    acc = float(np.mean(out["counts"].sum(axis=1) / x0.shape[0]))
    fmargin = np.abs(margin[:upto][np.isfinite(margin[:upto])])
    t0 = time.time()
    chain()
    warm_s = time.time() - t0
    t0 = time.time()
    chain(20)
    warm20_s = time.time() - t0
    busy, dev_ms, shares = trace_breakdown(lambda: chain(20), warm20_s,
                                           f"mcmc_{kind}", MCMC_GROUPS)
    res = {"launches": launches, "first_near_tie_step":
               int(np.argmax(tie)) if tie.any() else None,
           "near_tie_steps": np.flatnonzero(tie).tolist(),
           "parted_at_step": None if upto == nsteps else upto,
           "steps_compared": upto,
           "smallest_margin": float(fmargin.min()),
           "positions_bit_identical": pos_ok,
           "first_step_differing": first_diff,
           "decisions_same": dec_ok, "lnp_within_limit": lnp_ok,
           "lnp_err_over_limit": lnp_err, "spread_lnp_within_limit":
               spread_ok, "acceptance": acc,
           "jax_acceptance": float(ref[f"{kind}_acceptance"]),
           "card_fit_vs_jax": fit_errs, "kepler_iters": depth,
           "cold_s": cold_s, "warm_s": warm_s,
           "evals_per_s": x0.shape[0] * nsteps / warm_s,
           "warm20_s": warm20_s, "busy": busy, "device_ms_20": dev_ms,
           "peak_gib": peak / 2**30}
    log(f"mcmc {kind}: {x0.shape[0]} walkers x {nsteps} steps over {names}, "
        "at 10^4 TOAs; " + json.dumps(res) + "; device time by group "
        + json.dumps(shares))
    need = ("K1", "K8", "K9") if kind == "gls" else ("K1", "K9")
    if not (pos_ok and dec_ok and lnp_ok and spread_ok):
        raise AssertionError(f"mcmc {kind} disagrees with JAX")
    if launches["K9"] != 3 * nsteps or not all(launches[k] > 0
                                               for k in need):
        raise AssertionError(f"mcmc {kind}: launches {launches}")
    if upto < nsteps:
        log(f"mcmc {kind}: a near tie at step {upto} went the other way; "
            f"the chains part there and are compared up to it")
    elif abs(acc - res["jax_acceptance"]) > 1e-6:
        raise AssertionError(f"mcmc {kind}: acceptance {acc}")
    res.update(bt=bt, draws=draws, x0=x0)
    return res


def phase_mcmc_autocorr():
    """``EnsembleSampler.run_mcmc_autocorr`` on a 2-D unit Gaussian on
    the card, from the generator (seeded 1): converged by the emcee
    criterion, the target's variance recovered within 15 %."""
    import torch

    from pint_tpu_torch.sampler import K9, EnsembleSampler

    def lnpost(x):
        return -0.5 * torch.sum(x * x, dim=-1)

    s = EnsembleSampler(lnpost, nwalkers=32, seed=1, device="cuda")
    x0 = s.initial_ball(np.zeros(2), np.ones(2) * 0.5)
    before = K9.launches
    t0 = time.time()
    chain, converged, tau = s.run_mcmc_autocorr(x0, chunk=200,
                                                maxsteps=4000)
    wall = time.time() - t0
    flat = s.flatchain(burn=int(5 * np.max(tau)))
    var = flat.var(axis=0)
    out = {"converged": bool(converged), "steps": int(chain.shape[0]),
           "tau": tau.tolist(), "variance": var.tolist(),
           "acceptance": s.acceptance, "k9_launches": K9.launches - before,
           "wall_s": wall}
    log("mcmc autocorr: " + json.dumps(out))
    if not (converged and np.all(np.abs(var - 1.0) <= 0.15)):
        raise AssertionError("run_mcmc_autocorr did not converge on the "
                             "Gaussian")
    return out


def _k9_case(mc):
    """The first step of a chain's own inputs: the ensemble x0 (32 x 10),
    its lnp, the proposals' lnp of both halves (the second half's
    proposed against the first after its accept) and step 0's draws, on
    the card."""
    import torch

    from pint_tpu_torch import sampler as ts

    x = torch.tensor(mc["x0"], device="cuda")
    nw, nd = x.shape
    h = nw // 2
    draws = [tuple(torch.as_tensor(d[0, k], device="cuda").contiguous()
                   for d in mc["draws"]) for k in (0, 1)]
    draws = [(u, idx.to(torch.int64), u_acc) for u, idx, u_acc in draws]
    lnpost_v = torch.func.vmap(mc["bt"].lnposterior)
    with torch.no_grad():
        lnp = lnpost_v(x).contiguous()
        x0, lnp0 = x.clone(), lnp.clone()
        buf = ts.StretchBuffers.around(x, lnp)
        for gap, s in ((0, slice(0, h)), (1, slice(h, nw))):
            ts.stretch_move_plain(buf, gap, draws, 2.0)
            buf.lnp_prop[s] = lnpost_v(buf.prop[s])
    return x0, lnp0, buf.lnp_prop, draws


def _k9_synthetic(h, nd, seed=9):
    """A step's inputs at (2h, nd): walkers at scales from 1e-12 to 1e3,
    lnp near 1.2e5 with a NaN and a -inf proposal lnp, the draws of both
    halves."""
    import torch

    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-12, 3, nd)
    center = rng.normal(0, 1, nd) * 10.0 ** rng.uniform(-3, 3, nd)

    def t(a, dtype=torch.float64):
        return torch.tensor(np.asarray(a), dtype=dtype, device="cuda")
    lnp = rng.normal(1.2e5, 3.0, 2 * h)
    lnp_prop = lnp + rng.normal(0.0, 3.0, 2 * h)
    lnp_prop[:2] = (np.nan, -np.inf)
    draws = [(t(rng.uniform(size=h)), t(rng.integers(0, h, h), torch.int64),
              t(rng.uniform(size=h))) for _ in range(2)]
    return (t(center + scale * rng.standard_normal((2 * h, nd))), t(lnp),
            t(lnp_prop), draws)


class _K9Step:
    """A red-black step's buffers on the card and its three K9 launches
    (or K9's plain version), run in place: repeated steps leave a valid
    state, so a timed call holds launches alone."""

    def __init__(self, inputs, a=2.0):
        from pint_tpu_torch.sampler import StretchBuffers

        x, lnp, lnp_prop, self.draws = inputs
        self.buf = StretchBuffers.around(x.clone(), lnp.clone())
        self.buf.lnp_prop.copy_(lnp_prop)
        self.a = a

    def step(self, plain=False):
        from pint_tpu_torch import sampler as ts

        move = ts.stretch_move_plain if plain else ts.stretch_move
        for gap in (0, 1, 2):
            move(self.buf, gap, self.draws, self.a)

    def gap(self):
        """The middle launch alone: accept half 0, propose half 1."""
        from pint_tpu_torch.sampler import stretch_move

        stretch_move(self.buf, 1, self.draws, self.a)


def k9_k6_times():
    """K9 and K6 of the imported ``pint_tpu_torch`` under
    ``queued_ms``, for ``tools/torch_turns.py``: a K9 red-black step
    (``step_ms``) and its middle launch (``half_ms``) at 16 walkers a
    half x 10 parameters and 4096 x 64, and one K6 draw's n_leap + 1
    launches (``draw_ms``) at ``K6_SHAPE``, on buffers updated in place;
    beside each, calls made back to back with the host's enqueue
    (``cuda_ms``)."""
    from pint_tpu_torch.gw import hmc

    out = {"k9": {}}
    for h, nd in ((16, 10), (4096, 64)):
        st = _K9Step(_k9_synthetic(h, nd))
        out["k9"][f"{h}x{nd}"] = {
            "step_ms": queued_ms(st.step), "half_ms": queued_ms(st.gap),
            "step_with_enqueue_ms": cuda_ms(st.step, reps=50)}
    c, nd, n_leap = K6_SHAPE
    st = _k6_timed_state()

    def draw():
        hmc.nuts_draw_start(st)
        for i in range(n_leap - 1):
            hmc.nuts_leap_next(st, i)
        hmc.nuts_draw_finish(st, n_leap - 1, False, False, 0.8, 5)
    out["k6"] = {"draw_ms": queued_ms(draw, reps=20),
                 "draw_with_enqueue_ms": cuda_ms(draw, reps=20),
                 "chains": c, "ndim": nd, "n_leap": n_leap}
    return out


def phase_k9(mc):
    """K9 (a whole step: three launches) against the plain propose and
    accept in turn, at the GLS chain's own first step (32 x 10), at 8192
    walkers x 64 (h = 4096) and at a shape past one wave of co-resident
    blocks: walkers, lnp, proposals, z, flags and counts bit-identical
    (a NaN equal to a NaN) and bit-identical run to run.  Times, on
    buffers updated in place (no copy in the timed call): a step (three
    launches), its middle launch alone, the plain step, the step's bound;
    no PyTorch call computes the move."""
    import torch

    from pint_tpu_torch import sampler as ts

    def same(p, q):
        return all(torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
            torch.nan_to_num(a.double()).view(torch.int64),
            torch.nan_to_num(b.double()).view(torch.int64))
            for a, b in zip(p, q))

    wave = ts.K9.call("stretch_move_max_blocks")
    out = {"co_resident_blocks": wave}
    for label, inputs in (("path", _k9_case(mc)),
                          ("h4096_d64", _k9_synthetic(4096, 64)),
                          ("h16384_d40", _k9_synthetic(16384, 40))):
        steps = [_K9Step(inputs) for _ in range(3)]
        ts.K9.launches = 0
        steps[0].step()
        steps[1].step()
        launches = ts.K9.launches
        steps[2].step(plain=True)
        torch.cuda.synchronize()
        a, b, p = (st.buf for st in steps)
        ok_plain, ok_rerun = same(a, p), same(a, b)
        nd = a.x.shape[1]
        h = a.x.shape[0] // 2
        blocks = ts.K9.call("stretch_move_blocks", h, nd)
        max_abs = max(float(torch.max(torch.abs(torch.nan_to_num(x.double())
                                                - torch.nan_to_num(
                                                    y.double()))))
                      for x, y in zip(a, p))
        n_acc = a.counts.tolist()
        row = {"shape": [2 * h, nd], "bit_identical_to_plain": ok_plain,
               "run_to_run": ok_rerun, "max_abs_err": max_abs,
               "accepted": n_acc, "launches_per_step": launches // 2,
               "blocks": blocks, "past_one_wave": h * nd > 256 * wave}
        if not (ok_plain and ok_rerun and launches == 6):
            log(f"k9 {label}: " + json.dumps(row))
            raise AssertionError(f"K9 disagrees with its plain version at "
                                 f"{label}")
        if label == "h16384_d40" and not row["past_one_wave"]:
            raise AssertionError(f"k9: {2 * h} x {nd} is not past one wave "
                                 f"of {wave} blocks")
        timed = _K9Step(inputs)
        row["ms"], row["timed_by"] = kernel_ms(timed.step)
        row["gap_ms"], _ = kernel_ms(timed.gap)
        row["plain_ms"], _ = kernel_ms(partial(_K9Step(inputs).step,
                                               plain=True))
        # the step as a function: the walkers, lnp, the proposals' lnp
        # and the draws read once; the proposals and z written, and the
        # accepted walkers and their lnp; the flags and the counts
        acc_rows = sum(n_acc)
        row["bound_ms"], row["bound_by"] = bound_ms(
            8 * (2 * h * nd + 10 * h + 2 * h * nd + 2 * h
                 + acc_rows * (nd + 1)) + 2 * h + 16,
            2 * (8 * h * nd + 60 * h))
        row["library_ms"] = None
        row["per_call_with_enqueue_ms"] = cuda_ms(timed.step, reps=50)
        out[label] = row
        log(f"k9 {label}: " + json.dumps(row))
    out.update(build_report(ts.K9, ("stretch_move_kernel",)))
    log("k9 ptxas: " + json.dumps({k: v for k, v in out.items()
                                   if k == "ptxas"}))
    return out


def stream_nights(ref):
    """The 11 nights of the stream check, read from the committed tim in
    blocks of ``night_toas``."""
    from pint_tpu_torch.convert import B1855_STREAM_NIGHTS
    from pint_tpu_torch.toa import get_TOAs

    back = get_TOAs(str(B1855_STREAM_NIGHTS))
    n = int(ref["night_toas"])
    return [back[np.arange(i * n, (i + 1) * n)]
            for i in range(len(back) // n)]


def host_profile(f, night, kind):
    """Where an append's host time goes: ``cProfile`` of one more
    append (``night`` moved 6 days later, past every row, so it lands
    in the bucket; its rows are far off the model, so the triage holds
    them all out) after the compared nights; the 12 largest cumulative
    entries go to chiprun_out/stream_{kind}_host_profile.txt, the
    stream's own stages are returned [name, cumulative ms]."""
    import cProfile
    import io
    import pstats

    import torch

    extra = night[np.arange(len(night))]
    extra.ticks = extra.ticks + np.int64(6 * 86400) * 2**32
    extra.mjd_float = extra.mjd_float + 6.0
    extra._compute_posvels()
    prof = cProfile.Profile()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        prof.enable()
        f.append_refit(extra, maxiter=3)
        torch.cuda.synchronize()
        prof.disable()
    buf = io.StringIO()
    st = pstats.Stats(prof, stream=buf).sort_stats("cumulative")
    st.print_stats(40)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"stream_{kind}_host_profile.txt"),
              "w") as fh:
        fh.write(buf.getvalue())
    want = ("append_refit", "_stream_mini_build", "_stream_delta",
            "_stream_triage", "append", "append_toas", "prepare_appended",
            "to_table", "_append_fit_data", "_stream_refit",
            "stream_prepare", "merge", "_sliced")
    rows = [(fn[2], round(v[3] * 1e3, 3)) for fn, v in st.stats.items()
            if fn[2] in want and "pint_tpu_torch" in fn[0]]
    return sorted(rows, key=lambda r: -r[1])


def phase_stream(kind, model, toas, nights, ref, device="cuda"):
    """The streaming appends on the card (``gls``: the par; ``wls``: the
    white par), held to ``b1855_stream_answers.npz``: the bucketed fit
    (``bucket=True``, the 10842 bucket, ``fit_toas(maxiter=3)``),
    ``stream_prepare()`` and ``append_refit(night, maxiter=3)`` for the
    11 nights.  Per night, up to the first triage near tie decided
    otherwise than in JAX (``tolerances.STREAM_Z_TIE``; all nights when
    none is): mode, ``in_bucket``, verdict, quarantined rows and the
    captures it made equal to JAX's; chi^2 within
    ``tolerances.stream_chi2_limit``; values and uncertainties within
    ``tolerances.stream_fit_tolerances`` of JAX's refit condition number
    and centering ratio.  The
    final values within 0.05 sigma of the port's own from-scratch fit
    over the merged data (JAX's oracle), and that fit within the fit
    limits of JAX's.  Launches of K1, K2, K7, K10 at the capture and per
    night (K10: one per incremental append, plus one per capture);
    capture wall, median append latency over nights 1-9, the cold
    from-scratch prepare + fit, busy share of one append, peak
    memory."""
    import copy

    import torch

    from pint_tpu_torch import tolerances as tol
    from pint_tpu_torch.fitter import GLSFitter, WLSFitter
    from pint_tpu_torch.fixedpoint import K1
    from pint_tpu_torch.linalg import K2, K7, K10

    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cls = GLSFitter if kind == "gls" else WLSFitter
    free = [str(k) for k in ref[f"{kind}_free_params"]]
    kernels = {"K1": K1, "K2": K2, "K7": K7, "K10": K10}
    m = copy.deepcopy(model)
    f = cls(toas, m, device=device, bucket=True)
    f.fit_toas(maxiter=3)
    if list(m.free_params) != free or len(f.toas) != int(ref[f"{kind}_bucket"]):
        raise AssertionError(f"stream {kind}: free set or bucket differ")
    cond = f.fit_health["cond_log10"]
    base_tol = tol.fit_tolerances(
        tol.wls_normal_cond_log10(cond) if kind == "wls" else cond)
    base_err = float(np.max(np.abs(np.array([m.values[k] for k in free])
                                   - ref[f"{kind}_base_values"])
                            / ref[f"{kind}_base_uncertainties"]))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    sync()
    t0 = time.time()
    f.stream_prepare()
    sync()
    capture_s = time.time() - t0
    capture_launches = {n: k.launches for n, k in kernels.items()}
    nights_out = []
    upto = len(nights)
    bad = []
    lat = []
    busy = None
    for i, night in enumerate(nights):
        for k in kernels.values():
            k.launches = 0
        c0 = f.stream_counts["captures"]

        def run(night=night):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                out = f.append_refit(night, maxiter=3)
            sync()
            return out
        t0 = time.time()
        if cuda and i == len(nights) - 1:
            got = []
            busy, _ = profile_breakdown(lambda: got.append(run()), 0.0,
                                        f"stream_{kind}_append")
            rep = got[0]
        else:
            rep = run()
        wall = time.time() - t0
        if 1 <= i <= 9:
            lat.append(wall)
        tri = rep["triage"]
        q = np.zeros(len(night), dtype=bool)
        q[tri["quarantine"]] = True
        row = {"night": i, "mode": rep["mode"], "verdict": tri["verdict"],
               "quarantined": np.flatnonzero(q).tolist(),
               "captures": f.stream_counts["captures"] - c0,
               "margin": tri["margin"], "wall_s": wall,
               "launches": {n: k.launches for n, k in kernels.items()}}
        same = (rep["mode"] == str(ref[f"{kind}_mode"][i])
                and bool(rep["in_bucket"]) == bool(ref[f"{kind}_in_bucket"][i])
                and tri["verdict"] == str(ref[f"{kind}_verdict"][i])
                and np.array_equal(q, ref[f"{kind}_quarantine"][i])
                and row["captures"] == int(ref[f"{kind}_captures"][i]))
        if not same and min(tri["margin"], float(ref[f"{kind}_margin"][i])) \
                < tol.STREAM_Z_TIE:
            upto = i
            nights_out.append(row)
            break
        lim = tol.stream_chi2_limit()
        tols = tol.stream_fit_tolerances(ref[f"{kind}_cond_log10"][i],
                                         ref[f"{kind}_centering"][i])
        ju = ref[f"{kind}_uncertainties"][i]
        row["chi2_rel"] = abs(rep["chi2"] / float(ref[f"{kind}_chi2"][i])
                              - 1.0)
        row["chi2_limit"] = lim
        row["values_sigma"] = float(np.max(np.abs(
            np.array([m.values[k] for k in free]) - ref[f"{kind}_values"][i])
            / ju))
        row["unc_rel"] = float(np.max(np.abs(
            np.array([m.uncertainties[k] for k in free]) / ju - 1.0)))
        row["limits"] = {"values_sigma": tols["values_sigma"],
                         "unc_rel": tols["unc_rel"]}
        nights_out.append(row)
        k10 = row["launches"]["K10"]
        want_k10 = (1 if rep["mode"] == "incremental" else 0) \
            + row["captures"]
        if not same or row["chi2_rel"] > lim \
                or row["values_sigma"] > tols["values_sigma"] \
                or row["unc_rel"] > tols["unc_rel"] or k10 != want_k10:
            bad.append(i)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    final = np.array([m.values[k] for k in free])
    merged = f.toas[np.arange(f.toas.n_filled)]
    ms = copy.deepcopy(model)
    sync()
    t0 = time.time()
    fs = cls(merged, ms, device=device, bucket=True)
    fs.fit_toas(maxiter=3)
    sync()
    cold_s = time.time() - t0
    scratch = np.array([ms.values[k] for k in free])
    serr = np.array([ms.uncertainties[k] for k in free])
    vs_scratch = np.abs(final - scratch) / (0.05 * serr + 1e-9 * np.maximum(
        np.abs(scratch), 1.0))
    scond = fs.fit_health["cond_log10"]
    stol = tol.fit_tolerances(tol.wls_normal_cond_log10(scond)
                              if kind == "wls" else scond)
    scratch_err = float(np.max(np.abs(scratch - ref[f"{kind}_scratch_values"])
                               / ref[f"{kind}_scratch_uncertainties"]))
    host = host_profile(f, nights[-2], kind) if cuda else None
    res = {"base_fit_vs_jax_sigma": base_err,
           "base_limit": base_tol["values_sigma"],
           "capture_s": capture_s, "capture_launches": capture_launches,
           "append_latency_ms_median_1_9": float(np.median(lat)) * 1e3,
           "cold_scratch_prepare_fit_s": cold_s,
           "busy_share_one_append": busy, "peak_gib": peak / 2**30,
           "host_profile_top": host,
           "nights_compared": upto,
           "final_vs_own_scratch_over_limit": float(np.max(vs_scratch)),
           "scratch_vs_jax_sigma": scratch_err,
           "scratch_limit": stol["values_sigma"],
           "stream_counts": dict(f.stream_counts)}
    log(f"stream {kind}: {len(toas)} base TOAs in the {len(f.toas)} bucket, "
        f"{len(nights)} nights; " + json.dumps(res))
    for row in nights_out:
        log(f"stream {kind} night: " + json.dumps(row))
    if upto < len(nights):
        log(f"stream {kind}: a triage near tie at night {upto} went the "
            "other way; the streams part there")
    if bad or base_err > base_tol["values_sigma"] \
            or res["final_vs_own_scratch_over_limit"] > 1.0 \
            or scratch_err > stol["values_sigma"] \
            or capture_launches["K10"] != 1:
        raise AssertionError(f"stream {kind} disagrees with JAX (nights "
                             f"{bad})")
    res.update(fitter=f, nights=nights_out)
    return res


def phase_k10(st_gls, st_wls):
    """K10 against its plain version at the path's shapes: the GLS and
    WLS captures' own inputs (10842 x 72, c0 = 60; 10842 x 12) and the
    GLS fold (32 rows x K + P + 2 onto the stream's packed moments):
    bit-identical to the plain version (the same order; within
    ``tolerances.stream_moments_limit`` is the stated limit) and run to
    run; time beside the plain version, one ``torch.addmm`` (A w
    precomputed; and with A w formed inside the timed call) and the
    bound."""
    import torch

    from pint_tpu_torch import linalg as tl
    from pint_tpu_torch import tolerances as tol

    def case(f):
        with torch.no_grad():
            A, w, kd = f._stream_capture_inputs()
        return A.contiguous(), w, kd, torch.zeros(
            (A.shape[1], A.shape[1] - kd), dtype=torch.float64,
            device="cuda")

    fg = st_gls["fitter"]
    S = fg._stream["moments"].S
    rng = np.random.default_rng(10)
    c = S.shape[0]
    fold_A = torch.tensor(rng.standard_normal((32, c))
                          * 10.0 ** rng.uniform(-3, 3, c), device="cuda")
    fold_A[:, -1] = 1.0
    fold_w = torch.tensor(np.r_[rng.uniform(0.5, 2.0, 25) * 1e12,
                                np.zeros(7)], device="cuda")
    out = {}
    for label, (A, w, c0, S0) in (
            ("capture gls", case(fg)),
            ("capture wls", case(st_wls["fitter"])),
            ("fold gls", (fold_A, fold_w, 0, S.clone()))):
        n, cc = A.shape
        a = tl.stream_moments_cuda(S0.clone(), A, w, c0)
        b = tl.stream_moments_cuda(S0.clone(), A, w, c0)
        p = tl.stream_moments_plain(S0.clone(), A, w, c0)
        torch.cuda.synchronize()
        abs_sum = torch.abs(S0) + torch.abs(A * w[:, None]).T \
            @ torch.abs(A[:, c0:])
        lim = tol.stream_moments_limit(n, abs_sum.cpu().numpy())
        err = torch.abs(a - p).cpu().numpy()
        row = {"shape": [n, cc, c0],
               "bit_identical_to_plain": bool(torch.equal(
                   a.view(torch.int64), p.view(torch.int64))),
               "run_to_run": bool(torch.equal(a.view(torch.int64),
                                              b.view(torch.int64))),
               "max_abs_err": float(err.max()),
               "err_over_limit": float(np.max(err / np.maximum(lim,
                                                               1e-300)))}
        if not (row["run_to_run"] and row["err_over_limit"] <= 1.0):
            log(f"k10 {label}: " + json.dumps(row))
            raise AssertionError(f"K10 disagrees with its plain version at "
                                 f"{label}")
        St = S0.clone()
        row["ms"], row["timed_by"] = kernel_ms(
            partial(tl.stream_moments_cuda, St, A, w, c0))
        # ~400 small kernels a call at the capture's shape: events only
        # (the profiler's key_averages over 10^4 launches takes minutes)
        row["plain_ms"] = queued_ms(
            partial(tl.stream_moments_plain, St, A, w, c0), reps=5, warmup=1)
        Aw_t = (A * w[:, None]).T
        Aj = A[:, c0:]
        row["library_ms"], _ = kernel_ms(
            lambda: torch.addmm(St, Aw_t, Aj))
        # the same yardstick from K10's own inputs: A w inside the call
        row["library_aw_ms"], _ = kernel_ms(
            lambda: torch.addmm(St, (A * w[:, None]).T, A[:, c0:]))
        cw = cc - c0
        row["bound_ms"], row["bound_by"] = bound_ms(
            8 * (n * cc + n + 2 * cc * cw), 2 * n * cc * cw)
        out[label] = row
        log(f"k10 {label}: " + json.dumps(row))
    out.update(build_report(tl.K10, ("stream_moments_partial_rows",
                                     "stream_moments_partial",
                                     "stream_moments_reduce")))
    log("k10 ptxas: " + json.dumps({k: v for k, v in out.items()
                                    if not k.startswith(("capture",
                                                         "fold"))}))
    return out


def phase_crn_dense(arrays, pairs, kron_surf):
    """The dense CRN path on the 68-pulsar case: ``CommonProcess(pairs,
    nmodes=14, kron=False)`` on the card, ``lnlike`` at the exported
    points held to JAX's dense answers (Hellings-Downs, and the case's
    point under the singular ORFs), the 16 x 16 ``lnlike_grid`` held to
    the case's JAX kron grid and to the card's own kron grid; K11 runs,
    K3 does not (a dense instance builds no kron stacks)."""
    import torch

    from pint_tpu_torch import tolerances as tol
    from pint_tpu_torch.convert import CRN_DENSE_ANSWERS, load_arrays
    from pint_tpu_torch.fixedpoint import K1
    from pint_tpu_torch.gw.common import CommonProcess
    from pint_tpu_torch.linalg import K3, K11

    ref = load_arrays(CRN_DENSE_ANSWERS)
    nmodes = int(ref["ref_nmodes"])
    pts = [(float(a), float(g)) for a, g in ref["ref_points"]]
    grid_a, grid_g = arrays["ref_grid_log10_amp"], arrays["ref_grid_gamma"]
    n_pts = grid_a.size * grid_g.size
    kernels = {"K1": K1, "K3": K3, "K11": K11}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t0

    def run_path(crn):
        lnl, t_lnl = timed(lambda: [crn.lnlike(a, g) for a, g in pts])
        surf, t_grid = timed(lambda: crn.lnlike_grid(grid_a, grid_g))
        return (lnl, surf), {"lnlike_3_s": t_lnl,
                             "lnlike_grid_256_s": t_grid}

    # the main path: counts reset just before, read just after
    for k in kernels.values():
        k.launches = 0
    crn, t_build = timed(lambda: CommonProcess(
        pairs, nmodes=nmodes, kron=False, device="cuda"))
    (lnl, surf), cold = run_path(crn)
    launches = {n: k.launches for n, k in kernels.items()}
    cold["build_s"] = t_build
    log(f"crn dense: launches during the path {launches}")
    sing = {}
    for orf in ("monopole", "dipole"):
        sib = CommonProcess(nmodes=nmodes, orf=orf, kron=False,
                            device="cuda", _prebuilt=(
                                crn.data, crn.pos, crn.freqs, crn.df, None))
        sing[orf] = sib.lnlike(*pts[0])
        del sib
    torch.cuda.empty_cache()
    errs = {"hd": max(abs(x / r - 1) for x, r in zip(
                lnl, ref["ref_hd_dense"])),
            "monopole": abs(sing["monopole"]
                            / float(ref["ref_monopole_dense"][0]) - 1),
            "dipole": abs(sing["dipole"]
                          / float(ref["ref_dipole_dense"][0]) - 1),
            "grid_vs_jax_kron": float(np.max(np.abs(
                surf / arrays["ref_grid_lnlike"] - 1))),
            "grid_vs_card_kron": float(np.max(np.abs(surf / kron_surf - 1)))}
    tols = {"hd": tol.GW_LNLIKE_REL, "monopole": tol.GW_SINGULAR_REL,
            "dipole": tol.GW_SINGULAR_REL,
            "grid_vs_jax_kron": tol.GW_LNLIKE_REL,
            "grid_vs_card_kron": tol.GW_LNLIKE_REL}
    k_cols = crn.dense.gram.shape[0]
    log(f"crn dense: K {k_cols}, N {crn.n_toa_total}, {crn.n_pulsars} "
        f"pulsars; lnlike {lnl!r} (JAX dense "
        f"{ref['ref_hd_dense'].tolist()!r}); monopole {sing['monopole']!r}"
        f", dipole {sing['dipole']!r}; observed relative errors "
        + json.dumps(errs) + " tolerances " + json.dumps(tols))
    bad = [k for k in errs if not errs[k] <= tols[k]]
    if bad:
        raise AssertionError(f"the dense CRN path disagrees on {bad}")
    if not (launches["K11"] > 0 and launches["K3"] == 0):
        raise AssertionError(f"the dense path's kernels: {launches}")
    (_, _), warm = run_path(crn)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    _, t_grid = timed(lambda: crn.lnlike_grid(grid_a, grid_g))
    peak = torch.cuda.max_memory_allocated()
    log("crn dense: wall time cold " + json.dumps(cold) + " warm "
        + json.dumps(warm))
    log(f"crn dense: lnlike_grid {n_pts} points in {t_grid:.4f} s warm = "
        f"{n_pts / t_grid:.1f} points/s, {crn.grid_chunk()} points per "
        f"batch; peak device memory {peak / 2**30:.3f} GiB during the "
        f"grid ({base_mem / 2**30:.3f} GiB held before it)")
    busy, dev_ms, _ = trace_breakdown(
        lambda: crn.lnlike_grid(grid_a, grid_g), t_grid, "crn_dense_grid",
        {"K11": ["crn_"],
         "cuSOLVER potrf": ["getrf_wo_pivot", "syrk", "potrf"],
         "solve": ["trsv", "trsm"], "ATen": ["at::native"]})
    # one point's least work: the capacity's Cholesky and one solve at
    # the tensor-core peak, S and L each written once
    b, by = bound_ms(8 * 2 * k_cols**2, k_cols**3 / 3 + 2 * k_cols**2,
                     FP64_TC_FLOPS)
    log(f"crn dense: grid device time per point {dev_ms / n_pts!r} ms (all "
        f"kernels of one warm grid), bound {b!r} ms ({by}; the Cholesky of "
        f"{k_cols}^2 and one solve at the fp64 tensor-core peak)")
    return {"launches": launches, "crn": crn, "cold": cold, "warm": warm,
            "grid_points_per_s": n_pts / t_grid, "peak_bytes": peak,
            "grid_busy": busy}


def k11_synthetic(p, m2, n_noise, g, seed=11):
    """(gram, phi_noise, orf, phi_gw) of a random array of ``p`` pulsars
    on the card: a Hellings-Downs ORF of random sky positions, ``n_noise``
    noise columns a pulsar (its last at the offset's 1e30), an SPD
    gram."""
    import torch

    from pint_tpu_torch.gw.orf import orf_matrix

    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((p, 3))
    pos /= np.linalg.norm(pos, axis=1)[:, None]
    kn = p * n_noise
    k = kn + p * m2
    # the gram from the card's generator: at full width (K = 6188) the
    # host would take seconds
    a = torch.randn((2 * k, k), dtype=torch.float64, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(seed))
    phi_noise = 10.0 ** rng.uniform(-16.0, -12.0, kn)
    phi_noise[n_noise - 1::n_noise] = 1e30
    return ((a.T @ a) * 1e14,) + tuple(
        torch.tensor(x, device="cuda") for x in (
            phi_noise, orf_matrix(pos, "hd"),
            10.0 ** rng.uniform(-22.0, -14.0, (g, m2))))


def phase_k11(crn):
    """K11 against its plain version on the card at the dense path's
    full width (4 points: the exported three and the grid's corner of
    least GW power, where phi^-1 is largest; 9 points: the grid's chunk,
    a 3 x 3 lattice over the grid's range) and at a small-P,
    many-point shape: S per point relative to its largest entry and
    logdet phi within ``tolerances.crn_capacity_limit`` of the blocks'
    kappa, bit-identical run to run; times beside the plain version, the
    library yardstick (batched cholesky_ex + cholesky_inverse on the
    (G m2, P, P) blocks) and the bound; the capacity Cholesky's time."""
    import torch

    from pint_tpu_torch import tolerances as tol
    from pint_tpu_torch.linalg import (K11, KronPhi, cho_factor,
                                       crn_capacity_cuda, crn_capacity_plain,
                                       kron_gw_blocks)

    dd = crn.dense
    la = torch.tensor([-13.7, -14.4, -13.9, -15.0], dtype=torch.float64,
                      device="cuda")
    ga = torch.tensor([13 / 3, 3.0, 5.5, 6.0], dtype=torch.float64,
                      device="cuda")
    la9, ga9 = (torch.tensor(x, dtype=torch.float64, device="cuda")
                for x in np.meshgrid(np.linspace(-15.0, -13.5, 3),
                                     np.linspace(2.0, 6.0, 3)))
    cases = {"path G4": (dd.gram, dd.phi_noise, dd.orf,
                         crn._phi_gw(la, ga)),
             "grid chunk G9": (dd.gram, dd.phi_noise, dd.orf,
                               crn._phi_gw(la9.ravel(), ga9.ravel())),
             "small P": k11_synthetic(12, 10, 25, 512)}
    out = {}
    for label, args in cases.items():
        gram, phi_noise, orf, phi_gw = args
        g, m2 = phi_gw.shape
        p, kn, k = orf.shape[0], phi_noise.shape[0], gram.shape[0]
        s1, l1, _ = crn_capacity_cuda(*args)
        s2, l2, _ = crn_capacity_cuda(*args)
        sp, lp = crn_capacity_plain(*args)
        torch.cuda.synchronize()
        same = _bits_equal((s1, l1), (s2, l2))
        del s2, l2
        err_s = [float(torch.max(torch.abs(s1[i] - sp[i]))
                       / torch.max(torch.abs(sp[i]))) for i in range(g)]
        err_ld = [float(torch.abs(l1[i] - lp[i])
                        / (k + torch.abs(lp[i]))) for i in range(g)]
        kappa = tol.crn_block_kappa(orf.cpu().numpy(),
                                    phi_gw.cpu().numpy())
        lim = tol.crn_capacity_limit(p, kappa)
        row = {"G": g, "K": k, "kn": kn, "P": p, "m2": m2,
               "run_to_run": same, "max_S_rel": max(err_s),
               "max_logdet_rel": max(err_ld), "limit": lim, "kappa": kappa,
               "max_abs_err": float(torch.max(torch.abs(s1 - sp)))}
        log(f"k11 {label}: " + json.dumps(row))
        if not (same and max(err_s) <= lim and max(err_ld) <= lim):
            raise AssertionError(f"K11 disagrees with its plain version at "
                                 f"{label}")
        del sp
        row["ms"], row["timed_by"] = kernel_ms(
            lambda: crn_capacity_cuda(*args), reps=20)
        row["plain_ms"] = queued_ms(lambda: crn_capacity_plain(*args),
                                    reps=3, warmup=1)
        blocks = kron_gw_blocks(KronPhi(orf=orf, phi_gw=phi_gw,
                                        phi_noise=None)).reshape(-1, p, p)
        # events only: the batched inverse is a loop of small kernels,
        # and the profiler's summary over them takes minutes
        row["library_ms"] = queued_ms(lambda: torch.cholesky_inverse(
            torch.linalg.cholesky_ex(blocks)[0]), reps=20)
        # G0 read once, S written once; the blocks' factor, inverse and
        # product, scalar fp64 in shared memory
        row["bound_ms"], row["bound_by"] = bound_ms(
            8 * ((1 + g) * k * k + kn + p * p + g * m2 + g),
            g * m2 * p**3, FP64_FLOPS)
        row["shared_bytes"] = K11.call("crn_capacity_smem", p)
        row["gw_blocks"] = g * m2
        if label == "grid chunk G9":
            # one point's, as the path factors them
            row["capacity_cholesky_ms"] = queued_ms(
                lambda: cho_factor(s1[0]), reps=10)
            row["capacity_cholesky_bound_ms"], row["capacity_cholesky_by"] = \
                bound_ms(8 * k * (k + 1), k**3 / 3, FP64_TC_FLOPS)
        del s1
        torch.cuda.empty_cache()
        out[label] = row
        log(f"k11 {label} times: " + json.dumps(row))
    rep = build_report(K11, ("crn_gw_block_kernel", "crn_copy_kernelILb1ELb0",
                             "crn_copy_kernelILb1ELb1",
                             "crn_copy_kernelILb0ELb0",
                             "crn_copy_kernelILb0ELb1", "crn_logdet_kernel"))
    log("k11 ptxas: " + json.dumps(rep))
    out.update(rep)
    return out


def _bits_checksum(*ts):
    """An exact checksum of the tensors' bits: the int64 sum of each
    element's bits times its position, wrapping (the same in any
    order)."""
    import torch

    out = 0
    for t in ts:
        v = t.contiguous().view(torch.int64).flatten()
        w = torch.arange(1, v.numel() + 1, dtype=torch.int64,
                         device=v.device)
        out = (out * 1000003 + int((v * w).sum())) % 2**64
    return out


def k11_k7_times():
    """K11 and K7 at their paths' shapes under ``queued_ms``, for
    ``tools/torch_turns.py``: K11 at the dense grid's chunk of 9 points
    and at 4 points of a full-width synthetic array (K = 6188: 68
    pulsars, 63 noise columns each, m2 = 28) and at P = 12, G = 512;
    K7 at the WLS fit's N = 10^4, P = 11 and at the WLS grid's 256 x
    10^4 x 8.  Each beside an exact checksum of its outputs' bits, so
    that two checkouts' outputs can be compared."""
    import torch

    from pint_tpu_torch import linalg as tl

    out = {}
    for label, args in (("k11 G9", lambda: k11_synthetic(68, 28, 63, 9)),
                        ("k11 G4", lambda: k11_synthetic(68, 28, 63, 4)),
                        ("k11 P12 G512",
                         lambda: k11_synthetic(12, 10, 25, 512))):
        args = args()
        # (S, logdet) first; a checkout before K11b returned no more
        s, ld = tl.crn_capacity_cuda(*args)[:2]
        out[label] = {"checksum": _bits_checksum(s, ld)}
        del s, ld
        out[label]["ms"] = queued_ms(lambda: tl.crn_capacity_cuda(*args),
                                     reps=20)
        del args
        torch.cuda.empty_cache()
    rng = np.random.default_rng(7)
    for label, (g, n, p) in (("k7 fit", (1, 10_000, 11)),
                             ("k7 grid", (256, 10_000, 8))):
        lead = (g,) if g > 1 else ()
        args = (torch.tensor(rng.standard_normal(lead + (n,)) * 1e-6,
                             device="cuda"),
                torch.tensor(rng.standard_normal(lead + (n, p))
                             * 10.0 ** rng.uniform(-8, 8, p), device="cuda"),
                torch.tensor(rng.uniform(0.5, 2.0, n) * 1e-6, device="cuda"))
        out[label] = {"checksum": _bits_checksum(*tl.wls_whiten_cuda(*args)),
                      "ms": queued_ms(partial(tl.wls_whiten_cuda, *args))}
    return out


def fit_checksums():
    """Exact checksums of the fit phase's numbers on the card, for
    ``tools/torch_turns.py``: the 10k case's prefit time residuals, and
    after ``GLSFitter.fit_toas(maxiter=3)`` its fitted values and
    postfit residuals, so that two checkouts' fits can be compared bit
    for bit."""
    import copy

    import torch

    from pint_tpu_torch.convert import load_case
    from pint_tpu_torch.fitter import GLSFitter
    from pint_tpu_torch.residuals import Residuals

    _, model, toas, tzr = load_case()
    r = Residuals(toas, copy.deepcopy(model), tzr, device="cuda")
    out = {"prefit": _bits_checksum(r.time_resids_at(
        r.prepared.values_dict()))}
    f = GLSFitter(toas, model, tzr, device="cuda")
    f.fit_toas(maxiter=3)
    out["values"] = _bits_checksum(torch.tensor(
        [model.values[k] for k in model.free_params], dtype=torch.float64))
    out["postfit"] = _bits_checksum(f.resids.time_resids_at(
        f.prepared.values_dict()))
    return out


def k11b_synthetic(p, m2, n_noise, g, seed=12):
    """K11b's inputs (gS, gld, phi_noise (G, kn), phi_gw, M) on the
    card: :func:`k11_synthetic`'s prior with each point's own noise
    weights (the shared row times 10^u, u uniform in [-1, 1]), the GW
    blocks' inverses M from K11, and seeded normal cotangents."""
    import torch

    from pint_tpu_torch import linalg as tl

    gram, pn, orf, pg = k11_synthetic(p, m2, max(n_noise, 1), g, seed)
    if n_noise == 0:  # no noise columns: the GW sector alone
        k = p * m2
        gram, pn = gram[-k:, -k:].contiguous(), pn[:0]
    gen = torch.Generator("cuda").manual_seed(seed)
    f64 = dict(dtype=torch.float64, device="cuda")
    pn = pn[None, :] * 10.0 ** (2.0 * torch.rand(
        (g, pn.numel()), generator=gen, **f64) - 1.0)
    _, _, M = tl.crn_capacity_cuda(gram, pn, orf, pg)
    k = gram.shape[0]
    return (torch.randn((g, k, k), generator=gen, **f64),
            torch.randn(g, generator=gen, **f64), pn, pg, M)


def k11b_compare(args):
    """K11b twice against its plain version on the same card tensors:
    run-to-run bit identity, the largest error over each entry's limit
    (``tolerances.crn_capacity_bwd_limit`` of its sum of |terms|), the
    largest absolute error, and whether the noise cotangents are
    bit-identical."""
    import torch

    from pint_tpu_torch import linalg as tl
    from pint_tpu_torch import tolerances as tol

    gS, gld, pn, pg, M = args
    a = tl.crn_capacity_bwd_cuda(*args)
    b = tl.crn_capacity_bwd_cuda(*args)
    plain = tl.crn_capacity_bwd_plain(*args)
    abs_sum = tl.crn_capacity_bwd_plain(-gS.abs(), gld.abs(), pn, pg,
                                        M.abs())
    lim = tol.crn_capacity_bwd_limit(M.shape[-1])

    def worst(x, y, s):  # 0 / 0 (no terms, no error) counts as 0
        if not x.numel():
            return 0.0
        return float(torch.max(torch.nan_to_num(
            torch.abs(x - y) / (lim * s), nan=0.0)))
    over = max(worst(x, y, s) for x, y, s in zip(a, plain, abs_sum))
    torch.cuda.synchronize()
    return {"run_to_run": _bits_equal(a, b), "err_over_limit": over,
            "limit_per_abs_sum": lim,
            "max_abs_err": max(float(torch.max(torch.abs(x - y)))
                               if x.numel() else 0.0
                               for x, y in zip(a, plain)),
            "noise_bit_identical": _bits_equal(a[:1], plain[:1])}


def _k11b_path_inputs(post, theta):
    """K11b's inputs as the dense posterior's gradient at ``theta`` gives
    them (the launcher's arguments, recorded on the way)."""
    from pint_tpu_torch import linalg as tl

    got = []
    real = tl.crn_capacity_bwd_cuda

    def spy(*args):
        got.append(args)
        return real(*args)
    tl.crn_capacity_bwd_cuda = spy
    try:
        post.value_and_grad(theta)
    finally:
        tl.crn_capacity_bwd_cuda = real
    return tuple(t.detach() for t in got[-1])


def phase_hmc_dense(pairs, kron_post, ref, dref):
    """The dense GWB posterior on the 68-pulsar case (``GWBPosterior(
    CommonProcess(pairs, nmodes=14, kron=False))``, K = 6188, 138
    dimensions): lnprob and its gradient at the HMC case's 8 theta
    against JAX's kron values and the card's own kron posterior, at the
    dense file's 2 theta against JAX's dense values, -inf outside the
    prior, the injected-draw run against JAX's; K11 and K11b run, K3 and
    K5 do not; the wall of one gradient at 4 chains and where its device
    time goes."""
    import torch

    from pint_tpu_torch import tolerances as tol
    from pint_tpu_torch.fixedpoint import K1
    from pint_tpu_torch.gw.common import CommonProcess
    from pint_tpu_torch.gw.hmc import GWBPosterior, run_nuts
    from pint_tpu_torch.linalg import K3, K5, K5B, K11, K11B

    kernels = {"K1": K1, "K3": K3, "K5": K5, "K5b": K5B, "K11": K11,
               "K11b": K11B}
    kw = {k: int(ref[f"run_{k}"]) for k in (
        "n_chains", "num_warmup", "num_samples", "chunk", "num_leapfrog",
        "seed")}
    th = torch.as_tensor(ref["theta"], device="cuda")
    thd = torch.as_tensor(dref["theta"], device="cuda")
    # the main path: counts reset just before, read just after
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    post = GWBPosterior(CommonProcess(pairs, nmodes=int(ref["nmodes"]),
                                      kron=False, device="cuda"))
    torch.cuda.synchronize()
    t_build = time.time() - t0
    lnp, g = (a.cpu().numpy() for a in post.value_and_grad(th))
    lnp_d, g_d = (a.cpu().numpy() for a in post.value_and_grad(thd))
    t0 = time.time()
    res = run_nuts(post, draws=(ref["draw_z"], ref["draw_n_steps"],
                                ref["draw_u"]), **kw)
    t_run = time.time() - t0
    launches = {n: k.launches for n, k in kernels.items()}
    log(f"hmc dense: launches during the path {launches} (K "
        f"{post.crn.dense.gram.shape[0]}, ndim {post.ndim}; 8 + 2 theta, "
        f"then {kw})")
    if post.param_names != [str(n) for n in ref["param_names"]] \
            or not np.array_equal(post.bounds, ref["bounds"]) \
            or not np.array_equal(post.scales, ref["scales"]):
        raise AssertionError("hmc dense: layout, bounds or scales differ "
                             "from JAX")
    fin = np.isfinite(ref["lnprob"])
    lk, gk = (a.cpu().numpy() for a in kron_post.value_and_grad(th))

    def rel(lnp_got, g_got, lnp_ref, g_ref):
        return (float(np.max(np.abs(lnp_got / lnp_ref - 1))),
                max(float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
                    for a, b in zip(g_got, g_ref)))
    errs = {}
    errs["lnp_vs_jax_kron"], errs["grad_vs_jax_kron"] = rel(
        lnp[fin], g[fin], ref["lnprob"][fin], ref["grad"][fin])
    errs["lnp_vs_card_kron"], errs["grad_vs_card_kron"] = rel(
        lnp[fin], g[fin], lk[fin], gk[fin])
    errs["lnp_vs_jax_dense"], errs["grad_vs_jax_dense"] = rel(
        lnp_d, g_d, dref["dense_lnprob"], dref["dense_grad"])
    oob = bool(np.any(~fin)) and bool(np.all(lnp[~fin] == -np.inf))
    sc = post.scales
    run = {
        "samples_scales": float(np.max(np.abs(
            (res.samples - ref["run_samples"]) / sc))),
        "warmup_scales": float(np.max(np.abs(
            (res.warmup_samples - ref["run_warmup_samples"]) / sc))),
        "lnp_rel": float(np.max(np.abs(res.lnprob / ref["run_lnprob"]
                                       - 1))),
        "step_size_rel": float(np.max(np.abs(
            res.step_size / ref["run_step_size"] - 1)))}
    same = bool(np.array_equal(res.accepted, ref["run_accepted"]))
    log("hmc dense: observed " + json.dumps(errs) + f" (limits lnp "
        f"{tol.GW_LNLIKE_REL:g}, gradient {tol.HMC_GRAD_REL:g} of max|g|; "
        f"JAX's own kron-vs-dense gradient {dref['grad_rel'].tolist()}); "
        f"outside the prior -inf {oob}; lnprob {lnp.tolist()}")
    log(f"hmc dense: injected-draw run: largest deviations "
        + json.dumps(run) + f" (limits {tol.HMC_PATH_SCALES:g} in scales, "
        f"{tol.HMC_LNP_REL:g} rel); accept decisions identical to JAX's "
        f"{same} ({res.accepted.astype(int).tolist()}); run {t_run:.2f} s, "
        f"build {t_build:.2f} s")
    bad = [k for k, v in errs.items() if not v <= (
        tol.GW_LNLIKE_REL if k.startswith("lnp") else tol.HMC_GRAD_REL)]
    bad += [k for k, v in run.items() if not v <= (
        tol.HMC_PATH_SCALES if k.endswith("scales") else tol.HMC_LNP_REL)]
    if bad or not (oob and same):
        raise AssertionError(f"hmc dense fails: {bad}, oob {oob}, accept "
                             f"decisions {same}")
    if not (launches["K11"] > 0 and launches["K11b"] > 0
            and launches["K3"] == launches["K5"] == launches["K5b"] == 0):
        raise AssertionError(f"hmc dense: the path's kernels {launches}")
    # one gradient at 4 chains, warm: its wall, peak memory and device
    # time by group
    th4 = th[:4]

    def grad4():
        post.value_and_grad(th4)
        torch.cuda.synchronize()
    grad4()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.time()
    for _ in range(3):
        grad4()
    wall = (time.time() - t0) / 3
    peak = torch.cuda.max_memory_allocated()
    busy, dev_ms, shares = trace_breakdown(grad4, wall, "hmc_dense_grad", {
        "K11": ["crn_gw_block", "crn_copy", "crn_logdet"],
        "K11b": ["crn_capacity_bwd"],
        "cuSOLVER potrf": ["potrf", "syrk", "getrf_wo_pivot"],
        "triangular solves (trsm, trsv)": ["trsm", "trsv"],
        "gemm (the Cholesky backward's products)": ["gemm"],
        "ATen elementwise and copies": ["at::native"]})
    rates = {"grad_4_chains_wall_s": wall, "device_ms": dev_ms,
             "busy": busy, "shares": shares,
             "peak_gib": peak / 2**30, "held_before_gib": base / 2**30,
             "build_s": t_build, "run_s": t_run}
    log("hmc dense: one gradient at 4 chains " + json.dumps(rates))
    return {"launches": launches, "post": post, "errs": errs, "run": run,
            "rates": rates}


def phase_k11b(post, ref):
    """K11b against its plain version on the card at the dense
    posterior's own inputs (4 and 8 chains of the HMC case, K = 6188) and
    at P = 12, G = 512: within ``tolerances.crn_capacity_bwd_limit`` of
    each entry's sum of |terms|, bit-identical run to run; its time
    beside the plain version and the bound.  K11 with per-point noise
    weights (the posterior's 4 chains) against its plain version, and
    with every point's row equal, bit-identical to K11 with the one
    shared row."""
    import torch

    from pint_tpu_torch import linalg as tl
    from pint_tpu_torch import tolerances as tol
    from pint_tpu_torch.models.noise import gwb_phi

    th = torch.as_tensor(ref["theta"], device="cuda")
    cases = {"posterior G4": lambda: _k11b_path_inputs(post, th[:4]),
             "posterior G8": lambda: _k11b_path_inputs(post, th),
             "small P G512": lambda: k11b_synthetic(12, 10, 25, 512)}
    out = {}
    for label, make in cases.items():
        args = make()
        gS, gld, pn, pg, M = args
        g, m2 = pg.shape
        p, k = M.shape[-1], gS.shape[-1]
        kn = k - p * m2
        row = {"G": g, "K": k, "kn": kn, "P": p, "m2": m2,
               **k11b_compare(args)}
        log(f"k11b {label}: " + json.dumps(row))
        if not (row["run_to_run"] and row["err_over_limit"] <= 1.0):
            raise AssertionError(f"K11b disagrees with its plain version "
                                 f"at {label}")
        row["ms"], row["timed_by"] = kernel_ms(
            lambda: tl.crn_capacity_bwd_cuda(*args), reps=50)
        row["plain_ms"] = queued_ms(
            lambda: tl.crn_capacity_bwd_plain(*args), reps=10)
        # no PyTorch call computes the weights' cotangents from gS
        row["library_ms"] = None
        # gS's kn diagonal and m2 P^2 block entries, M's m2 P^2 entries,
        # the weights and gld read once, the cotangents written once; a
        # product and a sum a block entry (M symmetrized: two more),
        # ~10 operations a noise entry, scalar fp64
        row["bound_ms"], row["bound_by"] = bound_ms(
            8 * g * (kn + 2 * m2 * p * p + kn + m2 + 1 + kn + m2),
            g * (4 * m2 * p * p + 2 * m2 + 10 * kn), FP64_FLOPS)
        out[label] = row
        log(f"k11b {label} times: " + json.dumps(row))
        del args, gS, M
        torch.cuda.empty_cache()
    # K11 with a row of noise weights a point: the posterior's 4 chains
    dd = post.crn.dense
    th4 = torch.clamp(th[:4], post._lo, post._hi)
    pn = post.crn.dense_noise(post.phi_noise_at(th4))
    pg = gwb_phi(post.crn.freqs, 10.0 ** th4[:, 0:1], th4[:, 1:2],
                 post.crn.df)
    s1, l1, _ = tl.crn_capacity_cuda(dd.gram, pn, dd.orf, pg)
    s2, l2, _ = tl.crn_capacity_cuda(dd.gram, pn, dd.orf, pg)
    same = _bits_equal((s1, l1), (s2, l2))
    del s2, l2
    sp, lp = tl.crn_capacity_plain(dd.gram, pn, dd.orf, pg)
    err_s = max(float(torch.max(torch.abs(s1[i] - sp[i]))
                      / torch.max(torch.abs(sp[i]))) for i in range(4))
    err_ld = max(float(torch.abs(l1[i] - lp[i])
                       / (sp.shape[-1] + torch.abs(lp[i])))
                 for i in range(4))
    del sp, lp
    lim = tol.crn_capacity_limit(dd.orf.shape[0], tol.crn_block_kappa(
        dd.orf.cpu().numpy(), pg.cpu().numpy()))
    # every point's row equal: the same bits as the one shared row
    s3, l3, _ = tl.crn_capacity_cuda(
        dd.gram, pn[0].expand(4, -1).contiguous(), dd.orf, pg)
    s4, l4, _ = tl.crn_capacity_cuda(dd.gram, pn[0], dd.orf, pg)
    stride_same = _bits_equal((s3, l3), (s4, l4))
    del s1, s3, s4
    torch.cuda.empty_cache()
    row = {"run_to_run": same, "max_S_rel": err_s, "max_logdet_rel": err_ld,
           "limit": lim, "rows_equal_bits_as_shared_row": stride_same}
    log("k11 per-point noise weights G4: " + json.dumps(row))
    if not (same and stride_same and err_s <= lim and err_ld <= lim):
        raise AssertionError("K11 with per-point noise weights disagrees")
    out["k11 per point"] = row
    rep = build_report(tl.K11B, ("crn_capacity_bwd_kernel",))
    log("k11b ptxas: " + json.dumps(rep))
    out.update(rep)
    return out


#: (name, call(module, x, y)) for every function of pint_tpu_torch.dd on
#: two dd inputs
DD_CASES = [
    ("two_sum", lambda m, x, y: m.two_sum(x.hi, y.hi)),
    ("quick_two_sum", lambda m, x, y: m.quick_two_sum(x.hi, y.hi)),
    ("split", lambda m, x, y: m.split(x.hi)),
    ("two_prod", lambda m, x, y: m.two_prod(x.hi, y.hi)),
    ("two_prod_lo", lambda m, x, y: m.two_prod(x.lo, y.hi)),
    ("from_f64", lambda m, x, y: m.from_f64(x.hi)),
    ("from_sum", lambda m, x, y: m.from_sum(x.hi, y.lo)),
    ("normalize", lambda m, x, y: m.normalize(x.hi, y.hi)),
    ("to_f64", lambda m, x, y: m.to_f64(x)),
    ("add", lambda m, x, y: m.add(x, y)),
    ("add_f64", lambda m, x, y: m.add_f64(x, y.hi)),
    ("sub", lambda m, x, y: m.sub(x, y)),
    ("sub_f64", lambda m, x, y: m.sub_f64(x, y.hi)),
    ("mul", lambda m, x, y: m.mul(x, y)),
    ("mul_f64", lambda m, x, y: m.mul_f64(x, y.hi)),
    ("div", lambda m, x, y: m.div(x, y)),
    ("neg", lambda m, x, y: m.neg(x)),
    ("abs_", lambda m, x, y: m.abs_(x)),
    ("sqr", lambda m, x, y: m.sqr(y)),
    ("lt", lambda m, x, y: m.lt(x, y)),
    ("le", lambda m, x, y: m.le(x, y)),
    ("gt", lambda m, x, y: m.gt(x, y)),
    ("ge", lambda m, x, y: m.ge(x, y)),
    ("round_nearest", lambda m, x, y: m.round_nearest(x)),
    ("split_int_frac", lambda m, x, y: m.split_int_frac(x)),
    ("floor_", lambda m, x, y: m.floor_(x)),
    ("horner", lambda m, x, y: m.horner(m.mul_f64(y, 1e-3),
                                        [x, y, m.from_f64(0.25 * y.hi)])),
    ("taylor_horner", lambda m, x, y: m.taylor_horner(
        m.mul_f64(y, 1e3), [m.from_f64(0.0 * y.hi),
                            m.from_f64(218.81184 + 0.0 * y.hi),
                            m.from_f64(-4.083e-16 + 0.0 * y.hi),
                            m.from_f64(1e-26 + 0.0 * y.hi)])),
    ("operators", lambda m, x, y: ((x + y) * y - x / y, 2.0 - x, -x)),
]


def dd_inputs(n, seed, device):
    """Two dd tensors of ``n`` seeded longdoubles (mixed scales, with
    half-integer and integer edge cases) on ``device``."""
    from pint_tpu_torch import dd

    rng = np.random.default_rng(seed)

    def rand_ld(scale):
        a = rng.uniform(-1, 1, n).astype(np.longdouble) * np.longdouble(scale)
        return a + rng.uniform(-1, 1, n).astype(np.longdouble) \
            * np.longdouble(2.0) ** -40

    x, y = rand_ld(4e11), rand_ld(1e3)
    x[:6] = [123456789.5, -0.5, 0.5, 7.0, -3.0, 2.0**52]
    return (dd.from_longdouble(x, device), dd.from_longdouble(y, device))


def dd_mismatches(n=10**6, seed=15):
    """[names of DD_CASES whose outputs on CUDA tensors differ in any bit
    from the same calls on CPU tensors], at ``n`` seeded inputs."""
    import torch

    from pint_tpu_torch import dd

    xc, yc = dd_inputs(n, seed, "cpu")
    xg, yg = dd_inputs(n, seed, "cuda")

    def flat(out):
        if isinstance(out, (tuple, list)):
            return [t for o in out for t in flat(o)]
        return [out]

    bad = []
    for name, fn in DD_CASES:
        got = flat(fn(dd, xg, yg))
        ref = flat(fn(dd, xc, yc))
        for a, b in zip(got, ref):
            a = a.cpu()
            if a.dtype == torch.float64:
                a, b = a.view(torch.int64), b.view(torch.int64)
            if not torch.equal(a, b):
                bad.append(name)
                break
    return bad


def phase_dd():
    """Every dd function on 10^6 seeded CUDA inputs, bit-identical to the
    same calls on CPU tensors (an FMA contraction would change
    two_prod's error term); the time of add, mul and div on the card."""
    import torch

    from pint_tpu_torch import dd

    bad = dd_mismatches()
    log(f"dd: {len(DD_CASES)} calls on 10^6 CUDA inputs, bit-identical to "
        f"the CPU: {not bad} (differ: {bad})")
    if bad:
        raise AssertionError(f"dd on the card differs from the CPU in {bad}")
    x, y = dd_inputs(10**6, 16, "cuda")
    out = {}
    for name, fn, n_ops in (("add", dd.add, 20), ("mul", dd.mul, 24),
                            ("div", dd.div, 70)):
        ms, how = kernel_ms(lambda: fn(x, y))
        # four doubles in, two out; its separately rounded operations
        b, by = bound_ms(48 * 10**6, n_ops * 10**6)
        out[name] = {"ms": ms, "bound_ms": b, "bound_by": by,
                     "timed_by": how}
    log("dd times at 10^6 elements: " + json.dumps(out))
    return out


def phase_kron_append(ost):
    """``kron_gram_append``: 25 rows appended to one pulsar of the case
    against K3 over the extended stack, within ``KERNEL_SUM_REL`` of
    each entry's sum of |terms|; every other pulsar's blocks untouched;
    its time and bound."""
    import dataclasses

    import torch

    from pint_tpu_torch import tolerances as tol
    from pint_tpu_torch.linalg import (KronGram, _gram_split,
                                       kron_gram_append, kron_gram_cuda,
                                       kron_gram_plain, ragged_stack)

    data, pre = ost.data, ost.kron_data.gram
    a, n_new = len(data) // 2, 25
    rng = np.random.default_rng(25)
    d = data[a]
    nb, m2, nb_max = d.U.shape[1], d.F.shape[1], pre.g_uu.shape[-1]
    sig = rng.choice(d.sigma, n_new)
    new = (rng.standard_normal(n_new) * sig, sig,
           rng.standard_normal((n_new, nb)), rng.standard_normal((n_new, m2)))
    ext = [(x.r, x.sigma, x.U, x.F) if i != a else tuple(
        np.concatenate([o, q]) for o, q in zip((x.r, x.sigma, x.U, x.F), new))
        for i, x in enumerate(data)]
    st = ragged_stack(*(list(c) for c in zip(*ext)), "cuda")
    full = _gram_split(*kron_gram_cuda(st), st.nb_max)
    gabs, _ = kron_gram_plain(dataclasses.replace(st, t=st.t.abs()))
    ld_abs = torch.stack([torch.sum(torch.abs(torch.log(s**2)))
                          for s in torch.split(st.sigma, st.n_rows)])
    abs_gram = _gram_split(gabs, ld_abs, st.nb_max)
    u_rows = np.zeros((n_new, nb_max))
    u_rows[:, :nb] = new[2]
    rows = tuple(torch.tensor(x, device="cuda")
                 for x in (new[0], new[1], u_rows, new[3]))
    got = kron_gram_append(pre, a, len(d.r), *rows)
    torch.cuda.synchronize()
    ratio = {}
    others = [i for i in range(len(data)) if i != a]
    for name, g, f, s, p in zip(KronGram._fields, got, full, abs_gram, pre):
        ratio[name] = float(torch.max(torch.abs(g - f)
                                      / torch.clamp(s, min=1e-300)))
        if not torch.equal(g[others], p[others]):
            raise AssertionError(f"kron_gram_append changed another "
                                 f"pulsar's {name}")
    ms, how = kernel_ms(lambda: kron_gram_append(pre, a, len(d.r), *rows))
    # reads every block of the grams and the rows, writes the grams
    nbytes = 8 * (2 * sum(t.numel() for t in pre)
                  + sum(t.numel() for t in rows))
    w = nb_max + m2 + 1
    b, by = bound_ms(nbytes, n_new * w * (w + 1) + 4 * n_new)
    row = {"rows": n_new, "pulsar": a, "max_diff_over_sum_abs": ratio,
           "limit": tol.KERNEL_SUM_REL, "ms": ms, "timed_by": how,
           "bound_ms": b, "bound_by": by}
    log("kron append: " + json.dumps(row))
    if not all(v <= tol.KERNEL_SUM_REL for v in ratio.values()):
        raise AssertionError("kron_gram_append disagrees with K3 over the "
                             "extended stack")
    return row


#: device-time groups of a batched PTA fit (kernel names, lower case)
PTA_GROUPS = {"eigh": ["syev", "sytrd", "stedc", "ormtr", "orgtr"],
              "svd": ["gesvd", "gesdd", "svd"], "K1": ["phase_f0_t"],
              "K7": ["wls_whiten"], "gemm": ["gemm", "gemv"],
              "potrf": ["potrf", "potrs"], "ATen": ["at::native"]}
#: the reference's pins of a batched fit against per-pulsar fits of the
#: same members (tests/test_pta.py:221-263): F0 [Hz], chi^2 relative
PTA_SINGLE_F0_HZ = 5e-10
PTA_SINGLE_CHI2_REL = 1e-8


def pta_single_fit(kind, model, toas, tzr, device, maxiter=3):
    """One member's single-pulsar fit (``WLSFitter`` or ``GLSFitter``,
    written into ``model``): the fitter and its row (values, chi^2 at
    them -- white for WLS, as the batch's --, the condition of the last
    solve as ``fit_tolerances`` takes it).  The CPU tests call it too."""
    import torch

    from pint_tpu_torch import tolerances as tol
    from pint_tpu_torch.fitter import GLSFitter, WLSFitter

    f = (WLSFitter if kind == "wls" else GLSFitter)(toas, model, tzr,
                                                      device=device)
    chi2 = f.fit_toas(maxiter=maxiter)
    cond = f.fit_health["cond_log10"]
    if kind == "wls":
        cond = tol.wls_normal_cond_log10(cond)
        v = f.prepared.values_dict()
        chi2 = float(torch.sum((f.resids.time_resids_at(v)
                                / f.resids.sigma_at(v)) ** 2))
    return f, {"values": dict(model.values), "chi2": chi2,
               "cond_log10": cond}


def _pta_singles(pairs, kinds=("wls", "gls")):
    """The port's single-pulsar fits of every member on the card (each
    its own model, no superset): per kind the rows of
    :func:`pta_single_fit` and the walls of all the fits, cold (fitter
    builds and first fits) and warm (the same fitters from the same
    start)."""
    import copy

    import torch

    out = {}
    for kind in kinds:
        fitters, rows = [], []
        torch.cuda.synchronize()
        t0 = time.time()
        for model, toas, tzr in pairs:
            m = copy.deepcopy(model)
            start = dict(m.values)
            f, row = pta_single_fit(kind, m, toas, tzr, "cuda")
            fitters.append((f, m, start))
            rows.append(row)
        torch.cuda.synchronize()
        cold_s = time.time() - t0
        t0 = time.time()
        for f, m, start in fitters:
            m.values.update(start)
            f.fit_toas(maxiter=3)
        torch.cuda.synchronize()
        out[kind] = {"rows": rows, "cold_s": cold_s,
                     "warm_s": time.time() - t0}
    return out


def pta_fit_bound(b, kind, maxiter=3):
    """(least time [ms], what bounds it) of one batched fit's normal-
    equation work at the fp64 tensor-core peak: maxiter + 1 solves a
    member, each reading the design J (n x p), r and sigma once (and for
    GLS the basis U, n x nb, and forming M = [J | U], K = p + nb): WLS
    the whitening (rw, Jn written) and a thin SVD, 4 n p^2 + 22 p^3
    operations; GLS the weighted gram 2 n K^2, its eigendecomposition
    9 K^3 and the capacity Cholesky nb^3 / 3 with its gram 2 n nb^2.
    The fold and the design's build (elementwise, ~10^3 kernels a step)
    are left out, so this bounds the fit from below."""
    n, p = b.n_max, len(b.free_names)
    steps = (maxiter + 1) * b.n_pulsars
    if kind == "wls":
        nbytes = 8 * n * (2 * p + 3)
        flops = 4 * n * p * p + 22 * p ** 3
    else:
        nb = int(b._gather_noise()[0].shape[-1])
        k = p + nb
        nbytes = 8 * n * (k + 2)
        flops = 2 * n * k * k + 9 * k ** 3 + nb ** 3 / 3 + 2 * n * nb * nb
    return bound_ms(steps * nbytes, steps * flops, FP64_TC_FLOPS)


def _pta_against_singles(b, kind, vec, chi2, singles):
    """(worst |dF0| [Hz], worst chi^2 relative) of a batched fit against
    the single-pulsar fits of its members."""
    i_f0 = b.free_names.index("F0")
    rows = singles[kind]["rows"]
    return (max(abs(float(vec[k, i_f0]) - r["values"]["F0"])
                for k, r in enumerate(rows)),
            max(abs(float(chi2[k]) / r["chi2"] - 1.0)
                for k, r in enumerate(rows)))


#: the library calls of a batched fit that run one factorization a member
#: inside cuSOLVER (its batched Jacobi takes 32 rows at most): the SVD of
#: the whitened designs (WLS) and eigh of the normal matrices (GLS)
PTA_PER_MEMBER_OPS = ("aten::linalg_svd", "aten::_linalg_svd",
                      "aten::linalg_eigh", "aten::_linalg_eigh")


def trace_library_split(prof, label, ops):
    """(kernels, of them launched inside one of the CPU ops ``ops``,
    launched outside them) in ``prof``'s exported chrome trace: a kernel
    is matched to its launch call through CUPTI's correlation id, and
    the launch to the op spans by its host time stamp.  A kernel whose
    launch record is missing counts in neither part, so a lost window of
    records (PERF.md section 7) can only lower the parts."""
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, f"{label}_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X"]
    os.remove(path)
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events
             if e.get("cat") == "cpu_op" and e["name"] in ops]
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "spin_kernel" not in e["name"]]
    inside = outside = 0
    for e in kernels:
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        if any(lo <= t <= hi for lo, hi in spans):
            inside += 1
        else:
            outside += 1
    return len(kernels), inside, outside


def _pta_per_call(batches, kernels):
    """Per batched fit call, by (members, kind): the launches of each of
    the port's kernels (the first call), the ATen ops dispatched (a
    second, warm call) and, from the profiler's traces of two more, the
    kernels the card ran, how many of them cuSOLVER launched inside the
    per-member library calls (``PTA_PER_MEMBER_OPS``) and how many were
    launched outside them (the larger of the two traces' counts each:
    lost records only lower a count)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountOps(TorchDispatchMode):
        """Counts the ATen ops dispatched under it (after vmap's
        batching: a batched op is one call whatever its members)."""

        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    out = {}
    for b in batches:
        for kind in ("wls", "gls"):
            fit = getattr(b, f"fit_{kind}")
            before = {n: k.launches for n, k in kernels.items()}
            fit(maxiter=3)
            row = {n: k.launches - before[n] for n, k in kernels.items()}
            torch.cuda.synchronize()
            with CountOps() as mode:
                fit(maxiter=3)
            torch.cuda.synchronize()
            row["aten_ops"] = mode.n
            traced = []
            for _ in range(2):
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    fit(maxiter=3)
                    torch.cuda.synchronize()
                traced.append(trace_library_split(
                    prof, f"pta_{b.n_pulsars}_{kind}", PTA_PER_MEMBER_OPS))
            (row["kernels"], row["library_kernels"],
             row["other_kernels"]) = (max(c) for c in zip(*traced))
            out[f"{b.n_pulsars} {kind}"] = row
    return out


def phase_pta_batch(arrays, pairs):
    """The PTA batch on the card: ``PTABatch`` over the heterogeneous
    68 x 500 array of ``pta68_500_batch.npz`` (isolated and DD members
    alternating), its ``residuals``, ``residuals_shared``, ``chisq`` and
    ``fit_wls(3)``/``fit_gls(3)`` held to JAX's answers (residuals
    1e-11 s; chi^2 at fixed values ``tolerances.pta_chi2_limit``; values,
    sigma of the free entries within ``fit_tolerances`` of each member's
    condition, the values less one ulp (``values_sigma_ulp``), the fitted
    chi^2 within its conditioning part plus
    ``pta_chi2_limit``), and member by member to the port's own
    single-pulsar fitters on the card (F0 within 5e-10 Hz, chi^2 within
    1e-8 relative); the isolated members' placeholder PB, A1, T0, ECC, OM
    unmoved; launches of K1, K2, K7, K8 on the path (K1, K7 > 0, K2 = K8
    = 0); per batched fit call at 68 and at the first 8 members, those
    launches and the ATen ops dispatched (equal) and the profiler's
    kernels outside cuSOLVER's per-member SVD and eigh (fewer than 68 - 8
    more at 68: nothing else runs once per member); cold and warm walls
    of each fit kind, pulsar fits/s, the walls of the 68 single-pulsar
    fits, busy share, device time by group and peak memory of one warm
    fit of each kind."""
    import torch

    from pint_tpu_torch import tolerances as tol
    from pint_tpu_torch.fixedpoint import K1
    from pint_tpu_torch.linalg import K2, K7, K8
    from pint_tpu_torch.parallel import PTABatch

    kernels = {"K1": K1, "K2": K2, "K7": K7, "K8": K8}
    singles = _pta_singles(pairs)
    # the main path: counts reset just before, read just after
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    b = PTABatch(pairs, device="cuda")
    resid = b.residuals().cpu().numpy()
    shared = b.residuals_shared()
    chisq = b.chisq()
    torch.cuda.synchronize()
    eval_s = time.time() - t0
    fits = {}
    for kind in ("wls", "gls"):
        t0 = time.time()
        vec, chi2, cov = getattr(b, f"fit_{kind}")(maxiter=3)
        torch.cuda.synchronize()
        fits[kind] = {"vec": vec.cpu().numpy(), "chi2": chi2.cpu().numpy(),
                      "cov": cov.cpu().numpy(), "cold_s": time.time() - t0}
    launches = {n: k.launches for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()

    names = [str(n) for n in arrays["ref_free_names"]]
    valid = b.valid.cpu().numpy()
    sigma, cinv_r = b._sigma_cinv_r("wls")
    errs = {"free_names_equal": b.free_names == names,
            "residuals_s": float(np.max(np.abs(resid
                                               - arrays["ref_residuals"]))),
            "residuals_shared_equal": bool(np.array_equal(shared, resid)),
            "chisq_over_limit": float(np.max(
                np.abs(chisq - arrays["ref_chisq"])
                / tol.pta_chi2_limit(cinv_r, sigma, valid))),
            "chisq_rel": float(np.max(np.abs(chisq / arrays["ref_chisq"]
                                             - 1.0)))}
    mask = b.free_mask.cpu().numpy() > 0
    for kind, fit in fits.items():
        ref_vec = arrays[f"ref_{kind}_values"]
        ref_chi2 = arrays[f"ref_{kind}_chi2"]
        ref_cov = arrays[f"ref_{kind}_cov"]
        resid_lim = tol.pta_chi2_limit(
            b._sigma_cinv_r(kind, fit["vec"])[1], sigma, valid)
        worst = {"values_sigma": 0.0, "unc_rel": 0.0, "chi2_abs": 0.0}
        for k in range(len(pairs)):
            lim = tol.fit_tolerances(singles[kind]["rows"][k]["cond_log10"])
            lim["chi2_abs"] = lim.pop("chi2_rel") * abs(ref_chi2[k]) \
                + resid_lim[k]
            f = mask[k]
            jsig = np.sqrt(np.diag(ref_cov[k]))[f]
            sig = np.sqrt(np.diag(fit["cov"][k]))[f]
            got = {"values_sigma": tol.values_sigma_ulp(
                       fit["vec"][k][f], ref_vec[k][f], jsig),
                   "unc_rel": float(np.max(np.abs(sig / jsig - 1.0))),
                   "chi2_abs": float(abs(fit["chi2"][k] - ref_chi2[k]))}
            for n in worst:
                worst[n] = max(worst[n], got[n] / lim[n])
        errs[f"{kind}_over_limit"] = worst
        errs[f"{kind}_chi2_rel"] = float(np.max(np.abs(
            fit["chi2"] / ref_chi2 - 1.0)))
        d_f0, d_chi2 = _pta_against_singles(b, kind, fit["vec"], fit["chi2"],
                                            singles)
        errs[f"{kind}_single_f0_hz"] = d_f0
        errs[f"{kind}_single_chi2_rel"] = d_chi2
        errs[f"{kind}_ref_rung"] = str(arrays[f"ref_{kind}_rung"])
    iso = [k for k, p in enumerate(b.prepareds)
           if "BinaryDD" in p.model._superset_inert]
    errs["placeholders_moved"] = [
        (k, p) for k in iso for p, v in (("PB", 365.25), ("T0", 0.0),
                                         ("A1", 0.0), ("ECC", 0.0),
                                         ("OM", 0.0))
        if b.prepareds[k].model.values[p] != v]
    per_call = _pta_per_call([b, PTABatch(pairs[:8], device="cuda")],
                             kernels)

    out = {"launches": launches, "per_call": per_call, "eval_cold_s": eval_s,
           "peak_gib": peak / 2**30, "isolated_members": len(iso)}
    for kind in ("wls", "gls"):
        def warm(kind=kind):
            getattr(b, f"fit_{kind}")(maxiter=3)
            torch.cuda.synchronize()

        t0 = time.time()
        for _ in range(3):
            warm()
        warm_s = (time.time() - t0) / 3
        torch.cuda.reset_peak_memory_stats()
        busy, dev_ms, shares = trace_breakdown(warm, warm_s,
                                               f"pta_batch_{kind}",
                                               PTA_GROUPS)
        bound, bound_by = pta_fit_bound(b, kind)
        out[kind] = {"cold_s": fits[kind]["cold_s"], "warm_s": warm_s,
                     "fits_per_s": len(pairs) / warm_s, "busy": busy,
                     "device_ms": dev_ms, "bound_ms": bound,
                     "bound_by": bound_by, "shares": shares,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "singles_cold_s": singles[kind]["cold_s"],
                     "singles_warm_s": singles[kind]["warm_s"]}
    log("pta batch: " + json.dumps(out) + "; observed " + json.dumps(errs))
    bad = [n for n in ("free_names_equal", "residuals_shared_equal")
           if not errs[n]]
    bad += [n for n, lim in (("residuals_s", tol.PREFIT_S),
                             ("chisq_over_limit", 1.0))
            if not errs[n] <= lim]
    for kind in ("wls", "gls"):
        bad += [f"{kind} {n}" for n, v in errs[f"{kind}_over_limit"].items()
                if not v <= 1.0]
        if not errs[f"{kind}_single_f0_hz"] <= PTA_SINGLE_F0_HZ \
                or not errs[f"{kind}_single_chi2_rel"] <= PTA_SINGLE_CHI2_REL:
            bad.append(f"{kind} against the single-pulsar fits")
        if errs[f"{kind}_ref_rung"] != "baseline":
            bad.append(f"{kind} reference rung")
    if errs["placeholders_moved"] or not iso:
        bad.append("placeholders")
    if bad:
        raise AssertionError(f"pta batch disagrees on {bad}")
    if not (launches["K1"] > 0 and launches["K7"] > 0
            and launches["K2"] == launches["K8"] == 0):
        raise AssertionError(f"pta batch: K1 and K7 must run, K2 and K8 "
                             f"must not: {launches}")
    # the port's own launches and ATen ops per call are exact counts; the
    # profiler's count of kernels outside the library's per-member calls
    # is not (lost records lower it, cuBLAS picks its kernels by batch
    # size), but one launch a member would add 68 - 8 of them
    for kind in ("wls", "gls"):
        a, c = per_call[f"{len(pairs)} {kind}"], per_call[f"8 {kind}"]
        exact = [n for n in (*kernels, "aten_ops") if a[n] != c[n]]
        if exact or a["other_kernels"] - c["other_kernels"] >= len(pairs) - 8:
            raise AssertionError(f"pta batch {kind}: the calls outside the "
                                 "library's per-member solves depend on the "
                                 f"number of pulsars: {per_call}")
    return out


def phase_pta_homogeneous(pairs):
    """``PTABatch.fit_gls(3)`` over the GW array's 68 homogeneous pulsars
    (``load_pta_case()``: no superset, nb = 61), member by member against
    the port's ``GLSFitter`` on the card (F0 within 5e-10 Hz, chi^2
    within 1e-8 relative); launches per call (K1 > 0, K2 = K8 = 0);
    cold and warm walls beside the 68 single fits'."""
    import torch

    from pint_tpu_torch.fixedpoint import K1
    from pint_tpu_torch.linalg import K2, K7, K8
    from pint_tpu_torch.parallel import PTABatch

    kernels = {"K1": K1, "K2": K2, "K7": K7, "K8": K8}
    singles = _pta_singles(pairs, kinds=("gls",))
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    b = PTABatch(pairs, device="cuda")
    vec, chi2, _ = b.fit_gls(maxiter=3)
    torch.cuda.synchronize()
    cold_s = time.time() - t0
    launches = {n: k.launches for n, k in kernels.items()}
    t0 = time.time()
    for _ in range(3):
        b.fit_gls(maxiter=3)
    torch.cuda.synchronize()
    warm_s = (time.time() - t0) / 3
    d_f0, d_chi2 = _pta_against_singles(b, "gls", vec.cpu().numpy(),
                                        chi2.cpu().numpy(), singles)
    U, _ = b._gather_noise()
    out = {"superset": any(hasattr(p.model, "_superset_inert")
                           for p in b.prepareds),
           "nb": int(U.shape[-1]), "launches": launches, "cold_s": cold_s,
           "warm_s": warm_s, "fits_per_s": len(pairs) / warm_s,
           "singles_cold_s": singles["gls"]["cold_s"],
           "singles_warm_s": singles["gls"]["warm_s"],
           "single_f0_hz": d_f0, "single_chi2_rel": d_chi2}
    log("pta homogeneous: " + json.dumps(out))
    if out["superset"] or out["nb"] != 61:
        raise AssertionError("pta homogeneous: a superset or another basis "
                             "width")
    if not (d_f0 <= PTA_SINGLE_F0_HZ and d_chi2 <= PTA_SINGLE_CHI2_REL):
        raise AssertionError("pta homogeneous disagrees with the "
                             "single-pulsar GLS fits")
    if not (launches["K1"] > 0 and launches["K2"] == launches["K8"] == 0):
        raise AssertionError(f"pta homogeneous launches {launches}")
    return out


def gw_row(name, source, replaces, launches, m):
    return {"name": name, "route": "cuda",
            "source": f"pint_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": launches, "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"]}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    try:
        from pint_tpu_torch.convert import (load_case, load_hmc_reference,
                                            load_pta_case)
    except ImportError as e:
        print(f"chip_smoke: cannot import pint_tpu_torch ({e}); run from "
              "the repo root", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    failures = []

    def run(name, fn, *args):
        t0 = time.time()
        try:
            return fn(*args)
        except Exception:  # a failed phase is reported, the rest still run
            failures.append(name)
            log(f"PHASE FAILED: {name}\n{traceback.format_exc()}")
            return None
        finally:
            log(f"phase {name}: {time.time() - t0:.1f} s")

    card = run("card", phase_card)
    run("build", phase_build)
    k1_err = run("k1", phase_k1)
    arrays, model, toas, tzr = load_case()
    got = run("fit", phase_fit, arrays, model, toas, tzr)
    table = None
    if got is not None:
        launches, f, start_values = got
        k2_err = run("k2", phase_k2, f.resids._U_ext)
        if k1_err is not None and k2_err is not None:
            table = run("kernel table", phase_kernel_table, f, launches,
                        k1_err, k2_err)
        run("torch rows", phase_torch_rows, f, start_values)
    ingest = run("ingest", phase_ingest)
    k7 = fits = None
    if ingest is not None:
        fits = run("fit_par_tim", phase_fit_par_tim, *ingest[:3])
        if fits is not None:
            k7 = run("k7", phase_k7, fits["wls"]["fitter"])
    from pint_tpu_torch.convert import PN_ANSWERS, load_arrays

    run("pulse numbers", phase_pulse_numbers, load_arrays(PN_ANSWERS))
    if table is not None and k7 is not None:
        table.append(gw_row("wls_whiten", "wls_whiten.cu",
                            "pint_tpu/fitter.py:152",
                            fits["wls"]["launches"]["K7"], k7))
    else:
        table = None
    k8 = None
    if ingest is not None:
        from pint_tpu_torch.convert import (B1855_GRID_ANSWERS,
                                            B1855_WHITE_PAR)
        from pint_tpu_torch.models.builder import get_model

        model_pt, toas_pt = ingest[:2]
        white = get_model(str(B1855_WHITE_PAR))
        gref = load_arrays(B1855_GRID_ANSWERS)
        g_gls = run("grid gls", phase_grid, "gls", model_pt, toas_pt, gref)
        g_wls = run("grid wls", phase_grid, "wls", white, toas_pt, gref)
        if g_gls is not None:
            k8 = run("k8", phase_k8, g_gls)
            run("grid kernels", phase_grid_kernels, g_gls)
        run("downhill", phase_downhill, model_pt, white, toas_pt, gref)
    if table is not None and k8 is not None:
        table.append(gw_row("woodbury_chi2_pre", "woodbury_pre.cu",
                            "pint_tpu/linalg.py:381",
                            g_gls["launches"]["K8"], k8["grid"]))
    else:
        table = None
    k9 = mc_gls = None
    if ingest is not None:
        from pint_tpu_torch.convert import B1855_MCMC_ANSWERS

        mref = load_arrays(B1855_MCMC_ANSWERS)
        mc_gls = run("mcmc gls", phase_mcmc, "gls", model_pt, toas_pt, mref)
        run("mcmc wls", phase_mcmc, "wls", white, toas_pt, mref)
        if mc_gls is not None:
            k9 = run("k9", phase_k9, mc_gls)
    run("mcmc autocorr", phase_mcmc_autocorr)
    if table is not None and k9 is not None:
        table.append(gw_row("stretch_move", "stretch_move.cu",
                            "pint_tpu/sampler.py:207",
                            mc_gls["launches"]["K9"], k9["path"]))
    else:
        table = None
    k10 = st_gls = None
    if ingest is not None:
        from pint_tpu_torch.convert import B1855_STREAM_ANSWERS

        sref = load_arrays(B1855_STREAM_ANSWERS)
        nights = stream_nights(sref)
        st_gls = run("stream gls", phase_stream, "gls", model_pt, toas_pt,
                     nights, sref)
        st_wls = run("stream wls", phase_stream, "wls", white, toas_pt,
                     nights, sref)
        if st_gls is not None and st_wls is not None:
            k10 = run("k10", phase_k10, st_gls, st_wls)
    if table is not None and k10 is not None:
        n = st_gls["capture_launches"]["K10"] + sum(
            r["launches"]["K10"] for r in st_gls["nights"])
        table.append(gw_row("stream_moments", "stream_moments.cu",
                            "pint_tpu/linalg.py:838", n, k10["fold gls"]))
    else:
        table = None
    pta_arrays, pairs = load_pta_case()
    gw = run("gw path", phase_gw, pta_arrays, pairs)
    if gw is not None:
        k3 = run("k3", phase_k3, gw["ost"].kron_data.stack)
        k4 = run("k4", phase_k4, gw["ost"])
        if table is not None and k3 is not None and k4 is not None:
            table += [
                gw_row("kron_gram_ragged", "kron_gram.cu",
                       "pint_tpu/linalg.py:605", gw["launches"]["K3"],
                       k3["case"]),
                gw_row("os_pair_stage", "os_pairs.cu",
                       "pint_tpu/gw/os.py:86", gw["launches"]["K4"], k4)]
        else:
            table = None
        crn_d = run("crn dense", phase_crn_dense, pta_arrays, pairs,
                    gw["surf"])
        k11 = run("k11", phase_k11, crn_d["crn"]) if crn_d else None
        if table is not None and k11 is not None:
            table.append(gw_row("crn_capacity", "crn_capacity.cu",
                                "pint_tpu/gw/common.py:186",
                                crn_d["launches"]["K11"],
                                k11["grid chunk G9"]))
        else:
            table = None
        crn_d = None
        run("kron append", phase_kron_append, gw["ost"])
    else:
        table = None
    from pint_tpu_torch.convert import PTA68_500_BATCH

    run("pta batch", phase_pta_batch, *load_pta_case(PTA68_500_BATCH))
    # a fresh copy: a homogeneous batch writes its fit into the models
    run("pta homogeneous", phase_pta_homogeneous, load_pta_case()[1])
    run("dd", phase_dd)
    hmc = run("hmc", phase_hmc, pta_arrays, pairs)
    if hmc is not None:
        run("hmc parity", phase_hmc_parity, hmc["post"],
            load_hmc_reference())
        k5 = run("k5", phase_k5, hmc["post"])
        k6 = run("k6", phase_k6)
        if table is not None and k5 is not None and k6 is not None:
            n = hmc["launches"]
            table += [
                gw_row("kron_pulsar_fwd", "kron_pulsar.cu",
                       "pint_tpu/linalg.py:701", n["K5"], k5["k5"]),
                gw_row("kron_pulsar_bwd", "kron_pulsar.cu",
                       "pint_tpu/linalg.py:701", n["K5b"], k5["k5b"]),
                gw_row("nuts_step", "nuts_step.cu",
                       "pint_tpu/gw/hmc.py:365", n["K6"], k6)]
        else:
            table = None
        from pint_tpu_torch.convert import HMC_DENSE_ANSWERS

        hmc_d = run("hmc dense", phase_hmc_dense, pairs, hmc["post"],
                    load_hmc_reference(), load_arrays(HMC_DENSE_ANSWERS))
        k11b = run("k11b", phase_k11b, hmc_d["post"],
                   load_hmc_reference()) if hmc_d else None
        if table is not None and k11b is not None:
            table.append(gw_row("crn_capacity_bwd", "crn_capacity.cu",
                                "pint_tpu/gw/hmc.py:270",
                                hmc_d["launches"]["K11b"],
                                k11b["posterior G4"]))
        else:
            table = None
        hmc_d = None
    else:
        table = None
    wide = run("wide case", phase_wide_case)
    k5w = run("k5 wide", phase_k5_wide, wide) if wide else None
    if table is not None and k5w is not None:
        n = wide["launches"]
        table += [
            gw_row("kron_pulsar_fwd_wide", "kron_pulsar.cu",
                   "pint_tpu/linalg.py:701", n["K5w"], k5w["k5w path b4"]),
            gw_row("kron_pulsar_bwd_wide", "kron_pulsar.cu",
                   "pint_tpu/linalg.py:701", n["K5bw"],
                   k5w["k5bw path b4"])]
    else:
        table = None
    leaked = [m for m in ("jax", "pint_tpu") if m in sys.modules]
    if leaked:
        failures.append(f"imports {leaked}")
    if failures or table is None:
        log(f"chip_smoke: FAILED phases {failures}")
        return 1
    log(json.dumps({"kernels": table}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
