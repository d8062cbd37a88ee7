#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``pint_tpu_torch``) on one GPU.

Run from the repo root on a machine with an NVIDIA H100::

    python3 chip_smoke.py

Phases, each reported on its own line; any failure exits non-zero and
the closing ``{"ok": true, ...}`` line is not printed:

1. the card's name and power limit (nvidia-smi);
2. build of every hand-written kernel from ``pint_tpu_torch/csrc``
   (one nvcc per source, all started together), with its time;
3. kernel K1 (exact fixed-point phase) against its plain PyTorch
   version run on the CPU: 10^6 random (F0, t) pairs plus poison cases,
   ``n`` and the bits of ``frac`` identical;
4. kernel K2 (fixed-order segment sums) against its plain version on
   the CPU at N = 10^4, K_e = 400, M in {1, 10, 61}: bit identity, and
   bit identity from run to run on the card;
5. the 10k-TOA, 400-epoch GLS fit of the B1855-like DD pulsar with
   ECORR and red noise (``pint_tpu_torch/data/b1855_epochs_10k.npz``)
   through ``GLSFitter(..., device="cuda").fit_toas(maxiter=3)``, held
   to the JAX CPU answer the fixture carries; launch counts of K1 and
   K2 during the fit (both > 0); cold and warm wall time; a profiler
   breakdown of a warm fit;
6. the ``kernels`` JSON line: per kernel its launches during the fit,
   error against the plain version, time, plain-version time, bound,
   and the library call's time where one PyTorch call computes the same
   function.

Kernel times are device times (the profiler's kernel durations, summed
per call and averaged over repeated calls after a warm-up) at the
shapes the fit gives each kernel; the per-call time with the host's
enqueue (CUDA events around a loop) is printed beside them.  Inputs
stay in L2 between calls, as they do inside the fit.  Long outputs go
to chiprun_out/.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback
from functools import partial

import numpy as np

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and
#: FP64 (non-tensor) FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12

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
    """Mean device time of ``fn`` [ms]: the summed durations of the
    kernels it launches, from the profiler (CUPTI), without the host's
    enqueue gaps.  None when the profiler records no kernel."""
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
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / reps / 1e3 if us > 0 else None


def kernel_ms(fn):
    """(device ms per call, how it was measured): profiler kernel time,
    or CUDA events around a loop of calls when the profiler sees no
    kernel in two tries (a profiler session now and then records no
    device activity)."""
    for _ in range(2):
        ms = device_ms(fn)
        if ms is not None:
            return ms, "profiler"
    return cuda_ms(fn), "events"


def bound_ms(n_bytes, n_flops):
    """(least time [ms], what bounds it) at the published peaks."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_f = n_flops / FP64_FLOPS * 1e3
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
    from pint_tpu_torch.linalg import K2

    t0 = time.time()
    libs = _cuda.build([K1.source, K2.source])
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
    try:
        profile_breakdown(warm, warm_s)
    except Exception as e:  # a measurement, not a check: report and go on
        log(f"profile: unavailable ({type(e).__name__}: {e})")
    return launches, f


def profile_breakdown(fn, wall_s):
    """Device time by kernel over one warm fit (torch.profiler)."""
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
    with open(os.path.join(OUT_DIR, "fit_profile.txt"), "w") as fh:
        fh.write(ka.table(sort_by="self_device_time_total", row_limit=40))
    top = [(e.key[:60], round(e.self_device_time_total / 1e3, 3), e.count)
           for e in rows[:8]]
    log(f"profile: one warm fit, wall {wall:.3f} s (unprofiled "
        f"{wall_s:.3f} s), device busy {dev_us / 1e3:.3f} ms "
        f"({dev_us / 1e6 / wall * 100:.2f}% of wall); top kernels "
        f"[name, ms, calls] {json.dumps(top)}")


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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    try:
        from pint_tpu_torch.convert import load_case
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
        try:
            return fn(*args)
        except Exception:  # a failed phase is reported, the rest still run
            failures.append(name)
            log(f"PHASE FAILED: {name}\n{traceback.format_exc()}")
            return None

    card = run("card", phase_card)
    run("build", phase_build)
    k1_err = run("k1", phase_k1)
    arrays, model, toas, tzr = load_case()
    got = run("fit", phase_fit, arrays, model, toas, tzr)
    k2_err = None
    table = None
    if got is not None:
        launches, f = got
        k2_err = run("k2", phase_k2, f.resids._U_ext)
        if k1_err is not None and k2_err is not None:
            table = run("kernel table", phase_kernel_table, f, launches,
                        k1_err, k2_err)
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
