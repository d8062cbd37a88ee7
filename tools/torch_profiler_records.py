"""How many launches of the hand-written kernels the PyTorch profiler
records, read through ``key_averages`` and through the exported chrome
trace, against the launches made.

For K5 (one kernel a call, 16 chains x 68 pulsars, nb 63, m2 28), K3
(two kernels a call, 68 pulsars x 500 rows) and K10 (two kernels a call,
the GLS capture's 10842 x 72, c0 = 60), on seeded synthetic inputs of
chip_smoke.py's shapes, and a torch matmul beside them: three windows
of 20 calls each, enqueued freely and queued behind a sleep kernel,
each printed as launches made, kernels and µs per call in
``key_averages``, kernels and µs per call in the trace, the trace's span
per call, and the queued CUDA-event time per call.  ``--shared-cudart``
builds the kernels' libraries against the shared CUDA runtime (nvcc
``-cudart shared``, the one PyTorch loads) instead of a static copy.

Usage (from the repo root, on the card; ~1 min a mode)::

    python tools/torch_profiler_records.py
    python tools/torch_profiler_records.py --shared-cudart
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from functools import partial

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def cases():
    """{label: (call, kernels a call)} on the card (a matmul's count is
    cuBLAS's choice: None)."""
    import torch

    import chip_smoke as cs
    from pint_tpu_torch import linalg as tl

    pre = cs.synthetic_grams(68, 63, 28, seed=5)
    rng = np.random.default_rng(5)
    phi = torch.tensor(10.0 ** rng.uniform(-16, -12, (16, 68, 63)),
                       device="cuda")
    st = cs.synthetic_stack(68, 500, 63, 28)
    A = torch.tensor(rng.standard_normal((10842, 72)), device="cuda")
    w = torch.tensor(rng.uniform(0.5, 2.0, 10842) * 1e12, device="cuda")
    S = torch.zeros((72, 12), dtype=torch.float64, device="cuda")
    x = torch.randn((512, 512), dtype=torch.float64, device="cuda")
    return {"K5": (partial(tl.kron_pulsar_cuda, pre, phi), 1),
            "K3": (partial(tl.kron_gram_cuda, st), 2),
            "K10": (partial(tl.stream_moments_cuda, S, A, w, 60), 2),
            "torch matmul": (partial(torch.matmul, x, x), None)}


def profiled(fn, reps, queued=False):
    """The profile of ``reps`` calls of ``fn`` after a warm-up; with
    ``queued``, enqueued behind a sleep kernel as
    ``chip_smoke.queued_ms`` does, so the card runs them back to back."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if queued:
            torch.cuda._sleep(int(2e9 * (3 * reps * host_s + 2e-3)))
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return prof


def window(fn, queued, reps=20):
    """One profiled window of ``reps`` calls, read both ways."""
    from torch.autograd import DeviceType

    import chip_smoke as cs

    prof = profiled(fn, reps, queued=queued)
    ka = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    tr, span = cs.trace_kernels(prof, "profiler_records")
    return {"key_averages_kernels": sum(e.count for e in ka) / reps,
            "key_averages_us": sum(e.self_device_time_total
                                   for e in ka) / reps,
            "trace_kernels": sum(v[1] for v in tr.values()) / reps,
            "trace_us": sum(v[0] for v in tr.values()) / reps,
            "trace_span_us": span / reps}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shared-cudart", action="store_true")
    a = ap.parse_args(argv)
    import torch

    import chip_smoke as cs
    from pint_tpu_torch import _cuda

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    if a.shared_cudart:
        _cuda.NVCC_FLAGS = _cuda.NVCC_FLAGS + ("-cudart", "shared")
    mode = "shared" if a.shared_cudart else "static"
    for label, (fn, kernels) in cases().items():
        q = cs.queued_ms(fn) * 1e3
        for queued in (False, True):
            for rep in range(3):
                row = window(fn, queued)
                row.update(cudart=mode, queued=queued, window=rep,
                           kernels_a_call=kernels, queued_events_us=q)
                print(f"{label}: " + json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
