"""Where a K5w or K5bw block spends its time: clock64 at the wide
kernels' marks, read from block 0.

The script builds ``pint_tpu_torch/csrc/kron_pulsar.cu`` with
``-DWIDE_MARKS`` and the port's nvcc flags into a library of its own:
every ``WIDE_MARK()`` of the two wide kernels (after each block barrier,
around K5w's look-ahead factorization, after K5bw's staging of the next
strip and after its combine) then records thread 0's ``clock64()`` and
its source line in block 0.  It runs the library on synthetic grams
(``chip_smoke.synthetic_grams``, m2 = 28) at nb = 203, 4 chains x 4
pulsars, nb = 470, 16 chains x 4 pulsars (both at the 32-column panel)
and nb = 3000, 1 x 1 (the 8-column panel), and prints one JSON line for
each kernel and shape: the block's cycles from first to last mark, and
for each source line the cycles of the stretches that end there (the
time thread 0 took to reach that mark from the one before) and their
count.  The marks cost a few cycles each; the kernels' results are
checked against the plain versions.

Usage (on a machine with an NVIDIA GPU, from the repo root)::

    python tools/torch_k5w_phases.py
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
MARKS = 1 << 20  # WIDE_MARKS_MAX


def phases(lib):
    """(block 0's cycles, {line: [cycles, count]}) of the launches since
    the last call, whose marks it clears."""
    t = np.zeros(MARKS, np.int64)
    lines = np.zeros(MARKS, np.int32)
    lib.wide_marks_read(t.ctypes.data, lines.ctypes.data)
    n = int(np.count_nonzero(lines))
    tt, ll = t[:n], lines[:n]
    out = {}
    for dt, line in zip(np.diff(tt), ll[1:]):
        c = out.setdefault(int(line), [0, 0])
        c[0] += int(dt)
        c[1] += 1
    return int(tt[-1] - tt[0]) if n else 0, out


def main():
    import torch

    import chip_smoke as cs
    from pint_tpu_torch import _cuda
    from pint_tpu_torch import linalg as tl
    from pint_tpu_torch import tolerances as tol

    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _cuda.BUILD_DIR / "libkron_pulsar_marks.so"
    r = subprocess.run([_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-DWIDE_MARKS",
                        "-o", str(so), str(_cuda.CSRC / "kron_pulsar.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        sys.stderr.write(r.stdout + r.stderr)
        return 1
    lib = ctypes.CDLL(str(so))
    v, i64 = ctypes.c_void_p, ctypes.c_int64
    fwd, bwd = lib.kron_pulsar_fwd_wide_launch, lib.kron_pulsar_bwd_wide_launch
    fwd.argtypes = [v] * 15 + [i64] * 4 + [v]
    bwd.argtypes = [v] * 9 + [i64] * 3 + [v]
    fwd.restype = bwd.restype = lib.wide_marks_read.restype = ctypes.c_int
    lib.wide_marks_read.argtypes = [v, v]
    f64 = dict(dtype=torch.float64, device="cuda")
    rc = 0
    for p, c, nb in ((4, 4, 203), (4, 16, 470), (1, 1, 3000)):
        m2 = 28
        pre = cs.synthetic_grams(p, nb, m2, seed=nb)
        rng = np.random.default_rng(1)
        phi = torch.tensor(10.0 ** rng.uniform(-16, -12, (c, p, nb)), **f64)
        out = [torch.empty(s, **f64) for s in (
            (c, p), (c, p, m2), (c, p, m2, m2), (c, p), (c, p, nb, nb),
            (c, p, nb, 1 + m2))]
        scratch = torch.empty(
            c * p * tl.K5W.call("kron_pulsar_wide_scratch", nb), **f64)
        stream = torch.cuda.current_stream().cuda_stream
        ref = tl.kron_pulsar_plain(pre, phi)
        cots = [torch.tensor(rng.standard_normal(t.shape), **f64)
                for t in ref[:4]]
        gphi = torch.empty_like(phi)
        for name, fn, args, check in (
                ("K5w", fwd, [phi.data_ptr(), *(t.data_ptr() for t in pre),
                              *(t.data_ptr() for t in out),
                              scratch.data_ptr(), c * p, p, nb, m2, stream],
                 lambda: tol.vector_rel(out[4], ref[4])),
                ("K5bw", bwd, [phi.data_ptr(), out[4].data_ptr(),
                               out[5].data_ptr(),
                               *(t.data_ptr() for t in cots),
                               gphi.data_ptr(), scratch.data_ptr(), c * p,
                               nb, m2, stream],
                 lambda: tol.vector_rel(gphi, tl.kron_pulsar_bwd_plain(
                     phi, out[4], out[5], *cots)))):
            for _ in range(2):  # the second run's marks are read
                torch.cuda.synchronize()
                phases(lib)  # read and cleared
                if fn(*args):
                    raise RuntimeError(f"{name} failed to launch")
            torch.cuda.synchronize()
            total, by_line = phases(lib)
            err = check()
            rc = rc or int(not err <= tol.KRON_PULSAR_REL)
            print(json.dumps({
                "kernel": name, "chains": c, "pulsars": p, "nb": nb,
                "m2": m2, "panel": tl.k5_wide_panel(nb),
                "vs_plain": err, "block0_cycles": total,
                "cycles_by_mark_line": {
                    str(k): v for k, v in sorted(
                        by_line.items(), key=lambda x: -x[1][0])}}),
                flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
