"""Time kernels K9 (stretch move) and K6 (NUTS transition) of this
checkout and of an earlier one on the card, on the same inputs and the
same timer.

The inputs and the timer are ``chip_smoke.py``'s, loaded from this
checkout: K9 on ``_k9_synthetic`` at 16 and 4096 walkers a half (10 and
64 parameters), K6 on ``_k6_timed_state`` (16 chains x 138 coordinates,
12 leapfrog steps, gradients fixed), each timed by ``queued_ms`` (CUDA
events around 50 calls, 20 for K6, queued behind a sleep kernel) on
buffers updated in place, so a timed call holds the kernels' launches
alone.  A checkout with ``sampler.StretchBuffers`` runs K9 through
``chip_smoke._K9Step`` (three launches a step) and K6 through
``nuts_draw_start``, ``nuts_leap_next`` and ``nuts_draw_finish``
(n_leap + 1 launches a draw).  An earlier checkout (commit b4dd8f2 and
before) runs its own API: ``stretch_propose_cuda`` and
``stretch_accept_cuda`` for each half (six kernels a step) and
``nuts_leap_pre``, ``nuts_leap_post`` and ``nuts_draw_end`` (2 n_leap + 1
launches a draw).

- K9 ``step_ms``: one red-black step; ``half_ms``: the earlier form's
  half-move (propose, accept) or the current form's middle launch
  (accept half 0, propose half 1);
- K6 ``draw_ms``: one draw's elementwise work;
- ``step_with_enqueue_ms``, ``draw_with_enqueue_ms``: CUDA events
  around calls made back to back with nothing queued ahead
  (``chip_smoke.cuda_ms``), the host's enqueue included: the larger of
  the host's time and the card's;
- ``launch_ms``: an empty kernel launched cooperatively and plainly at
  the grid K9 takes at each shape (built here from a few lines of CUDA),
  what the cooperative launch costs over a plain one.

Usage (on a machine with an NVIDIA GPU, from the repo root)::

    python tools/torch_k9_k6_times.py                  # this checkout
    python tools/torch_k9_k6_times.py --against DIR    # and DIR's

With ``--against``, DIR (an unpacked checkout of another commit) and this
checkout run in turns, DIR, this, this, DIR, each in a process of its
own (both packages are named ``pint_tpu_torch``); each run prints one
JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
from functools import partial

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K9_SHAPES = ((16, 10), (4096, 64))

PROBE = r"""
#include <cstdint>
#include <cuda_runtime.h>
__global__ void launch_probe_kernel() {}
extern "C" int launch_probe(int64_t cooperative, int64_t blocks) {
  if (cooperative)
    return (int)cudaLaunchCooperativeKernel(
        (const void*)launch_probe_kernel, dim3((unsigned)blocks), dim3(256),
        nullptr, 0, 0);
  launch_probe_kernel<<<(unsigned)blocks, 256>>>();
  return (int)cudaGetLastError();
}
"""


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _k9_earlier(torch, ts, inputs):
    """(step, half-move) of the earlier K9 API on buffers updated in
    place."""
    x0, lnp0, lnp_prop, draws = inputs
    x, lnp = x0.clone(), lnp0.clone()
    h = x.shape[0] // 2
    half = (slice(0, h), slice(h, 2 * h))
    acc = torch.empty(2 * h, dtype=torch.uint8, device=x.device)
    count = torch.empty(2, dtype=torch.int64, device=x.device)

    def half_move(k):
        s, o = half[k], half[1 - k]
        u, idx, u_acc = draws[k]
        p, z = ts.stretch_propose_cuda(x[s], x[o], u, idx, 2.0)
        ts.stretch_accept_cuda(x[s], lnp[s], p, z, lnp_prop[s], u_acc,
                               acc[s], count[k:k + 1])

    def step():
        half_move(0)
        half_move(1)
    return step, partial(half_move, 0)


def _k6_draw(hmc, st, n_leap):
    """One draw's elementwise work on ``st``, non-adapting, through
    whichever API the checkout has."""
    if hasattr(hmc, "nuts_draw_start"):
        hmc.nuts_draw_start(st)
        for i in range(n_leap - 1):
            hmc.nuts_leap_next(st, i)
        hmc.nuts_draw_finish(st, n_leap - 1, False, False, 0.8, 5)
        return
    for i in range(n_leap):
        hmc.nuts_leap_pre(st, i)
        hmc.nuts_leap_post(st, i)
    hmc.nuts_draw_end(st, False, False, 0.8, 5)


def measure(root):
    """One checkout's times, as a dict."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from pint_tpu_torch import _cuda
    from pint_tpu_torch import sampler as ts
    from pint_tpu_torch.gw import hmc

    cs = _chip_smoke()
    _cuda.build([ts.K9.source, hmc.K6.source])
    current = hasattr(ts, "StretchBuffers")
    out = {"root": root, "package": os.path.dirname(ts.__file__),
           "card": torch.cuda.get_device_name(0), "current": current,
           "k9": {}}
    if current:
        _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = _cuda.BUILD_DIR / "launch_probe.cu"
        src.write_text(PROBE)
        probe = _cuda.CudaKernel("launch probe", str(src), "launch_probe",
                                 [ctypes.c_int64] * 2)
    for h, nd in K9_SHAPES:
        inputs = cs._k9_synthetic(h, nd)
        if current:
            st = cs._K9Step(inputs)
            step, half = st.step, st.gap
        else:
            step, half = _k9_earlier(torch, ts, inputs)
        row = {"step_ms": cs.queued_ms(step), "half_ms": cs.queued_ms(half),
               "step_with_enqueue_ms": cs.cuda_ms(step, reps=50),
               "launcher_calls_per_step": 3 if current else 4}
        if current:
            blocks = ts.K9.call("stretch_move_blocks", h, nd)
            row["launch_ms"] = {"blocks": blocks, **{
                kind: cs.queued_ms(partial(probe.call, "launch_probe", coop,
                                           blocks))
                for kind, coop in (("cooperative", 1), ("plain", 0))}}
        out["k9"][f"{h}x{nd}"] = row
    c, nd, n_leap = cs.K6_SHAPE
    st = cs._k6_timed_state()
    # 20 calls keep the earlier form's 25 launches a call under the
    # card's launch queue (~10^3)
    draw = partial(_k6_draw, hmc, st, n_leap)
    out["k6"] = {"draw_ms": cs.queued_ms(draw, reps=20),
                 "draw_with_enqueue_ms": cs.cuda_ms(draw, reps=20),
                 "launches_per_draw": n_leap + 1 if current
                 else 2 * n_leap + 1, "chains": c, "ndim": nd,
                 "n_leap": n_leap}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", help="another checkout's root: run it "
                    "and this one in turns")
    ap.add_argument("--root", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.root:
        print(json.dumps(measure(args.root)), flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    roots = ([args.against, HERE, HERE, args.against] if args.against
             else [HERE])
    rc = 0
    for r in roots:
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--root", r], capture_output=True, text=True)
        sys.stdout.write(p.stdout)
        if p.returncode:
            sys.stderr.write(p.stderr)
            rc = p.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
