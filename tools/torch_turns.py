"""Run one of ``chip_smoke.py``'s timing functions on this checkout's
port and on another checkout's, in turns, on the card.

NAME is a function of this checkout's ``chip_smoke.py`` that takes no
arguments and returns a dict of times of the ``pint_tpu_torch`` it
imports, on the inputs and under the timer (``queued_ms``) of this
checkout: ``k5_wide_times`` (K5w and K5bw at the wide path's nb = 203,
at nb = 470 with 16 chains x 4 pulsars and with 16 chains x 68
pulsars, beside the plain backward), ``k9_k6_times`` (a K9 step, a
K6 draw) or ``k11_k7_times`` (K11 at the dense grid's chunk of 9
points and at 4 points of a full-width array, and at P = 12, G = 512;
K7 at the WLS fit's 10^4 x 11 and the WLS grid's 256 x 10^4 x 8; each
with an exact checksum of its outputs' bits), or ``fit_checksums`` (the
exact checksums of the 10k GLS fit's prefit residuals, fitted values and
postfit residuals).

Usage (on a machine with an NVIDIA GPU, from the repo root)::

    python tools/torch_turns.py NAME                  # this checkout
    python tools/torch_turns.py NAME --against DIR    # and DIR's

With ``--against``, DIR (an unpacked checkout of another commit) and
this checkout run in turns, DIR, this, this, DIR, each in a process of
its own (both packages are named ``pint_tpu_torch``).  The card's name
and power limit come first; then each run prints one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(name, root):
    """``chip_smoke.<name>()`` of this checkout on ``root``'s package."""
    sys.path.insert(0, os.path.abspath(root))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    import pint_tpu_torch

    with contextlib.redirect_stdout(sys.stderr):  # the phases' log lines
        times = getattr(cs, name)()
    return {"root": root, "package": os.path.dirname(pint_tpu_torch.__file__),
            "card": torch.cuda.get_device_name(0), name: times}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("name", help="a timing function of chip_smoke.py")
    ap.add_argument("--against", help="another checkout's root: run it "
                    "and this one in turns")
    ap.add_argument("--root", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.root:
        print(json.dumps(measure(args.name, args.root)), flush=True)
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
                            args.name, "--root", r],
                           capture_output=True, text=True)
        sys.stdout.write(p.stdout)
        if p.returncode:
            sys.stderr.write(p.stderr)
            rc = p.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
