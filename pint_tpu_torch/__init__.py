"""pint_tpu_torch — the PyTorch/CUDA port of pint_tpu's timing core.

The package mirrors ``pint_tpu``'s module names and layout so each
counterpart is easy to find, and runs the GLS timing fit of one pulsar
(TOA table -> prepare -> residuals -> hybrid design -> GLS solve ->
Gauss-Newton iterations) on an NVIDIA GPU.  It imports neither ``jax``
nor any module of ``pint_tpu``: what it needs from there is copied
here.

Device rule: every entry point takes ``device``.  ``None`` means CUDA,
and raises when no CUDA device is present — the port never falls back
to the CPU on its own.  Pass ``device="cpu"`` to run the plain PyTorch
versions of the hand-written kernels (the tests do).
"""

from __future__ import annotations

from pathlib import Path

import torch

__version__ = "0.1.0"

C_M_PER_S = 299792458.0  #: speed of light [m/s] (exact, SI)
SECS_PER_DAY = 86400.0
AU_M = 149597870700.0  #: astronomical unit [m] (IAU 2012, exact)
AU_LS = AU_M / C_M_PER_S  #: AU in light-seconds (~499.005)
#: Dispersion constant: delay[s] = DM * DM_CONST / freq[MHz]^2 (the
#: community convention K == 1/2.41e-4 s MHz^2 cm^3 / pc)
DM_CONST = 1.0 / 2.41e-4
#: GM_sun / c^3 [s]
T_SUN_S = 4.925490947000452e-06
OBLIQUITY_J2000_ARCSEC = 84381.406  #: IAU 2006 J2000 obliquity
DAYS_PER_JULIAN_YEAR = 365.25
SECS_PER_JULIAN_YEAR = DAYS_PER_JULIAN_YEAR * SECS_PER_DAY

F64 = torch.float64

#: the JAX package's data directory (builtin ephemeris, clock and EOP
#: files), read in place and never copied
DATA_DIR = str(Path(__file__).resolve().parent.parent / "pint_tpu" / "data")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is requested (explicitly or by default)
    and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pint_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
