"""Overlap-reduction functions (pint_tpu gw/orf.py:37-136): the angular
correlation of a common gravitational-wave process across a pulsar
array.

Host-side numpy, as in the reference: the ORF matrix is a constant of
the array geometry, built once and moved to the device by its caller.

- Hellings-Downs cross-correlation, x = (1 - cos zeta) / 2:
  ``Gamma(zeta) = 3/2 x ln x - x/4 + 1/2``;
- the diagonal is the full auto-correlation (pulsar term included: 1
  for HD and dipole), while distinct co-located pulsars take the cross
  limit (HD 1/2);
- monopole (clock errors) 1, dipole (ephemeris errors) cos zeta.
"""

from __future__ import annotations

import numpy as np

from pint_tpu_torch.models.astrometry import psr_dir_static


def pulsar_positions(models) -> np.ndarray:
    """(N, 3) SSB -> pulsar ICRS unit vectors from each model's current
    RAJ/DECJ (``TimingModel.values``)."""
    return np.stack([psr_dir_static(m) for m in models], axis=0)


def angular_separation_matrix(pos) -> np.ndarray:
    """(N, N) pairwise separations [rad]; the diagonal exactly 0."""
    pos = np.asarray(pos, dtype=np.float64)
    zeta = np.arccos(np.clip(pos @ pos.T, -1.0, 1.0))
    return zeta * (1.0 - np.eye(zeta.shape[0]))


def hellings_downs(zeta, auto=None):
    """HD ORF at ``zeta`` [rad]; ``auto`` (default 1) is the value at
    zeta = 0."""
    zeta = np.asarray(zeta, dtype=np.float64)
    x = (1.0 - np.cos(zeta)) / 2.0
    x_safe = np.where(x > 0.0, x, 1.0)
    cross = 1.5 * x * np.log(x_safe) - x / 4.0 + 0.5
    return np.where(x > 0.0, cross, 1.0 if auto is None else auto)


def monopole(zeta, auto=None):
    return np.ones_like(np.asarray(zeta, dtype=np.float64))


def dipole(zeta, auto=None):
    zeta = np.asarray(zeta, dtype=np.float64)
    return np.where(zeta > 0.0, np.cos(zeta), 1.0 if auto is None else auto)


ORF_KINDS = {
    "hd": hellings_downs,
    "hellings_downs": hellings_downs,
    "monopole": monopole,
    "dipole": dipole,
}

#: the zeta = 0 value an off-diagonal (distinct, co-located) pair takes
_CROSS_AUTO = {hellings_downs: 0.5, dipole: 1.0, monopole: 1.0}


def orf_matrix(pos, kind="hd") -> np.ndarray:
    """Dense symmetric (N, N) ORF matrix from (N, 3) unit vectors.
    ``kind``: 'hd' | 'monopole' | 'dipole', or a callable ``orf(zeta)``."""
    fn = ORF_KINDS.get(kind, kind) if isinstance(kind, str) else kind
    if not callable(fn):
        raise ValueError(
            f"unknown ORF kind {kind!r} (have {sorted(ORF_KINDS)})")
    zeta = angular_separation_matrix(pos)
    n = zeta.shape[0]
    eye = np.eye(n)
    cross_auto = _CROSS_AUTO.get(fn)
    off = fn(zeta) if cross_auto is None else fn(zeta, auto=cross_auto)
    g = off * (1.0 - eye) + np.diag(fn(np.zeros(n)))
    return (g + g.T) / 2.0


def pair_indices(n):
    """(ii, jj) int64 over the N(N-1)/2 pairs i < j, row-major."""
    ii, jj = np.triu_indices(n, k=1)
    return ii.astype(np.int64), jj.astype(np.int64)
