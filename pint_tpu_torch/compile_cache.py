"""TOA-count buckets (pint_tpu compile_cache.py:793-930): the bucket
sizes, the zero-weight pad rows and the append that flips them.

Nothing is compiled here: eager PyTorch has no trace to share, and the
module keeps the JAX package's name only so that a reader finds the
counterpart.  The buckets stay because the streaming append's decision
(``in_bucket``: do the new rows fit the pad rows already there?) and
the report's ``mode`` are the reference's behaviour, and a dataset
whose shapes do not change across appends is what a captured CUDA
graph needs.  Host-side numpy only.
"""

from __future__ import annotations

import numpy as np

__all__ = ["PAD_ERROR_US", "BUCKET_BASE", "BUCKET_GROWTH", "bucket_size",
           "pad_toas", "append_toas"]

#: uncertainty of a pad row [us]: sigma = 1e16 s, weight 1e-32 s^-2,
#: which vanishes against any real TOA's weight (~1e12) far below f64
#: resolution (the JAX package's value, kept: it changes the answer)
PAD_ERROR_US = 1e22

#: geometric buckets: 64, 80, 100, 125, 156, ... (x1.25)
BUCKET_BASE = 64
BUCKET_GROWTH = 1.25


def bucket_size(n, base=BUCKET_BASE, growth=BUCKET_GROWTH):
    """The smallest bucket >= ``n``."""
    n = int(n)
    if n <= base:
        return base
    b = float(base)
    while int(round(b)) < n:
        b *= growth
    return int(round(b))


def pad_toas(toas, n_target=None):
    """``toas`` padded to its bucket (or to ``n_target``) with pad rows;
    ``.n_real`` records the real count.

    A pad row is a copy of the LAST real TOA, so it joins that row's
    mask groups and adds no basis column, with the uncertainty
    ``PAD_ERROR_US`` and the flag ``-pad 1`` (ECORR epochs skip it), so
    every weighted reduction drops it below f64 resolution.  Already
    padded TOAs come back as they are.  At a bucket boundary the result
    is a copy carrying ``n_real``: the caller's object is never
    stamped."""
    from pint_tpu_torch.toa import TOAs

    n = len(toas)
    if toas.n_real is not None:
        if n_target is not None and int(n_target) != n:
            raise ValueError(
                f"TOAs already padded to {n} (n_real={toas.n_real}); "
                f"cannot re-pad to {n_target}")
        return toas
    target = bucket_size(n) if n_target is None else int(n_target)
    if target < n:
        raise ValueError(f"pad target {target} < {n} TOAs")
    if target == n:
        out = toas[np.arange(n)]
        out.n_real = n
        return out
    pad = toas[np.full(target - n, n - 1, dtype=np.int64)]
    pad.error_us = np.full(target - n, PAD_ERROR_US)
    for f in pad.flags:
        f["pad"] = "1"
        if "pp_dm" in f:
            f["pp_dme"] = repr(PAD_ERROR_US)
    padded = TOAs.merge([toas, pad])
    padded.n_real = n
    return padded


def append_toas(toas, delta):
    """``(merged, in_bucket)``: ``delta`` appended to the (padded)
    ``toas``.

    When the new rows fit the bucket (``n_filled + len(delta) <=
    bucket``) the merged TOAs are padded to the SAME bucket: the append
    turns pad rows ``[n_filled, n_filled + len(delta))`` into real rows
    and the layout equals a from-scratch :func:`pad_toas` of the joined
    data.  ``in_bucket`` is False when the delta overflows (the merged
    TOAs then take the next bucket) or when the base carries a
    ``pad_valid`` mask whose pads are not all past ``n_filled``.  A base
    with ``n_filled`` (rows before it real or quarantined) keeps its
    interior False ``pad_valid`` entries, and the appended rows are
    marked valid."""
    from pint_tpu_torch.toa import TOAs

    if len(delta) == 0:
        raise ValueError("append_toas: empty delta")
    if delta.n_real is not None:
        raise ValueError("append_toas: delta must be unpadded TOAs")
    n_real = toas.n_real
    n_filled = toas.n_filled
    if toas.pad_valid is None:
        suffix_ok = True
        if n_filled is None:
            n_filled = n_real
        hole_valid = None
    else:
        ov = np.asarray(toas.pad_valid, dtype=bool)
        suffix_ok = n_filled is not None and not ov[n_filled:].any()
        hole_valid = ov[:n_filled] if suffix_ok else None
    if n_filled is None:
        n_filled = len(toas)
        real = toas
        bucket = None
    else:
        real = toas[np.arange(n_filled)]
        bucket = len(toas) if n_real is not None else None
    merged = TOAs.merge([real, delta])
    total = n_filled + len(delta)
    in_bucket = suffix_ok and bucket is not None and total <= bucket
    out = pad_toas(merged, n_target=bucket if in_bucket else None)
    out.n_filled = total
    if hole_valid is not None:
        out.pad_valid = np.concatenate(
            [hole_valid, np.ones(len(delta), dtype=bool),
             np.zeros(len(out) - total, dtype=bool)])
    return out, in_bucket
