"""Fixed-count iteration (pint_tpu compile_cache.py:499 iterate_fixed).

The reference runs ``carry = body(carry)`` exactly n times inside one
traced program, as a ``lax.scan`` or an unrolled loop, and with
``trace_of`` stacks one record per iteration, as the scan's ``ys``.
PyTorch runs eagerly, so here the loop is a host loop over launches
that are queued on the device: the count is fixed, nothing in it
reads the device, and the records stay on the device until the caller
copies them.  Capturing one call as a CUDA graph is a later step.
"""

from __future__ import annotations

import torch


def stack_records(records):
    """One record of stacked leaves from a list of records (dicts,
    tuples or lists of tensors), along a new leading axis."""
    first = records[0]
    if isinstance(first, dict):
        return {k: stack_records([r[k] for r in records]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(stack_records([r[i] for r in records])
                           for i in range(len(first)))
    return torch.stack(records)


def iterate_fixed(body, init, n_steps, trace_of=None):
    """Run ``carry = body(carry)`` exactly ``n_steps`` times.

    trace_of: optional ``fn(prev_carry, new_carry) -> record`` (a
    tensor, or a dict/tuple of tensors).  When given, returns
    ``(carry, trace)`` with ``trace`` the records stacked along a new
    leading axis; ``trace_of`` must copy what it keeps if ``body``
    updates the carry in place.  ``n_steps <= 0`` returns ``(init,
    None)`` (``init`` without ``trace_of``)."""
    traced = trace_of is not None
    if int(n_steps) <= 0:
        return (init, None) if traced else init
    records = []
    carry = init
    for _ in range(int(n_steps)):
        new = body(carry)
        if traced:
            records.append(trace_of(carry, new))
        carry = new
    if not traced:
        return carry
    return carry, stack_records(records)
