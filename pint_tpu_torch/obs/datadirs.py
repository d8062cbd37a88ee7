"""Shared runtime-data directory discovery + provenance.

Clock files ($PINT_TORCH_CLOCK_DIR / ./clock, then the JAX package's
bundled ``pint_tpu/data/runtime``) and IERS EOP files
($PINT_TORCH_IERS_DIR / ./iers) use the same search, and the same
(name, mtime, size) provenance string, which keys the EOP table's
memoization; data is local-only.
"""

from __future__ import annotations

import os

from pint_tpu_torch import DATA_DIR

__all__ = ["search_dirs", "data_identity"]


def builtin_runtime_dir():
    """The JAX package's runtime-data directory (pint_tpu/data/runtime),
    read in place: bundled clock/BIPM tabulations (reference analogue:
    the static src/pint/data/runtime/ package data)."""
    return os.path.join(DATA_DIR, "runtime")


def search_dirs(env_var, default_subdir, include_builtin=False):
    """Existing directories to search: $env_var (if set), then
    ./default_subdir, then (with ``include_builtin``) the bundled
    package data as lowest priority — a user-supplied file of the same
    name always wins.

    Only the CLOCK search opts into the bundle: the IERS search must
    not treat bundled clock files as EOP candidates nor hash them into
    EOP-keyed cache identities."""
    dirs = []
    env = os.environ.get(env_var)
    if env:
        dirs.append(env)
    dirs.append(default_subdir)
    if include_builtin:
        dirs.append(builtin_runtime_dir())
    return [d for d in dirs if os.path.isdir(d)]


def data_identity(dirs):
    """Provenance string over every file in ``dirs`` (name, mtime,
    size) — changing, adding, or removing any file changes the string."""
    parts = []
    for d in dirs:
        for f in sorted(os.listdir(d)):
            p = os.path.join(d, f)
            try:
                st = os.stat(p)
            except OSError:
                continue
            parts.append(f"{f}:{st.st_mtime_ns}:{st.st_size}")
    return ";".join(parts)
