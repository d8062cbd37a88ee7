"""Export the JAX CPU answers of the dense GWB posterior
(``pint_tpu.gw.hmc.GWBPosterior`` over ``CommonProcess(kron=False)``)
on the 68-pulsar case, for the port's dense posterior to be held to.

The array is ``tools/export_torch_pta_case.make_pta()`` (the one
``pint_tpu_torch/data/pta68_500.npz`` carries), the posterior the one of
``tools/export_torch_hmc_case.py`` (14 GWB modes, every pulsar's
TNREDAMP and TNREDGAM: 138 dimensions) with the dense (K, K) prior:
K = 6188 basis columns over 34000 TOAs.  Written arrays:

- ``param_names`` (must equal ``pta68_500_hmc.npz``'s);
- ``rows``: the rows of ``pta68_500_hmc.npz``'s ``theta`` taken (0, the
  center, and 1), ``theta`` (2, ndim) those rows;
- ``dense_lnprob`` (2,), ``dense_grad`` (2, ndim): JAX's dense
  ``lnprob`` and its ``jax.grad`` there;
- ``kron_lnprob``, ``kron_grad``: JAX's kron posterior at the same
  theta, and ``lnp_rel`` (2,), ``grad_rel`` (2,): JAX's own kron-vs-
  dense disagreement, |lnp_k / lnp_d - 1| and max |g_k - g_d| /
  max |g_d| (the reference's pin at full width);
- ``seconds``: the wall time of each dense value-and-gradient, and the
  commit.

Each dense value and gradient forms the (K, K) gram from the stacked
(34000, K) basis, the dense prior, its inverse and the capacity's
Cholesky, and their gradients (~6 GB; one theta at a time).

Usage (from the repo root, minutes on 8 CPU cores)::

    JAX_PLATFORMS=cpu python tools/export_torch_hmc_dense_case.py \\
        --case pint_tpu_torch/data/pta68_500_hmc.npz \\
        --out pint_tpu_torch/data/pta68_500_hmc_dense.npz
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tools.export_torch_case import _commit  # noqa: E402
from tools.export_torch_hmc_case import NMODES  # noqa: E402
from tools.export_torch_pta_case import make_pta  # noqa: E402

#: the rows of the HMC case's theta taken: the center and one chain start
ROWS = (0, 1)


def _value_and_grad(post, theta):
    """(lnprob (n,), grad (n, ndim), seconds (n,)): one jitted
    value-and-gradient, one theta at a time."""
    import jax
    import jax.numpy as jnp

    data = post.data()
    vg = jax.jit(jax.value_and_grad(lambda q: post.lnprob(q, data)))
    lnp, grad, secs = [], [], []
    for th in theta:
        t0 = time.time()
        v, g = vg(jnp.asarray(th))
        lnp.append(float(v))
        grad.append(np.asarray(g))
        secs.append(time.time() - t0)
    return np.asarray(lnp), np.stack(grad), np.asarray(secs)


def dense_answers(pairs, case, nmodes=NMODES, rows=ROWS):
    """The arrays listed in the module docstring (JAX on the CPU)."""
    from pint_tpu.gw import CommonProcess, GWBPosterior

    theta = np.asarray(case["theta"])[list(rows)]
    out = {"rows": np.asarray(rows), "theta": theta}
    for kron in (False, True):
        t0 = time.time()
        post = GWBPosterior(CommonProcess(pairs, nmodes=nmodes, kron=kron))
        if post.param_names != [str(n) for n in case["param_names"]]:
            raise SystemExit("the build does not reproduce the HMC case's "
                             "parameters")
        print(f"kron={kron}: build {time.time() - t0:.1f} s",
              file=sys.stderr)
        lnp, grad, secs = _value_and_grad(post, theta)
        key = "kron" if kron else "dense"
        out[f"{key}_lnprob"], out[f"{key}_grad"] = lnp, grad
        if not kron:
            out["seconds"] = secs
            out["param_names"] = np.asarray(post.param_names, dtype=np.str_)
        print(f"kron={kron}: lnprob {lnp.tolist()} ({secs.tolist()} s)",
              file=sys.stderr)
        del post
    ld, gd = out["dense_lnprob"], out["dense_grad"]
    out["lnp_rel"] = np.abs(out["kron_lnprob"] / ld - 1.0)
    out["grad_rel"] = (np.max(np.abs(out["kron_grad"] - gd), axis=1)
                       / np.max(np.abs(gd), axis=1))
    out["commit"] = np.asarray(_commit())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", default="pint_tpu_torch/data/pta68_500_hmc.npz")
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    case = np.load(a.case)
    arrays = dense_answers(make_pta(), case)
    if not np.array_equal(arrays["kron_lnprob"],
                          case["lnprob"][list(ROWS)]):
        print("note: the kron lnprob differs from the HMC case's by "
              f"{(arrays['kron_lnprob'] - case['lnprob'][list(ROWS)])}",
              file=sys.stderr)
    np.savez_compressed(a.out, **arrays)
    print(f"wrote {a.out}: dense lnprob {arrays['dense_lnprob'].tolist()}, "
          f"JAX's kron-vs-dense lnp rel {arrays['lnp_rel'].tolist()}, "
          f"gradient rel {arrays['grad_rel'].tolist()}")


if __name__ == "__main__":
    main()
