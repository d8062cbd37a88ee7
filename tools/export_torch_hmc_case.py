"""Export the JAX CPU answers of the Bayesian GWB posterior
(``pint_tpu.gw.hmc``) on the 68-pulsar case, for the port's
``pint_tpu_torch.gw.hmc`` to be held to.

The array is the one ``tools/export_torch_pta_case.py`` writes to
``pint_tpu_torch/data/pta68_500.npz`` (``make_pta()``, rebuilt here
from the same seed).  The posterior is
``GWBPosterior(CommonProcess(pairs, nmodes=14, kron=True))``: the GWB
(log10 A, gamma) plus every pulsar's TNREDAMP and TNREDGAM, 138
dimensions.  Written arrays:

- ``param_names``, ``bounds``, ``scales``, ``center``;
- ``theta`` (8, ndim): ``center()``, six rows of
  ``initial_chains(6, seed=1, ball=1.0)`` and ``center()`` with
  log10 A = -30 (outside the prior), with JAX's ``lnprob`` and its
  ``jax.grad`` at each (``lnprob``, ``grad``);
- ``x0`` = ``initial_chains(4, seed=0)``, the start of the run below;
- the draws of ``run_nuts(n_chains=4, num_warmup=2, num_samples=2,
  chunk=4, num_leapfrog=12, seed=0)``, replayed from the key splits
  its transition makes (pint_tpu/gw/hmc.py:367, :371-372, :405): per
  draw and chain the standard-normal momentum vector ``draw_z``, the
  trajectory length ``draw_n_steps`` and the acceptance uniform
  ``draw_u``;
- that run's ``NUTSResult`` fields (``run_samples``, ``run_lnprob``,
  ``run_accept_rate``, ``run_step_size``, ``run_divergences``,
  ``run_warmup_samples``) and its accept decisions ``run_accepted``
  (a draw is accepted iff the chain moved);
- the commit.

Usage (from the repo root, ~4 min on 8 CPU cores)::

    JAX_PLATFORMS=cpu python tools/export_torch_hmc_case.py \\
        --out pint_tpu_torch/data/pta68_500_hmc.npz
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
from tools.export_torch_pta_case import make_pta  # noqa: E402

NMODES = 14
#: the injected-draw run of the chip check
RUN = dict(n_chains=4, num_warmup=2, num_samples=2, chunk=4,
           num_leapfrog=12, seed=0)


def replay_draws(ndim, n_chains, n_draws, num_leapfrog, seed):
    """(z (D, C, ndim), n_steps (D, C), u (D, C)): the random numbers
    ``run_nuts`` draws, from the same key splits, vmapped over chains
    as its transition is."""
    import jax
    import jax.numpy as jnp

    def one(key):
        k_p, k_len, k_acc, k_next = jax.random.split(key, 4)
        return (k_next, jax.random.normal(k_p, (ndim,)),
                jax.random.randint(k_len, (), 1, num_leapfrog + 1),
                jax.random.uniform(k_acc))

    step = jax.jit(jax.vmap(one))
    keys = jax.random.split(jax.random.PRNGKey(int(seed)), n_chains)
    zs, ns, us = [], [], []
    for _ in range(n_draws):
        keys, z, n, u = step(keys)
        zs.append(np.asarray(z))
        ns.append(np.asarray(n))
        us.append(np.asarray(u))
    return np.stack(zs), np.stack(ns).astype(np.int64), np.stack(us)


def posterior_answers(pairs, nmodes=NMODES, run=RUN):
    """The JAX arrays listed in the module docstring."""
    import jax
    import jax.numpy as jnp

    from pint_tpu.gw import CommonProcess, GWBPosterior, run_nuts

    t0 = time.time()
    post = GWBPosterior(CommonProcess(pairs, nmodes=nmodes, kron=True))
    print(f"build {time.time() - t0:.1f} s, ndim {post.ndim}, "
          f"sigma_dynamic {post.sigma_dynamic}", file=sys.stderr)
    data = post.data()
    c = post.center()
    oob = c.copy()
    oob[0] = -30.0
    theta = np.concatenate([c[None], post.initial_chains(6, seed=1,
                                                         ball=1.0),
                            oob[None]])
    vg = jax.jit(jax.vmap(jax.value_and_grad(
        lambda q: post.lnprob(q, data))))
    t0 = time.time()
    lnp, grad = [], []
    for i in range(0, len(theta), 4):
        v, g = vg(jnp.asarray(theta[i:i + 4]))
        lnp.append(np.asarray(v))
        grad.append(np.asarray(g))
    print(f"lnprob + grad at {len(theta)} theta {time.time() - t0:.1f} s",
          file=sys.stderr)
    n_draws = run["num_warmup"] + run["num_samples"]
    z, n_steps, u = replay_draws(post.ndim, run["n_chains"], n_draws,
                                 run["num_leapfrog"], run["seed"])
    x0 = post.initial_chains(run["n_chains"], seed=run["seed"])
    t0 = time.time()
    res = run_nuts(post, **run)
    print(f"run_nuts {time.time() - t0:.1f} s, accept "
          f"{res.accept_rate}", file=sys.stderr)
    path = np.concatenate([x0[None], np.asarray(res.warmup_samples),
                           np.asarray(res.samples)])
    accepted = np.any(path[1:] != path[:-1], axis=-1)
    return {
        "param_names": np.asarray(post.param_names, dtype=np.str_),
        "bounds": np.asarray(post.bounds),
        "scales": np.asarray(post.scales),
        "center": c,
        "nmodes": np.asarray(nmodes),
        "theta": theta,
        "lnprob": np.concatenate(lnp),
        "grad": np.concatenate(grad),
        "x0": x0,
        "run_n_chains": np.asarray(run["n_chains"]),
        "run_num_warmup": np.asarray(run["num_warmup"]),
        "run_num_samples": np.asarray(run["num_samples"]),
        "run_chunk": np.asarray(run["chunk"]),
        "run_num_leapfrog": np.asarray(run["num_leapfrog"]),
        "run_seed": np.asarray(run["seed"]),
        "draw_z": z, "draw_n_steps": n_steps, "draw_u": u,
        "run_samples": np.asarray(res.samples),
        "run_lnprob": np.asarray(res.lnprob),
        "run_accept_rate": np.asarray(res.accept_rate),
        "run_step_size": np.asarray(res.step_size),
        "run_divergences": np.asarray(res.divergences),
        "run_warmup_samples": np.asarray(res.warmup_samples),
        "run_accepted": accepted,
        "commit": np.asarray(_commit()),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    arrays = posterior_answers(make_pta())
    np.savez_compressed(a.out, **arrays)
    print(f"wrote {a.out}: ndim {len(arrays['param_names'])}, lnprob at "
          f"center {float(arrays['lnprob'][0]):.6f}, run accept rate "
          f"{float(arrays['run_accept_rate']):.4f}")


if __name__ == "__main__":
    main()
