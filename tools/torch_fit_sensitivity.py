"""How closely can any port reproduce pint_tpu's GLS step and covariance?

Builds the B1855-like epoch dataset of ``tools/export_torch_case.py``,
takes pint_tpu's residuals and hybrid design matrix at the starting
values, and solves the GLS normal equations three ways:

1. pint_tpu's ``gls_normal_solve`` as is (the reference);
2. the same, with the design matrix perturbed by one ulp at random
   (three draws) — how far the reference moves on its own;
3. pint_tpu_torch's ``gls_normal_solve`` on the same inputs (CPU).

Prints, for 2 and 3, the largest step difference in units of the
parameter uncertainty and the relative uncertainty differences per
parameter, beside the normal matrix's condition number kappa and
eps * kappa.  Usage (repo root)::

    JAX_PLATFORMS=cpu python tools/torch_fit_sensitivity.py \\
        --epochs 200 --channels 25
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--channels", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)

    import jax.numpy as jnp
    import torch

    from pint_tpu.fitter import GLSFitter
    from pint_tpu.linalg import gls_normal_solve as j_solve
    from pint_tpu_torch.linalg import gls_normal_solve as t_solve
    from pint_tpu_torch.linalg import structured_from_blocks
    from tools.export_torch_case import b1855_model, epoch_toas

    model = b1855_model()
    toas = epoch_toas(model, a.epochs, a.channels, seed=a.seed)
    f = GLSFitter(toas, model)
    vec = jnp.array([model.values[k] for k in f._traced_free])
    d = f._fit_data
    r, J = f._rj(vec, f.prepared._values_pytree(), d)
    r, J = np.asarray(r), np.asarray(J)
    sigma, phi = np.asarray(d["noise_sigma"]), np.asarray(d["noise_phi"])
    gram = np.asarray(d["noise_gram"])
    U = d["U_ext"]

    def reference(Jm):
        out = j_solve(jnp.asarray(r), jnp.asarray(Jm), jnp.asarray(sigma),
                      U, jnp.asarray(phi), gram=jnp.asarray(gram),
                      with_health=True)
        return (np.asarray(out[0]), np.sqrt(np.diag(np.asarray(out[1]))),
                float(out[4].cond_log10))

    d0, u0, cond = reference(J)
    print(f"{len(toas)} TOAs, free {list(f._traced_free)}")
    print(f"kappa = 10^{cond:.4f}, eps*kappa = "
          f"{np.finfo(float).eps * 10**cond:.3e}")
    rng = np.random.default_rng(1)
    eps = np.finfo(float).eps
    for i in range(3):
        Jp = J * (1.0 + eps * rng.choice([-1.0, 1.0], J.shape))
        d1, u1, _ = reference(Jp)
        print(f"reference, one-ulp J perturbation {i}: max |dstep|/sigma "
              f"{np.max(np.abs(d1 - d0) / u0):.3e}, |dsigma|/sigma per "
              f"param {np.array2string(np.abs(u1 / u0 - 1), precision=2)}")
    su = structured_from_blocks(np.asarray(U.pre), np.asarray(U.seg),
                                U.eslot.shape[0], np.asarray(U.post), "cpu")
    out = t_solve(torch.tensor(r), torch.tensor(J), torch.tensor(sigma), su,
                  torch.tensor(phi), gram=torch.tensor(gram))
    dt, ut = out[0].numpy(), np.sqrt(np.diag(out[1].numpy()))
    print(f"port, same inputs: max |dstep|/sigma "
          f"{np.max(np.abs(dt - d0) / u0):.3e}, |dsigma|/sigma per param "
          f"{np.array2string(np.abs(ut / u0 - 1), precision=2)}")


if __name__ == "__main__":
    main()
