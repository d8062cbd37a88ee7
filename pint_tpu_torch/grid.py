"""Chi^2 grids batched over points (pint_tpu grid.py).

Each grid point freezes the gridded parameters at its values and refits
the remaining free parameters by a fixed number of Gauss-Newton steps;
the whole grid is ``torch.func.vmap`` of that per-point fit, so every
step runs once for all points: the phase fold's kernel K1 over G x N
ticks, the segment sums of kernel K2 with the points folded into the
columns, batched ``eigh`` (GLS) or kernel K7 and batched ``svd`` (WLS),
and the final chi^2 through kernel K8 against a capacity factor built
once.  No kernel is launched once per point.

As in the reference, the components that own neither a gridded nor a
refit parameter are folded once (frozen delays), the design is the
hybrid one over the refit parameters, and when no gridded or refit
parameter touches the noise model sigma, phi, the (K, K) noise gram and
the Woodbury factor are built once.  The points run on CUDA unless the
caller passes ``device="cpu"``.  Not ported: ``mesh=`` (sharding the
points over several cards).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from pint_tpu_torch import resolve_device
from pint_tpu_torch.fitter import resid_and_design, wls_gn_solve
from pint_tpu_torch.iterate import iterate_fixed
from pint_tpu_torch.linalg import (gls_normal_solve, noise_gram_precompute,
                                   woodbury_chi2_logdet_pre,
                                   woodbury_precompute)
from pint_tpu_torch.residuals import Residuals

__all__ = ["grid_chisq", "grid_chisq_vectorized", "make_grid_fn",
           "grid_chisq_tuple", "grid_chisq_derived",
           "grid_chisq_derived_tuple"]


def _make_fit_one(resids, grid_params, fit_params, n_steps):
    """``(fit_one, partition_record)``: ``fit_one(grid_vec) -> (chi2,
    fitted_values)`` is the per-point refit, a pure function of the
    point's values; everything the dataset fixes is built here, once."""
    prepared = resids.prepared
    model = prepared.model
    base = prepared.values_dict()
    correlated = model.has_correlated_errors
    grid_params, fit_params = tuple(grid_params), tuple(fit_params)

    frozen_names = prepared.frozen_delay_split(grid_params + fit_params)
    frozen, tzr_frozen = prepared.frozen_delay_leaves(frozen_names)
    data = {}
    if frozen is not None:
        data["frozen"] = frozen
        if tzr_frozen is not None:
            data["tzr_frozen"] = tzr_frozen
    # the hybrid partition over the refit parameters only: the gridded
    # ones are constants of each point
    partition = prepared.design_partition(fit_params, frozen=frozen_names)
    partition_record = {
        "n_linear": len(partition[0]),
        "n_nonlinear": len(partition[1]),
        "n_frozen": len(frozen_names),
        "frozen": tuple(frozen_names),
        "linear": tuple(partition[0]),
        "nonlinear": tuple(partition[1]),
    }

    noise_owned = {p for c in model.noise_components for p in c.params}
    sigma_frozen = noise_owned.isdisjoint(set(grid_params) | set(fit_params))
    sigma_const = pre = phi_const = gram_const = None
    if sigma_frozen:
        with torch.no_grad():
            sigma_const = resids.sigma_at(base)
            if correlated:
                U, phi_const = resids._noise_basis_phi_at(base)
                pre = woodbury_precompute(sigma_const, U, phi_const)
                gram_const = noise_gram_precompute(sigma_const, U,
                                                   phi_const)
    fit0 = torch.tensor([model.values[k] for k in fit_params],
                        dtype=torch.float64, device=resids.device)

    def fit_one(grid_vec):
        grid_sub = {name: grid_vec[i] for i, name in enumerate(grid_params)}

        def values_of(sub):
            values = dict(base)
            values.update(grid_sub)
            values.update(sub)
            return values

        def fit_sub(fit_vec):
            return {name: fit_vec[i] for i, name in enumerate(fit_params)}

        def gn_step(fit_vec):
            values = values_of(fit_sub(fit_vec))
            sigma = (sigma_const if sigma_const is not None
                     else resids.sigma_at(values))
            r, J = resid_and_design(
                fit_params, fit_vec, partition,
                lambda sub: resids.time_resids_at(values_of(sub), data),
                lambda sub: resids.linear_design_at(values_of(sub),
                                                    partition[0], data))
            if correlated:
                if pre is not None:
                    dpar = gls_normal_solve(r, J, sigma, pre.U, phi_const,
                                            gram=gram_const)[0]
                else:
                    U, phi = resids._noise_basis_phi_at(values)
                    dpar = gls_normal_solve(r, J, sigma, U, phi)[0]
            else:
                dpar = wls_gn_solve(r, J, sigma)[0]
            return fit_vec + dpar

        vec = fit0
        if fit_params:  # with every parameter gridded: chi^2 only
            vec = iterate_fixed(gn_step, fit0, n_steps)
        values = values_of(fit_sub(vec))
        if pre is not None:
            r = resids.time_resids_at(values, data)
            chi2 = woodbury_chi2_logdet_pre(r, pre)[0]
        elif sigma_const is not None and not correlated:
            r = resids.time_resids_at(values, data)
            chi2 = torch.sum((r / sigma_const) ** 2)
        else:
            chi2 = resids.chi2_at(values)
        return chi2, vec

    return fit_one, partition_record


def make_grid_fn(toas, model, grid_params, n_steps=3, tzr=None,
                 device=None):
    """Build once, call many times: returns ``(fn, fit_params,
    partition)`` where ``fn(grid_values (n, k)) -> (chi2 (n,), fitted
    (n, nfree))`` on the device (``fn.resids`` is the
    :class:`Residuals` it runs on), and ``partition`` records the frozen
    components and the hybrid split this build chose."""
    resids = Residuals(toas, model, tzr=tzr, device=resolve_device(device))
    grid_params = list(grid_params)
    if any(p in ("ECC", "EDOT") for p in grid_params):
        # a gridded eccentricity may lie anywhere: the Newton depth must
        # cover the full e < 0.97 unroll (a refit-only ECC keeps its
        # class: each point's refit is a local polish around the base)
        resids.prepared.ensure_kepler_depth(float("nan"))
    fit_params = [p for p in model.free_timing_params
                  if p not in grid_params]
    fit_one, partition = _make_fit_one(resids, grid_params, fit_params,
                                       n_steps)
    batched = torch.func.vmap(fit_one)

    def fn(grid_values):
        gv = torch.as_tensor(np.asarray(grid_values, np.float64),
                             device=resids.device)
        return batched(gv)

    fn.resids = resids
    return fn, fit_params, partition


def grid_chisq_vectorized(toas, model, grid_params, grid_values, n_steps=3,
                          chunk=None, tzr=None, device=None):
    """chi^2 over an (npoints, len(grid_params)) array of grid values.

    Returns (chi2 (npoints,), fitted free parameters (npoints, nfree)) as
    numpy arrays.  ``chunk`` bounds device memory: the points go through
    in batches of at most ``chunk``, each one batched call."""
    grid_values = np.asarray(grid_values, dtype=np.float64)
    fn, _, _ = make_grid_fn(toas, model, grid_params, n_steps, tzr=tzr,
                            device=device)
    n = grid_values.shape[0]
    step = n if chunk is None or n <= chunk else int(chunk)
    outs = [fn(grid_values[i:i + step]) for i in range(0, n, step)]
    chi2 = torch.cat([o[0] for o in outs])
    fitted = torch.cat([o[1] for o in outs])
    return chi2.detach().cpu().numpy(), fitted.detach().cpu().numpy()


def grid_chisq_tuple(toas, model, param_names, points, n_steps=3,
                     chunk=None, tzr=None, device=None):
    """chi^2 at an explicit list of parameter tuples (a Monte-Carlo scan,
    a contour's points) instead of a dense mesh.  A diverged refit or an
    unphysical point yields NaN/inf chi^2 for that point only.  Returns
    (chi2 (npoints,), fitted free parameters (npoints, nfree))."""
    return grid_chisq_vectorized(
        toas, model, list(param_names), np.asarray(points, np.float64),
        n_steps=n_steps, chunk=chunk, tzr=tzr, device=device)


def grid_chisq(toas, model, param_names, param_arrays, n_steps=3,
               chunk=None, tzr=None, device=None):
    """Dense mesh grid: ``param_arrays`` are 1-D axes; returns chi^2 of
    shape (len(axis1), len(axis2), ...)."""
    axes = [np.asarray(a, dtype=np.float64) for a in param_arrays]
    pts = np.array(list(itertools.product(*axes)))
    chi2, _ = grid_chisq_vectorized(toas, model, param_names, pts,
                                    n_steps=n_steps, chunk=chunk, tzr=tzr,
                                    device=device)
    return chi2.reshape([len(a) for a in axes])


def grid_chisq_derived(toas, model, param_names, parfuncs, grid_arrays,
                       n_steps=3, chunk=None, tzr=None, device=None):
    """chi^2 over a grid of derived coordinates: ``parfuncs[i]`` maps a
    coordinate tuple to the value of ``param_names[i]`` (a grid over
    (Mtot, q) of a model fit in (M2, SINI), say); ``grid_arrays`` are
    the coordinates' 1-D axes.  Returns (chi2 shaped like the mesh,
    parameter values (npoints, k))."""
    axes = [np.asarray(a, dtype=np.float64) for a in grid_arrays]
    mesh = np.array(list(itertools.product(*axes)))
    chi2, pvals = grid_chisq_derived_tuple(
        toas, model, param_names, parfuncs, mesh, n_steps=n_steps,
        chunk=chunk, tzr=tzr, device=device)
    return chi2.reshape([len(a) for a in axes]), pvals


def grid_chisq_derived_tuple(toas, model, param_names, parfuncs, points,
                             n_steps=3, chunk=None, tzr=None, device=None):
    """Derived-coordinate chi^2 at an explicit list of coordinate tuples.
    Returns (chi2 (npoints,), parameter values (npoints, k))."""
    pts = np.asarray(points, np.float64)
    pvals = np.stack(
        [np.asarray([f(*pt) for pt in pts], dtype=np.float64)
         for f in parfuncs], axis=1)
    chi2, _ = grid_chisq_vectorized(
        toas, model, list(param_names), pvals, n_steps=n_steps,
        chunk=chunk, tzr=tzr, device=device)
    return chi2, pvals
