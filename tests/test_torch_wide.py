"""Pulsars wider than one block of the narrow K5 holds (nb > 144), the
port's plain path against the JAX answers on the CPU.

``pint_tpu_torch/data/pta4_wide.npz`` (``tools/export_torch_tim_case.py``)
is a 4-pulsar array with 100 red-noise modes on every pulsar: each
capacity is ~203 columns wide.  On the card these shapes take the wide
forms K5w/K5bw (``tests/test_torch_cuda.py``); here the plain versions
compute ``lnlike``, a 2 x 2 ``lnlike_grid`` and the posterior's lnprob
and gradient, held to PERF.md's GW and HMC pins.
"""

import numpy as np
import pytest
import torch

from pint_tpu_torch import tolerances as tol
from pint_tpu_torch.convert import PTA4_WIDE, load_arrays, \
    pta_case_from_arrays
from pint_tpu_torch.gw.common import CommonProcess
from pint_tpu_torch.gw.hmc import GWBPosterior
from pint_tpu_torch.linalg import _k5_shape

# one intra-op thread: the tests run at small sizes, and pytest-xdist's
# workers share the machine's cores (torch's default of one thread per
# core in every worker oversubscribes them several times over)
torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def wide():
    arrays = load_arrays(PTA4_WIDE)
    crn = CommonProcess(pta_case_from_arrays(arrays),
                        nmodes=int(arrays["ref_nmodes"]), device=CPU)
    return arrays, crn


def test_case_is_wide(wide):
    _, crn = wide
    post = GWBPosterior(crn)
    nb = post.gram.g_uu.shape[-1]
    m2 = post.gram.g_ff.shape[-1]
    assert nb > 144
    assert _k5_shape(nb, m2) == ("wide", "wide")


def test_lnlike_and_grid_match_jax(wide):
    arrays, crn = wide
    la, ga = (float(x) for x in arrays["ref_lnlike_point"])
    lnl = crn.lnlike(la, ga)
    assert abs(lnl / float(arrays["ref_lnlike"]) - 1) <= tol.GW_LNLIKE_REL
    surf = crn.lnlike_grid(arrays["ref_grid_log10_amp"],
                           arrays["ref_grid_gamma"])
    assert np.max(np.abs(surf / arrays["ref_grid_lnlike"] - 1)) \
        <= tol.GW_LNLIKE_REL


def test_posterior_value_and_grad_match_jax(wide):
    arrays, crn = wide
    post = GWBPosterior(crn)
    assert post.param_names == [str(n) for n in arrays["ref_param_names"]]
    lnp, g = (a.numpy() for a in post.value_and_grad(
        torch.as_tensor(arrays["ref_theta"])))
    ref_lnp, ref_g = arrays["ref_lnprob"], arrays["ref_grad"]
    assert np.max(np.abs(lnp / ref_lnp - 1)) <= tol.GW_LNLIKE_REL
    for i in range(len(ref_lnp)):
        assert np.max(np.abs(g[i] - ref_g[i])) / np.max(np.abs(ref_g[i])) \
            <= tol.HMC_GRAD_REL
