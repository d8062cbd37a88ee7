"""Kernels K1 and K2 on the card against their plain PyTorch versions.

These tests need an NVIDIA GPU with nvcc (Hopper, sm_90a) and skip
without one.  They import nothing of JAX, so they also run on a machine
without it; tests/conftest.py imports JAX, so there run them with::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    return torch.device("cuda")


def test_k1_bit_identical_to_plain(card):
    from pint_tpu_torch import fixedpoint as fp

    rng = np.random.default_rng(0)
    f0 = torch.tensor(rng.uniform(1.0, 2048.0, 100_000))
    tmax = np.minimum(2.0**62, 0.999 * 2.0**43 / f0.numpy() * 2.0**32)
    t = torch.tensor(np.round(rng.uniform(-1, 1, f0.numel()) * tmax)
                     .astype(np.int64))
    n_ref, frac_ref = fp.phase_f0_t_plain(f0, t)
    n, frac = fp.phase_f0_t_cuda(f0.to(card), t.to(card))
    assert torch.equal(n.cpu(), n_ref)
    assert torch.equal(frac.cpu().view(torch.int64),
                       frac_ref.view(torch.int64))
    # a scalar F0 through the custom op, as the fit calls it
    n1, frac1 = fp.phase_f0_t(f0[0].to(card), t.to(card))
    n1_ref, frac1_ref = fp.phase_f0_t_plain(f0[0], t)
    assert torch.equal(n1.cpu(), n1_ref)
    assert torch.equal(frac1.cpu().view(torch.int64),
                       frac1_ref.view(torch.int64))


@pytest.mark.parametrize("m", [1, 10, 61])
def test_k2_bit_identical_and_deterministic(card, m):
    from pint_tpu_torch import linalg as tl

    rng = np.random.default_rng(m)
    seg = rng.integers(0, 401, 10_000)
    perm, offsets = (torch.tensor(a) for a in tl.epoch_csr(seg, 400))
    x = torch.tensor(rng.standard_normal((10_000, m)) * 1e6)
    ref = tl.segment_sum_plain(x, perm, offsets)
    a = tl.segment_sum_cuda(x.to(card), perm.to(card), offsets.to(card))
    b = tl.segment_sum_cuda(x.to(card), perm.to(card), offsets.to(card))
    assert torch.equal(a.cpu().view(torch.int64), ref.view(torch.int64))
    assert torch.equal(a.view(torch.int64), b.view(torch.int64))


def test_fit_on_card_counts_launches(card):
    from pint_tpu_torch.convert import load_case
    from pint_tpu_torch.fitter import GLSFitter
    from pint_tpu_torch.fixedpoint import K1
    from pint_tpu_torch.linalg import K2

    arrays, model, toas, tzr = load_case()
    K1.launches = K2.launches = 0
    GLSFitter(toas, model, tzr, device=card).fit_toas(maxiter=3)
    assert K1.launches > 0 and K2.launches > 0
    free = [str(p) for p in arrays["free_params"]]
    d = np.array([model.values[k] for k in free]) \
        - arrays["ref_fitted_values"]
    assert np.max(np.abs(d) / arrays["ref_uncertainties"]) < 1e-6
