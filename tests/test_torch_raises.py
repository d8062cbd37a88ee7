"""Input the port does not take yet raises ``NotImplementedError`` and
names its ROADMAP queue 1 item (ROADMAP, "Unported means raise"), on
the CPU: overlapping ECORR epochs and a second ECORR component (item 3),
sampled names that change sigma or are not PLRedNoise's (item 8),
``run_nuts(mesh=)`` (item 8) and ``run_nuts(checkpoint=)`` (item 2), and
the reverse-mode rule of ``segment_sum`` (item 11)."""

import functools

import pytest
import torch

from pint_tpu_torch.convert import pta_case_from_arrays
from pint_tpu_torch.gw.common import CommonProcess
from pint_tpu_torch.gw.hmc import GWBPosterior, run_nuts
from pint_tpu_torch.linalg import segment_sum_fixed_order
from pint_tpu_torch.models.builder import get_model
from pint_tpu_torch.models.noise import EcorrNoise
from pint_tpu_torch.models.timing_model import TimingModel
from pint_tpu_torch.simulation import make_fake_toas_fromMJDs
from tests.test_torch_hmc import _flagged_array
from tools.export_torch_pta_case import pta_case_arrays

PAR = ("PSR FAKE\nRAJ 04:00:00\nDECJ +10:00:00\nF0 100.0 1\nF1 -1e-15 1\n"
       "PEPOCH 54500\nDM 10\nTZRMJD 54500\nTZRSITE @\nTZRFRQ 1400\n"
       "UNITS TDB\nEPHEM builtin\n")


def _pair_toas(model):
    """Ten epochs of two TOAs 0.09 s apart (one ECORR epoch each)."""
    mjds = [53000.0 + 30.0 * i + d for i in range(10) for d in (0.0, 1e-6)]
    return make_fake_toas_fromMJDs(mjds, model, flags={"f": "fake"},
                                   device="cpu")


def _overlapping_ecorr():
    m = get_model(PAR + "ECORR -f fake 0.4\nECORR -f fake 0.3\n")
    m.prepare(_pair_toas(m), device="cpu")


class _SecondEcorr(EcorrNoise):
    """A second component of ECORR's category."""


def _two_ecorr_components():
    m = get_model(PAR + "ECORR -f fake 0.4\n")
    ecorr = m.component("EcorrNoise")
    two = TimingModel(list(m.components) + [_SecondEcorr(ecorr.selects)],
                      values=m.values, epoch_ticks=m.epoch_ticks,
                      free_params=m.free_params, name=m.name)
    two.meta = dict(m.meta)
    two.prepare(_pair_toas(m), device="cpu").structured_basis()


@functools.lru_cache(maxsize=None)
def _crn():
    tpairs = pta_case_from_arrays(pta_case_arrays(_flagged_array()))
    return CommonProcess(tpairs, nmodes=2, device="cpu")


def _sampled(name):
    GWBPosterior(_crn(), sample=("TNREDAMP", name))


def _run_nuts(**kw):
    run_nuts(GWBPosterior(_crn()), num_warmup=1, num_samples=1,
             n_chains=2, **kw)


def _segment_sum_backward():
    x = torch.ones((4, 2), dtype=torch.float64, requires_grad=True)
    perm = torch.arange(4, dtype=torch.int32)
    offsets = torch.tensor([0, 2, 4], dtype=torch.int32)
    segment_sum_fixed_order(x, perm, offsets).sum().backward()


#: {case: (call, the queue item its message names)}
CASES = {
    "overlapping ECORR epochs": (_overlapping_ecorr, 3),
    "two ECORR components": (_two_ecorr_components, 3),
    "sampled name changes sigma": (functools.partial(_sampled, "EFAC1"), 8),
    "sampled name not PLRedNoise's": (functools.partial(_sampled, "F0"), 8),
    "run_nuts mesh": (functools.partial(_run_nuts, mesh=object()), 8),
    "run_nuts checkpoint": (functools.partial(
        _run_nuts, checkpoint="chains.npz"), 2),
    "segment_sum backward": (_segment_sum_backward, 11),
}


@pytest.mark.parametrize("case", list(CASES))
def test_unported_input_names_its_queue_item(case):
    call, item = CASES[case]
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP queue 1 item {item}\b"):
        call()
