"""Input the port does not take yet raises ``NotImplementedError`` and
names its ROADMAP queue 1 item (ROADMAP, "Unported means raise"), on
the CPU: overlapping ECORR epochs and a second ECORR component (item 3),
sampled names that change sigma or are not PLRedNoise's (item 8),
``run_nuts(mesh=)`` (item 8) and ``run_nuts(checkpoint=)`` (item 2),
the reverse-mode rule of ``segment_sum`` (item 11), and of the PTA batch
``fit_wideband`` (item 10), ``mesh=``, ``chisq_grid`` and members of
different mask families (item 13), ``checkpoint=`` and the checkpoints
(item 2) and the GW statistics from a batch (item 8); on the photon
side an event file's ``orbfile=`` (item 1), a primitive kernel K12 does
not cover on the card, the energy-dependent templates and the template
fit's Hessian on the card (item 14), and ``MCMCFitter.fit_toas(
checkpoint=)`` (item 2)."""

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
from pint_tpu_torch.parallel import PTABatch
from pint_tpu_torch.simulation import make_fake_toas_fromMJDs
from tests.test_torch_hmc import _flagged_array
from tools.export_torch_pta_case import pta_case_arrays

# one intra-op thread: the tests run at small sizes, and pytest-xdist's
# workers share the machine's cores (torch's default of one thread per
# core in every worker oversubscribes them several times over)
torch.set_num_threads(1)

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


@functools.lru_cache(maxsize=None)
def _batch():
    pairs = []
    for extra in ("", "BINARY DD\nPB 8.3\nA1 6.1\nT0 54500.2\nECC 0.1\n"):
        m = get_model(PAR + extra)
        pairs.append((m, _pair_toas(m)))
    return PTABatch(pairs, device="cpu")


def _batch_call(name, *args, **kw):
    getattr(_batch(), name)(*args, **kw)


def _mask_families():
    pairs = []
    for extra in ("EFAC -f fake 1.1\n",
                  "EFAC -f fake 1.1\nEFAC -f other 1.2\n"):
        m = get_model(PAR + extra)
        pairs.append((m, _pair_toas(m)))
    PTABatch(pairs, device="cpu")


def _orbfile():
    from pint_tpu_torch.event_toas import load_event_TOAs

    load_event_TOAs("events.fits", "nicer", orbfile="orbit.fits")


def _k12_top_hat():
    from pint_tpu_torch import templates as tt

    t = tt.LCTemplate([tt.LCGaussian(), tt.LCTopHat()])
    tt.pack_template(t, torch.tensor(t.params))


def _energy(name):
    from pint_tpu_torch import templates as tt

    getattr(tt, name)()


def _lcfit_hessian_on_card():
    from pint_tpu_torch import templates as tt

    f = tt.LCFitter(tt.LCTemplate([tt.LCGaussian()]), [0.1, 0.5],
                    device="cpu")
    f.device = torch.device("cuda")
    f.param_uncertainties()


def _mcmc_checkpoint():
    from pint_tpu_torch.mcmc_fitter import MCMCFitter
    from pint_tpu_torch.templates import LCGaussian, LCTemplate

    m = get_model(PAR)
    toas = _pair_toas(m)
    MCMCFitter(toas, m, LCTemplate([LCGaussian()]), device="cpu",
               priors={n: None for n in m.free_params}).fit_toas(
        checkpoint="chain.npz")


#: {case: (call, the queue item its message names)}
CASES = {
    "event orbfile": (_orbfile, 1),
    "K12 primitive not covered": (_k12_top_hat, 14),
    "LCEGaussian": (functools.partial(_energy, "LCEGaussian"), 14),
    "LCETemplate": (functools.partial(_energy, "LCETemplate"), 14),
    "LCEFitter": (functools.partial(_energy, "LCEFitter"), 14),
    "ENormAngles": (functools.partial(_energy, "ENormAngles"), 14),
    "LCFitter Hessian on the card": (_lcfit_hessian_on_card, 14),
    "MCMCFitter checkpoint": (_mcmc_checkpoint, 2),
    "overlapping ECORR epochs": (_overlapping_ecorr, 3),
    "two ECORR components": (_two_ecorr_components, 3),
    "sampled name changes sigma": (functools.partial(_sampled, "EFAC1"), 8),
    "sampled name not PLRedNoise's": (functools.partial(_sampled, "F0"), 8),
    "run_nuts mesh": (functools.partial(_run_nuts, mesh=object()), 8),
    "run_nuts checkpoint": (functools.partial(
        _run_nuts, checkpoint="chains.npz"), 2),
    "segment_sum backward": (_segment_sum_backward, 11),
    "PTABatch fit_wideband": (functools.partial(
        _batch_call, "fit_wideband"), 10),
    "PTABatch mesh": (functools.partial(
        _batch_call, "fit_wls", mesh=object()), 13),
    "PTABatch checkpoint": (functools.partial(
        _batch_call, "fit_gls", checkpoint="fit.npz"), 2),
    "PTABatch chisq_grid": (functools.partial(
        _batch_call, "chisq_grid", ("F0",), [[100.0]]), 13),
    "PTABatch save_checkpoint": (functools.partial(
        _batch_call, "save_checkpoint", "fit.npz"), 2),
    "PTABatch optimal_statistic": (functools.partial(
        _batch_call, "optimal_statistic"), 8),
    "PTABatch mask families": (_mask_families, 13),
}


@pytest.mark.parametrize("case", list(CASES))
def test_unported_input_names_its_queue_item(case):
    call, item = CASES[case]
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP queue 1 item {item}\b"):
        call()
