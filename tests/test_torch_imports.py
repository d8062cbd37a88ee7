"""The port's boundaries: no JAX, no pint_tpu, CUDA unless told otherwise.

- ``import pint_tpu_torch`` (every module) leaves ``jax`` and
  ``pint_tpu`` out of ``sys.modules`` (a fresh subprocess), and an AST
  scan finds no import of either in the package or in chip_smoke.py;
- entry points default to CUDA and raise without it, unless given
  ``device="cpu"``;
- the hand-written kernels (``csrc/*.cu``) include no Python, PyTorch
  or JAX header: each is a plain C launcher that nvcc builds in seconds;
- chip_smoke.py exits non-zero and prints no result without a card, and
  in a directory that holds nothing else of the repo.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# one intra-op thread: the tests run at small sizes, and pytest-xdist's
# workers share the machine's cores (torch's default of one thread per
# core in every worker oversubscribes them several times over)
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "pint_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "pint_tpu")


def _modules():
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(REPO).with_suffix("")
        yield ".".join(rel.parts).removesuffix(".__init__")


def test_import_leaves_jax_and_pint_tpu_out():
    mods = list(_modules())
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len(bad), bad[:5])\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(REPO)) for p in PKG.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, f"{path}: {n}"


def test_gw_modules_are_scanned():
    mods = set(_modules())
    assert {"pint_tpu_torch.gw", "pint_tpu_torch.gw.orf",
            "pint_tpu_torch.gw.common", "pint_tpu_torch.gw.os"} <= mods


def test_hmc_modules_are_scanned():
    assert {"pint_tpu_torch.gw.hmc", "pint_tpu_torch.iterate"} \
        <= set(_modules())


def test_grid_and_downhill_modules_are_scanned():
    assert {"pint_tpu_torch.grid", "pint_tpu_torch.downhill"} \
        <= set(_modules())


def test_k8_wrapper_never_falls_back():
    """K8's wrapper raises on CPU tensors; its plain version runs only
    through the dispatcher, for CPU tensors."""
    from pint_tpu_torch import linalg as tl

    f64 = dict(dtype=torch.float64)
    i32 = dict(dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tl.woodbury_chi2_pre_cuda(
            torch.ones((2, 4), **f64), torch.ones(4, **f64),
            torch.ones((4, 1), **f64), torch.zeros(0, **i32),
            torch.zeros(1, **i32), torch.ones((4, 1), **f64),
            torch.eye(2, **f64))
    assert tl.K8.launches == 0


def test_bayesian_and_sampler_modules_are_scanned():
    assert {"pint_tpu_torch.bayesian", "pint_tpu_torch.sampler"} \
        <= set(_modules())


def test_k9_wrapper_never_falls_back():
    """K9's wrapper raises on CPU tensors, and the dispatcher on a device
    with no version; the plain stages run only for CPU tensors."""
    from pint_tpu_torch import sampler as ts

    f64 = dict(dtype=torch.float64)
    buf = ts.StretchBuffers.around(torch.zeros((4, 3), **f64),
                                   torch.zeros(4, **f64))
    u = torch.full((2,), 0.5, **f64)
    d = (u, torch.zeros(2, dtype=torch.int64), u)
    with pytest.raises(ValueError, match="CUDA"):
        ts.stretch_move_cuda(buf, 0, (d, None))
    with pytest.raises(ValueError, match="CUDA"):
        ts.stretch_move_cuda(buf, 2, (None, d))
    meta = ts.StretchBuffers(*(t.to("meta") for t in buf))
    with pytest.raises(ValueError, match="no version"):
        ts.stretch_move(meta, 0, (tuple(t.to("meta") for t in d), None))
    assert ts.K9.launches == 0


def test_photon_modules_are_scanned():
    assert {"pint_tpu_torch.fits", "pint_tpu_torch.event_toas",
            "pint_tpu_torch.eventstats", "pint_tpu_torch.templates",
            "pint_tpu_torch.mcmc_fitter"} <= set(_modules())


def test_k12_wrapper_never_falls_back():
    """K12's and K12b's wrappers raise on CPU tensors, and the
    dispatchers on a device with no version; the plain versions run only
    for CPU tensors."""
    from pint_tpu_torch import templates as tt

    f64 = dict(dtype=torch.float64)
    t = tt.LCTemplate([tt.LCGaussian()])
    types, rows, bg = tt.pack_template(t, torch.tensor(t.params))
    args = (torch.zeros((1, 8), **f64), None, types, rows[None],
            bg.reshape(1))
    with pytest.raises(ValueError, match="CUDA"):
        tt.photon_lnlike_cuda(*args)
    with pytest.raises(ValueError, match="CUDA"):
        tt.photon_lnlike_cuda(*args, density=True)
    with pytest.raises(ValueError, match="CUDA"):
        tt.photon_lnlike_bwd_cuda(*args)
    meta = tuple(None if a is None else a.to("meta") for a in args)
    with pytest.raises(ValueError, match="no version"):
        tt.photon_lnlike(*meta)
    with pytest.raises(ValueError, match="no version"):
        tt.photon_density(meta[0], *meta[2:])
    assert tt.K12.launches == 0 and tt.K12B.launches == 0


def test_ingest_modules_are_scanned():
    assert {"pint_tpu_torch.time", "pint_tpu_torch.time.mjd",
            "pint_tpu_torch.time.scales", "pint_tpu_torch.ephem",
            "pint_tpu_torch.ephem.analytic", "pint_tpu_torch.ephem.compiled",
            "pint_tpu_torch.obs",
            "pint_tpu_torch.obs.clock", "pint_tpu_torch.obs.datadirs",
            "pint_tpu_torch.obs.erot", "pint_tpu_torch.obs.iers",
            "pint_tpu_torch.toa", "pint_tpu_torch.models.parameter",
            "pint_tpu_torch.models.builder",
            "pint_tpu_torch.simulation"} <= set(_modules())


def test_ingest_reads_jax_data_in_place():
    """The builtin ephemeris and the runtime clock files are the JAX
    package's, read by path; nothing is copied into the port."""
    from pint_tpu_torch import DATA_DIR
    from pint_tpu_torch.ephem.compiled import data_path
    from pint_tpu_torch.obs.datadirs import builtin_runtime_dir

    data = REPO / "pint_tpu" / "data"
    assert Path(DATA_DIR) == data
    assert Path(data_path()) == data / "ephem_builtin.npz"
    assert Path(builtin_runtime_dir()) == data / "runtime"
    assert not any(p.suffix in (".clk", ".bsp") or p.name.startswith(
        "ephem_builtin") for p in PKG.rglob("*"))


def test_wls_and_wide_wrappers_never_fall_back():
    """K7's wrapper and the wide K5/K5b route raise on CPU tensors."""
    from pint_tpu_torch import linalg as tl

    with pytest.raises(ValueError, match="CUDA"):
        tl.wls_whiten_cuda(*(torch.ones(s, dtype=torch.float64)
                             for s in ((4,), (4, 2), (4,))))
    pre = tl.KronGram(*(torch.zeros(s, dtype=torch.float64) for s in (
        (1, 200, 200), (1, 200, 4), (1, 4, 4), (1, 200), (1, 4), (1,),
        (1,))))
    with pytest.raises(ValueError, match="CUDA"):
        tl.kron_pulsar_cuda(pre, torch.ones((1, 1, 200),
                                            dtype=torch.float64))
    assert tl.K7.launches == tl.K5W.launches == tl.K5BW.launches == 0


def test_hmc_wrappers_never_fall_back():
    """The CUDA wrappers of K5, K5b and K6 raise on CPU tensors: a
    kernel's plain version runs only through the dispatchers, and only
    for CPU tensors."""
    from pint_tpu_torch import linalg as tl
    from pint_tpu_torch.gw import hmc

    pre = tl.KronGram(*(torch.zeros(s, dtype=torch.float64) for s in (
        (2, 3, 3), (2, 3, 4), (2, 4, 4), (2, 3), (2, 4), (2,), (2,))))
    phi = torch.ones((1, 2, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        tl.kron_pulsar_cuda(pre, phi)
    L, X = torch.ones((1, 2, 3, 3)), torch.ones((1, 2, 3, 5))
    with pytest.raises(ValueError, match="CUDA"):
        tl.kron_pulsar_bwd_cuda(phi, L, X, *(torch.zeros(s) for s in (
            (1, 2), (1, 2, 4), (1, 2, 4, 4), (1, 2))))
    st = hmc.NutsState(torch.zeros((2, 3), dtype=torch.float64),
                       torch.zeros((2, 3), dtype=torch.float64),
                       torch.zeros(2, dtype=torch.float64),
                       torch.ones(3, dtype=torch.float64), 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        hmc._k6_launch(st, 0)
    assert hmc.K6.launches == 0 and tl.K5.launches == 0


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in (PKG / "csrc").glob("*.cu")))
def test_kernel_sources_are_plain_c(path):
    text = (REPO / path).read_text()
    includes = [ln.split()[1] for ln in text.splitlines()
                if ln.startswith("#include")]
    for inc in includes:
        assert not any(w in inc for w in ("torch", "Python", "pybind",
                                          "ATen", "jax")), (path, inc)
    assert 'extern "C"' in text
    head = text[:600]
    assert "Replaces" in head and "pint_tpu/" in head, path


def test_entry_points_default_to_cuda(monkeypatch):
    from pint_tpu_torch import resolve_device
    from pint_tpu_torch.convert import load_case
    from pint_tpu_torch.fitter import GLSFitter
    from pint_tpu_torch.residuals import Residuals

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, model, toas, tzr = load_case()
    for make in (lambda: GLSFitter(toas, model, tzr),
                 lambda: Residuals(toas, model, tzr),
                 lambda: model.prepare(toas, tzr),
                 lambda: GLSFitter(toas, model, tzr, device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert resolve_device("cpu").type == "cpu"
    assert model.prepare(toas, tzr, device="cpu").device.type == "cpu"


def test_fit_from_par_tim_defaults_to_cuda(monkeypatch):
    from pint_tpu_torch.convert import B1855_PAR, B1855_TIM
    from pint_tpu_torch.fitter import GLSFitter, WLSFitter
    from pint_tpu_torch.models.builder import get_model_and_toas
    from pint_tpu_torch.simulation import make_fake_toas_uniform

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, toas = get_model_and_toas(str(B1855_PAR), str(B1855_TIM))
    for make in (lambda: WLSFitter(toas, model),
                 lambda: GLSFitter(toas, model),
                 lambda: WLSFitter(toas, model, device="cuda"),
                 lambda: make_fake_toas_uniform(54000, 54100, 3, model)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_gw_entry_points_default_to_cuda(monkeypatch):
    from pint_tpu_torch.convert import load_case
    from pint_tpu_torch.gw.common import CommonProcess, build_pulsar_data
    from pint_tpu_torch.gw.os import OptimalStatistic

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, model, toas, tzr = load_case()
    pairs = [(model, toas, tzr)] * 2
    for make in (lambda: OptimalStatistic(pairs),
                 lambda: CommonProcess(pairs),
                 lambda: build_pulsar_data(pairs),
                 lambda: OptimalStatistic(pairs, device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_chip_smoke_refuses_without_card(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    runs = [(REPO, REPO / "chip_smoke.py")]
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    runs.append((tmp_path, alone))
    for cwd, script in runs:
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
