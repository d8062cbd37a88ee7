"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/*.cu`` file exports a plain C launcher (``extern "C"``)
that enqueues its kernel on the stream it is given and returns
``cudaGetLastError()``.  The launcher is compiled with ``nvcc`` into a
shared library on first use and bound with :mod:`ctypes`; nothing here
includes PyTorch's headers, so a build takes seconds.

Libraries land in ``build/pint_tpu_torch/`` next to the package (the
repo's ``.gitignore`` lists ``build/``), named by a hash of their
source, so an edited kernel is rebuilt and never served stale.
``-fmad=false`` keeps every multiply and add separately rounded: the
kernels must round exactly as their plain PyTorch versions do on the
CPU (it does not reach the fp64 tensor-core MMA of K3 and K5).
``-Xptxas=-v`` makes ptxas report each kernel's registers and spills;
the compiler's output is kept beside the library (:func:`build_log`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "pint_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler",
              "-fPIC")


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from csrc/ at first use")


def library_path(source: str) -> Path:
    src = CSRC / source
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def _nvcc_cmd(source: str, out: Path):
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC / source)]


def build(sources) -> dict:
    """Compile every source not yet built, one ``nvcc`` per source, all
    started together.  Returns ``{source: library path}``; raises with
    the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out = {}
    for s in sources:
        lib = library_path(s)
        out[s] = lib
        if not lib.exists():
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            procs[s] = (subprocess.Popen(
                _nvcc_cmd(s, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), tmp, lib)
    errors = []
    for s, (p, tmp, lib) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed on {s}:\n{log}")
        else:
            lib.with_suffix(".log").write_text(log)
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def build_log(source: str):
    """The compiler's output (ptxas's register and spill report) from
    the build of ``source``, or None if it was not built here."""
    log = library_path(source).with_suffix(".log")
    return log.read_text() if log.exists() else None


def ptxas_report(log: str) -> dict:
    """{mangled kernel name: {"registers", "spill_stores", "spill_loads",
    "stack"}} from ``nvcc -Xptxas=-v`` output."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


class CudaKernel:
    """One hand-written kernel: its source, its C launcher and the
    count of its launches.

    ``launches`` grows by one on every launch and nowhere else, so a run
    can show that it went through the kernel (set it to 0 before the
    run).  The launcher's last two arguments are the stream and are
    followed by nothing; its return value is ``cudaGetLastError()``."""

    def __init__(self, name, source, symbol, argtypes):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]  # + stream
        self.launches = 0
        self._fn = None
        self._lock = threading.Lock()

    def _load(self):
        with self._lock:
            if self._fn is None:
                lib = ctypes.CDLL(str(build([self.source])[self.source]))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._lib = lib  # keep the library mapped
                self._fn = fn
        return self._fn

    def call(self, symbol, *args) -> int:
        """Call another ``extern "C"`` function of the kernel's library
        that takes int64 arguments and returns an int (an occupancy
        query, say)."""
        self._load()
        fn = getattr(self._lib, symbol)
        fn.argtypes = [ctypes.c_int64] * len(args)
        fn.restype = ctypes.c_int
        return fn(*args)

    def launch(self, device: torch.device, *args):
        """Enqueue the kernel on ``device``'s current stream."""
        fn = self._load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(
                f"CUDA kernel {self.name} failed to launch: cudaError {err}")
        self.launches += 1
