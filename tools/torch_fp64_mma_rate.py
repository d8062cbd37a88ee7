"""Measure the fp64 tensor-core rate of each ``mma.sync`` shape on the
card: m8n8k4 (sm_80 and later) and m16n8k4, m16n8k8, m16n8k16 (sm_90).

Kernels K3 and K5 (``pint_tpu_torch/csrc/kron_gram.cu``,
``kron_pulsar.cu``) choose their MMA shape from these rates.  Each shape
runs in a loop of independent accumulators held in registers (6 a warp,
no memory traffic), over 2 and 4 blocks of 256 threads per SM; the
script prints TFLOP/s beside the card's name and power limit.  It
builds its own kernel with the port's nvcc flags into
``build/pint_tpu_torch/`` and changes nothing in the port.

Usage (on a machine with an NVIDIA GPU, from the repo root)::

    python tools/torch_fp64_mma_rate.py
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pint_tpu_torch import _cuda  # noqa: E402

NACC = 6
ITERS = 1000
# MMA shape -> its k (m is 8 or 16, n is 8)
SHAPES = {"m8n8k4": 4, "m16n8k4": 4, "m16n8k8": 8, "m16n8k16": 16}

SOURCE = r"""
#include <cuda_runtime.h>
#define NACC %(nacc)d
template <int NA, int NB, int ND>
__device__ __forceinline__ void mma(double (&d)[ND], const double (&a)[NA],
                                    const double (&b)[NB]);
template <>
__device__ __forceinline__ void mma<1, 1, 2>(double (&d)[2],
    const double (&a)[1], const double (&b)[1]) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
               "{%%0,%%1}, {%%2}, {%%3}, {%%0,%%1};\n"
               : "+d"(d[0]), "+d"(d[1]) : "d"(a[0]), "d"(b[0]));
}
template <>
__device__ __forceinline__ void mma<2, 1, 4>(double (&d)[4],
    const double (&a)[2], const double (&b)[1]) {
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
               "{%%0,%%1,%%2,%%3}, {%%4,%%5}, {%%6}, {%%0,%%1,%%2,%%3};\n"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
               : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}
template <>
__device__ __forceinline__ void mma<4, 2, 4>(double (&d)[4],
    const double (&a)[4], const double (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
               "{%%0,%%1,%%2,%%3}, {%%4,%%5,%%6,%%7}, {%%8,%%9}, "
               "{%%0,%%1,%%2,%%3};\n"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]),
                 "d"(b[1]));
}
template <>
__device__ __forceinline__ void mma<8, 4, 4>(double (&d)[4],
    const double (&a)[8], const double (&b)[4]) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
               "{%%0,%%1,%%2,%%3}, {%%4,%%5,%%6,%%7,%%8,%%9,%%10,%%11}, "
               "{%%12,%%13,%%14,%%15}, {%%0,%%1,%%2,%%3};\n"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]),
                 "d"(a[5]), "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]),
                 "d"(b[2]), "d"(b[3]));
}
template <int NA, int NB, int ND>
__global__ void rate(double* out, int iters) {
  double a[NA], b[NB], d[NACC][ND];
  for (int i = 0; i < NA; ++i) a[i] = threadIdx.x * 1e-3 + i;
  for (int i = 0; i < NB; ++i) b[i] = 1.0 + threadIdx.x * 1e-4 + i;
#pragma unroll
  for (int q = 0; q < NACC; ++q)
#pragma unroll
    for (int i = 0; i < ND; ++i) d[q][i] = 0.0;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int q = 0; q < NACC; ++q) mma<NA, NB, ND>(d[q], a, b);
  double s = 0.0;
#pragma unroll
  for (int q = 0; q < NACC; ++q)
#pragma unroll
    for (int i = 0; i < ND; ++i) s += d[q][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(int k16, int k, int blocks, int iters, double* out) {
  if (!k16) rate<1, 1, 2><<<blocks, 256>>>(out, iters);
  else if (k == 4) rate<2, 1, 4><<<blocks, 256>>>(out, iters);
  else if (k == 8) rate<4, 2, 4><<<blocks, 256>>>(out, iters);
  else rate<8, 4, 4><<<blocks, 256>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def build():
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _cuda.BUILD_DIR / "fp64_mma_rate.cu"
    lib = _cuda.BUILD_DIR / "libfp64_mma_rate.so"
    src.write_text(SOURCE % {"nacc": NACC})
    subprocess.run([_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).run
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main():
    if not torch.cuda.is_available():
        print("torch_fp64_mma_rate: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    fn = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 4 * 256, dtype=torch.float64, device="cuda")
    res = {}
    for name, k in SHAPES.items():
        m = 8 if name == "m8n8k4" else 16
        for per_sm in (2, 4):
            blocks = sms * per_sm
            args = (int(m == 16), k, blocks, ITERS, out.data_ptr())
            if fn(*args) != 0:
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            flop = blocks * 8 * ITERS * NACC * 2 * m * 8 * k
            res[f"{name} {per_sm}/SM"] = flop / ms / 1e9
    print(json.dumps({"tflop_per_s": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
