"""The FP64 rates of the card, as K1's f64 tensor-core body meets them.

Compiles a small CUDA source (with the kernel libraries' nvcc flags, into
gpmpc_tpu_torch/_build/dmma_rate/) whose kernels each run one instruction
mix in a loop on independent registers, on every SM at full occupancy:
f64 mma.sync at the shapes m8n8k4, m16n8k4, m16n8k8 and m16n8k16 (8
independent accumulators a warp), DFMA (8 independent chains a thread), and
the two mixed in one loop (an m16n8k4 MMA for every 8 DFMA a thread), to see
whether the tensor cores and the vector pipe overlap. Timed by CUDA events;
each rate is the flops the loop does (an MMA's 2 M N K, a DFMA's 2) over its
time. Then the latency of one dependent chain of each (one warp, one
accumulator), and the m16n8k8 rate at 1 to 8 warps on each scheduler, with
8 independent accumulators a warp or one chain. The values computed are
discarded (written once, so that the compiler keeps the loop).

Run on the card's machine:

    python -m gpmpc_tpu_torch.benchmarks.dmma_rate [--out DIR]

It prints one JSON line a measurement and writes DIR/dmma_rate.json.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import torch

from gpmpc_tpu_torch.ops.kernels import _build

SOURCE = r'''
#include <cuda_runtime.h>

template <int M, int K>
__device__ __forceinline__ void mma(double (&c)[M == 8 ? 2 : 4],
                                    const double* a, const double* b);

template <>
__device__ __forceinline__ void mma<8, 4>(double (&c)[2], const double* a,
                                          const double* b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
               "{%0, %1}, {%2}, {%3}, {%0, %1};"
               : "+d"(c[0]), "+d"(c[1]) : "d"(a[0]), "d"(b[0]));
}
template <>
__device__ __forceinline__ void mma<16, 4>(double (&c)[4], const double* a,
                                           const double* b) {
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
               "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
               : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
               : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}
template <>
__device__ __forceinline__ void mma<16, 8>(double (&c)[4], const double* a,
                                           const double* b) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
               "{%0, %1, %2, %3};"
               : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]),
                 "d"(b[1]));
}
template <>
__device__ __forceinline__ void mma<16, 16>(double (&c)[4], const double* a,
                                            const double* b) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
               "{%12, %13, %14, %15}, {%0, %1, %2, %3};"
               : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]),
                 "d"(a[5]), "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]),
                 "d"(b[2]), "d"(b[3]));
}

// CH independent accumulators a warp (1: a dependent chain), `iters`
// rounds; DF DFMA chains a thread beside them (DF 0: none) and MM 0 to run
// the DFMAs alone.
template <int M, int K, int CH, int DF, bool MM>
__global__ void rate_kernel(double* out, int iters, double x) {
  constexpr int NC = M == 8 ? 2 : 4;
  double a[8], b[4];
#pragma unroll
  for (int q = 0; q < 8; ++q) a[q] = x + q + threadIdx.x;
#pragma unroll
  for (int q = 0; q < 4; ++q) b[q] = x - q;
  double c[CH][NC];
#pragma unroll
  for (int h = 0; h < CH; ++h)
#pragma unroll
    for (int q = 0; q < NC; ++q) c[h][q] = 0.0;
  double f[DF > 0 ? DF : 1];
#pragma unroll
  for (int h = 0; h < (DF > 0 ? DF : 1); ++h) f[h] = x * h;
  for (int it = 0; it < iters; ++it) {
    if constexpr (MM) {
#pragma unroll
      for (int h = 0; h < CH; ++h) mma<M, K>(c[h], a, b);
    }
#pragma unroll
    for (int h = 0; h < DF; ++h) f[h] = fma(f[h], x, a[h & 7]);
  }
  double s = 0.0;
#pragma unroll
  for (int h = 0; h < CH; ++h)
#pragma unroll
    for (int q = 0; q < NC; ++q) s += c[h][q];
#pragma unroll
  for (int h = 0; h < (DF > 0 ? DF : 1); ++h) s += f[h];
  if (s == 12345.678) out[threadIdx.x] = s;
}

template <int M, int K, int CH, int DF, bool MM>
int launch(double* out, int blocks, int threads, int iters, void* stream) {
  rate_kernel<M, K, CH, DF, MM><<<blocks, threads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      out, iters, 1.0000001);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dmma_rate(int kind, double* out, int blocks, int threads,
                         int iters, void* stream) {
  switch (kind) {
    case 0: return launch<8, 4, 8, 0, true>(out, blocks, threads, iters, stream);
    case 1: return launch<16, 4, 8, 0, true>(out, blocks, threads, iters, stream);
    case 2: return launch<16, 8, 8, 0, true>(out, blocks, threads, iters, stream);
    case 3: return launch<16, 16, 8, 0, true>(out, blocks, threads, iters, stream);
    case 4: return launch<16, 4, 1, 8, false>(out, blocks, threads, iters, stream);
    case 5: return launch<16, 4, 1, 8, true>(out, blocks, threads, iters, stream);
    case 6: return launch<16, 4, 1, 0, true>(out, blocks, threads, iters, stream);
    case 7: return launch<16, 8, 1, 0, true>(out, blocks, threads, iters, stream);
    case 8: return launch<16, 4, 1, 1, false>(out, blocks, threads, iters, stream);
    default: return -1;
  }
}
'''
# kind: (name, M, N, K, MMAs a warp a round, DFMAs a thread a round)
KINDS = {0: ('m8n8k4', 8, 8, 4, 8, 0), 1: ('m16n8k4', 16, 8, 4, 8, 0),
         2: ('m16n8k8', 16, 8, 8, 8, 0), 3: ('m16n8k16', 16, 8, 16, 8, 0),
         4: ('dfma', 0, 0, 0, 0, 8), 5: ('m16n8k4 + 8 dfma', 16, 8, 4, 1, 8)}
# One dependent chain in one warp: its cycles a round give the latency.
LATENCY = {6: ('m16n8k4 latency', 16, 8, 4, 1, 0),
           7: ('m16n8k8 latency', 16, 8, 8, 1, 0),
           8: ('dfma latency', 0, 0, 0, 0, 1)}


def build():
    work = _build.BUILD_DIR / 'dmma_rate'
    work.mkdir(parents=True, exist_ok=True)
    src, lib = work / 'dmma_rate.cu', work / 'libdmma_rate.so'
    src.write_text(SOURCE)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, '-o', str(lib),
                    str(src)], check=True, capture_output=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).dmma_rate
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _time(fn, kind, out, blocks, threads, iters):
    stream = torch.cuda.current_stream().cuda_stream

    def go():
        if fn(kind, out.data_ptr(), blocks, threads, iters, stream) != 0:
            raise RuntimeError(f'dmma_rate kind {kind} failed to launch')
    go()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(5):
        go()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 5 / 1e3                # s a launch


def run() -> dict:
    fn = build()
    dev = torch.device('cuda')
    props = torch.cuda.get_device_properties(dev)
    sms = props.multi_processor_count
    clock = float(subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.max.sm',
         '--format=csv,noheader,nounits'], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0]) * 1e6
    out = torch.zeros(1024, dtype=torch.float64, device=dev)
    res = {}
    blocks, threads, iters = sms * 8, 128, 4096
    for kind, (name, m, n, k, mmas, dfmas) in KINDS.items():
        s = _time(fn, kind, out, blocks, threads, iters)
        warps = blocks * threads // 32
        flops = iters * (warps * mmas * 2 * m * n * k
                         + blocks * threads * dfmas * 2)
        res[name] = dict(tflops=flops / s / 1e12, seconds=s)
    for kind, (name, m, n, k, mmas, dfmas) in LATENCY.items():
        s = _time(fn, kind, out, 1, 32, iters)
        res[name] = dict(cycles=s * clock / iters, seconds=s)
    # Warps a scheduler: the m16n8k8 rate with 8 independent accumulators a
    # warp (kind 2) and with one dependent chain a warp (kind 7), at 1 to 8
    # warps on each of an SM's 4 schedulers.
    for kind, chains in ((2, 8), (7, 1)):
        for w in (1, 2, 4, 8):
            s = _time(fn, kind, out, sms * w, 128, iters)
            flops = iters * sms * w * 4 * chains * 2 * 16 * 8 * 8
            res[f'm16n8k8, {chains} chains a warp, {w} warps a scheduler'] = \
                dict(tflops=flops / s / 1e12, seconds=s)
    return dict(card=torch.cuda.get_device_name(dev), sms=sms,
                max_sm_clock_hz=clock, results=res)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    res = run()
    for name, r in res['results'].items():
        print(json.dumps({name: r}))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, 'dmma_rate.json'), 'w') as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
