// RG-LRU linear recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py
// (_rglru_kernel, launched by rglru_scan_pallas through pl.pallas_call).
// It computes h_t = a_t * h_{t-1} + b_t over [B, S, W] in f32, h_{-1} = 0.
//
// Layout: a, b, h are [B, S, W], read through their batch and time strides;
// only W must be contiguous.  Ragged S and W are bounds checks: the caller
// pads nothing.
//
// Schedule: one thread per (b, w) channel walks t = 0..S-1 and keeps h in a
// register; a CTA holds bw neighbouring channels, so every load and store
// of a time step is coalesced across w.  The TPU kernel's S-chunk grid axis
// and its carry in VMEM scratch become this loop.
//
// What bounds it on an H100: 12 bytes move per element (a, b read, h
// written) for 2 FLOPs, so bytes bound it.  The chain through h is serial,
// but the loads are not: the loop takes UNROLL steps at a time, issuing the
// loads of all of them before the first product, so each thread keeps
// 2 * UNROLL loads in flight.  At the prefill shape (B 4, W 2560) only
// 10,240 threads exist, which is too few to fill the card's memory
// pipeline; splitting S across CTAs (a two-pass scan) is the next step.
//
// Each product and sum is rounded on its own (__fmul_rn, __fadd_rn: never
// contracted into an FMA), as the plain torch version does, so the two
// agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int UNROLL = 8;

struct Params {
  const float* a; const float* b; float* h;
  int B, S, W;
  int64_t a_sb, a_ss, b_sb, b_ss, h_sb, h_ss;
};

__global__ void rglru_scan_kernel(Params p) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int bi = blockIdx.y;
  if (w >= p.W) return;
  const float* a = p.a + bi * p.a_sb + w;
  const float* b = p.b + bi * p.b_sb + w;
  float* h = p.h + bi * p.h_sb + w;
  float carry = 0.f;
  int t = 0;
  for (; t + UNROLL <= p.S; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      av[u] = a[(t + u) * p.a_ss];
      bv[u] = b[(t + u) * p.b_ss];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      carry = __fadd_rn(__fmul_rn(av[u], carry), bv[u]);
      h[(t + u) * p.h_ss] = carry;
    }
  }
  for (; t < p.S; ++t) {
    carry = __fadd_rn(__fmul_rn(a[t * p.a_ss], carry), b[t * p.b_ss]);
    h[t * p.h_ss] = carry;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success); the caller
// raises on anything else.
int rglru_scan_fwd(const float* a, const float* b, float* h, int B, int S, int W,
                   int64_t a_sb, int64_t a_ss, int64_t b_sb, int64_t b_ss,
                   int64_t h_sb, int64_t h_ss, int bw, void* stream) {
  if (B < 1 || S < 1 || W < 1 || bw < 1 || bw > 1024) return int(cudaErrorInvalidValue);
  Params p{a, b, h, B, S, W, a_sb, a_ss, b_sb, b_ss, h_sb, h_ss};
  const dim3 grid((W + bw - 1) / bw, B);
  rglru_scan_kernel<<<grid, bw, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
