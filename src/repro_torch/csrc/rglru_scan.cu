// RG-LRU linear recurrence for Hopper (sm_90a), split over time.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py
// (_rglru_kernel, launched by rglru_scan_pallas through pl.pallas_call).
// It computes h_t = a_t * h_{t-1} + b_t over [B, S, W] in f32, h_{-1} = 0.
//
// Layout: a, b, h are [B, S, W], read through their batch and time strides;
// only W must be contiguous.  Ragged S and W are bounds checks: the caller
// pads nothing.
//
// What bounds it on an H100: 12 bytes move per element (a, b read, h
// written) for 2 FLOPs, so bytes bound it.  The chain through h is serial;
// with one thread per channel walking all of S, the prefill shape (B 4,
// W 2560) has 10,240 threads, too few to keep enough loads in flight.
//
// Schedule: time is cut into segments of L steps (the wrapper's `seg`,
// at most LMAX).  A CTA of NW warps takes 32 neighbouring channels (one
// 128-byte row a step) and NW consecutive segments, one warp a segment,
// one lane a channel.  Each thread loads its segment's a and b into
// registers (2 L loads in flight, coalesced across the warp) and takes the
// segment's aggregate from a zero start: P = a_1 ... a_L in token order and
// R, the walk's result.  Segments are carried in order: the carry into
// segment g+1 is P_g * carry_g + R_g.  Warp 0 does this for the CTA's NW
// segments through shared memory, after taking the carry into its first
// segment from the CTA before it in time, which publishes it in a scratch
// slot and then raises a flag (__threadfence, st.release; the reader
// ld.acquire's the flag).  CTAs take their (time block, channel block)
// from an atomic ticket, time-major, so the CTA a carry waits on has
// always started: a spinning CTA never starves the one it waits on.  Then
// each thread walks its segment again from its carry-in and writes h.
// The carries are folded in segment order and only that way, so every
// launch gives the same bits.
//
// Each product and sum is rounded on its own (__fmul_rn, __fadd_rn: never
// contracted into an FMA), as the plain torch twin (rglru_scan_plain, which
// follows the same schedule) does, so the two agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;        // segments (warps) per CTA; SEGS_PER_CTA in Python
constexpr int LANES = 32;    // channels per CTA; CHANNELS_PER_CTA in Python

struct Params {
  const float* a; const float* b; float* h;
  float* carry;              // [chains][blocks - 1][32]
  unsigned* sync;            // [0] ticket; [1 + chain] blocks published
  int B, S, W, L, n_cb, n_blocks;
  int64_t a_sb, a_ss, b_sb, b_ss, h_sb, h_ss;
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" :: "l"(p), "r"(v) : "memory");
}

template <int LMAX>
__global__ void __launch_bounds__(NW * LANES) rglru_scan_kernel(Params p) {
  __shared__ float sP[NW][LANES], sR[NW][LANES], sC[NW][LANES];
  __shared__ unsigned s_ticket;
  const int lane = threadIdx.x % LANES, warp = threadIdx.x / LANES;
  if (threadIdx.x == 0) s_ticket = atomicAdd(p.sync, 1u);
  __syncthreads();
  const unsigned n_chains = unsigned(p.B) * p.n_cb;
  const int blk = int(s_ticket / n_chains);
  const int chain = int(s_ticket % n_chains);
  const int bi = chain / p.n_cb;
  const int w = (chain % p.n_cb) * LANES + lane;
  const int t0 = (blk * NW + warp) * p.L;
  const int n = (w < p.W) ? max(0, min(p.L, p.S - t0)) : 0;
  const float* a = p.a + bi * p.a_sb + int64_t(t0) * p.a_ss + w;
  const float* b = p.b + bi * p.b_sb + int64_t(t0) * p.b_ss + w;

  float av[LMAX], bv[LMAX];
#pragma unroll
  for (int u = 0; u < LMAX; ++u) {
    if (u < n) {
      av[u] = a[u * p.a_ss];
      bv[u] = b[u * p.b_ss];
    }
  }
  // walk 1: the segment's aggregate from a zero start
  float P = 1.f, R = 0.f;
#pragma unroll
  for (int u = 0; u < LMAX; ++u) {
    if (u < n) {
      P = __fmul_rn(P, av[u]);
      R = __fadd_rn(__fmul_rn(av[u], R), bv[u]);
    }
  }
  sP[warp][lane] = P;
  sR[warp][lane] = R;
  __syncthreads();

  // the carry, in segment order: from the CTA before, through this one's
  // segments, to the CTA after
  if (warp == 0) {
    float c = 0.f;
    unsigned* flag = p.sync + 1 + chain;
    float* slot = p.carry + (int64_t(chain) * (p.n_blocks - 1) + blk) * LANES + lane;
    if (blk > 0) {
      // every lane acquires the flag itself, so its own read of the slot
      // is ordered after the producer's write
      while (ld_acquire(flag) < unsigned(blk)) __nanosleep(32);
      c = __ldcg(slot - LANES);
    }
#pragma unroll
    for (int s = 0; s < NW; ++s) {
      sC[s][lane] = c;
      c = __fadd_rn(__fmul_rn(sP[s][lane], c), sR[s][lane]);
    }
    if (blk + 1 < p.n_blocks) {
      __stcg(slot, c);
      __threadfence();
      __syncwarp();
      if (lane == 0) st_release(flag, unsigned(blk + 1));
    }
  }
  __syncthreads();

  // walk 2: from the exact carry-in, writing h
  float hv = sC[warp][lane];
  float* h = p.h + bi * p.h_sb + int64_t(t0) * p.h_ss + w;
#pragma unroll
  for (int u = 0; u < LMAX; ++u) {
    if (u < n) {
      hv = __fadd_rn(__fmul_rn(av[u], hv), bv[u]);
      h[u * p.h_ss] = hv;
    }
  }
}

template <int LMAX>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const unsigned grid = unsigned(p.B) * p.n_cb * p.n_blocks;
  rglru_scan_kernel<LMAX><<<grid, NW * LANES, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// `carry` holds B * ceil(W / 32) * (ceil(S / (8 L)) - 1) * 32 floats and
// `sync` 1 + B * ceil(W / 32) zeroed words (rglru_scan.scratch_shape).
// Returns cudaGetLastError() after the launch (0 on success); the caller
// raises on anything else.
int rglru_scan_fwd(const float* a, const float* b, float* h, float* carry, unsigned* sync,
                   int B, int S, int W, int L,
                   int64_t a_sb, int64_t a_ss, int64_t b_sb, int64_t b_ss,
                   int64_t h_sb, int64_t h_ss, void* stream) {
  if (B < 1 || S < 1 || W < 1 || L < 1 || L > 32) return int(cudaErrorInvalidValue);
  const int n_cb = (W + LANES - 1) / LANES;
  const int n_blocks = (S + NW * L - 1) / (NW * L);
  Params p{a, b, h, carry, sync, B, S, W, L, n_cb, n_blocks,
           a_sb, a_ss, b_sb, b_ss, h_sb, h_ss};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L <= 8) return int(launch<8>(p, s));
  if (L <= 16) return int(launch<16>(p, s));
  return int(launch<32>(p, s));
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
