// RWKV-6 (Finch) wkv recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan.py
// (_rwkv_kernel, launched by rwkv6_scan_pallas through pl.pallas_call).
// Per (batch, head), with the [hd, hd] f32 state S starting at zero:
//   out_t = r_t^T (S + diag(u) k_t v_t^T);   S <- diag(w_t) S + k_t v_t^T
// and the final S is written out.
//
// Layout: r, k, v, w and out are [B, S, H, hd] (the JAX wrapper's layout,
// before its moveaxis), read through their strides; only hd must be
// contiguous.  u is [H, hd] and s_last [B, H, hd, hd], both contiguous.
// The kernel stops at S, which leaves the state exactly where the JAX
// wrapper's tail padding (w = 1, k = 0) leaves it.
//
// Schedule: one CTA per (head, batch) with hd threads.  Thread v keeps
// column S[:, v] in registers.  Each step stages r_t, k_t and w_t in shared
// memory (double-buffered, so one __syncthreads per step), while the next
// step's inputs are already being loaded into registers.
//
// What bounds it on an H100: ~20 bytes per (token, head, channel) against
// ~5 FLOPs per state element per token, so at hd 64 the bytes and the f32
// operations take about as long (PERF.md has the counts).  What holds it
// back is the serial chain over t: at the prefill shape (B 4, H 40) there
// are 160 CTAs of 64 threads, about one per SM, and every step waits on a
// barrier.  Splitting t into chunks (the chunked form in
// models/recurrent.py) is the way to more parallelism, in a later PR.
//
// The state update rounds each product and sum on its own (__fmul_rn,
// __fadd_rn), as the plain torch version does, so the two carry the same
// state bit for bit; only out's sum over k is taken in another order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Params {
  const float* r; const float* k; const float* v; const float* w;
  const float* u; float* out; float* s_last;
  int B, S, H;
  int64_t r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
      w_sb, w_ss, w_sh, o_sb, o_ss, o_sh;
};

template <int HD>
__global__ void __launch_bounds__(HD) rwkv6_scan_kernel(Params p) {
  __shared__ __align__(16) float sr[2][HD];
  __shared__ __align__(16) float sk[2][HD];
  __shared__ __align__(16) float sw[2][HD];
  __shared__ __align__(16) float su[HD];

  const int c = threadIdx.x;          // this thread's column v of S
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const float* r = p.r + b * p.r_sb + h * p.r_sh + c;
  const float* k = p.k + b * p.k_sb + h * p.k_sh + c;
  const float* v = p.v + b * p.v_sb + h * p.v_sh + c;
  const float* w = p.w + b * p.w_sb + h * p.w_sh + c;
  float* out = p.out + b * p.o_sb + h * p.o_sh + c;
  su[c] = p.u[h * HD + c];

  float s[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) s[i] = 0.f;

  float rn = 0.f, kn = 0.f, vn = 0.f, wn = 0.f;
  if (p.S > 0) { rn = r[0]; kn = k[0]; vn = v[0]; wn = w[0]; }
  for (int t = 0; t < p.S; ++t) {
    const int buf = t & 1;
    sr[buf][c] = rn;
    sk[buf][c] = kn;
    sw[buf][c] = wn;
    const float vt = vn;
    __syncthreads();
    if (t + 1 < p.S) {
      rn = r[(t + 1) * p.r_ss];
      kn = k[(t + 1) * p.k_ss];
      vn = v[(t + 1) * p.v_ss];
      wn = w[(t + 1) * p.w_ss];
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < HD; ++i) {
      const float at = __fmul_rn(sk[buf][i], vt);
      acc[i & 3] = fmaf(sr[buf][i], __fadd_rn(s[i], __fmul_rn(su[i], at)), acc[i & 3]);
      s[i] = __fadd_rn(__fmul_rn(sw[buf][i], s[i]), at);
    }
    out[t * p.o_ss] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }

  float* sl = p.s_last + (int64_t(b) * p.H + h) * HD * HD + c;
#pragma unroll
  for (int i = 0; i < HD; ++i) sl[i * HD] = s[i];
}

template <int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  rwkv6_scan_kernel<HD><<<dim3(p.H, p.B), HD, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success); the caller
// raises on anything else.
int rwkv6_scan_fwd(const float* r, const float* k, const float* v, const float* w,
                   const float* u, float* out, float* s_last, int B, int S, int H, int hd,
                   int64_t r_sb, int64_t r_ss, int64_t r_sh,
                   int64_t k_sb, int64_t k_ss, int64_t k_sh,
                   int64_t v_sb, int64_t v_ss, int64_t v_sh,
                   int64_t w_sb, int64_t w_ss, int64_t w_sh,
                   int64_t o_sb, int64_t o_ss, int64_t o_sh, void* stream) {
  if (B < 1 || H < 1 || S < 0) return int(cudaErrorInvalidValue);
  Params p{r, k, v, w, u, out, s_last, B, S, H,
           r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           w_sb, w_ss, w_sh, o_sb, o_ss, o_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8: return int(launch<8>(p, s));
    case 16: return int(launch<16>(p, s));
    case 32: return int(launch<32>(p, s));
    case 64: return int(launch<64>(p, s));
    default: return int(cudaErrorInvalidValue);
  }
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
