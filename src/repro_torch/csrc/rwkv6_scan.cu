// RWKV-6 (Finch) wkv recurrence for Hopper (sm_90a), split over time.
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
// What bounds it on an H100: ~20 bytes per (token, head, channel) against
// ~5 f32 operations per state element per token, so at hd 64 the bytes and
// the operations take about as long (PERF.md has the counts).  One CTA
// per (batch, head) walking all of S would leave the card nearly empty
// (160 CTAs at the rwkv6-3b prefill shape), every token waiting on a
// barrier and on device memory.  Split over time as below, it is bound by
// issuing its f32 instructions: the state update must round its product
// and its sum apart (3 instructions an element and token), and out needs
// one more.
//
// Schedule: time is cut into segments of L tokens (the wrapper's `seg`),
// one CTA of hd*hd/16 threads per (batch, head, segment): 5,120 CTAs of 256
// threads at that shape with L = 64.  A CTA stages its segment's r, k, v
// and w in shared memory with cp.async, so no pass below waits on device
// memory or needs a barrier per token.  A thread holds an 8 x 2 tile of
// the state (rows 8q.., columns 2c..); the hd/8 row groups of a column
// pair are neighbouring lanes, and staged rows carry 4 floats of pad after
// their first 32 so the row groups' float4 reads hit distinct banks.  Sums
// over rows are taken for hd/16 tokens at once (sum_scatter: 7 shuffles
// for 4 tokens at hd 64, each lane left with one total to write).  Since
// out_t = r_t . S_{t-1} + v_t (r_t . u k_t), each token's bonus weight
// r_t . u k_t is taken once, up front.
//   Walk 1 runs from a zero start: the segment's state dS, and the part of
//   out that does not depend on the state carried in, written over v.
//   Then, per row in token order, D = w_1 ... w_L, and r_t scaled by
//   w_1 ... w_{t-1}, written over k.
//   Carry: the CTA waits for segment g-1's flag, reads the state S_g that
//   it published, forms S_{g+1} = D * S_g + dS in its own scratch slot,
//   then __threadfence and a st.release of the flag; the reader's thread 0
//   ld.acquire's the flag before the CTA reads the slot.  The last
//   segment's S_{g+1} is s_last.  CTAs take their (segment, batch, head)
//   from an atomic ticket, segment-major, so the CTA a carry waits on has
//   always started: a spinning CTA never starves the one it waits on.  The
//   carries are folded in segment order and only that way (no look-back),
//   so every launch gives the same bits.
//   out_t is then its local part plus (scaled r_t) . S_g: one product an
//   element, not a second walk.
// Per state element and token that is 4 f32 instructions in walk 1 and 1
// after the carry, against 9 for two full walks.
//
// The state update and the carry round each product and sum on its own
// (__fmul_rn, __fadd_rn), as the plain torch twin (rwkv6_scan_plain, which
// follows the same schedule) does, so the two carry the same state bit for
// bit.  out is the same sum taken in another order and association (the
// carried-in part through the decay products, the bonus through r . u k),
// held to the twin at the JAX package's kernel tolerance.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Params {
  const float* in[4];        // r, k, v, w
  const float* u; float* out; float* s_last;
  float* carry;              // [B*H][G - 1][hd*hd], in thread order
  unsigned* sync;            // [0] ticket; [1 + b*H + h] segments published
  int B, S, H, L, G, vec16;
  int64_t sb[4], ss[4], sh[4];
  int64_t o_sb, o_ss, o_sh;
};

__device__ __forceinline__ int pad(int i) { return i + ((i >> 5) << 2); }

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(dst), "l"(src));
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void load8(const float* s, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(s);
  const float4 b = *reinterpret_cast<const float4*>(s + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

template <int HD>
struct Shape {
  static constexpr int NQ = HD / 8;                   // row groups of 8
  static constexpr int NT = HD * HD / 16;             // threads a CTA
  static constexpr int HDP = HD + 4 * ((HD - 1) / 32);  // staged row, padded
};

// The state carried into segment g, S_g, published by segment g-1 (zero for
// the first segment).  Thread 0 acquires the flag; the barrier passes that
// on to the CTA, whose reads go to L2 (__ldcg), past any stale L1 line.
template <int HD>
__device__ __forceinline__ void carry_in(int g, const unsigned* flag,
                                         const float* slot, float (&s)[8][2]) {
  if (g == 0) {
#pragma unroll
    for (int m = 0; m < 8; ++m) s[m][0] = s[m][1] = 0.f;
    return;
  }
  if (threadIdx.x == 0)
    while (ld_acquire(flag) < unsigned(g)) __nanosleep(64);
  __syncthreads();
  const float4* src = reinterpret_cast<const float4*>(slot - HD * HD);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float4 x = __ldcg(src + e);
    s[2 * e][0] = x.x; s[2 * e][1] = x.y; s[2 * e + 1][0] = x.z; s[2 * e + 1][1] = x.w;
  }
}

// The sum of x over N neighbouring lanes (N a power of two), in each.
template <int N, unsigned MASK>
__device__ __forceinline__ float lane_sum(float x) {
#pragma unroll
  for (int off = 1; off < N; off <<= 1) x += __shfl_xor_sync(MASK, x, off);
  return x;
}

// v holds NQ partial sums in each of the NQ lanes of a column pair (its
// row groups); leaves lane q the total of v[q], by recursive halving:
// NQ - 1 shuffles for NQ sums, all of one level independent.
template <int NQ, unsigned MASK>
__device__ __forceinline__ float sum_scatter(float (&v)[NQ], int q) {
#pragma unroll
  for (int half = NQ / 2; half >= 1; half /= 2) {
    const bool upper = q & half;
#pragma unroll
    for (int e = 0; e < half; ++e) {
      const float send = upper ? v[e] : v[e + half];
      const float keep = upper ? v[e + half] : v[e];
      v[e] = keep + __shfl_xor_sync(MASK, send, half);
    }
  }
  return v[0];
}

// One token for a thread's 8 x 2 tile at row rt (r, k, w) and column vt (v)
// of the staged segment: acc[j] += r . s[:, j] over its rows (s before the
// token), then s <- diag(w) s + k v^T, rounded as the twin.
__device__ __forceinline__ void step(const float* rt, const float* kt, const float* wt,
                                     const float* vt, float (&s)[8][2], float* acc) {
  float rr[8], kk[8], ww[8];
  load8(rt, rr);
  load8(kt, kk);
  load8(wt, ww);
  const float2 vv = *reinterpret_cast<const float2*>(vt);
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    acc[0] = fmaf(rr[m], s[m][0], acc[0]);
    acc[1] = fmaf(rr[m], s[m][1], acc[1]);
    const float a0 = __fmul_rn(kk[m], vv.x), a1 = __fmul_rn(kk[m], vv.y);
    s[m][0] = __fadd_rn(__fmul_rn(ww[m], s[m][0]), a0);
    s[m][1] = __fadd_rn(__fmul_rn(ww[m], s[m][1]), a1);
  }
}

template <int HD>
__global__ void __launch_bounds__(Shape<HD>::NT) rwkv6_scan_kernel(Params p) {
  constexpr int NQ = Shape<HD>::NQ, NT = Shape<HD>::NT, HDP = Shape<HD>::HDP;
  constexpr unsigned MASK = NT >= 32 ? 0xffffffffu : (1u << NT) - 1u;
  extern __shared__ __align__(16) float smem[];
  __shared__ float sD[HD];
  __shared__ unsigned s_ticket;

  const int tid = threadIdx.x, q = tid % NQ, c = tid / NQ;
  if (tid == 0) s_ticket = atomicAdd(p.sync, 1u);
  __syncthreads();
  const unsigned n_bh = unsigned(p.B) * p.H;
  const int g = int(s_ticket / n_bh), bh = int(s_ticket % n_bh);
  const int b = bh / p.H, h = bh % p.H;
  const int t0 = g * p.L;
  const int n = max(0, min(p.L, p.S - t0));
  float* const st[4] = {smem, smem + p.L * HDP, smem + 2 * p.L * HDP, smem + 3 * p.L * HDP};
  float* const sbonus = smem + 4 * p.L * HDP;

  // stage the segment: r, k, v, w rows [t0, t0 + n)
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float* src = p.in[a] + b * p.sb[a] + h * p.sh[a] + int64_t(t0) * p.ss[a];
    for (int idx = tid; idx < n * (HD / 4); idx += NT) {
      const int t = idx / (HD / 4), col = (idx % (HD / 4)) * 4;
      const uint32_t dst = smem_u32(st[a] + t * HDP + pad(col));
      const float* s = src + t * p.ss[a] + col;
      if (p.vec16) {
        cp_async_16(dst, s);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) cp_async_4(dst + 4 * e, s + e);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  float* const sr = st[0]; float* const sk = st[1];
  float* const sv = st[2]; float* const sw = st[3];

  // the bonus term's weight of each token, r_t . (u k_t): 4 threads a token
  {
    constexpr int ROWS = HD / 4;
    const int part = tid % 4;
    const float* u = p.u + h * HD + part * ROWS;
    for (int base = 0; base < n * 4; base += NT) {
      const int t = (base + tid) / 4;
      float x = 0.f;
      if (t < n) {
#pragma unroll
        for (int e = 0; e < ROWS; ++e) {
          const int i = t * HDP + pad(part * ROWS + e);
          x = fmaf(sr[i], __ldg(u + e) * sk[i], x);
        }
      }
      x = lane_sum<4, MASK>(x);
      if (t < n && part == 0) sbonus[t] = x;
    }
  }
  __syncthreads();

  const int i0 = pad(8 * q), j0 = pad(2 * c);
  unsigned* flag = p.sync + 1 + bh;
  float* slot = p.carry + (int64_t(bh) * (p.G - 1) + g) * (HD * HD) + 16 * tid;
  float* out = p.out + b * p.o_sb + h * p.o_sh + int64_t(t0) * p.o_ss + 2 * c;
  float s[8][2];
  // Tokens are taken TG at a time: a lane's NV partial sums over its rows
  // (TG tokens x 2 columns) are summed over the column pair's lanes with
  // one sum_scatter, which leaves lane q the total of token q / 2, column
  // q % 2 (at hd 8 one lane holds a whole column pair and keeps both).
  constexpr int NV = NQ > 1 ? NQ : 2, TG = NV / 2;
  // lane q's (token in the group, column) after the sum, and how many it has
  const int own_t = NQ > 1 ? q / 2 : 0, own_j = NQ > 1 ? q % 2 : 0;
  constexpr int OWN = NQ > 1 ? 1 : 2;

  // walk 1, from a zero start: dS, and out's part that does not depend
  // on S_g, r_t . dS_{t-1} + v_t (r_t . u k_t), in place of v_t (only
  // this column pair's lanes read those columns of v, and all of them
  // have read a group's v before its sum)
  float ds[8][2];
#pragma unroll
  for (int m = 0; m < 8; ++m) ds[m][0] = ds[m][1] = 0.f;
  for (int tb = 0; tb < n; tb += TG) {
    float v[NV];
#pragma unroll
    for (int tt = 0; tt < TG; ++tt) {
      const int t = (tb + tt) * HDP;
      v[2 * tt] = v[2 * tt + 1] = 0.f;
      if (tb + tt < n) step(sr + t + i0, sk + t + i0, sw + t + i0, sv + t + j0, ds, v + 2 * tt);
    }
    if constexpr (NQ > 1) v[0] = sum_scatter<NV, MASK>(v, q);
    __syncwarp(MASK);   // every lane has read this group's v
#pragma unroll
    for (int e = 0; e < OWN; ++e) {
      const int t = tb + own_t, j = own_j + e;
      if (t < n) {
        float* vt = sv + t * HDP + j0 + j;
        *vt = fmaf(*vt, sbonus[t], v[e]);
      }
    }
  }
  __syncthreads();
  // per row, in token order: D = w_1 ... w_n, and r_t scaled by the decay
  // from the segment's start, w_1 ... w_{t-1}, in place of k_t
  for (int i = tid; i < HD; i += NT) {
    const int pi = pad(i);
    float cum = 1.f;
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      sk[t * HDP + pi] = sr[t * HDP + pi] * cum;
      cum = __fmul_rn(cum, sw[t * HDP + pi]);
    }
    sD[i] = cum;
  }
  __syncthreads();

  // the carry: S_{g+1} = D * S_g + dS, published for segment g+1, or
  // s_last after the last segment
  carry_in<HD>(g, flag, slot, s);
  float x[8][2];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    x[m][0] = __fadd_rn(__fmul_rn(sD[8 * q + m], s[m][0]), ds[m][0]);
    x[m][1] = __fadd_rn(__fmul_rn(sD[8 * q + m], s[m][1]), ds[m][1]);
  }
  if (g + 1 < p.G) {
    float4* dst = reinterpret_cast<float4*>(slot);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      __stcg(dst + e, make_float4(x[2 * e][0], x[2 * e][1], x[2 * e + 1][0], x[2 * e + 1][1]));
    __threadfence();
    __syncthreads();
    if (tid == 0) st_release(flag, unsigned(g + 1));
  } else {
    float* sl = p.s_last + int64_t(bh) * HD * HD + 2 * c;
#pragma unroll
    for (int m = 0; m < 8; ++m)
      *reinterpret_cast<float2*>(sl + (8 * q + m) * HD) = make_float2(x[m][0], x[m][1]);
  }

  // out_t = its local part + (r_t w_1 ... w_{t-1}) . S_g
  for (int tb = 0; tb < n; tb += TG) {
    float v[NV];
#pragma unroll
    for (int e = 0; e < NV; ++e) v[e] = 0.f;
    if (g > 0) {
#pragma unroll
      for (int tt = 0; tt < TG; ++tt) {
        const int t = tb + tt;
        if (t < n) {
          float rc[8];
          load8(sk + t * HDP + i0, rc);
#pragma unroll
          for (int m = 0; m < 8; ++m) {
            v[2 * tt] = fmaf(rc[m], s[m][0], v[2 * tt]);
            v[2 * tt + 1] = fmaf(rc[m], s[m][1], v[2 * tt + 1]);
          }
        }
      }
      if constexpr (NQ > 1) v[0] = sum_scatter<NV, MASK>(v, q);
    }
#pragma unroll
    for (int e = 0; e < OWN; ++e) {
      const int t = tb + own_t, j = own_j + e;
      if (t < n) out[t * p.o_ss + j] = sv[t * HDP + j0 + j] + v[e];
    }
  }
}

// Raises the kernel's dynamic shared-memory limit to `smem` bytes, once per
// instantiation, device and larger size.  The carveout asks for all of the
// SM's shared memory: three CTAs of 70 KB at hd 64 and L = 64 fit only in
// the largest.
template <int HD>
cudaError_t set_smem(size_t smem) {
  constexpr int MAX_DEVICES = 64;
  static size_t limit[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < MAX_DEVICES && limit[dev] >= smem)) return err;
  err = cudaFuncSetAttribute(rwkv6_scan_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(rwkv6_scan_kernel<HD>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               int(cudaSharedmemCarveoutMaxShared));
  if (err == cudaSuccess && dev < MAX_DEVICES) limit[dev] = smem;
  return err;
}

template <int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = size_t(4) * p.L * (4 * Shape<HD>::HDP + 1);
  const cudaError_t err = set_smem<HD>(smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = unsigned(p.B) * p.H * p.G;
  rwkv6_scan_kernel<HD><<<grid, Shape<HD>::NT, smem, stream>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr, int64_t s0, int64_t s1, int64_t s2) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && s0 % 4 == 0 && s1 % 4 == 0 &&
         s2 % 4 == 0;
}

}  // namespace

extern "C" {

// `carry` holds B * H * (G - 1) * hd * hd floats and `sync` 1 + B * H zeroed
// words, G = max(1, ceil(S / L)) (rwkv6_scan.scratch_shape).  Returns
// cudaGetLastError() after the launch (0 on success); the caller raises on
// anything else.
int rwkv6_scan_fwd(const float* r, const float* k, const float* v, const float* w,
                   const float* u, float* out, float* s_last, float* carry, unsigned* sync,
                   int B, int S, int H, int hd, int L,
                   int64_t r_sb, int64_t r_ss, int64_t r_sh,
                   int64_t k_sb, int64_t k_ss, int64_t k_sh,
                   int64_t v_sb, int64_t v_ss, int64_t v_sh,
                   int64_t w_sb, int64_t w_ss, int64_t w_sh,
                   int64_t o_sb, int64_t o_ss, int64_t o_sh, void* stream) {
  if (B < 1 || H < 1 || S < 0 || L < 1) return int(cudaErrorInvalidValue);
  const int G = S > 0 ? (S + L - 1) / L : 1;
  const int vec16 = aligned16(r, r_sb, r_ss, r_sh) && aligned16(k, k_sb, k_ss, k_sh) &&
                    aligned16(v, v_sb, v_ss, v_sh) && aligned16(w, w_sb, w_ss, w_sh);
  Params p{{r, k, v, w}, u, out, s_last, carry, sync, B, S, H, L, G, vec16,
           {r_sb, k_sb, v_sb, w_sb}, {r_ss, k_ss, v_ss, w_ss}, {r_sh, k_sh, v_sh, w_sh},
           o_sb, o_ss, o_sh};
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
