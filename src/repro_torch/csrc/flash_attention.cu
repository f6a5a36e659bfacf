// Divergence-aware flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_attn_kernel, launched by flash_attention_bhsd through pl.pallas_call).
// It computes softmax(q.k^T * hd^-0.5 under causal, window and kv_len) . v
// with an online softmax whose m, l and acc stay in f32 across kv tiles.
//
// Layout: q, o are [B, Sq, H, hd] and k, v are [B, Sk, K, hd] (BSHD, GQA),
// read through their strides; only the head dimension must be contiguous.
// The kv head of query head h is h / (H / K), so no repeated k/v exists.
//
// Schedule: one CTA per (q tile, head, batch) with one thread per q row up
// to hd 128.  At hd 256 a row's q and accumulator (512 floats) do not fit
// one thread's registers: a group of G = 4 neighbouring threads shares the
// row, each holding every G-th float4 of it, and the group sums its q.k
// partial dots with __shfl_xor_sync.  That CTA holds up to 64 rows, and the
// caller takes 64-key tiles so the f32 k/v tiles fit in shared memory.
// The CTA walks only the kv tiles kv_tile_range() gives, which are exactly
// the tiles the TPU kernel's _tile_class calls non-EMPTY: EMPTY tiles are
// never visited.  FULL tiles skip the mask.  Ragged Sq / Sk edges are
// masked here, so the caller pads nothing.
//
// What bounds it on an H100: at llama3.2-1b prefill (hd 64, S 2048) the
// work is ~4*hd FLOPs per live (q, k) pair against ~4*hd bytes per q row,
// far above the card's ~295 FLOP/byte ridge, so it is bound by operations.
// This first version runs them as f32 FMAs on the CUDA cores (67 TFLOP/s
// peak), not on the tensor cores (989 TFLOP/s bf16): it is simple and
// right first.  What the design does about the bound: each k/v tile is
// staged once in shared memory as f32 and read by every thread of the CTA
// as warp-wide broadcasts, the q row and its accumulator live in
// registers, and keys are taken 16 at a time so that the softmax rescale
// (one exp per chunk) is amortized.  wgmma on bf16 tiles and TMA loads are
// the next step.
//
// Masking keeps the reference's finite NEG_INF = -1e30 and divides by
// max(l, 1e-30): with -inf, exp(m_prev - m_new) is NaN on a row whose first
// visited tile is fully masked.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int CH = 16;          // keys per online-softmax step
constexpr int MAX_BQ = 128;     // q rows per CTA, one thread per row
constexpr int MAX_BQ_WIDE = 64; // q rows per CTA at hd 256
constexpr int WIDE_G = 4;       // threads per q row at hd 256

__host__ __device__ constexpr int max_threads(int g) {
  return g == 1 ? MAX_BQ : MAX_BQ_WIDE * g;
}

struct Params {
  const void* q; const void* k; const void* v; void* o;
  int B, Sq, Sk, H, K;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  int causal, window, bq, bk;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Mirrors repro_torch.kernels.flash_attention.kv_tile_range.
__device__ __forceinline__ void kv_tile_range(int qs, int bq, int bk, int nk, int causal,
                                              int window, int kv_len, int* lo, int* hi) {
  *lo = window > 0 ? max(0, qs - window + 1) / bk : 0;
  int h = min(nk, (kv_len + bk - 1) / bk);
  if (causal) h = min(h, (qs + bq - 1) / bk + 1);
  *hi = h;
}

// The "full" half of _tile_class: every (q, k) pair of the tile is live.
__device__ __forceinline__ bool tile_full(int qs, int ks, int bq, int bk, int causal,
                                          int window, int kv_len) {
  const int q_min = qs, q_max = qs + bq - 1, k_min = ks, k_max = ks + bk - 1;
  bool full = k_max < kv_len;
  if (causal) full = full && k_max <= q_min;
  if (window > 0) full = full && k_min >= q_max - window + 1;
  return full;
}

// G threads share each q row; thread g of a group holds the float4s
// g, g + G, g + 2G, ... of the row (interleaved, so the group's shared-memory
// reads of one k/v row hit distinct banks).
template <typename T, int HD, int G>
__global__ void __launch_bounds__(max_threads(G)) flash_attention_kernel(Params p) {
  constexpr int DG = HD / G;      // head dims this thread holds
  extern __shared__ float4 smem4[];
  const int rows = (p.bk + CH - 1) / CH * CH;
  float* k_tile = reinterpret_cast<float*>(smem4);
  float* v_tile = k_tile + rows * HD;

  const int tid = threadIdx.x;
  const int g = tid % G;
  const int qs = blockIdx.x * p.bq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.K);
  const int row = qs + tid / G;
  const bool row_live = row < p.Sq;
  const int kv_len = p.Sk;
  // the lanes of this warp that exist (the last warp may be partial)
  const int warp_lanes = min(32, int(blockDim.x) - (tid & ~31));
  const unsigned lanes = warp_lanes == 32 ? 0xffffffffu : (1u << warp_lanes) - 1u;

  const T* qg = static_cast<const T*>(p.q);
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  float q[DG], acc[DG];
#pragma unroll
  for (int i = 0; i < DG / 4; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = 4 * (g + G * i) + c;
      q[4 * i + c] = row_live ? to_f32(qg[b * p.q_sb + row * p.q_ss + h * p.q_sh + d]) : 0.f;
      acc[4 * i + c] = 0.f;
    }
  }
  float m = NEG_INF, l = 0.f;

  const int nk = (p.Sk + p.bk - 1) / p.bk;
  int lo, hi;
  kv_tile_range(qs, p.bq, p.bk, nk, p.causal, p.window, kv_len, &lo, &hi);

  for (int j = lo; j < hi; ++j) {
    const int ks = j * p.bk;
    const int n = min(p.bk, p.Sk - ks);    // keys of this tile inside Sk
    __syncthreads();                       // the previous tile is consumed
    for (int e = tid; e < rows * HD; e += blockDim.x) {
      const int r = e / HD, c = e % HD;
      float kv = 0.f, vv = 0.f;
      if (r < n) {
        kv = to_f32(kg[(ks + r) * p.k_ss + c]);
        vv = to_f32(vg[(ks + r) * p.v_ss + c]);
      }
      k_tile[e] = kv;
      v_tile[e] = vv;
    }
    __syncthreads();
    const bool full = tile_full(qs, ks, p.bq, p.bk, p.causal, p.window, kv_len);

    for (int c0 = 0; c0 < n; c0 += CH) {
      float s[CH];
      float m_new = m;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float4* kr = reinterpret_cast<const float4*>(k_tile + (c0 + c) * HD);
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DG / 4; ++i) {
          const float4 kk = kr[g + G * i];
          dot = fmaf(q[4 * i + 0], kk.x, dot);
          dot = fmaf(q[4 * i + 1], kk.y, dot);
          dot = fmaf(q[4 * i + 2], kk.z, dot);
          dot = fmaf(q[4 * i + 3], kk.w, dot);
        }
#pragma unroll
        for (int o = 1; o < G; o <<= 1) dot += __shfl_xor_sync(lanes, dot, o);
        float sv = dot * p.scale;
        if (!full) {
          const int kj = ks + c0 + c;
          bool live = kj < kv_len;
          if (p.causal) live = live && row >= kj;
          if (p.window > 0) live = live && row - kj < p.window;
          if (!live) sv = NEG_INF;
        }
        // keys past the tile's end (chunk padding) take no part at all
        s[c] = (c0 + c < n) ? sv : NEG_INF;
        if (c0 + c < n) m_new = fmaxf(m_new, sv);
      }
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        s[c] = (c0 + c < n) ? expf(s[c] - m_new) : 0.f;
        psum += s[c];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int i = 0; i < DG / 4; ++i) {
        float a0 = acc[4 * i + 0] * alpha, a1 = acc[4 * i + 1] * alpha;
        float a2 = acc[4 * i + 2] * alpha, a3 = acc[4 * i + 3] * alpha;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const float4 vv = reinterpret_cast<const float4*>(v_tile + (c0 + c) * HD)[g + G * i];
          a0 = fmaf(s[c], vv.x, a0);
          a1 = fmaf(s[c], vv.y, a1);
          a2 = fmaf(s[c], vv.z, a2);
          a3 = fmaf(s[c], vv.w, a3);
        }
        acc[4 * i + 0] = a0; acc[4 * i + 1] = a1;
        acc[4 * i + 2] = a2; acc[4 * i + 3] = a3;
      }
      m = m_new;
    }
  }

  if (row_live) {
    const float denom = fmaxf(l, 1e-30f);
    T* og = static_cast<T*>(p.o) + b * p.o_sb + row * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int i = 0; i < DG / 4; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) og[4 * (g + G * i) + c] = from_f32<T>(acc[4 * i + c] / denom);
    }
  }
}

template <typename T, int HD, int G = 1>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  if (p.bq * G > max_threads(G)) return cudaErrorInvalidValue;
  const int rows = (p.bk + CH - 1) / CH * CH;
  const size_t smem = size_t(2) * rows * HD * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, HD, G>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.Sq + p.bq - 1) / p.bq, p.H, p.B);
  flash_attention_kernel<T, HD, G><<<grid, p.bq * G, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 8: return launch<T, 8>(p, stream);
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    case 256: return launch<T, 256, WIDE_G>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success); the caller raises on anything else.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int dtype,
                        int B, int Sq, int Sk, int H, int K, int hd,
                        int64_t q_sb, int64_t q_ss, int64_t q_sh,
                        int64_t k_sb, int64_t k_ss, int64_t k_sh,
                        int64_t v_sb, int64_t v_ss, int64_t v_sh,
                        int64_t o_sb, int64_t o_ss, int64_t o_sh,
                        int causal, int window, int bq, int bk, void* stream) {
  if (bq < 1 || bq > MAX_BQ || bk < 1 || K < 1 || H % K) return int(cudaErrorInvalidValue);
  Params p{q, k, v, o, B, Sq, Sk, H, K,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
           causal, window, bq, bk, float(1.0 / std::sqrt(double(hd)))};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch_hd<float>(p, hd, s)
                  : dtype == 1 ? dispatch_hd<__nv_bfloat16>(p, hd, s)
                               : cudaErrorInvalidValue;
  return int(err);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
