// Divergence-aware flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_attn_kernel, launched by flash_attention_bhsd through pl.pallas_call).
// It computes softmax(q.k^T * hd^-0.5 under causal, window and kv_len) . v
// with an online softmax whose m, l and acc stay in f32 across kv tiles.
//
// Layout: q is [B, Sq, H, hd], k [B, Sk, K, hd], v [B, Sk, K, hdv] and o
// [B, Sq, H, hdv] (BSHD, GQA), read through their strides; only the head
// dimension must be contiguous.  hdv is hd but in latent attention
// (DeepSeek-V3, Moonlight: q and k at 128 + 64, v at 128), which has no
// TPU kernel in the JAX package; padding v to 192 would waste a third of
// P.v and of v's bytes, so v and o keep their own width.
// q's row 0 sits at global position q_off (0 for whole rows; a rank's first
// row when the sequence is split over ranks): the causal and window masks
// and the kv-tile range compare q_off + row with the key's position, so a
// q tile that starts off the kv tile grid straddles the diagonal and is
// masked like any PARTIAL tile.
// The kv head of query head h is h / (H / K), so no repeated k/v exists.
// Every CTA walks only the kv tiles kv_tile_range() gives, which are exactly
// the tiles the TPU kernel's _tile_class calls non-EMPTY: EMPTY tiles are
// never visited.  FULL tiles skip the mask.  Ragged Sq / Sk edges are masked
// here, so the caller pads nothing.  Masking keeps the reference's finite
// NEG_INF = -1e30 and divides by max(l, 1e-30): with -inf, exp(m_prev -
// m_new) is NaN on a row whose first visited tile is fully masked.
//
// Two kernels, one function:
//
// * bf16 at hd 64, 128, 256 and 320 (every config that reaches K3 causally)
//   and at (hd, hdv) = (192, 128) runs on the tensor cores:
//   flash_attention_tc_kernel below.
// * f32 at every head dim, and bf16 at hd 8, 16 and 32 (no config reaches
//   them; the tensor-core kernel's 16-byte rows and ldmatrix tiles want hd a
//   multiple of 64), run on the CUDA cores: flash_attention_kernel.  f32 stays
//   there because its 2e-5 tolerance holds only in f32 FMAs (TF32 keeps ~3
//   digits).
//
// What bounds it on an H100: at llama3.2-1b prefill (hd 64, S 2048) the work
// is ~4*hd FLOPs per live (q, k) pair against ~4*hd bytes per q row, far
// above the card's ~295 FLOP/byte ridge, so it is bound by operations; the
// tensor-core kernel exists to run them at the tensor cores' rate.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q; const void* k; const void* v; void* o;
  int B, Sq, Sk, H, K;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  int causal, window, bq, bk, q_off;
  float scale;
};

// Mirrors repro_torch.kernels.flash_attention.kv_tile_range; qs is the
// global position of the q tile's first row.
__device__ __forceinline__ void kv_tile_range(int qs, int bq, int bk, int nk, int causal,
                                              int window, int kv_len, int* lo, int* hi) {
  *lo = window > 0 ? max(0, qs - window + 1) / bk : 0;
  int h = min(nk, (kv_len + bk - 1) / bk);
  if (causal) h = min(h, (qs + bq - 1) / bk + 1);
  *hi = h;
}

// The "full" half of _tile_class: every (q, k) pair of the tile is live
// (qs global, as in kv_tile_range).
__device__ __forceinline__ bool tile_full(int qs, int ks, int bq, int bk, int causal,
                                          int window, int kv_len) {
  const int q_min = qs, q_max = qs + bq - 1, k_min = ks, k_max = ks + bk - 1;
  bool full = k_max < kv_len;
  if (causal) full = full && k_max <= q_min;
  if (window > 0) full = full && k_min >= q_max - window + 1;
  return full;
}

// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16; hd 64, 128, 256, 320).
//
// One CTA of 4 warps per (head, batch, q tile of up to 64 rows); each warp
// owns 16 q rows.  Both products run on mma.sync.m16n8k16 (bf16 in, f32
// accumulate).  mma.sync rather than wgmma: it is what removes the CUDA-core
// bound, it lets P go from the S accumulator straight into the next product
// in registers with one fragment layout per warp, and it needs no
// warpgroup-wide descriptors or asynchronous fences; wgmma is the next step.
//
// * S = q.k^T: the q fragment is the A operand; k rows, stored [key][hd] in
//   shared memory, are the "col" B operand, read with ldmatrix.x4.
// * P stays in registers: the f32 S fragment of two neighbouring n8 key
//   tiles is, element for element, the A fragment of the k16 step of p.v,
//   so P is rounded to bf16 there and fed to the second mma.  Rounding P is
//   the one numeric departure from the TPU kernel, which keeps P in f32: it
//   costs about bf16's epsilon (2^-8) relative on each weight, far inside
//   the bf16 tolerance of 2e-2.  l sums the unrounded f32 weights.
// * O += P.v: v rows, stored [key][hd], are the B operand through
//   ldmatrix.x4.trans.
// * The online softmax runs on the fragment: a thread holds 2 rows (gid,
//   gid + 8) x 2 columns of each n8 tile, so the row max is a max over the
//   thread's columns and then over the quad (__shfl_xor_sync 1 and 2).  The
//   accumulator is rescaled by alpha = 2^(m_prev - m_new) once per kv tile.
//   Scores are kept in the log2 domain (scale * log2 e folded in), with the
//   finite NEG_INF for masked pairs and -inf for keys past the tile's end,
//   which so take no part at all, as in the plain twin, where they do not
//   exist.
// * Loads: q once and each k/v tile by cp.async, 16 bytes a thread, into a
//   ring of 2 bf16 stages; tile j+1's loads are issued before tile j's
//   products.  Rows past Sk (or past the tile's bk) and q rows past Sq use
//   the zero-fill form (src-size 0): nothing is read out of bounds, and
//   zeros rather than stale bits meet the zero weights.  Each 16-byte chunk
//   c of row r sits at chunk c ^ (r & 7) of its row (rows are a multiple of
//   128 bytes), so the 8 rows one ldmatrix phase reads hit 8 distinct bank
//   groups, transposed or not.
// * Registers: the accumulator of 16 rows x hdv f32 is hdv/2 registers a
//   thread (160 at hd 320), the q fragments hd/4 more.  While hd + hdv is
//   at most 320 the q fragments stay in registers for the whole kv loop
//   (228 registers at (192, 128), which ran 10% faster than reading them
//   from shared memory at 168); above, they are read from shared memory
//   with ldmatrix at each k step (that loop unrolled 4 deep: fully
//   unrolled, its fragments in flight spill at hd 320).  kv tiles are 64 keys while hd + hdv is at most 320,
//   else 32 (S is then 16 registers).  Shared memory: (64 * hd + 2 * bk *
//   (hd + hdv)) bf16, 120 KB at hd 320, 104 KB at (192, 128).
// * Grid: (H, B, q tiles) with the q tile taken from the top down, so that
//   the longest causal rows start first (the block scheduler walks x
//   fastest and z slowest).
namespace tc {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;       // q rows per CTA
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__host__ __device__ constexpr int block_k(int hd, int hdv) { return hd + hdv <= 320 ? 64 : 32; }

__host__ __device__ constexpr size_t smem_bytes(int hd, int hdv) {
  return size_t(BQ * hd + 2 * block_k(hd, hdv) * (hd + hdv)) * sizeof(bf16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared; with valid false nothing is read and the 16
// bytes are zero-filled.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a . b for one m16n8k16 tile: a the 16x16 A fragment, b0 b1 the
// 16x8 B fragment, d the 16x8 f32 accumulator.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as one bf16x2 register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Element offset of 16-byte chunk c of row r in a swizzled [rows][HD] tile.
template <int HD>
__device__ __forceinline__ int swz(int r, int c) {
  return r * HD + ((c ^ (r & 7)) << 3);
}

template <int HD, int HDV>
__global__ void __launch_bounds__(THREADS) flash_attention_tc_kernel(Params p) {
  constexpr int BK = block_k(HD, HDV);
  constexpr int CH = HD / 8;        // 16-byte chunks per q or k row
  constexpr int CHV = HDV / 8;      // 16-byte chunks per v row
  constexpr int NT = BK / 8;        // n8 key tiles of S
  constexpr int DT = HDV / 8;       // n8 head-dim tiles of O
  constexpr int KS = HD / 16;       // k16 steps of q.k^T
  constexpr bool Q_IN_REGS = HD + HDV <= 320;
  static_assert(HD % 64 == 0 && HDV % 64 == 0 && BK % 16 == 0, "tile shapes");

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);   // [BQ][HD]
  bf16* sk = sq + BQ * HD;                     // [2][BK][HD]
  bf16* sv = sk + 2 * BK * HD;                 // [2][BK][HDV]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int qs = (gridDim.z - 1 - blockIdx.z) * p.bq;
  const int kvh = h / (p.H / p.K);
  const int q_rows = min(p.bq, p.Sq - qs);    // rows of this tile inside Sq

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  for (int i = tid; i < BQ * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = r < q_rows;
    cp_async_16(smem_u32(sq + swz<HD>(r, c)), qg + (ok ? (qs + r) * p.q_ss + c * 8 : 0), ok);
  }
  cp_async_commit();

  auto load_kv = [&](int j, int stage) {
    const int ks = j * p.bk;
    const int n = min(p.bk, p.Sk - ks);
    bf16* dk = sk + stage * BK * HD;
    bf16* dv = sv + stage * BK * HDV;
    if constexpr (HD == HDV) {
      for (int i = tid; i < BK * CH; i += THREADS) {
        const int r = i / CH, c = i % CH;
        const bool ok = r < n;
        const int64_t row = ok ? ks + r : 0;
        const int off = swz<HD>(r, c);
        cp_async_16(smem_u32(dk + off), kg + row * p.k_ss + c * 8, ok);
        cp_async_16(smem_u32(dv + off), vg + row * p.v_ss + c * 8, ok);
      }
    } else {
      for (int i = tid; i < BK * CH; i += THREADS) {
        const int r = i / CH, c = i % CH;
        const bool ok = r < n;
        cp_async_16(smem_u32(dk + swz<HD>(r, c)), kg + int64_t(ok ? ks + r : 0) * p.k_ss + c * 8, ok);
      }
      for (int i = tid; i < BK * CHV; i += THREADS) {
        const int r = i / CHV, c = i % CHV;
        const bool ok = r < n;
        cp_async_16(smem_u32(dv + swz<HDV>(r, c)), vg + int64_t(ok ? ks + r : 0) * p.v_ss + c * 8, ok);
      }
    }
  };

  const int nk = (p.Sk + p.bk - 1) / p.bk;
  int lo, hi;
  kv_tile_range(p.q_off + qs, p.bq, p.bk, nk, p.causal, p.window, p.Sk, &lo, &hi);
  if (lo < hi) load_kv(lo, 0);
  cp_async_commit();
  cp_async_wait<1>();               // the q tile is in
  __syncthreads();

  // ldmatrix lane roles.  A operand (q) and the transposed B operand (v):
  // lanes 8-15 give rows 8-15, lanes 16-31 the second 8 columns.  B operand
  // (k): lanes 8-15 the second 8 columns, lanes 16-31 keys 8-15.
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_chk = lane >> 4;
  const int k_row = (lane & 7) + (lane >> 4) * 8;
  const int k_chk = (lane >> 3) & 1;
  const int q_row = warp * 16 + a_row;

  uint32_t qf[Q_IN_REGS ? KS : 1][4];
  if constexpr (Q_IN_REGS) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) ldsm_x4(smem_u32(sq + swz<HD>(q_row, 2 * kk + a_chk)), qf[kk]);
  }

  float o[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  const float sl2 = p.scale * LOG2E;
  // the global position of the thread's first row (its second is 8 on;
  // their local rows, pos - q_off, are needed only for the store)
  const int pos0 = p.q_off + qs + warp * 16 + gid;

  for (int j = lo; j < hi; ++j) {
    const int stage = (j - lo) & 1;
    if (j + 1 < hi) load_kv(j + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();             // tile j is in
    __syncthreads();
    const bf16* tk = sk + stage * BK * HD;
    const bf16* tv = sv + stage * BK * HDV;

    float s[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll (Q_IN_REGS ? KS : 4)
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      if constexpr (Q_IN_REGS) {
        a[0] = qf[kk][0]; a[1] = qf[kk][1]; a[2] = qf[kk][2]; a[3] = qf[kk][3];
      } else {
        ldsm_x4(smem_u32(sq + swz<HD>(q_row, 2 * kk + a_chk)), a);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kb[4];
        ldsm_x4(smem_u32(tk + swz<HD>(np * 16 + k_row, 2 * kk + k_chk)), kb);
        mma(s[2 * np], a, kb[0], kb[1]);
        mma(s[2 * np + 1], a, kb[2], kb[3]);
      }
    }

    // scale into the log2 domain and mask
    const int ks = j * p.bk;
    // Two forms of one mask.  Lane (t, e) holds key c = t * 8 + tig * 2 +
    // (e & 1) of the tile for row pos0 (e < 2) or pos0 + 8.  Up to hd 128
    // the direct form keeps ptxas's allocation as it was without q_off (at
    // hd 128 the other form takes fewer registers and runs slower); above
    // it, where the accumulator takes hd / 2 registers, the
    // strength-reduced form (per tile only n_left and dist0, per lane
    // compile-time constants) keeps hd 320 from spilling.
    if constexpr (HD <= 128) {
      const int n = min(p.bk, p.Sk - ks);
      const bool masked =
          p.bk < BK || !tile_full(p.q_off + qs, ks, p.bq, p.bk, p.causal, p.window, p.Sk);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[t][e] * sl2;
          if (masked) {
            const int c = t * 8 + tig * 2 + (e & 1);    // key within the tile
            const int kj = ks + c, pos = e < 2 ? pos0 : pos0 + 8;
            bool live = true;
            if (p.causal) live = pos >= kj;
            if (p.window > 0) live = live && pos - kj < p.window;
            x = c >= n ? -INFINITY : live ? x : NEG_INF;
          }
          s[t][e] = x;
        }
      }
    } else {
      const bool masked =
          p.bk < BK || !tile_full(p.q_off + qs, ks, p.bq, p.bk, p.causal, p.window, p.Sk);
      const int n_left = min(p.bk, p.Sk - ks) - tig * 2;
      const int dist0 = pos0 - ks - tig * 2;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[t][e] * sl2;
          if (masked) {
            const int c = t * 8 + (e & 1);              // key past tig * 2
            const int d = dist0 + (e < 2 ? 0 : 8) - c;  // row pos - key pos
            bool live = true;
            if (p.causal) live = d >= 0;
            if (p.window > 0) live = live && d < p.window;
            x = c >= n_left ? -INFINITY : live ? x : NEG_INF;
          }
          s[t][e] = x;
        }
      }
    }

    // online softmax on the fragment
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      mx0 = fmaxf(mx0, fmaxf(s[t][0], s[t][1]));
      mx1 = fmaxf(mx1, fmaxf(s[t][2], s[t][3]));
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      s[t][0] = exp2f(s[t][0] - m0);
      s[t][1] = exp2f(s[t][1] - m0);
      s[t][2] = exp2f(s[t][2] - m1);
      s[t][3] = exp2f(s[t][3] - m1);
      ps0 += s[t][0] + s[t][1];
      ps1 += s[t][2] + s[t][3];
    }
    l0 = l0 * alpha0 + ps0;         // a per-thread partial, summed at the end
    l1 = l1 * alpha1 + ps1;
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      o[t][0] *= alpha0; o[t][1] *= alpha0;
      o[t][2] *= alpha1; o[t][3] *= alpha1;
    }

    // O += P . v, P rounded to bf16 in registers
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vb[4];
        ldsm_x4_trans(smem_u32(tv + swz<HDV>(kk * 16 + a_row, 2 * dp + a_chk)), vb);
        mma(o[2 * dp], a, vb[0], vb[1]);
        mma(o[2 * dp + 1], a, vb[2], vb[3]);
      }
    }
    __syncthreads();                // this stage is free for tile j + 2
  }

#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh + tig * 2;
  const int row0 = pos0 - p.q_off, row1 = row0 + 8;
  if (warp * 16 + gid < q_rows) {
    bf16* orow = og + row0 * p.o_ss;
#pragma unroll
    for (int t = 0; t < DT; ++t)
      *reinterpret_cast<uint32_t*>(orow + t * 8) = pack_bf16(o[t][0] * inv0, o[t][1] * inv0);
  }
  if (warp * 16 + gid + 8 < q_rows) {
    bf16* orow = og + row1 * p.o_ss;
#pragma unroll
    for (int t = 0; t < DT; ++t)
      *reinterpret_cast<uint32_t*>(orow + t * 8) = pack_bf16(o[t][2] * inv1, o[t][3] * inv1);
  }
}

template <int HD, int HDV>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  if (p.bq > BQ || p.bk > block_k(HD, HDV)) return cudaErrorInvalidValue;
  constexpr size_t smem = smem_bytes(HD, HDV);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(flash_attention_tc_kernel<HD, HDV>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(p.H, p.B, (p.Sq + p.bq - 1) / p.bq);
  flash_attention_tc_kernel<HD, HDV><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// CUDA-core kernel (f32 at every head dim; bf16 at hd 8, 16, 32).
//
// One CTA per (q tile, head, batch).  Up to hd 128 one thread holds a q row
// and its accumulator in registers, up to 128 rows a CTA.  From hd 256 a
// row's q and accumulator do not fit one thread's registers: a group of G
// neighbouring threads shares the row (G = 4 at hd 256, 8 at hd 320), each
// holding every G-th float4 of it (interleaved, so the group's shared-memory
// reads of one k/v row hit distinct banks), and the group sums its q.k
// partial dots with __shfl_xor_sync.  Such a CTA holds 256 / G rows.  Each
// k/v tile is staged once in shared memory as f32 and read by every thread
// as warp-wide broadcasts; keys are taken 16 at a time so that the softmax
// rescale (one exp per chunk) is amortized.
constexpr int CH = 16;          // keys per online-softmax step
constexpr int MAX_BQ = 128;     // q rows per CTA, one thread per row

__host__ __device__ constexpr int max_threads(int g) { return g == 1 ? MAX_BQ : 256; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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
  const int pos = p.q_off + row;          // the row's global position
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
  kv_tile_range(p.q_off + qs, p.bq, p.bk, nk, p.causal, p.window, kv_len, &lo, &hi);

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
    const bool full = tile_full(p.q_off + qs, ks, p.bq, p.bk, p.causal, p.window, kv_len);

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
          if (p.causal) live = live && pos >= kj;
          if (p.window > 0) live = live && pos - kj < p.window;
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

cudaError_t dispatch_f32(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 8: return launch<float, 8>(p, stream);
    case 16: return launch<float, 16>(p, stream);
    case 32: return launch<float, 32>(p, stream);
    case 64: return launch<float, 64>(p, stream);
    case 128: return launch<float, 128>(p, stream);
    case 256: return launch<float, 256, 4>(p, stream);
    case 320: return launch<float, 320, 8>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_bf16(const Params& p, int hd, int hdv, cudaStream_t stream) {
  typedef __nv_bfloat16 bf16;
  if (hd != hdv)
    return hd == 192 && hdv == 128 ? tc::launch<192, 128>(p, stream) : cudaErrorInvalidValue;
  switch (hd) {
    case 8: return launch<bf16, 8>(p, stream);
    case 16: return launch<bf16, 16>(p, stream);
    case 32: return launch<bf16, 32>(p, stream);
    case 64: return tc::launch<64, 64>(p, stream);
    case 128: return tc::launch<128, 128>(p, stream);
    case 256: return tc::launch<256, 256>(p, stream);
    case 320: return tc::launch<320, 320>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  hd: q's and k's head dim (the scale
// is hd^-0.5); hdv: v's and o's.  q_off: the global position of q's row 0
// (keys are at 0 .. Sk-1).  Returns cudaGetLastError() after the launch (0
// on success); the caller raises on anything else.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int dtype,
                        int B, int Sq, int Sk, int H, int K, int hd, int hdv,
                        int64_t q_sb, int64_t q_ss, int64_t q_sh,
                        int64_t k_sb, int64_t k_ss, int64_t k_sh,
                        int64_t v_sb, int64_t v_ss, int64_t v_sh,
                        int64_t o_sb, int64_t o_ss, int64_t o_sh,
                        int causal, int window, int bq, int bk, int q_off,
                        void* stream) {
  if (bq < 1 || bq > MAX_BQ || bk < 1 || K < 1 || H % K || q_off < 0)
    return int(cudaErrorInvalidValue);
  Params p{q, k, v, o, B, Sq, Sk, H, K,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
           causal, window, bq, bk, q_off, float(1.0 / std::sqrt(double(hd)))};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? (hd == hdv ? dispatch_f32(p, hd, s) : cudaErrorInvalidValue)
                  : dtype == 1 ? dispatch_bf16(p, hd, hdv, s)
                               : cudaErrorInvalidValue;
  return int(err);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
