// K1: the Hanoi step machine for Hopper (sm_90a).
//
// Replaces the JAX device program of src/repro/core/hanoi.py: _run (a
// lax.while_loop over _step, a 29-way lax.switch over opcodes), vmapped over
// warps by src/repro/engine/adapters.py::_jitted_batch_runner.  No Pallas
// kernel carries it; torch cannot keep a data-dependent loop over an opcode
// switch resident on the device, so it is written by hand.
//
// One launch runs a whole batch: it builds each warp's initial state (the
// reference's init_state), steps it until it halts or spends its fuel, and
// writes the final state, its trace and the trace's -1 / 0 fill past
// trace_n.  The grid is what the card holds at once; each hardware warp
// takes simulated warps one after another from a counter, and once none is
// left it fills the rows of warps that are done (below).  A simulated warp
// runs on one hardware warp:
//   - lane t holds its registers (a column of the warp's register file,
//     [n_regs][32]) and its predicates: the bits of one 32-bit word in a
//     register up to 32 predicates, else ceil(n_preds / 32) words in the
//     warp's shared memory ([words][32]); execution masks come from
//     __ballot_sync, lanes >= n_threads are never set in them;
//   - the WS and REC stacks (depth n_threads + 2), the Bx file, the
//     program's padded rows, the oracle skip flags and the mem_size image
//     live in the warp's slice of shared memory; waiting, finished, the
//     stack tops, fuel and the counters are warp-uniform registers.
//
// The layout follows the shape (choose_layout picks it before the launch;
// hanoi_step.layout asks the same function): 4 simulated warps a CTA, or 2,
// or 1, the most whose slices fit the 232,448 bytes a CTA may use.  Past one
// warp's limit the memory image, then the program rows with the skip flags,
// then the register file leave shared memory, one after the other: the
// memory image is worked on in place in the mem output, the program is read
// through the read-only path, and the registers live in a global scratch
// buffer with the shared layout.  The default shape (the paper's config)
// runs 4 warps a CTA with everything in shared memory.
//
// What bounds it on an H100: each scheduler slot is a chain of dependent
// shared-memory reads (stack top, program row, registers) of ~30 cycles
// each, so one warp's time is its slot count times that chain; the trace's
// max_steps entries a warp are the bytes, most of them the -1 / 0 fill past
// trace_n.  Many warps a SM hide the chain's latency from each other.  So:
//   - the trace is written once, coalesced 32 entries at a time from a
//     buffer of one entry a lane;
//   - the fill is Hopper's bulk asynchronous copies
//     (cp.async.bulk.global.shared::cta) of a CTA-wide tile of -1 words and
//     one of 0 words, issued by one lane over 16-byte-aligned ranges (plain
//     stores write the few words at their ends).  It overlaps the stepping
//     of the longest warps, which set the kernel's time: at each 32-entry
//     flush of its trace, a warp fills its rows from their end down by up
//     to FILL_PIECES tiles while the filled range stays FILL_MARGIN entries
//     clear of the trace; what is left past trace_n once it halts is filled
//     by a hardware warp that has run out of warps to step, or, for a warp
//     still stepping when its row came up, by itself at its end (a
//     per-warp state word, set by atomics, decides which).  A trace that
//     grows into the filled range first waits for those copies to complete
//     (cp.async.bulk.wait_group), so its entries land after the fill.
//     Before exiting, a warp waits only until its copies have read the
//     tiles (cp.async.bulk.wait_group.read).
//
// Where a literal port would diverge from the reference, this follows it:
//   - _first_lane of an empty mask is lane 0 (jnp.argmax), not __ffs(0) - 1;
//   - IADD, IADDI, IMUL and SHL wrap as int32 (done in uint32_t), SHL and
//     SHR shift by imm & 31, SHR is a logical u32 shift;
//   - addresses are floor-mod: (R + imm) mod mem_size is never negative;
//   - STG and the atomics apply lanes one at a time, in lane order, last
//     writer wins: STG through __match_any_sync (the highest lane of each
//     address writes), the atomics through a serial loop over the lanes;
//   - JAX's index rules: a gather normalizes a negative index once and
//     clamps (gidx), a scatter normalizes once and drops what is out of
//     range (sidx); a register or predicate write out of range writes
//     nothing; an opcode past ATOMADD runs as ATOMADD (lax.switch clamps);
//   - a pc outside the program is an implicit EXIT.
//
// Every value of the warp-uniform state is computed by all 32 lanes alike,
// and each slot reads all the uniform state it needs before it writes
// any: a __syncwarp() separates the reads from the writes and ends the slot.
#include <cuda_runtime.h>
#include <stdint.h>

// The launch's arguments (hanoi_step._Params mirrors it field for field).
struct HanoiArgs {
  const int* prog;                 // [N, L, 8]
  const unsigned char* skip;       // [N, L] (bool)
  const int* regs_in;              // [N, W, NR]
  const int* mem_in;               // [N, M]
  const int* lanes_in;             // [N, W]
  int* ws_pc; long long* ws_mask; int* ws_top;          // [N, SD] x2, [N]
  int* rec_pc; int* rec_bx; int* rec_top;               // [N, SD] x2, [N]
  long long* bx_val; unsigned char* bx_valid;           // [N, NB] x2
  long long* waiting; long long* finished;              // [N]
  int* regs; unsigned char* preds; int* mem; int* lane_ids;
  int* trace_pc; int* trace_mask;                       // [N, T]
  int* trace_n; int* steps; int* fuel; unsigned char* halted; int* error;
  int* regs_work;                  // [N, NR, 32] when the registers are global
  int* work;                       // [2 + 2N] zeros: the next warp to step,
                                   // the next row to fill, each warp's
                                   // state and its filled range's start
  int N, L, W, NR, NP, NB, M, T;
  unsigned full, active0;
  int majority_first;
};

// The layout of a launch: simulated warps a CTA, the parts that live in
// global memory, and the CTA's shared memory in bytes (choose_layout).
struct Choice {
  int warps, global_mem, global_prog, global_regs, smem;
};

// What the kernel takes: the caller's arguments, the layout chosen for them
// and whether the trace buffers take bulk copies (16-byte aligned).
struct HanoiParams : HanoiArgs, Choice {
  int bulk;
};

namespace {

constexpr int SMEM_LIMIT = 232448;  // shared memory a CTA may use (H100)
constexpr unsigned ALL = 0xffffffffu;
constexpr int ERR_NO_FREE_BX = 1;
// the fill's tiles (-1, then 0), at the end of a CTA's shared memory; the
// tiles a warp's rows take at each flush of its trace, at most, and the
// entries they keep clear above it
constexpr int FILL_WORDS = 256, FILL_BYTES = 2 * FILL_WORDS * 4;
constexpr int FILL_PIECES = 16, FILL_MARGIN = 1024;
// a simulated warp's state word: stepping, done (a filler fills its row),
// or passed by the fillers while stepping (it fills its row itself)
constexpr int STEPPING = 0, DONE = 1, SELF_FILL = 2;

enum Op : int {
  NOP, EXIT, BRA, BSSY, BSYNC, BMOV_B2R, BMOV_R2B, BREAK, WARPSYNC, YIELD,
  CALL, RET, MOV, MOVR, IADD, IADDI, IMUL, AND_, OR_, XOR_, SHL, SHR, ISETP,
  LANEID, LDG, STG, ATOMCAS, ATOMEXCH, ATOMADD
};


__host__ __device__ inline int align16(int b) { return (b + 15) & ~15; }

// One warp's slice of shared memory.  A
// part that lives in global memory (g_*) takes no room; NPW is the words of
// predicates a lane keeps here (0 when they fit a register).
struct Layout {
  int prog, mem, regs, ws_pc, ws_mask, rec_pc, rec_bx, bx_val, bx_valid,
      skip, preds, total;
};

__host__ __device__ inline Layout layout(int L, int NR, int NB, int M, int SD,
                                         int NPW, bool g_mem, bool g_prog,
                                         bool g_regs) {
  Layout o;
  int off = 0;
  o.prog = off;     off += g_prog ? 0 : align16(L * 8 * 4);
  o.mem = off;      off += g_mem ? 0 : align16(M * 4);
  o.regs = off;     off += g_regs ? 0 : align16(NR * 32 * 4);
  o.ws_pc = off;    off += align16(SD * 4);
  o.ws_mask = off;  off += align16(SD * 4);
  o.rec_pc = off;   off += align16(SD * 4);
  o.rec_bx = off;   off += align16(SD * 4);
  o.bx_val = off;   off += align16(NB * 4);
  o.bx_valid = off; off += align16(NB);
  o.skip = off;     off += g_prog ? 0 : align16(L);
  o.preds = off;    off += align16(NPW * 32 * 4);
  o.total = off;
  return o;
}

// The layout of a shape, before the launch: everything in shared memory
// with 4 simulated warps a CTA, else 2, else 1, the most whose slices (and
// the CTA's fill tiles) fit SMEM_LIMIT; past one warp's limit, one warp a
// CTA with the memory image in global memory; past that, the program rows
// too; past that, the register file too.  warps 0 when even the stacks, the Bx file and the predicates do
// not fit.  A part is sized (in int) only where it stays in shared memory,
// and only once it alone fits there.
inline Choice choose_layout(int L, int W, int NR, int NP, int NB, int M) {
  const int SD = W + 2, NPW = NP > 32 ? (NP + 31) / 32 : 0;
  const bool mem_fits = (long long)M * 4 <= SMEM_LIMIT,
             prog_fits = (long long)L * 33 <= SMEM_LIMIT,
             regs_fits = (long long)NR * 128 <= SMEM_LIMIT;
  if ((long long)NB * 5 + (long long)NPW * 128 > SMEM_LIMIT) return {};
  constexpr int ladder[6][4] = {{4, 0, 0, 0}, {2, 0, 0, 0}, {1, 0, 0, 0},
                                {1, 1, 0, 0}, {1, 1, 1, 0}, {1, 1, 1, 1}};
  for (const auto& c : ladder) {
    if ((!c[1] && !mem_fits) || (!c[2] && !prog_fits) ||
        (!c[3] && !regs_fits))
      continue;
    const long long b = (long long)c[0] *
        layout(L, NR, NB, M, SD, NPW, c[1], c[2], c[3]).total + FILL_BYTES;
    if (b <= SMEM_LIMIT) return {c[0], c[1], c[2], c[3], int(b)};
  }
  return {};
}

// JAX gather index: normalize a negative index once, then clamp
__device__ __forceinline__ int gidx(int i, int n) {
  if (i < 0) i += n;
  return min(max(i, 0), n - 1);
}

// JAX scatter index: normalize once; false (dropped) if still out of range
__device__ __forceinline__ bool sidx(int i, int n, int& j) {
  j = i < 0 ? i + n : i;
  return j >= 0 && j < n;
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return int(unsigned(a) + unsigned(b));
}

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// one bulk copy of `bytes` (a multiple of 16) from shared to global memory
__device__ __forceinline__ void bulk_store(void* gmem, const void* smem,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      :: "l"(gmem), "r"(s), "r"(bytes) : "memory");
}

// until this thread's bulk copies have written their destinations, and
// ordered before its later generic accesses
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n"
               "fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// words [from, to) of a warp's two trace rows (word row0 of the buffers) to
// -1 and 0: bulk copies of the tiles over the 16-byte-aligned middle (by
// lane 0, as one group), plain stores at its ends; plain stores only where
// !bulk.
__device__ __forceinline__ void fill_range(int* tr_pc, int* tr_mask,
                                           long long row0, int from, int to,
                                           const unsigned char* tiles,
                                           bool bulk, int lane) {
  int lo = from, hi = from;             // the bulk range [lo, hi)
  if (bulk) {
    const int a = from + int((4 - ((row0 + from) & 3)) & 3);
    const int b = to - int((row0 + to) & 3);
    if (a < b) { lo = a; hi = b; }
  }
  for (int i = from + lane; i < lo; i += 32) { tr_pc[i] = -1; tr_mask[i] = 0; }
  for (int i = max(hi, from) + lane; i < to; i += 32) {
    tr_pc[i] = -1; tr_mask[i] = 0;
  }
  if (lane == 0 && lo < hi) {
    for (int i = lo; i < hi; i += FILL_WORDS) {
      const int bytes = min(FILL_WORDS, hi - i) * 4;
      bulk_store(tr_pc + i, tiles, bytes);
      bulk_store(tr_mask + i, tiles + FILL_BYTES / 2, bytes);
    }
    bulk_commit();
  }
}

// first set lane among the low W bits; 0 for none (jnp.argmax)
__device__ __forceinline__ int first_lane(unsigned m, unsigned full) {
  m &= full;
  return m ? __ffs(m) - 1 : 0;
}

// predicate guard of encoded field p (0 / +k / -k) for this lane
__device__ __forceinline__ bool pred_of(unsigned pbits, int p, int NP) {
  if (p == 0) return true;
  long long idx = (p < 0 ? -(long long)p : (long long)p) - 1;
  idx = idx < 0 ? 0 : (idx > NP - 1 ? NP - 1 : idx);
  const bool v = (pbits >> idx) & 1u;
  return p > 0 ? v : !v;
}

__device__ __forceinline__ bool compare(int a, int b, int code) {
  switch (min(max(code, 0), 5)) {
    case 0: return a == b;
    case 1: return a != b;
    case 2: return a < b;
    case 3: return a <= b;
    case 4: return a > b;
    default: return a >= b;
  }
}

// WARPS simulated warps a CTA; GEN: the layout may put the memory image, the
// program and the registers in global memory (p.global_*; only at WARPS 1);
// BIGP: more than 32 predicates, kept in shared memory.  The explicit
// minimum of one CTA an SM leaves ptxas free to take the registers the
// step code needs; without it ptxas caps them (72 at 4 warps a CTA, and
// spills in the global layout), and the step runs slower.
template <int WARPS, bool GEN, bool BIGP>
__global__ void __launch_bounds__(WARPS * 32, 1) hanoi_kernel(HanoiParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the fill's tiles, after the warps' slices; visible to the bulk copies'
  // async proxy before any warp copies them
  unsigned char* const tiles = smem + p.smem - FILL_BYTES;
  for (int i = threadIdx.x; i < FILL_WORDS; i += WARPS * 32) {
    reinterpret_cast<int*>(tiles)[i] = -1;
    reinterpret_cast<int*>(tiles + FILL_BYTES / 2)[i] = 0;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int W = p.W, NR = p.NR, NP = p.NP, NB = p.NB, M = p.M, L = p.L;
  const int SD = W + 2, T = p.T;
  const unsigned FULL = p.full;
  const bool g_mem = GEN && p.global_mem, g_prog = GEN && p.global_prog,
             g_regs = GEN && p.global_regs;
  const int NPW = BIGP ? (NP + 31) / 32 : 0;
  const Layout lay = layout(L, NR, NB, M, SD, NPW, g_mem, g_prog, g_regs);
  unsigned char* base = smem + (threadIdx.x >> 5) * lay.total;
  const bool bulk = p.bulk;
  int* const state = p.work + 2;
  int* const filled_from = p.work + 2 + p.N;
  // the next index from a counter, for the whole warp
  auto take = [&](int* counter) -> long long {
    int v = 0;
    if (lane == 0) v = atomicAdd(counter, 1);
    return __shfl_sync(ALL, v, 0);
  };
  // row j's -1 / 0 past trace_n tn that its flushes left: [tn, lo) and
  // [fill_hi, T)
  auto fill_row = [&](long long j, int tn, int lo) {
    int* const rpc = p.trace_pc + j * T;
    int* const rmask = p.trace_mask + j * T;
    fill_range(rpc, rmask, j * T, tn, lo, tiles, bulk, lane);
    const int hi = bulk ? T - int((j * T + T) & 3) : T;
    for (int i = max(tn, hi) + lane; i < T; i += 32) {
      rpc[i] = -1; rmask[i] = 0;
    }
  };

  for (;;) {                            // the simulated warps, one at a time
    const long long w = take(p.work);
    if (w >= p.N) break;
    __syncwarp();                         // the last warp's reads of the slice
    const int* prog = g_prog ? p.prog + w * L * 8
                             : reinterpret_cast<const int*>(base + lay.prog);
    int* mem = g_mem ? p.mem + w * M : reinterpret_cast<int*>(base + lay.mem);
    int* regs = g_regs ? p.regs_work + w * NR * 32          // [NR][32]
                       : reinterpret_cast<int*>(base + lay.regs);
    unsigned* pwords = reinterpret_cast<unsigned*>(base + lay.preds);
    int* ws_pc = reinterpret_cast<int*>(base + lay.ws_pc);
    unsigned* ws_mask = reinterpret_cast<unsigned*>(base + lay.ws_mask);
    int* rec_pc = reinterpret_cast<int*>(base + lay.rec_pc);
    int* rec_bx = reinterpret_cast<int*>(base + lay.rec_bx);
    unsigned* bx_val = reinterpret_cast<unsigned*>(base + lay.bx_val);
    unsigned char* bx_valid = base + lay.bx_valid;
    const unsigned char* skip = g_prog ? p.skip + w * L : base + lay.skip;

    // ---- initial state (the reference's init_state) -------------------------
    if (!g_prog) {
      int* sprog = reinterpret_cast<int*>(base + lay.prog);
      unsigned char* sskip = base + lay.skip;
      for (int i = lane; i < L * 8; i += 32) sprog[i] = p.prog[w * L * 8 + i];
      for (int i = lane; i < L; i += 32) sskip[i] = p.skip[w * L + i];
    }
    for (int i = lane; i < M; i += 32) mem[i] = p.mem_in[w * M + i];
    for (int r = 0; r < NR; ++r)
      regs[r * 32 + lane] = lane < W ? p.regs_in[(w * W + lane) * NR + r] : 0;
    for (int i = lane; i < SD; i += 32) {
      ws_pc[i] = 0; ws_mask[i] = i == 0 ? p.active0 : 0u;
      rec_pc[i] = 0; rec_bx[i] = 0;
    }
    for (int i = lane; i < NB; i += 32) { bx_val[i] = 0u; bx_valid[i] = 0; }
    const bool live_lane = lane < W;
    const int my_lane_id = live_lane ? p.lanes_in[w * W + lane] : 0;
    unsigned pbits = 0;                   // this lane's predicates (!BIGP)
    for (int k = 0; k < NPW; ++k) pwords[k * 32 + lane] = 0u;
    // the guard of encoded predicate field pf (0 / +k / -k) for this lane
    auto guard_of = [&](int pf) -> bool {
      if constexpr (BIGP) {
        if (pf == 0) return true;
        long long idx = (pf < 0 ? -(long long)pf : (long long)pf) - 1;
        idx = idx < 0 ? 0 : (idx > NP - 1 ? NP - 1 : idx);
        const bool v = (pwords[(idx >> 5) * 32 + lane] >> (idx & 31)) & 1u;
        return pf > 0 ? v : !v;
      } else {
        return pred_of(pbits, pf, NP);
      }
    };
    int ws_top = 0, rec_top = -1, trace_n = 0, steps = 0, fuel = T, error = 0;
    unsigned waiting = 0, finished = 0;
    bool halted = false;
    int* const tr_pc = p.trace_pc + w * T;
    int* const tr_mask = p.trace_mask + w * T;
    int buf_pc = -1, buf_mask = 0;        // the trace entry this lane buffers
    // the rows' range [fill_lo, fill_hi) is being filled by bulk copies;
    // fill_hi is the last 16-byte boundary in them, [fill_hi, T) is filled
    // at the end
    const int fill_hi = bulk ? T - int((w * T + T) & 3) : T;
    int fill_lo = fill_hi;
    __syncwarp();

    auto set_pc = [&](int top, int v) { if (top < SD) ws_pc[top] = v; };
    // ws[top] <-> ws[top - 1] for top >= 1, with the reference's gather and
    // scatter rules: read both, then (after the slot's barrier) write both
    struct Swap { int a, b; unsigned ma, mb; };
    auto swap_read = [&](int top) {
      return Swap{ws_pc[gidx(top, SD)], ws_pc[gidx(top - 1, SD)],
                  ws_mask[gidx(top, SD)], ws_mask[gidx(top - 1, SD)]};
    };
    auto swap_write = [&](int top, const Swap& s) {
      if (top < SD) { ws_pc[top] = s.b; ws_mask[top] = s.mb; }
      if (top - 1 < SD) { ws_pc[top - 1] = s.a; ws_mask[top - 1] = s.ma; }
    };

    while (!halted && fuel > 0) {
      // ---- 1) reconvergence check (SS VII-B) ---------------------------------
      const int rtop = gidx(max(rec_top, 0), SD);
      const int rbx = rec_bx[rtop];
      const int rb = gidx(rbx, NB);
      const unsigned live = bx_val[rb] & ~finished;
      fuel -= 1;
      if (rec_top >= 0 && bx_valid[rb] && (live & ~waiting) == 0) {
        const int rpc = rec_pc[rtop];
        __syncwarp();
        int j;
        if (sidx(rbx, NB, j)) bx_valid[j] = 0;
        waiting &= ~live;
        if (live != 0) {
          if (ws_top + 1 < SD) { ws_pc[ws_top + 1] = wrap_add(rpc, 1); ws_mask[ws_top + 1] = live; }
          ws_top += 1;
        }
        rec_top -= 1;
        __syncwarp();
        continue;
      }
      // ---- 2) execute top-of-WS ----------------------------------------------
      if (ws_top < 0) { halted = true; break; }
      const int top = ws_top;
      const int pc = ws_pc[gidx(top, SD)];
      const unsigned amask = ws_mask[gidx(top, SD)];
      if (pc < 0 || pc >= L) {            // fell off the program: an EXIT
        __syncwarp();
        for (int i = lane; i < NB; i += 32)
          if (bx_valid[i]) bx_val[i] &= ~amask;
        finished |= amask;
        ws_top -= 1;
        __syncwarp();
        continue;
      }
      const int4* row = reinterpret_cast<const int4*>(prog + pc * 8);
      const int4 f0 = g_prog ? __ldg(row) : row[0];
      const int4 f1 = g_prog ? __ldg(row + 1) : row[1];
      const int op = min(max(f0.x, 0), int(ATOMADD));
      const int dst = f0.y, s0 = f0.z, s1 = f0.w, s2 = f1.x, imm = f1.y;
      const bool guard = live_lane && guard_of(f1.z) && guard_of(f1.w);
      const unsigned execm = amask & __ballot_sync(ALL, guard);
      const bool ev = (execm >> lane) & 1u;
      // trace: lane (trace_n mod 32) buffers the entry; every 32 entries the
      // warp stores them, coalesced
      if ((trace_n & 31) == lane) { buf_pc = pc; buf_mask = int(amask); }
      trace_n += 1;
      steps += 1;
      if ((trace_n & 31) == 0) {
        if (trace_n > fill_lo) {          // the trace reaches the filled range
          if (lane == 0) bulk_wait();
          __syncwarp();
        }
        tr_pc[trace_n - 32 + lane] = buf_pc;
        tr_mask[trace_n - 32 + lane] = buf_mask;
        // the rows' next pieces from the end down, clear of the trace
        const int k = bulk ? min(FILL_PIECES,
                                 (fill_lo - trace_n - FILL_MARGIN) / FILL_WORDS)
                           : 0;
        if (k > 0) {
          fill_lo -= k * FILL_WORDS;
          if (lane == 0) {
            for (int i = 0; i < k; ++i) {
              bulk_store(tr_pc + fill_lo + i * FILL_WORDS, tiles, FILL_BYTES / 2);
              bulk_store(tr_mask + fill_lo + i * FILL_WORDS,
                         tiles + FILL_BYTES / 2, FILL_BYTES / 2);
            }
            bulk_commit();
          }
        }
      }
      const int R0 = regs[min(max(s0, 0), NR - 1) * 32 + lane];
      const int R1 = regs[min(max(s1, 0), NR - 1) * 32 + lane];
      const int R2 = regs[min(max(s2, 0), NR - 1) * 32 + lane];
      const bool dst_ok = dst >= 0 && dst < NR;
      const int pc1 = pc + 1;
      int j;

      switch (op) {
        case EXIT: {
          const unsigned rem = amask & ~execm;
          __syncwarp();
          for (int i = lane; i < NB; i += 32)
            if (bx_valid[i]) bx_val[i] &= ~execm;
          finished |= execm;
          if (rem == 0) {
            ws_top -= 1;
          } else {
            set_pc(top, pc1);
            if (top < SD) ws_mask[top] = rem;
          }
          break;
        }
        case BRA: {
          const unsigned taken = execm, ft = amask & ~execm;
          __syncwarp();
          if (taken == 0 || ft == 0) {
            set_pc(top, taken == 0 ? pc1 : imm);
          } else {
            const bool maj_ft = p.majority_first && __popc(ft) > __popc(taken);
            if (top < SD) { ws_pc[top] = maj_ft ? imm : pc1; ws_mask[top] = maj_ft ? taken : ft; }
            if (top + 1 < SD) { ws_pc[top + 1] = maj_ft ? pc1 : imm; ws_mask[top + 1] = maj_ft ? ft : taken; }
            ws_top += 1;
          }
          break;
        }
        case BSSY: {
          __syncwarp();
          if (execm != 0) {
            if (sidx(dst, NB, j)) { bx_val[j] = amask; bx_valid[j] = 1; }
            if (rec_top + 1 < SD) { rec_pc[rec_top + 1] = imm; rec_bx[rec_top + 1] = dst; }
            rec_top += 1;
          }
          set_pc(top, pc1);
          break;
        }
        case BSYNC: {
          const bool at_top = rec_top >= 0 && rec_bx[rtop] == dst;
          const unsigned bv = bx_val[gidx(dst, NB)];
          const bool skp = skip[pc] && bx_valid[gidx(dst, NB)] &&
                           (bv & ~finished) != amask;
          const Swap sw = swap_read(top);
          __syncwarp();
          if (skp) {                      // Turing-oracle heuristic (SS IX)
            if (sidx(dst, NB, j)) bx_val[j] = bv & ~amask;
            set_pc(top, pc1);
          } else if (at_top) {
            ws_top -= 1;
            waiting |= amask;
          } else if (top >= 1) {          // park: retry after the sibling
            swap_write(top, sw);
          }
          break;
        }
        case BMOV_B2R: {
          const int v = int(bx_val[gidx(s0, NB)]);
          __syncwarp();
          if (execm != 0) {
            if (ev && dst_ok) regs[dst * 32 + lane] = v;
            if (sidx(s0, NB, j)) bx_valid[j] = 0;
          }
          set_pc(top, pc1);
          break;
        }
        case BMOV_R2B: {
          const int v = __shfl_sync(ALL, R0, first_lane(execm, FULL));
          __syncwarp();
          if (execm != 0 && sidx(dst, NB, j)) {
            bx_val[j] = unsigned(v) & FULL & ~finished;
            bx_valid[j] = 1;
          }
          set_pc(top, pc1);
          break;
        }
        case BREAK: {
          const unsigned bv = bx_val[gidx(dst, NB)];
          __syncwarp();
          if (sidx(dst, NB, j)) bx_val[j] = bv & ~execm;
          set_pc(top, pc1);
          break;
        }
        case WARPSYNC: {
          const int v = __shfl_sync(ALL, R0, first_lane(execm ? execm : amask, FULL));
          const unsigned m = (s0 == -1 ? unsigned(imm) : unsigned(v)) & FULL;
          bool hit = false;
          for (int k = lane; k < SD; k += 32) hit |= k <= rec_top && rec_pc[k] == pc;
          const bool present = __any_sync(ALL, hit);
          const bool at_top = rec_top >= 0 && rec_pc[rtop] == pc;
          int free_bx = -1;
          for (int c = 0; c < NB && free_bx < 0; c += 32) {
            const unsigned b = __ballot_sync(ALL, c + lane < NB && !bx_valid[c + lane]);
            if (b) free_bx = c + __ffs(b) - 1;
          }
          const Swap sw = swap_read(top);
          __syncwarp();
          if (!present) {
            if (free_bx >= 0) {
              bx_val[free_bx] = m & ~finished;
              bx_valid[free_bx] = 1;
              if (rec_top + 1 < SD) { rec_pc[rec_top + 1] = pc; rec_bx[rec_top + 1] = free_bx; }
              rec_top += 1;
              ws_top -= 1;
              waiting |= amask;
            } else {
              error |= ERR_NO_FREE_BX;
              set_pc(top, pc1);
            }
          } else if (at_top) {            // join
            ws_top -= 1;
            waiting |= amask;
          } else if (top >= 1) {          // park
            swap_write(top, sw);
          }
          break;
        }
        case YIELD: {
          bool sib = false;
          Swap sw{};
          if (top >= 1) {
            const int ry = rec_bx[rtop];
            const unsigned lv = bx_val[gidx(ry, NB)] & ~finished;
            sw = swap_read(top);
            // the swap reads ws_pc[top] after the slot's pc + 1 is set
            sw.a = top < SD ? pc1 : ws_pc[SD - 1];
            sib = rec_top >= 0 && bx_valid[gidx(ry, NB)] && ((sw.ma | sw.mb) & ~lv) == 0;
          }
          __syncwarp();
          if (sib) swap_write(top, sw);
          else set_pc(top, pc1);
          break;
        }
        case CALL:
          __syncwarp();
          set_pc(top, execm != 0 ? imm : pc1);
          break;
        case RET: {
          const int tgt = __shfl_sync(ALL, R0, first_lane(execm ? execm : amask, FULL));
          __syncwarp();
          set_pc(top, execm != 0 ? tgt : pc1);
          break;
        }
        case ISETP: {
          const bool res = compare(R0, s1 == -1 ? imm : R1, s2);
          __syncwarp();
          if (ev && dst >= 0 && dst < NP) {
            if constexpr (BIGP) {
              unsigned& word = pwords[(dst >> 5) * 32 + lane];
              word = (word & ~(1u << (dst & 31))) | (unsigned(res) << (dst & 31));
            } else {
              pbits = (pbits & ~(1u << dst)) | (unsigned(res) << dst);
            }
          }
          set_pc(top, pc1);
          break;
        }
        case STG: {
          const int a = floor_mod(wrap_add(R0, imm), M);
          __syncwarp();
          if (ev) {                       // the highest lane of each address wins
            const unsigned same = __match_any_sync(execm, a);
            if (lane == 31 - __clz(same)) mem[a] = R1;
          }
          set_pc(top, pc1);
          break;
        }
        case ATOMCAS: case ATOMEXCH: case ATOMADD: {
          const int a_mine = floor_mod(wrap_add(R0, imm), M);
          const int dc = max(dst, 0);
          __syncwarp();
          for (unsigned m = execm; m; m &= m - 1) {       // lane order
            const int t = __ffs(m) - 1;
            const int a = __shfl_sync(ALL, a_mine, t);
            if (lane == t) {
              const int old = mem[a];
              mem[a] = op == ATOMCAS ? (old == R1 ? R2 : old)
                     : op == ATOMEXCH ? R1 : wrap_add(old, R1);
              if (dc < NR) regs[dc * 32 + lane] = old;
            }
            __syncwarp();
          }
          set_pc(top, pc1);
          break;
        }
        default: {                        // NOP and the register writers
          int v = R0;                     // MOVR
          switch (op) {
            case MOV: v = imm; break;
            case IADD: v = wrap_add(R0, R1); break;
            case IADDI: v = wrap_add(R0, imm); break;
            case IMUL: v = int(unsigned(R0) * unsigned(R1)); break;
            case AND_: v = R0 & R1; break;
            case OR_: v = R0 | R1; break;
            case XOR_: v = R0 ^ R1; break;
            case SHL: v = int(unsigned(R0) << (imm & 31)); break;
            case SHR: v = int(unsigned(R0) >> (imm & 31)); break;
            case LANEID: v = my_lane_id; break;
            case LDG: v = mem[floor_mod(wrap_add(R0, imm), M)]; break;
            default: break;
          }
          __syncwarp();
          if (op != NOP && ev && dst_ok) regs[dst * 32 + lane] = v;
          set_pc(top, pc1);
          break;
        }
      }
      __syncwarp();
    }
    __syncwarp();

    // ---- the trace's buffered tail ------------------------------------------
    const int tail = trace_n & 31;
    if (trace_n > fill_lo) {
      if (lane == 0) bulk_wait();
      __syncwarp();
    }
    if (lane < tail) {
      tr_pc[trace_n - tail + lane] = buf_pc;
      tr_mask[trace_n - tail + lane] = buf_mask;
    }

    // ---- final state -----------------------------------------------------------
    for (int i = lane; i < SD; i += 32) {
      p.ws_pc[w * SD + i] = ws_pc[i];
      p.ws_mask[w * SD + i] = (long long)ws_mask[i];
      p.rec_pc[w * SD + i] = rec_pc[i];
      p.rec_bx[w * SD + i] = rec_bx[i];
    }
    for (int i = lane; i < NB; i += 32) {
      p.bx_val[w * NB + i] = (long long)bx_val[i];
      p.bx_valid[w * NB + i] = bx_valid[i];
    }
    if (!g_mem)                           // else mem is the mem output itself
      for (int i = lane; i < M; i += 32) p.mem[w * M + i] = mem[i];
    if (live_lane) {
      for (int r = 0; r < NR; ++r) p.regs[(w * W + lane) * NR + r] = regs[r * 32 + lane];
      for (int k = 0; k < NP; ++k)
        p.preds[(w * W + lane) * NP + k] =
            ((BIGP ? pwords[(k >> 5) * 32 + lane] : pbits) >> (k & 31)) & 1u;
      p.lane_ids[w * W + lane] = my_lane_id;
    }
    if (lane == 0) {
      p.ws_top[w] = ws_top; p.rec_top[w] = rec_top;
      p.waiting[w] = (long long)waiting; p.finished[w] = (long long)finished;
      p.trace_n[w] = trace_n; p.steps[w] = steps; p.fuel[w] = fuel;
      p.halted[w] = halted; p.error[w] = error;
    }

    // ---- done: a filler fills the rest of the row, or, if the fillers have
    // passed it, this warp ------------------------------------------------------
    int was = STEPPING;
    if (lane == 0) {
      filled_from[w] = fill_lo;
      __threadfence();                    // trace_n and fill_lo before DONE
      was = atomicExch(state + w, DONE);
    }
    if (__shfl_sync(ALL, was, 0) == SELF_FILL) fill_row(w, trace_n, fill_lo);
  }                                     // the simulated warps

  // ---- no warp left to step: fill the rows of the warps that are done -----
  for (;;) {
    const long long j = take(p.work + 1);
    if (j >= p.N) break;
    int tn = -1, lo = 0;                // tn -1: still stepping, it fills
    if (lane == 0 && atomicCAS(state + j, STEPPING, SELF_FILL) == DONE) {
      __threadfence();
      tn = *static_cast<volatile int*>(p.trace_n + j);
      lo = *static_cast<volatile int*>(filled_from + j);
    }
    tn = __shfl_sync(ALL, tn, 0);
    lo = __shfl_sync(ALL, lo, 0);
    if (tn >= 0) fill_row(j, tn, lo);
  }
  if (lane == 0)                        // the copies have read the tiles
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

template <int WARPS, bool GEN, bool BIGP>
int launch(const HanoiParams& p, cudaStream_t stream) {
  if (p.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hanoi_kernel<WARPS, GEN, BIGP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return int(e);
  }
  // the CTAs the card holds at once, at most one a simulated warp's worth
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, hanoi_kernel<WARPS, GEN, BIGP>, WARPS * 32, p.smem);
  if (e != cudaSuccess) return int(e);
  const long long need = (p.N + WARPS - 1) / WARPS;
  const int grid = int(min(need, (long long)max(1, per_sm * sms)));
  hanoi_kernel<WARPS, GEN, BIGP><<<grid, WARPS * 32, p.smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <bool BIGP>
int launch_layout(const HanoiParams& p, cudaStream_t stream) {
  if (p.global_mem || p.global_prog || p.global_regs)
    return p.warps == 1 ? launch<1, true, BIGP>(p, stream)
                        : int(cudaErrorInvalidValue);
  switch (p.warps) {
    case 4: return launch<4, false, BIGP>(p, stream);
    case 2: return launch<2, false, BIGP>(p, stream);
    case 1: return launch<1, false, BIGP>(p, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Runs every warp of the batch to its end, in choose_layout's layout for
// its shape.  Outputs are written whole; the caller allocates them, and the
// register scratch buffer where the layout puts the registers in global
// memory.  Returns cudaGetLastError() after the launch (0 on success); the
// caller raises on anything else.
int hanoi_run(const HanoiArgs* args, void* stream) {
  HanoiParams p;
  static_cast<HanoiArgs&>(p) = *args;
  if (p.N < 1 || p.L < 1 || p.W < 1 || p.W > 32 || p.NR < 1 || p.NP < 1 ||
      p.NB < 1 || p.M < 1 || p.T < 1)
    return int(cudaErrorInvalidValue);
  static_cast<Choice&>(p) = choose_layout(p.L, p.W, p.NR, p.NP, p.NB, p.M);
  if (p.warps == 0 || (p.global_regs && !p.regs_work) || !p.work)
    return int(cudaErrorInvalidValue);
  p.bulk = reinterpret_cast<uintptr_t>(p.trace_pc) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(p.trace_mask) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p.NP > 32 ? launch_layout<true>(p, s) : launch_layout<false>(p, s);
}

// hanoi_run's layout for a shape, into out: warps a CTA (0: none fits),
// global_mem, global_prog, global_regs and the CTA's shared memory bytes.
void hanoi_layout(int L, int W, int NR, int NP, int NB, int M, int* out) {
  const Choice c = choose_layout(L, W, NR, NP, NB, M);
  out[0] = c.warps; out[1] = c.global_mem; out[2] = c.global_prog;
  out[3] = c.global_regs; out[4] = c.smem;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
