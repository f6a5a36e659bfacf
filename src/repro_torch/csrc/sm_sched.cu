// K2: the SM issue scheduler for Hopper (sm_90a).
//
// Replaces the JAX device program of
// src/repro/engine/mechanisms/sm_jax.py::_cell_scheduler (its `schedule`, a
// lax.scan over out_cap issue slots), vmapped over SM cells by
// _compiled_grid_scheduler.  No Pallas kernel carries it; torch cannot keep
// a slot loop with a data-dependent argmin resident on the device, so it is
// written by hand.
//
// One launch schedules a whole grid of cells.  Each slot of a cell issues one
// instruction, after an optional hop over an idle gap:
//   1. the gap to the earliest ready time of a pending warp is a memory stall
//      if a warp waking then is blocked on memory, a scoreboard stall
//      otherwise; greedy-then-oldest forgets its last warp on a gap;
//   2. the ready warp with the lowest priority key issues (GTO: the last
//      warp first, then by id; round robin: from the cursor; oldest first:
//      by id; the keys are injective);
//   3. its next (pc, mask) comes from the trace rows K1 wrote, through
//      warp_map, and the opcode from the warp's program (a pc outside it
//      reads as NOP, the opcode is clipped);
//   4. the warp is ready again after the opcode's latency and is blocked on
//      memory if the opcode is a memory op;
//   5. busy, issue stall (more than one warp ready) and thread instructions
//      (the mask's popcount) are counted.
// Slots past the cell's total are (-1, -1, 0) and count nothing.  All
// arithmetic is int32 and wraps, as JAX's does.
//
// Two layouts:
//   - cells of up to 32 warps (sched_warp_kernel): one hardware warp a cell,
//     up to 8 cells a CTA, as many as spread the grid over every SM; lane w
//     holds warp w's state.  A slot is one link of a
//     dependent chain, and a warp issues in order, so every instruction that
//     waits on a result, and every branch, lengthens the slot.  The design
//     keeps only the link on the chain:
//       * one warp-wide minimum a slot picks both the slot's time and its
//         warp: each pending lane offers (wait, key, lane) packed in a word,
//         its wait the cycles until it is ready (0 when it is), so the
//         minimum's wait is the idle gap and its lane the argmin among the
//         warps ready after it.  Where a wait could pass the word's 21 bits
//         (latencies near 2^21, or a cycle that wraps), a separate build
//         resolves a saturated minimum exactly with two more minima;
//       * each lane keeps its warp's next issue ready (pc, mask, latency and
//         memory flag) and the three after it in stages; the issued lane
//         advances them in the next slot, while that slot's minimum is in
//         flight, by predicated loads that the advance after consumes;
//       * each lane's trace comes through a ring of 64 entries in shared
//         memory, topped up by cp.async once every 16 slots, 16 to 40
//         entries ahead (the copies of one top-up are waited for at the
//         next); the cell's opcode columns are staged in shared memory at
//         the start (read through the read-only path when they do not fit);
//       * the issued lane writes its slot (pc, mask) into a shared staging
//         buffer, flushed coalesced every 16 slots; the counters (the ready
//         count, the gap's class, thread instructions) are votes read a slot
//         later and selects.  The slot loop is unrolled by 16, so a slot has
//         no branch.
//   - wider cells (sched_cta_kernel): one CTA a cell; thread t holds warps
//     t, t + blockDim, ... in a global scratch buffer; two block reductions
//     a slot (the earliest time; then the gap's class, the argmin as a
//     64-bit (key, warp) minimum and the ready count); the issuing warp's
//     thread reads its entry, updates its state and writes the slot.
//
// What bounds it on an H100: each slot is a dependent chain (the minimum,
// then the issued warp's update, then every lane's next word), so a cell's
// time is its slot count times that chain; the cells run side by side.  The
// bytes (the traces read once, the slots written once) are a small share.
// slot_chain_kernel measures the shortest such link on the card.
#include <cuda_runtime.h>
#include <stdint.h>

// The launch's arguments (sm_sched._Params mirrors it field for field).
struct SchedParams {
  const int* warp_map;    // [C, N] row of each warp in the trace buffers
  const int* trace_n;     // [C, N] trace length of each warp
  const int* ops;         // [U, L] opcode column of each trace row's program
  const int* trace_pc;    // [U, T]
  const int* trace_mask;  // [U, T] u32 bits
  int* out_warp;          // [C, cap]
  int* out_pc;            // [C, cap]
  int* out_mask;          // [C, cap] u32 bits
  int* counters;          // [7, C] issued, cycle, busy, istall, sstall,
                          //        mstall, tinstr
  int* scratch;           // [C, N, 4] state of the wide layout
  int C, N, U, L, T, cap, policy;
  int lat[32];            // issue latency of each opcode
  unsigned is_mem;        // bit op: the opcode blocks on memory
};

namespace {

constexpr unsigned ALL = 0xffffffffu;
constexpr int MAX_CELLS = 8;      // cells (hardware warps) a CTA, narrow
constexpr int N_OPS = 29;         // opcodes NOP..ATOMADD
constexpr int NOP = 0;
constexpr int GTO = 0, RR = 1, OLDEST = 2;   // POLICY_NAMES order
constexpr int BIG = 0x7fffffff;
constexpr int WIDE_THREADS = 256;   // a CTA of the wide layout, at most
// the narrow layout: a block of BLOCK slots between top-ups of a lane's
// trace ring (RING entries, copied CHUNK at a time, up to AHEAD entries
// past its cursor: a block reads up to 19 entries past it, and a top-up's
// copies are read only after the next top-up has waited for them)
constexpr int BLOCK = 16, RING = 64, CHUNK = 4, AHEAD = 2 * BLOCK + 8;
constexpr int RING_BYTES = 32 * RING * 4;          // one array, all lanes
constexpr int WARP_BYTES = 2 * RING_BYTES + 2 * BLOCK * 4;   // + staging
constexpr int LAT_BYTES = 128;                      // the latency table
constexpr int SMEM_LIMIT = 232448;  // shared memory a CTA may use (H100)
// the packed word: wait (21 bits) | key (6 bits) | lane (5 bits)
constexpr unsigned SAT = (1u << 21) - 1u;

__device__ __forceinline__ int wadd(int a, int b) {
  return int(unsigned(a) + unsigned(b));
}

__device__ __forceinline__ int wsub(int a, int b) {
  return int(unsigned(a) - unsigned(b));
}

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__host__ __device__ inline int align16(int b) { return (b + 15) & ~15; }

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// dst = *src where pred, else dst unchanged: a predicated load, so that
// only a later reader of dst waits for it
__device__ __forceinline__ void ld_shared_if(int& dst, const int* src,
                                             bool pred) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
               " @p ld.shared.b32 %0, [%1];\n}\n"
               : "+r"(dst) : "r"(a), "r"(int(pred)) : "memory");
}

__device__ __forceinline__ void ld_shared_u8_if(int& dst,
                                                const unsigned char* src,
                                                bool pred) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
               " @p ld.shared.u8 %0, [%1];\n}\n"
               : "+r"(dst) : "r"(a), "r"(int(pred)) : "memory");
}

__device__ __forceinline__ void ld_global_nc_if(int& dst, const int* src,
                                                bool pred) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
               " @p ld.global.nc.b32 %0, [%1];\n}\n"
               : "+r"(dst) : "l"(src), "r"(int(pred)));
}

__device__ __forceinline__ void store_counters(
    const SchedParams& p, long long c, int issued, int cycle, int busy,
    int istall, int sstall, int mstall, int tinstr) {
  int* const q = p.counters + c;
  q[0] = issued; q[p.C] = cycle; q[2 * p.C] = busy; q[3 * p.C] = istall;
  q[4 * p.C] = sstall; q[5 * p.C] = mstall; q[6 * p.C] = tinstr;
}

// ---------------------------------------------------------------------------
// cells of up to 32 warps: one hardware warp a cell
// ---------------------------------------------------------------------------
// Dynamic shared memory: the latency table, then for each cell of the CTA
// its lanes' rings (pc, then mask: [32][RING] each), the staging buffer
// (pc, mask: [BLOCK] each) and, when STAGED, the opcode of each of its
// warps' rows ([N][L] bytes, clipped).  EXACT: waits may pass the packed
// word; vec: the trace rows may be copied 16 bytes at a time.
//
// A slot s: every lane's word, the minimum, then (while the minimum is in
// flight) what slot s - 1 left: the issued lane's output and pipeline
// advance, and the counters from slot s - 1's votes; then the decode and
// the update by selects, and the votes of slot s.
template <int POLICY, bool EXACT, bool STAGED>
__global__ void __launch_bounds__(MAX_CELLS * 32) sched_warp_kernel(
    SchedParams p, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* const lat_s = reinterpret_cast<int*>(smem);
  if (threadIdx.x < 32) lat_s[threadIdx.x] = p.lat[threadIdx.x];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long c = (long long)blockIdx.x * (blockDim.x >> 5) +
                      (threadIdx.x >> 5);
  if (c >= p.C) return;                 // the whole warp leaves together
  const int N = p.N, L = p.L, T = p.T, cap = p.cap;
  const unsigned is_mem = p.is_mem;
  unsigned char* const base = smem + LAT_BYTES + (threadIdx.x >> 5) *
      (WARP_BYTES + (STAGED ? align16(N * L) : 0));
  int* const rpc = reinterpret_cast<int*>(base) + lane * RING;
  int* const rmask = reinterpret_cast<int*>(base + RING_BYTES) + lane * RING;
  int* const st_pc = reinterpret_cast<int*>(base + 2 * RING_BYTES);
  int* const st_mask = st_pc + BLOCK;
  unsigned char* const code = base + WARP_BYTES;       // [N][L]
  const bool mine = lane < N;           // lane w is the cell's warp w
  const int row = mine ? p.warp_map[c * N + lane] : 0;
  const int tn = mine ? p.trace_n[c * N + lane] : 0;
  const int* const tpc = p.trace_pc + (long long)row * T;
  const int* const tmask = p.trace_mask + (long long)row * T;
  const int* const ops = p.ops + (long long)row * L;

  // copies of this lane's trace up to entry `upto` (from `fetched`), chunk
  // k into ring slot k % (RING / CHUNK), as one group; an entry past T - 1
  // reads entry T - 1, as JAX's gather clamps
  int fetched = 0;
  auto top_up = [&](int upto) {
    for (; mine && fetched < upto; fetched += CHUNK) {
      const int at = fetched & (RING - 1);
      if (vec && fetched + CHUNK <= T) {
        cp_async16(rpc + at, tpc + fetched);
        cp_async16(rmask + at, tmask + fetched);
      } else {
#pragma unroll
        for (int i = 0; i < CHUNK; ++i) {
          const int e = min(fetched + i, T - 1);
          cp_async4(rpc + at + i, tpc + e);
          cp_async4(rmask + at + i, tmask + e);
        }
      }
    }
    cp_async_commit();
  };
  top_up(AHEAD);
  if (STAGED) {                         // each warp's row's opcodes, clipped
    for (int w = 0; w < N; ++w) {
      const int* const o = p.ops + (long long)__shfl_sync(ALL, row, w) * L;
      for (int i = lane; i < L; i += 32)
        code[w * L + i] = (unsigned char)min(max(__ldg(o + i), 0), N_OPS - 1);
    }
  }
  cp_async_wait<0>();
  __syncwarp();                         // every lane's copies and opcodes

  // the opcode of a trace entry's pc (NOP outside the program), into op
  // where pred
  auto opcode_if = [&](int& op, int pc, bool pred) {
    const bool in = pc >= 0 && pc < L;
    op = pred ? NOP : op;
    if constexpr (STAGED) {
      ld_shared_u8_if(op, code + lane * L + (in ? pc : 0), pred && in);
    } else {
      ld_global_nc_if(op, ops + (in ? pc : 0), pred && in);
    }
  };
  // the lane's pipeline: entries idx and idx + 1 with their latency and
  // memory flag (q0, q1), entry idx + 2 with its opcode (q2), entry idx + 3
  // as read (q3).  An advance consumes only what the previous one loaded.
  int q0pc = rpc[0], q0m = rmask[0], q1pc = rpc[1], q1m = rmask[1];
  int q2pc = rpc[2], q2m = rmask[2], q3pc = rpc[3], q3m = rmask[3];
  int op0 = NOP, op1 = NOP, op2 = NOP;
  opcode_if(op0, q0pc, mine);
  opcode_if(op1, q1pc, mine);
  opcode_if(op2, q2pc, mine);
  if (!STAGED) op0 = min(max(op0, 0), N_OPS - 1);
  if (!STAGED) op1 = min(max(op1, 0), N_OPS - 1);
  int lat0 = lat_s[op0], lat1 = lat_s[op1];
  bool mem0 = (is_mem >> op0) & 1u, mem1 = (is_mem >> op1) & 1u;

  // the warp's state: its cursor, its earliest issue time (the later of its
  // in-order time and its ready time) and whether it waits on memory
  int idx = 0, earliest = 0;
  bool blocked_mem = false;
  const int total = int(__reduce_add_sync(ALL, unsigned(tn)));
  const int n = max(0, min(cap, total));   // the slots issued
  // uniform: the cycle, the last issued warp (GTO's first slot favours
  // warp 0; round robin's cursor is last + 1, from warp 0)
  int cycle = 0, last = POLICY == RR ? -1 : 0;
  int istall = 0, sstall = 0, mstall = 0, tinstr = 0;   // tinstr: this lane's
  int* const ow = p.out_warp + c * cap;
  int* const opc = p.out_pc + c * cap;
  int* const om = p.out_mask + c * cap;
  int buf_w = -1;                       // the slot's warp this lane buffers
  // what slot s - 1 leaves to slot s: whether this lane issued, the votes
  // of the warps ready after the gap (and of those blocked on memory among
  // them), the gap
  bool issued = false;
  unsigned ready_votes = 0u, mem_votes = 0u, last_gap = 0u;
  const unsigned klane = POLICY == GTO ? (unsigned(lane + 1) << 5) | lane
                                       : (unsigned(lane) << 5) | lane;

  // slot t's deferred half, branch-free: its output, the issued lane's
  // pipeline advance, its counters
  auto settle = [&](int t) {
    if (issued) {                       // predicated stores
      st_pc[t & (BLOCK - 1)] = q0pc;
      st_mask[t & (BLOCK - 1)] = q0m;
    }
    tinstr = wadd(tinstr, issued ? __popc(unsigned(q0m)) : 0);
    q0pc = issued ? q1pc : q0pc; q0m = issued ? q1m : q0m;
    lat0 = issued ? lat1 : lat0; mem0 = issued ? mem1 : mem0;
    const int op = STAGED ? op2 : min(max(op2, 0), N_OPS - 1);
    mem1 = issued ? bool((is_mem >> op) & 1u) : mem1;
    ld_shared_if(lat1, lat_s + op, issued);
    q1pc = issued ? q2pc : q1pc; q1m = issued ? q2m : q1m;
    opcode_if(op2, q3pc, issued);
    q2pc = issued ? q3pc : q2pc; q2m = issued ? q3m : q2m;
    const int e = (idx + 3) & (RING - 1);
    ld_shared_if(q3pc, rpc + e, issued);
    ld_shared_if(q3m, rmask + e, issued);
    istall += __popc(ready_votes) > 1;
    mstall = wadd(mstall, mem_votes ? int(last_gap) : 0);
    sstall = wadd(sstall, mem_votes ? 0 : int(last_gap));
    buf_w = (t & (BLOCK - 1)) == lane ? last : buf_w;
  };
  auto slot = [&](bool settle_prev, int t_prev) {
    const bool pending = idx < tn;
    const unsigned wait = earliest > cycle
        ? unsigned(earliest) - unsigned(cycle) : 0u;
    const unsigned w = EXACT ? min(wait, SAT) : wait;
    unsigned word;
    if constexpr (POLICY == GTO) {
      word = (w << 11) | (lane == last && wait == 0u ? unsigned(lane) : klane);
    } else if constexpr (POLICY == RR) {
      const int d = lane - last - 1;    // (lane - cursor) mod N
      word = (w << 11) | (unsigned(d < 0 ? d + N : d) << 5) | unsigned(lane);
    } else {
      word = (w << 11) | klane;
    }
    unsigned m = __reduce_min_sync(ALL, pending ? word : ALL);
    if (settle_prev) settle(t_prev);    // while the minimum is in flight
    unsigned gap = m >> 11;
    bool ready;                         // ready once the gap has passed
    if (EXACT && gap == SAT) {          // every wait saturated: exactly
      gap = __reduce_min_sync(ALL, pending ? wait : ALL);
      ready = pending && wait == gap;
      m = __reduce_min_sync(ALL, ready ? word & 0x7ffu : ALL);
    } else {
      ready = pending && w == gap;
    }
    const int sel = int(m & 31u);
    const int cyc = int(unsigned(cycle) + gap);
    issued = lane == sel;
    const int t_ready = wadd(cyc, lat0), in_order = wadd(cyc, 1);
    ready_votes = __ballot_sync(ALL, ready);
    mem_votes = __ballot_sync(ALL, ready && blocked_mem);
    earliest = issued ? max(in_order, t_ready) : earliest;
    blocked_mem = issued ? mem0 && t_ready >= in_order : blocked_mem;
    idx += issued;
    last_gap = gap;
    last = sel;
    cycle = wadd(cyc, 1);
  };
  // slots [s0, s0 + k) are settled: store them, coalesced
  auto flush = [&](int s0, int k) {
    __syncwarp();
    if (lane < k) {
      ow[s0 + lane] = buf_w;
      opc[s0 + lane] = st_pc[lane];
      om[s0 + lane] = st_mask[lane];
    }
    __syncwarp();
  };

  int s = 0;
  for (; s + BLOCK <= n; s += BLOCK) {  // blocks of BLOCK slots, no branch
#pragma unroll
    for (int j = 0; j < BLOCK; ++j) slot(j > 0, s + j - 1);
    settle(s + BLOCK - 1);
    flush(s, BLOCK);
    cp_async_wait<0>();                 // the last top-up's copies are here
    top_up(idx + AHEAD);
  }
  for (int j = 0; s + j < n; ++j) slot(j > 0, s + j - 1);   // the rest
  if (s < n) {
    settle(n - 1);
    flush(s, n - s);
  }
  // (-1, -1, 0) to cap
  for (int i = n + lane; i < cap; i += 32) {
    ow[i] = -1; opc[i] = -1; om[i] = 0;
  }
  cp_async_wait<0>();                   // no copy outlives the CTA
  tinstr = int(__reduce_add_sync(ALL, unsigned(tinstr)));
  if (lane == 0)
    store_counters(p, c, n, cycle, n, istall, sstall, mstall, tinstr);
}

// ---------------------------------------------------------------------------
// wider cells: one CTA a cell, state in a global scratch buffer
// ---------------------------------------------------------------------------
__device__ __forceinline__ int block_min(int v, int* red, int nw) {
  v = __reduce_min_sync(ALL, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = red[0];
  for (int i = 1; i < nw; ++i) m = min(m, red[i]);
  return m;
}

__device__ __forceinline__ unsigned long long warp_min64(unsigned long long v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const unsigned long long u = __shfl_xor_sync(ALL, v, o);
    v = u < v ? u : v;
  }
  return v;
}

__global__ void __launch_bounds__(WIDE_THREADS) sched_cta_kernel(SchedParams p) {
  __shared__ int red_a[32];
  __shared__ unsigned long long red_key[32];
  __shared__ int red_n[32], red_mem[32];
  const long long c = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x, nw = nt >> 5;
  const int N = p.N, L = p.L, T = p.T, cap = p.cap, policy = p.policy;
  const int* const wmap = p.warp_map + c * N;
  const int* const tn = p.trace_n + c * N;
  int* const st = p.scratch + c * N * 4;     // [N][idx, t_ready, t_mem, in_order]
  int* const ow = p.out_warp + c * cap;
  int* const opc = p.out_pc + c * cap;
  int* const om = p.out_mask + c * cap;

  int my_total = 0;
  for (int w = tid; w < N; w += nt) {
    st[w * 4] = 0; st[w * 4 + 1] = 0; st[w * 4 + 2] = 0; st[w * 4 + 3] = 0;
    my_total = wadd(my_total, tn[w]);
  }
  my_total = __reduce_add_sync(ALL, my_total);
  if ((tid & 31) == 0) red_n[tid >> 5] = my_total;
  __syncthreads();
  int total = 0;
  for (int i = 0; i < nw; ++i) total = wadd(total, red_n[i]);
  __syncthreads();

  int cycle = 0, issued = 0, last = 0, cursor = 0;
  int busy = 0, istall = 0, sstall = 0, mstall = 0;
  int tinstr = 0;                     // this thread's part of the sum
  int s = 0;
  for (; s < cap && issued < total; ++s) {
    // round 1: the earliest time a pending warp is ready
    int e_min = BIG;
    for (int w = tid; w < N; w += nt) {
      const int* q = st + w * 4;
      if (q[0] < tn[w]) e_min = min(e_min, max(q[3], q[1]));
    }
    const int next_t = block_min(e_min, red_a, nw);
    const bool stalled = next_t > cycle;
    const int cyc = max(cycle, next_t);
    // round 2: the gap's class, the argmin and the ready count
    const int last_now = stalled ? -1 : last;
    unsigned long long best = ~0ull;
    int n_ready = 0, gm = 0;
    for (int w = tid; w < N; w += nt) {
      const int* q = st + w * 4;
      const bool pending = q[0] < tn[w];
      const int earliest = pending ? max(q[3], q[1]) : BIG;
      gm |= pending && earliest <= next_t && q[2] && q[1] >= q[3];
      if (pending && earliest <= cyc) {
        const unsigned key = policy == GTO ? (w == last_now ? 0u : unsigned(w) + 1u)
                           : policy == RR ? unsigned(floor_mod(w - cursor, N))
                           : unsigned(w);
        const unsigned long long k = ((unsigned long long)key << 32) | unsigned(w);
        best = k < best ? k : best;
        n_ready += 1;
      }
    }
    best = warp_min64(best);
    n_ready = __reduce_add_sync(ALL, n_ready);
    gm = __any_sync(ALL, gm);
    if ((tid & 31) == 0) {
      red_key[tid >> 5] = best; red_n[tid >> 5] = n_ready; red_mem[tid >> 5] = gm;
    }
    __syncthreads();
    best = red_key[0]; n_ready = red_n[0]; gm = red_mem[0];
    for (int i = 1; i < nw; ++i) {
      best = red_key[i] < best ? red_key[i] : best;
      n_ready += red_n[i]; gm |= red_mem[i];
    }
    // no ready warp issues warp 0, as JAX's argmin over all-BIG keys does
    const int sel = best == ~0ull ? 0 : int(best & 0xffffffffu);
    const int gap = stalled ? wsub(next_t, cycle) : 0;
    if (gm) mstall = wadd(mstall, gap);
    else sstall = wadd(sstall, gap);
    cycle = cyc;
    if (sel % nt == tid) {             // the issuing warp's thread
      int* q = st + sel * 4;
      const int row = wmap[sel];
      const long long e = (long long)row * T + min(q[0], T - 1);
      const int pc = __ldg(p.trace_pc + e);
      const int mask = __ldg(p.trace_mask + e);
      int op = pc >= 0 && pc < L ? __ldg(p.ops + (long long)row * L + pc) : NOP;
      op = min(max(op, 0), N_OPS - 1);
      q[1] = wadd(cycle, p.lat[op]);
      q[2] = (p.is_mem >> op) & 1u;
      q[3] = wadd(cycle, 1);
      q[0] += 1;
      tinstr = wadd(tinstr, __popc(unsigned(mask)));
      ow[s] = sel; opc[s] = pc; om[s] = mask;
    }
    busy += 1;
    if (n_ready > 1) istall += 1;
    if (policy == GTO) last = sel;
    else last = last_now;
    if (policy == RR) cursor = (sel + 1) % N;
    cycle = wadd(cycle, 1);
    issued += 1;
    __syncthreads();                   // every thread has read red_* of s
  }
  for (int i = s + tid; i < cap; i += nt) { ow[i] = -1; opc[i] = -1; om[i] = 0; }
  tinstr = __reduce_add_sync(ALL, tinstr);
  if ((tid & 31) == 0) red_n[tid >> 5] = tinstr;
  __syncthreads();
  if (tid == 0) {
    int sum = 0;
    for (int i = 0; i < nw; ++i) sum = wadd(sum, red_n[i]);
    store_counters(p, c, issued, cycle, busy, istall, sstall, mstall, sum);
  }
}

// ---------------------------------------------------------------------------
// the shortest slot the scheduling function allows, for K2's bound
// ---------------------------------------------------------------------------
// With up to 32 warps, one warp-wide minimum over a word packed per lane
// (ready: its key; else its wait and then its key) picks both the slot's
// time and its warp, since an idle gap ends at the earliest ready time and
// its ties go to the lowest key; the issued lane's update then feeds the
// next minimum.  The trace entry and its latency can be read ahead, and the
// counters feed nothing back.  One warp runs `links` such links (a
// __reduce_min_sync, then a compare and a select-add in the issued lane)
// and writes the clock cycles they took.
__global__ void slot_chain_kernel(int links, unsigned step,
                                  long long* cycles) {
  const unsigned lane = threadIdx.x & 31;
  unsigned key = lane;
  __syncwarp();
  const long long t0 = clock64();
#pragma unroll 8
  for (int i = 0; i < links; ++i) {
    const unsigned m = __reduce_min_sync(ALL, key);
    key = (m & 31u) == lane ? key + step : key;
  }
  const long long t1 = clock64();
  if (lane == 0) {
    cycles[0] = t1 - t0;
    cycles[1] = key;                   // keeps the chain live
  }
}

// The narrow layout's own link, for comparison with K2's time: the same
// dependent chain as sched_warp_kernel's slot (every lane's packed word
// from its earliest time, the greedy-then-oldest key, one minimum, the
// decode, the issued lane's update with its latency) without the trace
// ring, the staging, the counters or the saturated path.  Lane l's
// latency is 1 + l % 4, so lane 0 issues runs as GTO does.
__global__ void slot_link_kernel(int links, long long* cycles) {
  const int lane = threadIdx.x & 31;
  const int lat = 1 + (lane & 3);
  int earliest = 0, cycle = 0, last = 0;
  __syncwarp();
  const long long t0 = clock64();
  for (int i = 0; i < links; ++i) {
    const unsigned wait = earliest > cycle
        ? unsigned(earliest) - unsigned(cycle) : 0u;
    const unsigned key = lane == last && wait == 0u ? 0u : unsigned(lane) + 1u;
    const unsigned m = __reduce_min_sync(
        ALL, (min(wait, SAT) << 11) | (key << 5) | unsigned(lane));
    const int sel = int(m & 31u);
    const int cyc = int(unsigned(cycle) + (m >> 11));
    if (lane == sel) earliest = max(wadd(cyc, 1), wadd(cyc, lat));
    last = sel;
    cycle = wadd(cyc, 1);
  }
  const long long t1 = clock64();
  if (lane == 0) {
    cycles[0] = t1 - t0;
    cycles[1] = cycle;                 // keeps the chain live
  }
}

// The narrow layout of a grid on a card of `sms` SMs: the cells spread
// over every SM, ceil(C / SMs) a CTA, at most MAX_CELLS; whether their
// opcode columns fit in shared memory (STAGED) and whether a wait can pass
// the packed word (EXACT); the CTA's shared memory in bytes.
struct Narrow {
  int cells, grid, staged, exact, bytes;
};

Narrow narrow_layout(const SchedParams& p, int sms) {
  Narrow n;
  const int code = align16(p.N * p.L);
  n.cells = int(min((long long)MAX_CELLS,
                    max(1LL, ((long long)p.C + sms - 1) / sms)));
  n.grid = (p.C + n.cells - 1) / n.cells;
  n.staged = LAT_BYTES + (long long)n.cells * (WARP_BYTES + code) <=
             SMEM_LIMIT;
  // every wait stays below the packed word's SAT, and no time wraps, when
  // the cycle after cap slots of the longest gaps stays below 2^31
  long long lmax = 1;
  for (int i = 0; i < 32; ++i) lmax = lmax > p.lat[i] ? lmax : p.lat[i];
  n.exact = lmax >= SAT ||
      (long long)p.cap * (lmax + 1) + lmax >= (long long)BIG;
  n.bytes = LAT_BYTES + n.cells * (WARP_BYTES + (n.staged ? code : 0));
  return n;
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return int(e);
}

// the narrow layout's build for a policy
template <bool EXACT, bool STAGED>
void (*pick(int policy))(SchedParams, int) {
  return policy == GTO ? sched_warp_kernel<GTO, EXACT, STAGED>
       : policy == RR ? sched_warp_kernel<RR, EXACT, STAGED>
                      : sched_warp_kernel<OLDEST, EXACT, STAGED>;
}

}  // namespace

extern "C" {

// Schedules every cell of the grid.  Outputs are written whole (slots past
// a cell's total filled); the caller allocates them, and the scratch buffer
// when N > 32.  Returns cudaGetLastError() after the launch (0 on success);
// the caller raises on anything else.
int sm_schedule(const SchedParams* params, void* stream) {
  const SchedParams p = *params;
  if (p.C < 1 || p.N < 1 || p.U < 1 || p.L < 1 || p.T < 1 || p.cap < 32 ||
      p.cap % 32 || p.policy < 0 || p.policy > 2 || (p.N > 32 && !p.scratch))
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.N <= 32) {
    int sms = 0;
    const int e = sm_count(&sms);
    if (e) return e;
    const Narrow n = narrow_layout(p, sms);
    const int vec = p.T % 4 == 0 &&
        reinterpret_cast<uintptr_t>(p.trace_pc) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(p.trace_mask) % 16 == 0;
    using Kernel = void (*)(SchedParams, int);
    Kernel kernel;
    if (n.exact)
      kernel = n.staged ? pick<true, true>(p.policy)
                        : pick<true, false>(p.policy);
    else
      kernel = n.staged ? pick<false, true>(p.policy)
                        : pick<false, false>(p.policy);
    if (n.bytes > 48 * 1024) {
      const cudaError_t a = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, n.bytes);
      if (a != cudaSuccess) return int(a);
    }
    kernel<<<n.grid, n.cells * 32, n.bytes, s>>>(p, vec);
  } else {
    const int threads = min(WIDE_THREADS, (p.N + 31) / 32 * 32);
    sched_cta_kernel<<<p.C, threads, 0, s>>>(p);
  }
  return int(cudaGetLastError());
}

// sm_schedule's narrow layout for a grid of cells of up to 32 warps on
// this card, into out: cells a CTA, CTAs, staged, exact, shared memory
// bytes.  Returns 0, or the CUDA error of the card's query.
int sm_narrow_layout(const SchedParams* params, int* out) {
  int sms = 0;
  const int e = sm_count(&sms);
  if (e) return e;
  const Narrow n = narrow_layout(*params, sms);
  out[0] = n.cells; out[1] = n.grid; out[2] = n.staged; out[3] = n.exact;
  out[4] = n.bytes;
  return 0;
}

// One warp through slot_chain_kernel (link 0) or slot_link_kernel (link
// 1): cycles[0] gets the clock cycles of `links` links, cycles[1] the last
// key or cycle.  Returns cudaGetLastError().
int sm_slot_chain(int links, int link, long long* cycles, void* stream) {
  if (links < 1 || !cycles || link < 0 || link > 1)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (link == 0) slot_chain_kernel<<<1, 32, 0, s>>>(links, 32u, cycles);
  else slot_link_kernel<<<1, 32, 0, s>>>(links, cycles);
  return int(cudaGetLastError());
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
