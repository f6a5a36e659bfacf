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
//     4 cells a CTA; lane w holds warp w's cursor, ready time, memory flag
//     and in-order time in registers.  The earliest time and the argmin come
//     from __reduce_min_sync (the argmin over (key << 5) | lane), the ready
//     set and its size from __ballot_sync / __popc, the gap's class from
//     __any_sync, the latency of an opcode from the lane that holds it
//     (__shfl_sync).  Each lane keeps the next 4 to 8 entries of its warp's
//     trace in registers, loaded 4 at a time, 4 entries ahead of use.  32
//     slots of output are buffered, one a lane, and stored together,
//     coalesced.
//   - wider cells (sched_cta_kernel): one CTA a cell; thread t holds warps
//     t, t + blockDim, ... in a global scratch buffer; two block reductions
//     a slot (the earliest time; then the gap's class, the argmin as a
//     64-bit (key, warp) minimum and the ready count); the issuing warp's
//     thread reads its entry, updates its state and writes the slot.
//
// What bounds it on an H100: each slot is a dependent chain (reductions,
// then the issued warp's trace entry and opcode, then the update), so a
// cell's time is its slot count times that chain; the cells run side by
// side.  The bytes (the traces read once, the slots written once) are a
// small share.
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
constexpr int CELLS = 4;          // cells (hardware warps) a CTA, narrow
constexpr int N_OPS = 29;         // opcodes NOP..ATOMADD
constexpr int NOP = 0;
constexpr int GTO = 0, RR = 1;    // timing.policies.POLICY_NAMES order
constexpr int BIG = 0x7fffffff;
constexpr int WIDE_THREADS = 256;   // a CTA of the wide layout, at most

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

// the element of an 8-entry register ring at position k (no local memory)
__device__ __forceinline__ int pick8(const int (&a)[8], int k) {
  int v = a[0];
#pragma unroll
  for (int i = 1; i < 8; ++i) v = k == i ? a[i] : v;
  return v;
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
__global__ void __launch_bounds__(CELLS * 32) sched_warp_kernel(SchedParams p) {
  const int lane = threadIdx.x & 31;
  const long long c = (long long)blockIdx.x * CELLS + (threadIdx.x >> 5);
  if (c >= p.C) return;                 // the whole warp leaves together
  const int N = p.N, L = p.L, T = p.T, cap = p.cap, policy = p.policy;
  const bool mine = lane < N;           // lane w is the cell's warp w
  const int row = mine ? p.warp_map[c * N + lane] : 0;
  const int tn = mine ? p.trace_n[c * N + lane] : 0;
  const int lat_l = p.lat[lane];        // lane k holds opcode k's latency
  const int* const tpc = p.trace_pc + (long long)row * T;
  const int* const tmask = p.trace_mask + (long long)row * T;
  const int* const ops = p.ops + (long long)row * L;

  // the ring: entry e of this warp's trace at position e & 7; it holds
  // entries [idx - idx % 4, idx - idx % 4 + 8).  An entry past T - 1 reads
  // entry T - 1, as JAX's gather clamps.
  int rpc[8], rmask[8];
  auto refill = [&](int first) {        // first is a multiple of 4
    int v_pc[4], v_mask[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = min(first + k, T - 1);
      v_pc[k] = mine ? __ldg(tpc + e) : -1;
      v_mask[k] = mine ? __ldg(tmask + e) : 0;
    }
    if (first & 4) {
#pragma unroll
      for (int k = 0; k < 4; ++k) { rpc[4 + k] = v_pc[k]; rmask[4 + k] = v_mask[k]; }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) { rpc[k] = v_pc[k]; rmask[k] = v_mask[k]; }
    }
  };
  refill(0);
  refill(4);

  int idx = 0, t_ready = 0, in_order = 0;
  bool t_mem = false;
  const int total = __reduce_add_sync(ALL, tn);
  int cycle = 0, issued = 0, last = 0, cursor = 0;
  int busy = 0, istall = 0, sstall = 0, mstall = 0, tinstr = 0;
  int* const ow = p.out_warp + c * cap;
  int* const opc = p.out_pc + c * cap;
  int* const om = p.out_mask + c * cap;
  int buf_w = -1, buf_pc = -1, buf_mask = 0;   // the slot this lane buffers

  int s = 0;
  for (; s < cap && issued < total; ++s) {
    const bool pending = idx < tn;
    const int earliest = pending ? max(in_order, t_ready) : BIG;
    const int next_t = __reduce_min_sync(ALL, earliest);
    const bool stalled = next_t > cycle;
    const bool blocked_mem = t_mem && t_ready >= in_order;
    const bool gap_mem = __any_sync(ALL, pending && earliest <= next_t && blocked_mem);
    const int gap = stalled ? wsub(next_t, cycle) : 0;
    if (gap_mem) mstall = wadd(mstall, gap);
    else sstall = wadd(sstall, gap);
    cycle = max(cycle, next_t);
    if (stalled) last = -1;
    const bool ready = pending && earliest <= cycle;
    const unsigned key = policy == GTO ? (lane == last ? 0u : unsigned(lane) + 1u)
                       : policy == RR ? unsigned(floor_mod(lane - cursor, N))
                       : unsigned(lane);
    const unsigned packed = ready ? (key << 5) | lane : 0xffffffe0u | lane;
    const int sel = int(__reduce_min_sync(ALL, packed) & 31u);
    const int n_ready = __popc(__ballot_sync(ALL, ready));
    const int pc = __shfl_sync(ALL, pick8(rpc, idx & 7), sel);
    const int mask = __shfl_sync(ALL, pick8(rmask, idx & 7), sel);
    int op = NOP;
    if (lane == sel && pc >= 0 && pc < L) op = __ldg(ops + pc);
    op = min(max(__shfl_sync(ALL, op, sel), 0), N_OPS - 1);
    const int lat = __shfl_sync(ALL, lat_l, op);
    if (lane == sel) {
      t_ready = wadd(cycle, lat);
      t_mem = (p.is_mem >> op) & 1u;
      in_order = wadd(cycle, 1);
      idx += 1;
      if ((idx & 3) == 0) refill(idx + 4);
    }
    tinstr = wadd(tinstr, __popc(unsigned(mask)));
    busy += 1;
    if (n_ready > 1) istall += 1;
    if (policy == GTO) last = sel;
    if (policy == RR) cursor = (sel + 1) % N;
    if ((s & 31) == lane) { buf_w = sel; buf_pc = pc; buf_mask = mask; }
    if ((s & 31) == 31) {
      ow[s - 31 + lane] = buf_w; opc[s - 31 + lane] = buf_pc;
      om[s - 31 + lane] = buf_mask;
    }
    cycle = wadd(cycle, 1);
    issued += 1;
  }
  // the buffered tail, then (-1, -1, 0) to cap
  const int tail = s & 31;
  if (lane < tail) {
    ow[s - tail + lane] = buf_w; opc[s - tail + lane] = buf_pc;
    om[s - tail + lane] = buf_mask;
  }
  for (int i = s + lane; i < cap; i += 32) { ow[i] = -1; opc[i] = -1; om[i] = 0; }
  if (lane == 0)
    store_counters(p, c, issued, cycle, busy, istall, sstall, mstall, tinstr);
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
    sched_warp_kernel<<<(p.C + CELLS - 1) / CELLS, CELLS * 32, 0, s>>>(p);
  } else {
    const int threads = min(WIDE_THREADS, (p.N + 31) / 32 * 32);
    sched_cta_kernel<<<p.C, threads, 0, s>>>(p);
  }
  return int(cudaGetLastError());
}

// One warp through slot_chain_kernel: cycles[0] gets the clock cycles of
// `links` links, cycles[1] the last key.  Returns cudaGetLastError().
int sm_slot_chain(int links, long long* cycles, void* stream) {
  if (links < 1 || !cycles) return int(cudaErrorInvalidValue);
  slot_chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      links, 32u, cycles);
  return int(cudaGetLastError());
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
