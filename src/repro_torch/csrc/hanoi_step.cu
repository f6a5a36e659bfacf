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
// trace_n.  One simulated warp maps to one hardware warp:
//   - lane t holds its registers (a column of the warp's shared register
//     file) and its predicates (bits of one 32-bit word); execution masks
//     come from __ballot_sync, lanes >= n_threads are never set in them;
//   - the WS and REC stacks (depth n_threads + 2), the Bx file, the
//     program's padded rows, the oracle skip flags and the mem_size image
//     live in the warp's slice of shared memory; waiting, finished, the
//     stack tops, fuel and the counters are warp-uniform registers.
//
// What bounds it on an H100: each scheduler slot is a chain of dependent
// shared-memory reads (stack top, program row, registers) of ~30 cycles
// each, so one warp's time is its slot count times that chain; the trace's
// max_steps entries a warp (written once, coalesced 32 at a time from a
// buffer of one entry a lane) are the bytes.  Many warps a SM hide the
// chain's latency from each other.
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
struct HanoiParams {
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
  int N, L, W, NR, NP, NB, M, T;
  unsigned full, active0;
  int majority_first;
};

namespace {

constexpr int WARPS = 4;            // simulated warps per CTA (WARPS_PER_CTA)
constexpr unsigned ALL = 0xffffffffu;
constexpr int ERR_NO_FREE_BX = 1;

enum Op : int {
  NOP, EXIT, BRA, BSSY, BSYNC, BMOV_B2R, BMOV_R2B, BREAK, WARPSYNC, YIELD,
  CALL, RET, MOV, MOVR, IADD, IADDI, IMUL, AND_, OR_, XOR_, SHL, SHR, ISETP,
  LANEID, LDG, STG, ATOMCAS, ATOMEXCH, ATOMADD
};


__host__ __device__ inline int align16(int b) { return (b + 15) & ~15; }

// One warp's slice of shared memory; hanoi_step.smem_bytes mirrors it.
struct Layout {
  int prog, mem, regs, ws_pc, ws_mask, rec_pc, rec_bx, bx_val, bx_valid,
      skip, total;
};

__host__ __device__ inline Layout layout(int L, int NR, int NB, int M, int SD) {
  Layout o;
  int off = 0;
  o.prog = off;     off += align16(L * 8 * 4);
  o.mem = off;      off += align16(M * 4);
  o.regs = off;     off += align16(NR * 32 * 4);
  o.ws_pc = off;    off += align16(SD * 4);
  o.ws_mask = off;  off += align16(SD * 4);
  o.rec_pc = off;   off += align16(SD * 4);
  o.rec_bx = off;   off += align16(SD * 4);
  o.bx_val = off;   off += align16(NB * 4);
  o.bx_valid = off; off += align16(NB);
  o.skip = off;     off += align16(L);
  o.total = off;
  return o;
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

__global__ void __launch_bounds__(WARPS * 32) hanoi_kernel(HanoiParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (w >= p.N) return;                 // the whole warp leaves together
  const int W = p.W, NR = p.NR, NP = p.NP, NB = p.NB, M = p.M, L = p.L;
  const int SD = W + 2, T = p.T;
  const unsigned FULL = p.full;
  const Layout lay = layout(L, NR, NB, M, SD);
  unsigned char* base = smem + (threadIdx.x >> 5) * lay.total;
  int* prog = reinterpret_cast<int*>(base + lay.prog);
  int* mem = reinterpret_cast<int*>(base + lay.mem);
  int* regs = reinterpret_cast<int*>(base + lay.regs);     // [NR][32]
  int* ws_pc = reinterpret_cast<int*>(base + lay.ws_pc);
  unsigned* ws_mask = reinterpret_cast<unsigned*>(base + lay.ws_mask);
  int* rec_pc = reinterpret_cast<int*>(base + lay.rec_pc);
  int* rec_bx = reinterpret_cast<int*>(base + lay.rec_bx);
  unsigned* bx_val = reinterpret_cast<unsigned*>(base + lay.bx_val);
  unsigned char* bx_valid = base + lay.bx_valid;
  unsigned char* skip = base + lay.skip;

  // ---- initial state (the reference's init_state) -------------------------
  for (int i = lane; i < L * 8; i += 32) prog[i] = p.prog[w * L * 8 + i];
  for (int i = lane; i < L; i += 32) skip[i] = p.skip[w * L + i];
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
  unsigned pbits = 0;                   // this lane's predicates
  int ws_top = 0, rec_top = -1, trace_n = 0, steps = 0, fuel = T, error = 0;
  unsigned waiting = 0, finished = 0;
  bool halted = false;
  int* const tr_pc = p.trace_pc + w * T;
  int* const tr_mask = p.trace_mask + w * T;
  int buf_pc = -1, buf_mask = 0;        // the trace entry this lane buffers
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
    const int4 f0 = *reinterpret_cast<const int4*>(prog + pc * 8);
    const int4 f1 = *reinterpret_cast<const int4*>(prog + pc * 8 + 4);
    const int op = min(max(f0.x, 0), int(ATOMADD));
    const int dst = f0.y, s0 = f0.z, s1 = f0.w, s2 = f1.x, imm = f1.y;
    const bool guard = live_lane && pred_of(pbits, f1.z, NP) && pred_of(pbits, f1.w, NP);
    const unsigned execm = amask & __ballot_sync(ALL, guard);
    const bool ev = (execm >> lane) & 1u;
    // trace: lane (trace_n mod 32) buffers the entry; every 32 entries the
    // warp stores them, coalesced
    if ((trace_n & 31) == lane) { buf_pc = pc; buf_mask = int(amask); }
    trace_n += 1;
    steps += 1;
    if ((trace_n & 31) == 0) {
      tr_pc[trace_n - 32 + lane] = buf_pc;
      tr_mask[trace_n - 32 + lane] = buf_mask;
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
        if (ev && dst >= 0 && dst < NP)
          pbits = (pbits & ~(1u << dst)) | (unsigned(res) << dst);
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

  // ---- the trace's buffered tail, then -1 / 0 to max_steps ----------------
  const int tail = trace_n & 31;
  if (lane < tail) {
    tr_pc[trace_n - tail + lane] = buf_pc;
    tr_mask[trace_n - tail + lane] = buf_mask;
  }
  for (int i = trace_n + lane; i < T; i += 32) { tr_pc[i] = -1; tr_mask[i] = 0; }

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
  for (int i = lane; i < M; i += 32) p.mem[w * M + i] = mem[i];
  if (live_lane) {
    for (int r = 0; r < NR; ++r) p.regs[(w * W + lane) * NR + r] = regs[r * 32 + lane];
    for (int k = 0; k < NP; ++k) p.preds[(w * W + lane) * NP + k] = (pbits >> k) & 1u;
    p.lane_ids[w * W + lane] = my_lane_id;
  }
  if (lane == 0) {
    p.ws_top[w] = ws_top; p.rec_top[w] = rec_top;
    p.waiting[w] = (long long)waiting; p.finished[w] = (long long)finished;
    p.trace_n[w] = trace_n; p.steps[w] = steps; p.fuel[w] = fuel;
    p.halted[w] = halted; p.error[w] = error;
  }
}

}  // namespace

extern "C" {

// Runs every warp of the batch to its end.  Outputs are written whole; the
// caller allocates them.  Returns cudaGetLastError() after the launch (0 on
// success); the caller raises on anything else.
int hanoi_run(const HanoiParams* params, void* stream) {
  const HanoiParams p = *params;
  if (p.N < 1 || p.L < 1 || p.W < 1 || p.W > 32 || p.NR < 1 || p.NP < 1 ||
      p.NP > 32 || p.NB < 1 || p.M < 1 || p.T < 1)
    return int(cudaErrorInvalidValue);
  // shared memory of a CTA (hanoi_step.smem_bytes mirrors it)
  const int smem = WARPS * layout(p.L, p.NR, p.NB, p.M, p.W + 2).total;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hanoi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return int(e);
  }
  const int grid = (p.N + WARPS - 1) / WARPS;
  hanoi_kernel<<<grid, WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
