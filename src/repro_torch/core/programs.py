"""SASS-lite programs: the paper's figures + a benchmark suite.

Hand-written programs reproduce the paper's walkthrough figures exactly
(Fig 3/7 spinlock, Fig 5 nested divergence with BMOV spilling, Fig 6 early
reconvergence with BREAK).  The generated suite mimics the control-flow
character of the paper's benchmark families (Table II): regular compute
kernels (Rodinia-like), data-dependent loops (graph-like BFS), atomics-heavy
kernels, and deep nesting — each parameterized by input data, so one program
yields several "executions" as in the paper's 59-execution methodology.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .asm import assemble
from .isa import MachineConfig
from .structured import If, Raw, Seq, While, compile_structured

# ---------------------------------------------------------------------------
# Paper figures
# ---------------------------------------------------------------------------

# Fig 3 / Fig 7: spinlock.  mem[0] = mutex, mem[1] = shared counter.
# The critical section uses a plain load/inc/store so mutual exclusion is
# *observable*: the final counter equals W only if the lock works.
SPINLOCK_ASM = """
    MOV R0, 0           ; mutex address
    MOV R1, 1           ; counter address
    MOV R3, 0           ; CAS compare value
    MOV R4, 1           ; CAS swap value
    BSSY B0, esync
loop:
    YIELD               ; SS VI-C: switch to the sibling (lock holder) path
    ATOMCAS R2, [R0], R3, R4
    ISETP.NE P0, R2, 0  ; P0 true -> failed to acquire
    @P0 BRA loop
    LDG R5, [R1]        ; critical section: counter++ (non-atomic on purpose)
    IADDI R5, R5, 1
    STG [R1], R5
    ATOMEXCH R6, [R0], R3   ; release the lock
esync:
    BSYNC B0
    EXIT
"""

# Same program with the YIELD removed — the paper's SS V-G ablation: on real
# Turing (and on Hanoi) this must hang.
SPINLOCK_NO_YIELD_ASM = SPINLOCK_ASM.replace("    YIELD", "    NOP  ")


def spinlock_program() -> np.ndarray:
    return assemble(SPINLOCK_ASM)


def spinlock_no_yield_program() -> np.ndarray:
    return assemble(SPINLOCK_NO_YIELD_ASM)


# Fig 5: nested divergence; B0 serves two reconvergence points, spilled to R0.
# Threads {2,3} take the outer branch; thread 3 takes the inner branch.
FIG5_ASM = """
    LANEID R1
    BSSY B0, fsync      ; outer reconvergence (F), B0 = full mask
    BMOV R0, B0         ; spill: R0 <- B0  (Fig 5 step 2)
    ISETP.GE P0, R1, 2
    @P0 BRA bblk
    MOV R2, 100         ; not-taken path (threads 0,1)
    BRA fblk
bblk:
    BSSY B0, esync      ; inner reconvergence (E), B0 = {2,3}  (step 3)
    ISETP.EQ P1, R1, 3
    @P1 BRA dblk
    MOV R2, 20          ; C: thread 2
    BRA esync
dblk:
    MOV R2, 30          ; D: thread 3
esync:
    BSYNC B0            ; reunites threads 2,3
    MOV R3, 5           ; E tail, executed by {2,3} together
fblk:
    BMOV B0, R0         ; refill: B0 <- R0  (steps 4,5)
fsync:
    BSYNC B0            ; reunites all threads
    EXIT
"""


def fig5_program() -> np.ndarray:
    return assemble(FIG5_ASM)


# Fig 6: early reconvergence (B is NOT the IPDom of the branch in A); BREAK in
# C removes thread 0 from B0 so threads 1-3 reunite early at B.
FIG6_ASM = """
    LANEID R1
    BSSY B1, dsync      ; outer (IPDom) reconvergence — pushed first
    BSSY B0, bsync      ; early reconvergence at B — pushed on top
    ISETP.GE P0, R1, 1
    @P0 BRA bblk        ; threads 1,2,3 -> B ; thread 0 falls through to C
    ISETP.GE P1, R1, 1  ; C: P1 false exactly for thread 0
    BREAK !P1, B0       ; remove thread 0 from B0 (Fig 6 step 2)
    @!P1 BRA dblk       ; thread 0 heads to D, never executing B
    BRA bblk
bblk:
    MOV R2, 7           ; B body
bsync:
    BSYNC B0            ; early reconvergence: threads 1,2,3 (step 3)
    MOV R3, 8           ; B tail, executed by {1,2,3} together
dblk:
dsync:
    BSYNC B1            ; full reconvergence at D (step 4)
    MOV R4, 9
    EXIT
"""

FIG6_NO_BREAK_ASM = FIG6_ASM.replace("    BREAK !P1, B0", "    NOP")


def fig6_program() -> np.ndarray:
    return assemble(FIG6_ASM)


def fig6_no_break_program() -> np.ndarray:
    """Without the BREAK the BSYNC at B waits for thread 0 forever (SS VI-B)."""
    return assemble(FIG6_NO_BREAK_ASM)


# Fig 1/4 basic diamond: if (lane < W/2) A else B; join.
def diamond_program() -> np.ndarray:
    return assemble("""
    LANEID R1
    BSSY B0, sync
    ISETP.LT P0, R1, 2
    @P0 BRA taken
    MOV R2, 200
    BRA join
taken:
    MOV R2, 111
join:
sync:
    BSYNC B0
    IADDI R3, R2, 1
    EXIT
""")


# WARPSYNC: divergent paths meet at a WARPSYNC with an immediate full mask.
def warpsync_program(w: int = 4) -> np.ndarray:
    full = (1 << w) - 1
    return assemble(f"""
    LANEID R1
    ISETP.GE P0, R1, {w // 2}
    @P0 BRA x
    MOV R2, 1
    BRA w
x:
    MOV R2, 2
w:
    WARPSYNC {full}
    MOV R3, 9
    EXIT
""")


# ---------------------------------------------------------------------------
# Generated benchmark suite (Table II analogue)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Benchmark:
    """A program plus its machine/memory setup and oracle annotations."""
    name: str
    family: str                      # rodinia | graph | atomic | synthetic
    program: np.ndarray
    init_mem: np.ndarray | None = None
    # BSYNC pcs where the Turing-oracle heuristic may skip reconvergence
    skip_bsync_pcs: tuple[int, ...] = ()
    race_free: bool = True           # scalar-reference comparable

    def __repr__(self) -> str:  # keep pytest ids short
        return f"Benchmark({self.name})"


def _find_bsync_pcs(program: np.ndarray) -> list[int]:
    from .isa import F_OP, Op
    return [pc for pc in range(program.shape[0])
            if int(program[pc, F_OP]) == Op.BSYNC]


def _mem(cfg: MachineConfig, seed: int, lo: int = 0, hi: int = 8) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, size=cfg.mem_size, dtype=np.int32)


def make_suite(cfg: MachineConfig = MachineConfig(n_threads=32),
               datasets: int = 2) -> list[Benchmark]:
    """Build the benchmark suite; ``datasets`` input sets per data-dependent
    program (the paper runs 18 extra executions by varying inputs)."""
    W = cfg.n_threads
    out: list[Benchmark] = []

    # -- rodinia-like: branchy vector compute (hotspot/srad flavor) ---------
    # out[i] = data[i] > 3 ? data[i]*2 : data[i]+1, strided loop
    branchy = Seq([
        Raw(["LANEID R1", "MOV R2, 0"]),  # R2 = loop induction (i = lane)
        Raw(["MOVR R3, R1"]),
        While(
            cond=[f"ISETP.LT P0, R3, {4 * W}"], pred=0,
            body=Seq([
                Raw(["LDG R4, [R3+0]"]),
                If(cond=["ISETP.GT P1, R4, 3"], pred=1,
                   then_=Raw(["IADD R5, R4, R4"]),
                   else_=Raw(["IADDI R5, R4, 1"])),
                Raw([f"IADDI R6, R3, {cfg.mem_size // 2}",
                     "STG [R6+0], R5",
                     f"IADDI R3, R3, {W}"])]),
        )])
    prog = compile_structured(branchy, cfg)
    for d in range(datasets):
        out.append(Benchmark(f"HOTS{d}", "rodinia", prog,
                             init_mem=_mem(cfg, 11 + d)))

    # -- rodinia-like: nested conditionals (lud/gaussian flavor) ------------
    nested = Seq([
        Raw(["LANEID R1", "LDG R4, [R1+0]"]),
        If(cond=["ISETP.GT P0, R4, 1"], pred=0,
           then_=Seq([
               If(cond=["ISETP.GT P1, R4, 4"], pred=1,
                  then_=If(cond=["ISETP.GT P2, R4, 6"], pred=2,
                           then_=Raw(["MOV R5, 3"]),
                           else_=Raw(["MOV R5, 2"])),
                  else_=Raw(["MOV R5, 1"]))]),
           else_=Raw(["MOV R5, 0"])),
        Raw([f"IADDI R6, R1, {cfg.mem_size // 2}", "STG [R6+0], R5"]),
    ])
    prog = compile_structured(nested, cfg)
    for d in range(datasets):
        out.append(Benchmark(f"GAUS{d}", "rodinia", prog,
                             init_mem=_mem(cfg, 23 + d)))

    # -- graph-like: data-dependent inner loop (BFS neighbor expansion) -----
    # each lane walks mem[deg[lane]] neighbors; degrees are skewed so warps
    # diverge heavily — the paper's graph suites (Lonestar/GraphBIG) flavor.
    bfs = Seq([
        Raw(["LANEID R1", "LDG R2, [R1+0]",      # R2 = degree
             "MOV R3, 0",                         # R3 = j
             "MOV R7, 0"]),                       # R7 = acc
        While(cond=["ISETP.LT P0, R3, R2"], pred=0,
              body=Seq([
                  Raw([f"IADDI R4, R3, {W}",      # neighbor index
                       "LDG R5, [R4+0]",
                       "IADD R7, R7, R5",
                       "IADDI R3, R3, 1"])])),
        Raw([f"IADDI R6, R1, {cfg.mem_size // 2}", "STG [R6+0], R7"]),
    ])
    prog = compile_structured(bfs, cfg)
    # the heuristic skip candidates: every BSYNC in the loop region
    skips = tuple(_find_bsync_pcs(prog))
    for d in range(datasets):
        out.append(Benchmark(f"RBFS{d}", "graph", prog,
                             init_mem=_mem(cfg, 37 + d, 0, 6)))
    # BFSD analogue: same program, hardware-oracle skips reconvergence
    out.append(Benchmark("BFSD", "graph", prog,
                         init_mem=_mem(cfg, 40, 0, 6),
                         skip_bsync_pcs=skips))

    # -- graph-like: frontier loop with early BREAK exit ---------------------
    brk = Seq([
        Raw(["LANEID R1", "LDG R2, [R1+0]", "MOV R3, 0"]),
        While(cond=[f"ISETP.LT P0, R3, {2 * W}"], pred=0,
              break_pred=1,
              body=Seq([
                  Raw(["IADD R4, R3, R1", "LDG R5, [R4+0]",
                       "IADD R2, R2, R5", "IADDI R3, R3, 1",
                       # break when acc passes a threshold (data dependent)
                       "ISETP.GT P1, R2, 9"])])),
        Raw([f"IADDI R6, R1, {cfg.mem_size // 2}", "STG [R6+0], R2"]),
    ])
    # note: break_pred is evaluated at the loop head of the NEXT iteration,
    # so P1 must be (re)set inside the body before looping — done above.
    prog = compile_structured(brk, cfg)
    for d in range(datasets):
        out.append(Benchmark(f"BFSW{d}", "graph", prog,
                             init_mem=_mem(cfg, 53 + d)))

    # -- atomics: histogram (races by design -> behavioral checks only) -----
    hist = Seq([
        Raw(["LANEID R1", "LDG R2, [R1+0]",
             f"AND R2, R2, R2",                  # no-op, keep shape
             f"IADDI R3, R2, {cfg.mem_size // 2}",
             "MOV R4, 1",
             "ATOMADD R5, [R3+0], R4"]),
    ])
    prog = compile_structured(hist, cfg)
    for d in range(datasets):
        out.append(Benchmark(f"HIST{d}", "atomic", prog,
                             init_mem=_mem(cfg, 67 + d, 0, 8),
                             race_free=False))

    # -- atomics: spinlock (Fig 3/7) -----------------------------------------
    out.append(Benchmark("SLOCK", "atomic", spinlock_program(),
                         race_free=False))

    # -- rodinia-like: triangular nested loops (LUD flavor) ------------------
    lud = Seq([
        Raw(["LANEID R1", "MOV R2, 0", "MOV R7, 0"]),
        While(cond=["ISETP.LE P0, R2, R1"], pred=0,        # i <= lane
              body=Seq([
                  Raw(["MOV R3, 0"]),
                  While(cond=["ISETP.LT P1, R3, R2"], pred=1,   # j < i
                        body=Raw(["IADD R4, R2, R3",
                                  "LDG R5, [R4+0]",
                                  "IADD R7, R7, R5",
                                  "IADDI R3, R3, 1"])),
                  Raw(["IADDI R2, R2, 1"])])),
        Raw([f"IADDI R6, R1, {cfg.mem_size // 2}", "STG [R6+0], R7"]),
    ])
    prog = compile_structured(lud, cfg)
    for d in range(datasets):
        out.append(Benchmark(f"LUD{d}", "rodinia", prog,
                             init_mem=_mem(cfg, 81 + d)))

    # -- rodinia-like: wavefront with predicated updates (NW flavor) --------
    nw = Seq([
        Raw(["LANEID R1", "MOV R3, 0", "LDG R7, [R1+0]"]),
        While(cond=[f"ISETP.LT P0, R3, {W // 2}"], pred=0,
              body=Seq([
                  Raw(["IADD R4, R1, R3", "LDG R5, [R4+0]"]),
                  If(cond=["ISETP.GT P1, R5, R7"], pred=1,
                     then_=Raw(["MOVR R7, R5"]),
                     else_=Raw(["IADDI R7, R7, 1"])),
                  Raw(["IADDI R3, R3, 1"])])),
        Raw([f"IADDI R6, R1, {cfg.mem_size // 2}", "STG [R6+0], R7"]),
    ])
    prog = compile_structured(nw, cfg)
    for d in range(datasets):
        out.append(Benchmark(f"NW{d}", "rodinia", prog,
                             init_mem=_mem(cfg, 95 + d)))

    # -- graph-like: iterative prune with flag convergence (KCORE flavor) ---
    kcore = Seq([
        Raw(["LANEID R1", "LDG R2, [R1+0]",      # R2 = degree
             "MOV R3, 0"]),
        While(cond=[f"ISETP.LT P0, R3, {W // 4}"], pred=0,
              body=Seq([
                  If(cond=["ISETP.GT P1, R2, 2"], pred=1,
                     then_=Raw(["IADDI R2, R2, -1"]),
                     else_=Raw(["NOP"])),
                  Raw(["IADDI R3, R3, 1"])])),
        Raw([f"IADDI R6, R1, {cfg.mem_size // 2}", "STG [R6+0], R2"]),
    ])
    prog = compile_structured(kcore, cfg)
    for d in range(datasets):
        out.append(Benchmark(f"KCOR{d}", "graph", prog,
                             init_mem=_mem(cfg, 103 + d)))

    # -- functions: CALL/RET under divergence (Tango/NN flavor) -------------
    fn = assemble(f"""
        LANEID R1
        MOV R9, ret1
        BSSY B0, callsync
        ISETP.GE P0, R1, {W // 2}
        @P0 BRA docall
        MOV R2, 5
        BRA callsync
    docall:
        CALL square
    ret1:
    callsync:
        BSYNC B0
        IADDI R4, R2, {cfg.mem_size // 2}
        STG [R4+0], R2
        EXIT
    square:
        MOVR R2, R1
        IMUL R2, R2, R2
        RET R9
    """)
    out.append(Benchmark("CALLS", "synthetic", fn, race_free=False))

    # -- synthetic: paper walkthrough figures also join the suite -----------
    out.append(Benchmark("FIG5", "synthetic", fig5_program()))
    out.append(Benchmark("FIG6", "synthetic", fig6_program()))
    out.append(Benchmark("DIAMOND", "synthetic", diamond_program()))
    out.append(Benchmark("WSYNC", "synthetic", warpsync_program(W)))
    return out
