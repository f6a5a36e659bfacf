"""Random structured-program generator shared by the property suites.

Port of the repo's ``tests/progen.py`` (numpy only, copied; it imports
nothing of ``repro``), for the port's analysis benchmark: the same
programs, seed for seed.

Lives outside the test modules (and imports no hypothesis) so that
benchmark/property consumers can build the same If/While/BREAK program
distribution regardless of whether hypothesis is installed.

Three distributions:

* ``make_program(seed, n_bx)`` — the original If/While/BREAK nest
  distribution, unchanged (bit-identical rng stream) so the long-standing
  property suites keep exercising exactly the same programs;
* ``make_program(seed, n_bx, sync_features=True)`` — additionally weaves in
  the synchronization-heavy shapes the multi-mechanism conformance suite
  needs: top-level WARPSYNC joins, a Fig 3/7-style spinlock region (CAS
  acquire loop + YIELD + observable critical section + EXCH release), and a
  BREAK loop with a nested inner While (divergence-region depth >= 2).
  These programs deadlock pre-Volta by design (simt_stack has no YIELD),
  which is exactly what the differential suite's "agree wherever both
  finish" contract is for.  Memory is widened so the lock/counter cells sit
  above every lane-private address.
* ``make_program(seed, n_bx, mem_features=True)`` — additionally weaves in
  the memory-latency-heavy shapes the cycle-accurate timing suite needs:
  long-latency loads feeding dependent ALU chains (the scoreboard must
  stall the consumer, not the whole warp) and loads inside divergent
  branches (only part of the warp is behind the miss).  Drawn from an
  independent rng stream, so base shapes per seed are unchanged.

Feature flags compose: each draws from its own seeded rng, and none of
them perturbs the historical base stream.

Orthogonally, ``unannotated=True`` strips the compiler-planted
BSSY/BSYNC/BMOV (and spin-loop YIELDs) from any of the three
distributions after compilation — the same shapes, presented the way the
annotation synthesizer (:mod:`repro_torch.analysis.transform`) receives them.
Rng streams are untouched: stripping is a post-pass on the encoded
program.
"""
import numpy as np

from repro_torch.core import MachineConfig, compile_structured
from repro_torch.core.structured import If, Raw, Seq, While

W = 8
MEM = 64
BASE_CFG = MachineConfig(n_threads=W, n_regs=16, n_preds=4, n_bx=8,
                         mem_size=MEM, max_steps=20_000)

# sync-feature programs get a widened memory so the spinlock's shared cells
# cannot collide with lane-private reads (cells < 4W) or writes (< 8W)
SYNC_MEM = 96
LOCK_CELL = 8 * W              # 64: the mutex
COUNTER_CELL = 8 * W + 1       # 65: the observable critical-section counter

# lane-private address offsets: lower half of memory is read-only input,
# upper half is written at lane-private cells
_RD_OFFS = [0, W, 2 * W, 3 * W]
_WR_OFFS = [4 * W, 5 * W, 6 * W, 7 * W]


def _raw(rng) -> Raw:
    ops = []
    for _ in range(rng.integers(1, 4)):
        k = rng.integers(0, 6)
        if k == 0:
            ops.append(f"IADDI R2, R2, {int(rng.integers(-3, 4))}")
        elif k == 1:
            ops.append("IADD R5, R2, R1")
        elif k == 2:
            ops.append("XOR R6, R5, R2")
        elif k == 3:
            ops.append(f"LDG R5, [R1+{int(rng.choice(_RD_OFFS))}]")
        elif k == 4:
            ops.append(f"STG [R1+{int(rng.choice(_WR_OFFS))}], R5")
        else:
            ops.append("IADD R2, R2, R5")
    return Raw(ops)


def _cond(rng, pred: int) -> list[str]:
    reg = rng.choice(["R2", "R5", "R6", "R1"])
    cmp = rng.choice(["LT", "GT", "EQ", "NE", "GE", "LE"])
    return [f"ISETP.{cmp} P{pred}, {reg}, {int(rng.integers(-2, 5))}"]


def _node(rng, depth: int, loop_level: int) -> "Seq | If | While | Raw":
    choices = ["raw", "seq"]
    if depth < 3:
        choices += ["if", "if", "while"]
    kind = rng.choice(choices)
    if kind == "raw":
        return _raw(rng)
    if kind == "seq":
        return Seq([_node(rng, depth, loop_level)
                    for _ in range(rng.integers(1, 3))])
    pred = int(rng.integers(0, 2))
    if kind == "if":
        has_else = bool(rng.integers(0, 2))
        return If(cond=_cond(rng, pred), pred=pred,
                  then_=_node(rng, depth + 1, loop_level),
                  else_=_node(rng, depth + 1, loop_level) if has_else else None)
    # while: bounded counter in R{8+loop_level}
    rc = 8 + loop_level
    bound = int(rng.integers(1, 4))
    body = Seq([Raw([f"IADDI R{rc}, R{rc}, 1"]),
                _node(rng, depth + 1, loop_level + 1)])
    brk = None
    if rng.integers(0, 3) == 0:
        body = Seq([Raw(["ISETP.GT P2, R5, 6"]), body])
        brk = 2
    return Seq([Raw([f"MOV R{rc}, 0"]),
                While(cond=[f"ISETP.LT P{pred}, R{rc}, {bound}"], pred=pred,
                      body=body, break_pred=brk)])


_SYNC_UID = [0]    # unique label suffixes across spinlock regions


def _spinlock_node() -> Raw:
    """A Fig 3/7-style spinlock region with an *observable* critical section.

    Mirrors ``programs.SPINLOCK_ASM`` (BSSY bracket, YIELD at the loop head
    so Hanoi's sibling switch can reach the lock holder, CAS acquire,
    non-atomic counter increment, EXCH release) on dedicated shared cells
    above the lane-private range.  The final state is schedule-invariant:
    the lock cell ends 0, the counter ends W (mutual exclusion), every
    lane's last CAS returned 0 and its EXCH returned 1 — only the *transit*
    registers R14/R15 (not in CHECK_REGS) ever hold schedule-dependent
    values.  Top-level only: R14/R15 double as Bx spill registers inside
    deeply nested regions, and no spill is live between top-level regions.

    The lock cell is freed by ``make_program``'s init-mem, NOT by a runtime
    store: on a per-thread-PC machine a straggler lane reaching a runtime
    "zero the lock" store while another lane holds the lock would break
    mutual exclusion — the schedule-invariance argument above needs the
    protocol to be self-contained.
    """
    uid = _SYNC_UID[0]
    _SYNC_UID[0] += 1
    return Raw([
        "MOV R12, 0",
        "MOV R13, 1",
        f"BSSY B0, slk_end_{uid}",
        f"slk_loop_{uid}:",
        "YIELD",
        f"ATOMCAS R14, [R12+{LOCK_CELL}], R12, R13",
        "ISETP.NE P3, R14, 0",
        f"@P3 BRA slk_loop_{uid}",
        f"LDG R15, [R12+{COUNTER_CELL}]",    # critical section: counter++
        "IADDI R15, R15, 1",
        f"STG [R12+{COUNTER_CELL}], R15",
        f"ATOMEXCH R14, [R12+{LOCK_CELL}], R12",
        f"slk_end_{uid}:",
        "BSYNC B0",
    ])


def _break_nested_while(rng) -> Seq:
    """A BREAK loop whose body contains a nested While: divergence-region
    depth >= 2 under an early-exit-past-BSYNC region (the Fig 6 shape the
    compiler dedicates a Bx register to)."""
    inner = Seq([Raw(["MOV R10, 0"]),
                 While(cond=["ISETP.LT P1, R10, 2"], pred=1,
                       body=Seq([Raw(["IADDI R10, R10, 1"]), _raw(rng)]))])
    bound = int(rng.integers(2, 5))
    body = Seq([Raw([f"ISETP.GT P2, R5, {int(rng.integers(4, 9))}"]),
                Raw(["IADDI R9, R9, 1"]), inner])
    return Seq([Raw(["MOV R9, 0"]),
                While(cond=[f"ISETP.LT P0, R9, {bound}"], pred=0,
                      body=body, break_pred=2)])


def _load_use_chain(mrng) -> Raw:
    """A long-latency load feeding a dependent ALU chain.

    The first consumer (``IADD R6, R5, R6``) has a RAW hazard on the load
    destination: under the cycle model the scoreboard must park the warp
    for the full memory latency before the chain can start, while the
    trace-conservative model charges only the issue slot.  The chain then
    alternates R5/R6 so every instruction depends on its predecessor —
    no independent work for dual-issue to hide the miss behind.
    """
    ops = [f"LDG R5, [R1+{int(mrng.choice(_RD_OFFS))}]"]
    for _ in range(int(mrng.integers(3, 7))):
        ops.append("IADD R6, R5, R6")
        ops.append("XOR R5, R6, R2")
    return Raw(ops)


def _divergent_load(mrng) -> If:
    """A load inside a divergent branch (the load-behind-divergence shape).

    Only the lanes that take the branch are behind the miss; the timing
    model still stalls the whole warp (per-warp scoreboard), which is the
    behaviour the stall-taxonomy tests pin down.
    """
    then_ = Raw([f"LDG R5, [R1+{int(mrng.choice(_RD_OFFS))}]",
                 "IADD R6, R6, R5"])
    else_ = Raw([f"LDG R5, [R1+{int(mrng.choice(_RD_OFFS))}]",
                 "XOR R6, R5, R2"])
    return If(cond=[f"ISETP.LT P0, R1, {int(mrng.integers(1, W))}"], pred=0,
              then_=then_, else_=else_ if mrng.integers(0, 2) else None)


def make_program(seed: int, n_bx: int, *, sync_features: bool = False,
                 mem_features: bool = False, unannotated: bool = False):
    """Build one random program; returns ``((prog, mem), cfg)`` or
    ``(None, cfg)`` for legitimately rejected shapes.

    All flags off reproduces the historical distribution exactly (same rng
    stream, same MachineConfig).  ``sync_features=True`` draws the
    synchronization constructs from an independent rng so the base shape
    for a given seed stays recognizable, and widens ``mem_size`` for the
    shared cells.  ``mem_features=True`` appends memory-latency-heavy
    shapes (load→dependent-ALU chains, loads in divergent branches) drawn
    from another independent rng; it composes with ``sync_features``.

    ``unannotated=True`` compiles the *same* shape (identical rng
    streams), then strips the compiler-planted BSSY/BSYNC/BMOV (and
    spin-loop YIELDs) via :func:`repro_torch.analysis.strip_annotations` — the
    synthesizer's input distribution.  Annotations the stripper must
    conservatively retain (WARPSYNC joins, non-canonical regions) stay.
    """
    rng = np.random.default_rng(seed)
    base = [Raw(["LANEID R1", "MOVR R2, R1"]),
            _node(rng, 0, 0),
            _node(rng, 0, 0)]
    cfg = BASE_CFG._replace(n_bx=n_bx)
    mem_nodes: "list[Raw | If]" = []
    if mem_features:
        mrng = np.random.default_rng(seed ^ 0x9E3779B9)
        mem_nodes.append(_load_use_chain(mrng))
        mem_nodes.append(_divergent_load(mrng))
        if mrng.integers(0, 2):
            mem_nodes.append(_load_use_chain(mrng))
    if sync_features:
        srng = np.random.default_rng(seed ^ 0x5F3759DF)
        full = (1 << W) - 1
        items = base[:2]
        if srng.integers(0, 2):
            items.append(Raw([f"WARPSYNC {full}"]))   # top-level full join
        items.append(_spinlock_node())
        items.append(base[2])
        if srng.integers(0, 2):
            items.append(_break_nested_while(srng))
        if srng.integers(0, 2):
            items.append(Raw([f"WARPSYNC {full}"]))
        ast = Seq(items + mem_nodes)
        cfg = cfg._replace(mem_size=SYNC_MEM)
    else:
        ast = Seq(base + mem_nodes)
    try:
        prog = compile_structured(ast, cfg)
    except ValueError:   # BREAK under spill pressure: legitimately rejected
        return None, cfg
    mem = rng.integers(0, 8, size=cfg.mem_size).astype(np.int32)
    if sync_features:
        mem[LOCK_CELL] = 0          # the mutex must start free
        mem[COUNTER_CELL] = 0       # counter starts 0 -> must end W
    if unannotated:
        from repro_torch.analysis import strip_annotations   # lazy
        prog = strip_annotations(prog, cfg).program
    return (prog, mem), cfg


CHECK_REGS = [1, 2, 5, 6, 8, 9, 10]


def corpus(n_seeds: int = 40, n_bx: int = 8, *, unannotated: bool = False):
    """Every distribution's programs for ``n_seeds`` seeds, as
    ``(label, program, cfg)`` triples — the shared walk the static-analysis
    conformance gate, the analyzer benchmark, and CI smoke all iterate
    (rejected seeds are skipped, exactly as the property suites skip them).
    ``unannotated=True`` passes through to :func:`make_program`.
    """
    out = []
    for tag, kw in (("base", {}), ("sync", {"sync_features": True}),
                    ("mem", {"mem_features": True})):
        for seed in range(n_seeds):
            made, cfg = make_program(seed, n_bx, unannotated=unannotated,
                                     **kw)
            if made is not None:
                out.append((f"{tag}-{seed}", made[0], cfg))
    return out
