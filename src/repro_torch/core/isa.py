"""SASS-lite ISA for the Hanoi control-flow-management engine.

The paper ("Control Flow Management in Modern GPUs") defines semantics for the
control-flow subset of NVIDIA Turing's native ISA (SASS).  We encode a
SASS-like mini ISA ("SASS-lite") sufficient to express every scenario the
paper studies: nested divergence (Fig 5), earlier-than-IPDom reconvergence
with BREAK (Fig 6), spinlocks with YIELD (Figs 3/7), predication (SS V-A),
WARPSYNC, CALL/RET, and enough ALU / memory / atomic ops to build the
benchmark suite.

Programs are dense ``int32[L, N_FIELDS]`` tables so they can be consumed by
both the numpy interpreter and the vectorized JAX engine.

Instruction word fields::

    [opcode, dst, src0, src1, src2, imm, pred1, pred2]

Predicate encoding (paper SS V-A: up to two predicates, AND-ed, each
negatable):  ``0`` = none (always true), ``+k`` = P(k-1), ``-k`` = !P(k-1).
"""
from __future__ import annotations

import enum
from typing import NamedTuple

import numpy as np

N_FIELDS = 8
(F_OP, F_DST, F_SRC0, F_SRC1, F_SRC2, F_IMM, F_PRED1, F_PRED2) = range(N_FIELDS)


class Op(enum.IntEnum):
    """Opcodes.  The control-flow subset mirrors Table I's green entries."""

    NOP = 0
    # --- control flow (paper SS V) -------------------------------------------
    EXIT = 1        # terminate executing threads
    BRA = 2         # [imm=target] conditional/unconditional branch
    BSSY = 3        # [dst=Bx, imm=target(BSYNC pc)] init reconvergence mask
    BSYNC = 4       # [dst=Bx] reconverge threads named in Bx
    BMOV_B2R = 5    # [dst=Rd, src0=Bx]  spill  Bx -> Rd (invalidates Bx)
    BMOV_R2B = 6    # [dst=Bx, src0=Rs]  fill   Rs -> Bx (revalidates Bx)
    BREAK = 7       # [dst=Bx] remove predicated-true threads from Bx mask
    WARPSYNC = 8    # [src0=Rs or -1, imm=mask if src0==-1] sync named threads
    YIELD = 9       # switch to sibling path if one exists
    CALL = 10       # [imm=target] direct call (return addr staged via MOV)
    RET = 11        # [src0=Rs] indirect jump to Rs (uniform across path)
    # --- ALU -----------------------------------------------------------------
    MOV = 12        # Rd = imm
    MOVR = 13       # Rd = Rs0
    IADD = 14       # Rd = Rs0 + Rs1
    IADDI = 15      # Rd = Rs0 + imm
    IMUL = 16       # Rd = Rs0 * Rs1
    AND = 17        # Rd = Rs0 & Rs1
    OR = 18         # Rd = Rs0 | Rs1
    XOR = 19        # Rd = Rs0 ^ Rs1
    SHL = 20        # Rd = Rs0 << imm
    SHR = 21        # Rd = Rs0 >> imm  (logical)
    ISETP = 22      # Pd = cmp(Rs0, Rs1|imm)   [src2=cmp code, src1=-1 -> imm]
    LANEID = 23     # Rd = lane id
    # --- memory / atomics ----------------------------------------------------
    LDG = 24        # Rd = mem[Rs0 + imm]
    STG = 25        # mem[Rs0 + imm] = Rs1     (lane-serialized, lowest first)
    ATOMCAS = 26    # Rd = CAS(mem[Rs0+imm], cmp=Rs1, new=Rs2) (lane-serialized)
    ATOMEXCH = 27   # Rd = EXCH(mem[Rs0+imm], Rs1)
    ATOMADD = 28    # Rd = ADD(mem[Rs0+imm], Rs1) returns old


N_OPS = len(Op)

# ISETP comparison codes (field src2)
CMP_EQ, CMP_NE, CMP_LT, CMP_LE, CMP_GT, CMP_GE = range(6)
CMP_NAMES = {"EQ": CMP_EQ, "NE": CMP_NE, "LT": CMP_LT,
             "LE": CMP_LE, "GT": CMP_GT, "GE": CMP_GE}

CONTROL_OPS = frozenset({
    Op.EXIT, Op.BRA, Op.BSSY, Op.BSYNC, Op.BMOV_B2R, Op.BMOV_R2B,
    Op.BREAK, Op.WARPSYNC, Op.YIELD, Op.CALL, Op.RET,
})
MEMORY_OPS = frozenset({Op.LDG, Op.STG, Op.ATOMCAS, Op.ATOMEXCH, Op.ATOMADD})
ATOMIC_OPS = frozenset({Op.ATOMCAS, Op.ATOMEXCH, Op.ATOMADD})


class Instr(NamedTuple):
    op: int
    dst: int = 0
    src0: int = 0
    src1: int = 0
    src2: int = 0
    imm: int = 0
    pred1: int = 0
    pred2: int = 0

    def encode(self) -> np.ndarray:
        # masks in imm may be given as unsigned 32-bit values; wrap to i32
        return np.array(self, dtype=np.int64).astype(np.int32)


def encode_program(instrs: list[Instr]) -> np.ndarray:
    """Encode a list of instructions into an ``int32[L, N_FIELDS]`` table."""
    if not instrs:
        raise ValueError("empty program")
    return np.stack([i.encode() for i in instrs]).astype(np.int32)


def decode_program(table: np.ndarray) -> list[Instr]:
    return [Instr(*map(int, row)) for row in np.asarray(table)]


class MachineConfig(NamedTuple):
    """Shapes of the simulated machine.  The paper uses 4-thread warps for
    illustration and 32 for the real machine; both are supported."""

    n_threads: int = 32
    n_regs: int = 16
    n_preds: int = 4
    n_bx: int = 8           # paper SS IX-A sizes the design for 8 Bx registers
    mem_size: int = 256
    max_steps: int = 4096   # scheduler-slot fuel; exhaustion => deadlock

    @property
    def full_mask(self) -> int:
        return (1 << self.n_threads) - 1


def hardware_cost_bytes(cfg: MachineConfig) -> dict:
    """Paper SS IX-A storage accounting for Hanoi vs. a SIMT-Stack.

    Hanoi per warp: WS stack (W entries x (PC + mask)), REC stack
    (W entries x (PC + Bx index)), Bx file, waiting + finished masks.
    SIMT-Stack per warp: W entries x (PC + reconvergence PC + mask).
    """
    W = cfg.n_threads
    pc_bits = 32
    mask_bits = W
    bx_idx_bits = max(1, (cfg.n_bx - 1).bit_length())
    # Hanoi (SS IX-A): WS needs at most W entries, REC W-1 (we round to W)
    ws_bits = W * (pc_bits + mask_bits)
    rec_bits = W * (pc_bits + bx_idx_bits)
    bx_bits = cfg.n_bx * (mask_bits + 1)
    masks_bits = 2 * mask_bits
    hanoi_bits = ws_bits + rec_bits + bx_bits + masks_bits
    # SIMT-Stack worst case: every divergence pushes a reconvergence entry
    # plus a path entry -> 2W entries of (PC, reconvergence PC, mask)
    simt_bits = 2 * W * (pc_bits + pc_bits + mask_bits)
    return {
        "hanoi_bytes": hanoi_bits // 8,
        "simt_stack_bytes": simt_bits // 8,
        "saving_frac": 1.0 - (hanoi_bits / simt_bits),
        "ws_bytes": ws_bits // 8,
        "rec_bytes": rec_bits // 8,
        "bx_bytes": (bx_bits + 7) // 8,
    }
