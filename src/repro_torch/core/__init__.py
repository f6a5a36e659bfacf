"""The simulator's core (port of ``repro.core``): the SASS-lite ISA and
assembler, structured-program compiler, benchmark suite, the numpy
reference interpreters, CFG analysis, trace diffing, the trace timing
model, and Hanoi as a batched state machine (:mod:`.hanoi`, whose device
half is kernel K1).  Everything but :mod:`.hanoi` is numpy only, copied
from the reference so that the port imports nothing of it."""
from .isa import (CONTROL_OPS, Instr, MachineConfig, Op, decode_program,
                  encode_program, hardware_cost_bytes)
from .asm import AsmError, assemble, disassemble
from .interp import (RunResult, popcount, run_reference, simd_utilization)
from .cfg import build_cfg, immediate_postdominators
from .trace import discrepancy, levenshtein, trace_tokens
from .structured import (If, Raw, Seq, While, compile_structured, emit_text,
                         region_depth)

__all__ = [
    "AsmError", "CONTROL_OPS", "If", "Instr", "MachineConfig", "Op", "Raw",
    "RunResult", "Seq", "While", "assemble", "build_cfg", "compile_structured",
    "decode_program", "disassemble", "discrepancy", "emit_text",
    "encode_program", "hardware_cost_bytes", "immediate_postdominators",
    "levenshtein", "popcount", "region_depth", "run_reference",
    "simd_utilization", "trace_tokens",
]
