"""A tiny assembler for SASS-lite.

Syntax follows the paper's rendering of Turing SASS (SS V-A):

* ``@P0`` / ``@!P0`` guard prefix (first predicate);
* an optional predicate *first operand* (``BRA P1, target`` /
  ``@!P0 BREAK P1, B0``) as the second predicate — both AND together;
* labels (``loop:``), ``;``/``#`` comments;
* registers ``R0..``, predicate regs ``P0..``, convergence-barrier regs
  ``B0..``;
* memory operands ``[R2]`` / ``[R2+8]``;
* ``ISETP.LT P0, R1, R2`` or immediate ``ISETP.GE P0, R1, 7``.

Example (the paper's Fig 3 spinlock, see repro.core.programs)::

    lock_loop:
        ATOMCAS R2, [R0], R3, R4
        ISETP.NE P0, R2, 0
        @P0 BRA lock_loop
    ...
"""
from __future__ import annotations

import re

import numpy as np

from .isa import CMP_NAMES, N_FIELDS, F_IMM, F_OP, Instr, Op, encode_program

_LABEL_RE = re.compile(r"^([A-Za-z_][\w.]*):$")
_MEM_RE = re.compile(r"^\[R(\d+)(?:\s*\+\s*(-?\w+))?\]$")

#: Ops whose ``imm`` field is a code address (an edge or reconvergence
#: target).  MOV is deliberately absent: its imm *can* stage a return
#: address for RET (see programs.CALLS), which is why the transform passes
#: refuse to edit CALL/RET-bearing programs instead of guessing.
TARGET_OPS = frozenset({int(Op.BRA), int(Op.CALL), int(Op.BSSY)})


class AsmError(ValueError):
    """An assembly error with source context.

    ``reason`` is the bare message; ``lineno``/``col`` (1-based) and
    ``source`` (the raw offending source line) are attached by
    :func:`assemble` when the error surfaces through it, and the formatted
    ``str`` then carries a ``line L, col C:`` prefix plus a caret snippet —
    so a one-character typo in a 300-line listing is a one-glance fix.
    """

    def __init__(self, reason: str, *, lineno: "int | None" = None,
                 col: "int | None" = None, source: "str | None" = None,
                 token: "str | None" = None) -> None:
        self.reason = reason
        self.lineno = lineno
        self.col = col
        self.source = source
        self.token = token        # offending token, for column recovery
        super().__init__(self._format())

    def _format(self) -> str:
        loc = ""
        if self.lineno is not None:
            loc = f"line {self.lineno}"
            if self.col is not None:
                loc += f", col {self.col}"
            loc += ": "
        msg = f"{loc}{self.reason}"
        if self.source is not None:
            msg += f"\n    {self.source}"
            if self.col is not None:
                msg += "\n    " + " " * (self.col - 1) + "^"
        return msg

    def with_context(self, lineno: int, source: str) -> "AsmError":
        """A copy of this error annotated with its source coordinates."""
        col = None
        if self.token:
            at = source.find(self.token)
            if at >= 0:
                col = at + 1
        return AsmError(self.reason, lineno=lineno, col=col,
                        source=source, token=self.token)


def _parse_pred(tok: str) -> int:
    """``P3`` -> 4, ``!P3`` -> -4, per the isa.py predicate encoding."""
    neg = tok.startswith("!")
    if neg:
        tok = tok[1:]
    if not re.fullmatch(r"P\d+", tok):
        raise AsmError(f"bad predicate {tok!r}", token=tok)
    return (-1 if neg else 1) * (int(tok[1:]) + 1)


def _is_pred(tok: str) -> bool:
    return bool(re.fullmatch(r"!?P\d+", tok))


def _reg(tok: str, kind: str) -> int:
    if not re.fullmatch(rf"{kind}\d+", tok):
        raise AsmError(f"expected {kind}-register, got {tok!r}", token=tok)
    return int(tok[1:])


def _int(tok: str) -> int:
    return int(tok, 0)


def assemble(text: str) -> np.ndarray:
    """Assemble SASS-lite text into an ``int32[L, 8]`` program table.

    Errors raise :class:`AsmError` annotated with the 1-based source line
    number, the offending column where recoverable, and the raw source line.
    """
    lines: list[tuple[str, list[str]]] = []   # (mnemonic, operand tokens)
    guards: list[int] = []
    labels: dict[str, int] = {}
    srcs: list[tuple[int, str]] = []          # (1-based lineno, raw line)

    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = raw.split(";")[0].split("#")[0].strip()
        if not line:
            continue
        m = _LABEL_RE.match(line)
        if m:
            labels[m.group(1)] = len(lines)
            continue
        guard = 0
        if line.startswith("@"):
            gtok, line = line.split(None, 1)
            try:
                guard = _parse_pred(gtok[1:])
            except AsmError as exc:
                raise exc.with_context(lineno, raw) from None
        parts = line.split(None, 1)
        mnem = parts[0].upper()
        ops = [t.strip() for t in parts[1].split(",")] if len(parts) > 1 else []
        lines.append((mnem, ops))
        guards.append(guard)
        srcs.append((lineno, raw))

    def res(tok: str, pc: int) -> int:
        """Resolve a label or integer literal."""
        if tok in labels:
            return labels[tok]
        try:
            return _int(tok)
        except ValueError:
            raise AsmError(f"unknown label/literal {tok!r} at pc {pc}",
                           token=tok) from None

    def build(pc: int, mnem: str, ops: "list[str]", guard: int) -> Instr:
        p2 = 0
        # a leading predicate operand is the second predicate (SS V-A)
        if ops and _is_pred(ops[0]) and not mnem.startswith("ISETP"):
            p2 = _parse_pred(ops[0])
            ops = ops[1:]

        def mem(tok: str) -> tuple[int, int]:
            m = _MEM_RE.match(tok.replace(" ", ""))
            if not m:
                raise AsmError(f"bad memory operand {tok!r} at pc {pc}",
                               token=tok)
            return int(m.group(1)), (res(m.group(2), pc) if m.group(2) else 0)

        k = dict(pred1=guard, pred2=p2)
        if mnem == "NOP":
            i = Instr(Op.NOP, **k)
        elif mnem == "EXIT":
            i = Instr(Op.EXIT, **k)
        elif mnem == "BRA":
            i = Instr(Op.BRA, imm=res(ops[0], pc), **k)
        elif mnem == "BSSY":
            i = Instr(Op.BSSY, dst=_reg(ops[0], "B"), imm=res(ops[1], pc), **k)
        elif mnem == "BSYNC":
            i = Instr(Op.BSYNC, dst=_reg(ops[0], "B"), **k)
        elif mnem == "BMOV":
            if ops[0].startswith("B"):
                i = Instr(Op.BMOV_R2B, dst=_reg(ops[0], "B"),
                          src0=_reg(ops[1], "R"), **k)
            else:
                i = Instr(Op.BMOV_B2R, dst=_reg(ops[0], "R"),
                          src0=_reg(ops[1], "B"), **k)
        elif mnem == "BREAK":
            i = Instr(Op.BREAK, dst=_reg(ops[0], "B"), **k)
        elif mnem == "WARPSYNC":
            if ops[0].startswith("R"):
                i = Instr(Op.WARPSYNC, src0=_reg(ops[0], "R"), **k)
            else:
                i = Instr(Op.WARPSYNC, src0=-1, imm=_int(ops[0]), **k)
        elif mnem == "YIELD":
            i = Instr(Op.YIELD, **k)
        elif mnem == "CALL":
            i = Instr(Op.CALL, imm=res(ops[0], pc), **k)
        elif mnem == "RET":
            i = Instr(Op.RET, src0=_reg(ops[0], "R"), **k)
        elif mnem == "MOV":
            i = Instr(Op.MOV, dst=_reg(ops[0], "R"), imm=res(ops[1], pc), **k)
        elif mnem == "MOVR":
            i = Instr(Op.MOVR, dst=_reg(ops[0], "R"), src0=_reg(ops[1], "R"), **k)
        elif mnem in ("IADD", "IMUL", "AND", "OR", "XOR"):
            i = Instr(Op[mnem], dst=_reg(ops[0], "R"), src0=_reg(ops[1], "R"),
                      src1=_reg(ops[2], "R"), **k)
        elif mnem == "IADDI":
            i = Instr(Op.IADDI, dst=_reg(ops[0], "R"), src0=_reg(ops[1], "R"),
                      imm=res(ops[2], pc), **k)
        elif mnem in ("SHL", "SHR"):
            i = Instr(Op[mnem], dst=_reg(ops[0], "R"), src0=_reg(ops[1], "R"),
                      imm=_int(ops[2]), **k)
        elif mnem.startswith("ISETP."):
            cmp = CMP_NAMES[mnem.split(".")[1]]
            if ops[2].startswith("R"):
                i = Instr(Op.ISETP, dst=_parse_pred(ops[0]) - 1,
                          src0=_reg(ops[1], "R"), src1=_reg(ops[2], "R"),
                          src2=cmp, **k)
            else:
                i = Instr(Op.ISETP, dst=_parse_pred(ops[0]) - 1,
                          src0=_reg(ops[1], "R"), src1=-1, src2=cmp,
                          imm=res(ops[2], pc), **k)
        elif mnem == "LANEID":
            i = Instr(Op.LANEID, dst=_reg(ops[0], "R"), **k)
        elif mnem == "LDG":
            r, off = mem(ops[1])
            i = Instr(Op.LDG, dst=_reg(ops[0], "R"), src0=r, imm=off, **k)
        elif mnem == "STG":
            r, off = mem(ops[0])
            i = Instr(Op.STG, src0=r, src1=_reg(ops[1], "R"), imm=off, **k)
        elif mnem in ("ATOMCAS", "ATOMEXCH", "ATOMADD"):
            r, off = mem(ops[1])
            src2 = _reg(ops[3], "R") if mnem == "ATOMCAS" else 0
            i = Instr(Op[mnem], dst=_reg(ops[0], "R"), src0=r,
                      src1=_reg(ops[2], "R"), src2=src2, imm=off, **k)
        else:
            raise AsmError(f"unknown mnemonic {mnem!r} at pc {pc}",
                           token=mnem)
        return i

    instrs: list[Instr] = []
    for pc, ((mnem, ops), guard) in enumerate(zip(lines, guards)):
        lineno, raw = srcs[pc]
        try:
            instrs.append(build(pc, mnem, ops, guard))
        except AsmError as exc:
            raise (exc if exc.lineno is not None
                   else exc.with_context(lineno, raw)) from None
        except IndexError:
            raise AsmError(f"missing operand(s) for {mnem}", lineno=lineno,
                           source=raw) from None
        except KeyError as exc:
            raise AsmError(f"bad operand {exc.args[0]!r} for {mnem}",
                           lineno=lineno, source=raw) from None

    return encode_program(instrs)


def disassemble_line(row: np.ndarray) -> str:
    """One instruction row rendered as text, without the pc prefix.

    The form analyzer diagnostics quote (``repro.analysis`` pairs it with
    the pc); :func:`disassemble` prefixes each line with its pc.
    """
    op = Op(int(row[0]))
    fields = dict(zip(
        ("op", "dst", "src0", "src1", "src2", "imm", "p1", "p2"),
        map(int, row)))
    g = ""
    if fields["p1"]:
        k = fields["p1"]
        g = f"@{'!' if k < 0 else ''}P{abs(k) - 1} "
    body = " ".join(f"{f}={v}" for f, v in fields.items()
                    if f not in ("op", "p1") and v)
    return f"{g}{op.name} {body}".rstrip()


def disassemble(table: np.ndarray) -> str:
    """Best-effort inverse of :func:`assemble` (for debugging / logs)."""
    return "\n".join(f"{pc:4d}: {disassemble_line(row)}"
                     for pc, row in enumerate(np.asarray(table)))


class EditInstr:
    """One instruction under edit: raw fields plus a symbolic target.

    ``fields`` is the 8-wide isa.py row as a mutable list.  ``target`` is
    the :class:`EditInstr` this instruction's code-address immediate refers
    to (BRA/CALL/BSSY), a raw ``int`` kept verbatim when the encoded target
    was out of range, or ``None`` for ops without a code-address imm.
    Identity is object identity — two nodes with equal fields are distinct
    instructions, so list/dict membership follows the program, not values.
    """

    __slots__ = ("fields", "target")

    def __init__(self, fields: "list[int] | tuple[int, ...]",
                 target: "EditInstr | int | None" = None) -> None:
        if len(fields) != N_FIELDS:
            raise ValueError(f"expected {N_FIELDS} fields, got {len(fields)}")
        self.fields = [int(x) for x in fields]
        self.target = target

    @property
    def op(self) -> int:
        return self.fields[F_OP]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<EditInstr {disassemble_line(np.asarray(self.fields))}>"


class ProgramEditor:
    """Symbolic insert/remove over a program table with target re-resolution.

    Decoding turns every code-address immediate into a node reference, so
    instructions can be inserted or removed anywhere and :meth:`encode`
    re-assigns pcs and re-resolves every BRA/BSSY/CALL immediate — the
    re-assembly substrate under ``repro.analysis.transform``.

    Insertion is deliberately explicit about edge capture: inserting before
    a node does NOT redirect branches to that node unless they are listed in
    ``capture``.  Whether a jump to a loop header should land on a newly
    synthesized BSSY (yes, for an If opening a loop body) or stay on the old
    first instruction (yes, for a region's interior back-edge) is a *policy*
    decision that belongs to the pass, not the editor.
    """

    def __init__(self, program: np.ndarray) -> None:
        table = np.asarray(program, dtype=np.int32)
        if table.ndim != 2 or table.shape[1] != N_FIELDS:
            raise ValueError(f"program must be [L, {N_FIELDS}], got {table.shape}")
        self.nodes: "list[EditInstr]" = [EditInstr(row) for row in table.tolist()]
        n = len(self.nodes)
        for node in self.nodes:
            if node.fields[F_OP] in TARGET_OPS:
                t = node.fields[F_IMM]
                node.target = self.nodes[t] if 0 <= t < n else t

    def index(self, node: EditInstr) -> int:
        """Current position of ``node`` (identity match)."""
        for i, x in enumerate(self.nodes):
            if x is node:
                return i
        raise ValueError("node is not in this editor")

    def refs_to(self, node: EditInstr) -> "list[EditInstr]":
        """All nodes whose target is ``node``."""
        return [x for x in self.nodes if x.target is node]

    def insert_before(self, at: EditInstr, node: EditInstr, *,
                      capture: "tuple[EditInstr, ...] | list[EditInstr]" = ()
                      ) -> None:
        """Insert ``node`` immediately before ``at``.

        Referrers listed in ``capture`` are retargeted to the new node;
        every other reference to ``at`` keeps pointing at ``at``.
        """
        i = self.index(at)
        for ref in capture:
            ref.target = node
        self.nodes.insert(i, node)

    def remove(self, node: EditInstr) -> None:
        """Remove ``node``; references to it fall through to its successor.

        Removing the last instruction leaves referrers pointing one past the
        end (encoded as a raw out-of-range target) — the analyzer will flag
        it, which is the honest outcome of that edit.
        """
        i = self.index(node)
        del self.nodes[i]
        succ: "EditInstr | int" = (self.nodes[i] if i < len(self.nodes)
                                   else len(self.nodes))
        for ref in self.nodes:
            if ref.target is node:
                ref.target = succ

    def positions(self) -> "dict[EditInstr, int]":
        """Node -> current pc (nodes hash by identity)."""
        return {node: pc for pc, node in enumerate(self.nodes)}

    def encode(self) -> np.ndarray:
        """Re-assemble into an ``int32[L, 8]`` table, resolving targets."""
        if not self.nodes:
            raise ValueError("cannot encode an empty program")
        pcs = self.positions()
        rows = []
        for node in self.nodes:
            f = list(node.fields)
            if node.target is not None:
                f[F_IMM] = (pcs[node.target]
                            if isinstance(node.target, EditInstr)
                            else int(node.target))
            rows.append(f)
        return np.array(rows, dtype=np.int32)
