"""Lint CLI: ``python -m repro_torch.analysis [files.asm ...] [--suite]``.

Port of ``repro.analysis.__main__`` (numpy only, copied; it imports nothing of
``repro``).

Assembles each ``.asm`` file (surfacing :class:`repro_torch.core.asm.AsmError`
with its line/column context) and/or walks the built-in benchmark suite,
runs the static verifier, and prints every diagnostic as
``pc NNNN  [severity] code: message`` over the disassembled instruction.

``--fix`` runs the annotation synthesizer first (region synthesis, Bx
allocation + BMOV spilling, YIELD insertion) and lints the *rewritten*
program; ``--select``/``--ignore`` narrow the diagnostics that count,
and ``--format=github`` emits GitHub Actions workflow annotations so CI
can gate on a chosen subset.

Exit status: 0 clean, 1 when any program has errors (or, with
``--strict``, warnings), 2 when an input fails to assemble or ``--fix``
cannot rewrite it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.core.asm import AsmError, assemble
from repro_torch.core.isa import MachineConfig

from .fingerprint import FEATURES, FP_VERSION, fingerprint
from .passes import AnalysisReport, Severity, analyze_program
from .transform import TransformError, synthesize_annotations

_GITHUB_LEVEL = {Severity.ERROR: "error", Severity.WARN: "warning",
                 Severity.INFO: "notice"}


def _programs(ns) -> "list[tuple[str, object]]":
    progs: list[tuple[str, object]] = []
    for path in ns.files:
        text = Path(path).read_text()
        try:
            progs.append((path, assemble(text)))
        except AsmError as exc:
            print(f"{path}: assembly failed\n{exc}", file=sys.stderr)
            raise SystemExit(2)
    if ns.suite:
        from repro_torch.core.programs import make_suite
        for bench in make_suite(MachineConfig(n_threads=ns.threads)):
            progs.append((f"suite:{bench.name}", bench.program))
    return progs


def _code_set(spec: "str | None") -> "frozenset[str] | None":
    if spec is None:
        return None
    codes = frozenset(c.strip() for c in spec.split(",") if c.strip())
    return codes or None


def _filter(report: AnalysisReport, select, ignore) -> AnalysisReport:
    """Narrow a report to the diagnostics the caller cares about."""
    diags = report.diagnostics
    if select is not None:
        diags = tuple(d for d in diags if d.code in select)
    if ignore is not None:
        diags = tuple(d for d in diags if d.code not in ignore)
    if diags is report.diagnostics:
        return report
    return AnalysisReport(diags, report.fingerprint, report.name)


def _github_lines(name: str, report: AnalysisReport) -> "list[str]":
    # GitHub annotation syntax: properties are comma-separated, the
    # message follows '::'.  .asm inputs map pc -> 1-based line; suite
    # programs have no file, so the program name rides in the title.
    is_file = not name.startswith("suite:")
    out = []
    for d in report.diagnostics:
        props = f"file={name}," if is_file else ""
        props += f"line={d.pc + 1},title={d.code}"
        msg = d.message if is_file else f"[{name}] {d.message}"
        out.append(f"::{_GITHUB_LEVEL[d.severity]} {props}::{msg}")
    return out


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="statically verify SASS-lite programs (no execution)")
    ap.add_argument("files", nargs="*", help=".asm files to lint")
    ap.add_argument("--suite", action="store_true",
                    help="also lint the built-in benchmark suite")
    ap.add_argument("--threads", type=int, default=32,
                    help="warp width for --suite programs (default 32)")
    ap.add_argument("--strict", action="store_true",
                    help="treat warnings as failures")
    ap.add_argument("--fix", action="store_true",
                    help="synthesize missing BSSY/BSYNC/BMOV/YIELD "
                         "annotations before linting")
    ap.add_argument("--select", metavar="CODE[,CODE]",
                    help="only count/show these diagnostic codes")
    ap.add_argument("--ignore", metavar="CODE[,CODE]",
                    help="drop these diagnostic codes")
    ap.add_argument("--format", choices=("text", "github"), default="text",
                    help="output style (github = workflow annotations)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit one JSON object per program")
    ap.add_argument("--fingerprint", action="store_true",
                    help="also print each program's CFG fingerprint")
    ns = ap.parse_args(argv)
    if not ns.files and not ns.suite:
        ap.error("nothing to lint: pass .asm files and/or --suite")
    select, ignore = _code_set(ns.select), _code_set(ns.ignore)

    progs = _programs(ns)
    failed = False
    for name, prog in progs:
        if ns.fix:
            try:
                syn = synthesize_annotations(prog, name=name)
            except TransformError as exc:
                print(f"{name}: --fix failed\n{exc}", file=sys.stderr)
                raise SystemExit(2)
            prog = syn.program
            if syn.changed and ns.format == "text" and not ns.as_json:
                print(f"{name}: synthesized {syn.regions} region(s), "
                      f"{syn.spills} spill(s), {syn.yields} yield(s)")
        report = _filter(analyze_program(prog, name=name), select, ignore)
        bad = report.errors + (report.warnings if ns.strict else ())
        failed = failed or bool(bad)
        if ns.as_json:
            print(json.dumps({
                "name": name,
                "ok": not bad,
                "diagnostics": [
                    {"severity": str(d.severity), "code": d.code,
                     "pc": d.pc, "message": d.message, "line": d.line}
                    for d in report.diagnostics],
                "fingerprint": {"v": FP_VERSION,
                                "features": dict(zip(FEATURES,
                                                     report.fingerprint))},
            }))
            continue
        if ns.format == "github":
            for line in _github_lines(name, report):
                print(line)
            continue
        print(report.render())
        if ns.fingerprint:
            fp = fingerprint(prog)
            pairs = ", ".join(f"{k}={v:g}" for k, v in zip(FEATURES, fp))
            print(f"  fingerprint v{FP_VERSION}: {pairs}")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
