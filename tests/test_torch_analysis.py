"""The port's static analysis (``repro_torch.analysis``) against the JAX
package's ``repro.analysis``, and the cases of ``tests/test_analysis.py``
and ``tests/test_transform.py`` run on the port.

Everything here is integer and bit-exact: diagnostics (code, severity, pc,
message, disassembly), fingerprints and distances, the stripped and
synthesized program tables and their pc maps, and the cost model's
estimates (both packages use the same numpy arithmetic) are compared for
equality, with no tolerance.  ``Simulator(device="cpu")`` runs
``hanoi_torch``'s plain twin: its ``verify=`` rejects what the reference
rejects and its ``synthesize=True`` traces equal the reference ``hanoi``'s.
The reference's service cases (admission rejection, ``auto_annotate``)
wait for the service's port and are not here.  The machine with the card
has no JAX: there this module skips.
"""
import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("jax")

from repro import analysis as janalysis                            # noqa: E402
from repro.core import programs as JP                              # noqa: E402
from repro.core.isa import MachineConfig as JCfg                   # noqa: E402
from repro.engine import Simulator as JSimulator                   # noqa: E402
from repro_torch import analysis as tanalysis                      # noqa: E402
from repro_torch.analysis import (FEATURES, ProgramCFG, Severity,  # noqa: E402
                                  StaticAnalysisError, TransformError,
                                  analyze_program, distance, estimate,
                                  fingerprint, fingerprint_meta,
                                  rank_correlation, strip_annotations,
                                  synthesize_annotations, verify_program)
from repro_torch.analysis.transform import ANNOTATION_OPS          # noqa: E402
from repro_torch.benchmarks import progen as tprogen               # noqa: E402
from repro_torch.core import compile_structured                    # noqa: E402
from repro_torch.core import programs as P                         # noqa: E402
from repro_torch.core.asm import (AsmError, assemble, disassemble,  # noqa: E402
                                  disassemble_line)
from repro_torch.core.cfg import immediate_postdominators          # noqa: E402
from repro_torch.core.isa import F_DST, F_OP, MachineConfig, Op    # noqa: E402
from repro_torch.core.programs import make_suite                   # noqa: E402
from repro_torch.core.structured import If, Raw, Seq               # noqa: E402
from repro_torch.engine import Simulator, iter_mechanisms          # noqa: E402
from tests import progen as jprogen                                # noqa: E402

W8 = MachineConfig(n_threads=8)
W4 = MachineConfig(n_threads=4)
JW8 = JCfg(n_threads=8)
SUITE = make_suite(W8, datasets=1)
SIM = Simulator("hanoi", device="cpu")     # hanoi_torch runs its plain twin

# the one suite program whose round-trip is equivalent-but-not-bit-equal:
# FIG5 hand-forces B0 reuse with an R0 spill where the allocator simply
# uses two of the eight Bx registers
KNOWN_DEVIATIONS = {"FIG5"}

SINGLE_WARP = [m.name for m in iter_mechanisms() if "composite" not in m.tags]


def codes(report):
    return [d.code for d in report.diagnostics]


def jcfg(cfg):
    return JCfg(**cfg._asdict())


def corpus_pairs(n_seeds, **kw):
    """The port's progen corpus beside the reference's, seed for seed."""
    mine, theirs = tprogen.corpus(n_seeds, **kw), jprogen.corpus(n_seeds, **kw)
    assert [m[0] for m in mine] == [t[0] for t in theirs]
    return list(zip(mine, theirs))


def _program_set():
    """(label, port program, port cfg, reference cfg): the suite at two
    widths, the figures and fixtures, and the progen corpus."""
    out = [(f"suite8:{b.name}", b.program, W8, JW8) for b in make_suite(W8)]
    W32 = MachineConfig(n_threads=32, mem_size=256, max_steps=60_000)
    out += [(f"suite32:{b.name}", b.program, W32, jcfg(W32))
            for b in make_suite(W32)]
    out += [(name, prog, W8, JW8) for name, prog in (
        ("fig6nb", P.fig6_no_break_program()),
        ("spin_no_yield", P.spinlock_no_yield_program()),
        ("bra99", assemble("BRA 99")),
        ("loop", assemble("loop:\nMOV R1, 1\nBRA loop")))]
    out += [(label, prog, cfg, jcfg(cfg))
            for (label, prog, cfg), _ in corpus_pairs(12)]
    out += [(f"u-{label}", prog, cfg, jcfg(cfg))
            for (label, prog, cfg), _ in corpus_pairs(6, unannotated=True)]
    return out


PROGRAMS = _program_set()


def diag_tuples(report):
    return [(d.severity.value, d.code, d.pc, d.message, d.line)
            for d in report.diagnostics]


# ---------------------------------------------------------------------------
# equality with repro.analysis
# ---------------------------------------------------------------------------

def test_port_progen_is_the_reference_progen():
    for (tl, tp, tc), (jl, jp, jc) in corpus_pairs(20) + corpus_pairs(
            5, unannotated=True):
        assert tl == jl and tc._asdict() == jc._asdict()
        np.testing.assert_array_equal(tp, jp)
    for seed in (0, 3, 7):
        for kw in ({}, {"sync_features": True}, {"mem_features": True}):
            mine, tc = tprogen.make_program(seed, 8, **kw)
            ref, jc = jprogen.make_program(seed, 8, **kw)
            assert (mine is None) == (ref is None)
            assert tc._asdict() == jc._asdict()
            for a, b in zip(mine or (), ref or ()):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("chunk", range(4))
def test_analyze_program_equals_reference(chunk):
    for label, prog, cfg, jc in PROGRAMS[chunk::4]:
        mine = analyze_program(prog, cfg, name=label)
        ref = janalysis.analyze_program(prog, jc, name=label)
        assert diag_tuples(mine) == diag_tuples(ref), label
        assert (mine.ok, mine.name, mine.codes()) == \
            (ref.ok, ref.name, ref.codes()), label
        assert mine.render() == ref.render(), label


@pytest.mark.parametrize("chunk", range(2))
def test_fingerprint_and_distance_equal_reference(chunk):
    progs = PROGRAMS[chunk::2]
    fps = [fingerprint(p, c) for _, p, c, _ in progs]
    jfps = [janalysis.fingerprint(p, jc) for _, p, _, jc in progs]
    assert fps == jfps
    assert tanalysis.FEATURES == janalysis.FEATURES
    assert tanalysis.FP_VERSION == janalysis.FP_VERSION
    for (_, p, c, jc) in progs[:10]:
        assert fingerprint_meta(p, c) == janalysis.fingerprint_meta(p, jc)
    for i in range(0, len(fps) - 1):
        assert distance(fps[i], fps[i + 1]) == \
            janalysis.distance(jfps[i], jfps[i + 1])
    assert tanalysis.rank(fps[0], list(enumerate(fps))) == \
        janalysis.rank(jfps[0], list(enumerate(jfps)))


@pytest.mark.parametrize("chunk", range(2))
def test_estimate_equals_reference(chunk):
    from repro.timing import CycleConfig as JCycleConfig
    from repro_torch.timing import CycleConfig
    for label, prog, cfg, jc in PROGRAMS[chunk::2]:
        mine, ref = estimate(prog, cfg), janalysis.estimate(prog, jc)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref), label
        assert mine.stall_fraction == ref.stall_fraction, label
    slow = estimate(PROGRAMS[0][1], W8,
                    cycle_cfg=CycleConfig(memory_latency=300))
    jslow = janalysis.estimate(PROGRAMS[0][1], JW8,
                               cycle_cfg=JCycleConfig(memory_latency=300))
    assert dataclasses.asdict(slow) == dataclasses.asdict(jslow)
    xs, ys = [3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8]
    assert rank_correlation(xs, ys) == janalysis.rank_correlation(xs, ys)


def _refusals(rs):
    return [(r.code, r.pc, r.message) for r in rs]


@pytest.mark.parametrize("chunk", range(4))
def test_strip_and_synthesize_equal_reference(chunk):
    for label, prog, cfg, jc in PROGRAMS[chunk::4]:
        s, js = strip_annotations(prog, cfg), janalysis.strip_annotations(
            prog, jc)
        np.testing.assert_array_equal(s.program, js.program, err_msg=label)
        assert (s.removed, s.kept_regions, s.pc_map) == \
            (js.removed, js.kept_regions, js.pc_map), label
        for src in (prog, s.program):
            try:
                r = synthesize_annotations(src, cfg, name=label)
            except TransformError as exc:
                with pytest.raises(janalysis.TransformError) as jexc:
                    janalysis.synthesize_annotations(src, jc, name=label)
                assert str(exc) == str(jexc.value)
                continue
            j = janalysis.synthesize_annotations(src, jc, name=label)
            np.testing.assert_array_equal(r.program, j.program,
                                          err_msg=label)
            assert (r.regions, r.spills, r.yields, r.pc_map) == \
                (j.regions, j.spills, j.yields, j.pc_map), label
            assert _refusals(r.skipped) == _refusals(j.skipped), label
            assert _refusals(r.refused) == _refusals(j.refused), label
            assert diag_tuples(r.report) == diag_tuples(j.report), label
    assert sorted(int(o) for o in ANNOTATION_OPS) == sorted(
        int(o) for o in janalysis.transform.ANNOTATION_OPS)


def test_errors_raised_on_the_same_inputs():
    bad = P.fig6_no_break_program()
    with pytest.raises(StaticAnalysisError) as mine:
        verify_program(bad, W8, name="fig6nb")
    with pytest.raises(janalysis.StaticAnalysisError) as ref:
        janalysis.verify_program(bad, JW8, name="fig6nb")
    assert str(mine.value) == str(ref.value)
    assert diag_tuples(mine.value.report) == diag_tuples(ref.value.report)
    spin = P.spinlock_no_yield_program()
    with pytest.raises(StaticAnalysisError) as mine:
        verify_program(spin, W8, strict=True)
    with pytest.raises(janalysis.StaticAnalysisError) as ref:
        janalysis.verify_program(spin, JW8, strict=True)
    assert str(mine.value) == str(ref.value)
    with pytest.raises(TransformError) as mine:
        synthesize_annotations(assemble(CALL_RET_UNANNOTATED), W8,
                               strict=True)
    with pytest.raises(janalysis.TransformError) as ref:
        janalysis.synthesize_annotations(assemble(CALL_RET_UNANNOTATED), JW8,
                                         strict=True)
    assert str(mine.value) == str(ref.value)


def test_simulator_verify_rejects_what_the_reference_rejects():
    sim = Simulator(device="cpu", verify=True)      # hanoi_torch, plain twin
    jsim = JSimulator("hanoi", verify=True)
    progs = [b.program for b in SUITE] + [
        P.fig6_no_break_program(), assemble("BRA 99"),
        P.spinlock_no_yield_program()]
    for prog in progs:
        for verify in (True, "strict"):
            outcome = []
            for s in (sim, jsim):
                try:
                    s.run(prog, W8 if s is sim else JW8, verify=verify,
                          fuel=64)
                    outcome.append(None)
                except (StaticAnalysisError,
                        janalysis.StaticAnalysisError) as exc:
                    outcome.append(str(exc))
            assert outcome[0] == outcome[1]
    with pytest.raises(StaticAnalysisError):
        sim.run_batch([P.diamond_program(), P.fig6_no_break_program()], W8)


@pytest.mark.parametrize("width", [4, 8])
def test_synthesize_on_cpu_equals_reference_hanoi(width):
    cfg = MachineConfig(n_threads=width, mem_size=64, max_steps=20_000)
    suite = [b for b in make_suite(cfg, datasets=1)]
    jsuite = JP.make_suite(jcfg(cfg), datasets=1)
    stripped = [strip_annotations(b.program, cfg).program for b in suite]
    spin = assemble(P.SPINLOCK_NO_YIELD_ASM)
    mine = Simulator(device="cpu").run_batch(
        [dataclasses.replace(_req(b, cfg), program=p)
         for b, p in zip(suite, stripped)] + [_req(spin, cfg)],
        verify="strict", synthesize=True)
    ref = JSimulator("hanoi").run_batch(
        [_jreq(b, cfg, p) for b, p in zip(jsuite, stripped)]
        + [_jreq(spin, cfg, spin)], verify="strict", synthesize=True)
    assert [r.mechanism for r in mine] == ["hanoi_torch"] * len(mine)
    for a, b in zip(mine, ref):
        assert (a.trace, a.status.value, a.steps, a.fuel_left) == \
            (b.trace, b.status.value, b.steps, b.fuel_left)
        np.testing.assert_array_equal(a.mem, b.mem)
        np.testing.assert_array_equal(a.regs, b.regs)
    assert int(mine[-1].mem[1]) == width       # every lane took the lock


def _req(b, cfg):
    from repro_torch.engine import as_request
    return as_request(b, cfg)


def _jreq(b, cfg, program):
    from repro.engine import as_request as jas_request
    return dataclasses.replace(jas_request(b, jcfg(cfg)),
                               program=np.asarray(program))


# ---------------------------------------------------------------------------
# the cases of tests/test_analysis.py, on the port
# ---------------------------------------------------------------------------

def calls_benchmark():
    bench = next(b for b in make_suite(W8) if b.name == "CALLS")
    return bench.program


def test_call_site_ipdom_is_callsync_not_sink():
    prog = calls_benchmark()
    ipdoms = immediate_postdominators(prog)
    bsync_pcs = [pc for pc in range(prog.shape[0])
                 if int(prog[pc, F_OP]) == Op.BSYNC]
    assert ipdoms, "CALLS has conditional branches"
    for pc, ipdom in ipdoms.items():
        assert ipdom in bsync_pcs


def test_predicated_call_has_fall_through_edge():
    prog = assemble("""
        LANEID R1
        ISETP.GE P0, R1, 2
        @P0 CALL f
        EXIT
    f:
        MOV R9, 4
        RET R9
    """)
    g = ProgramCFG(prog)
    assert sorted(g.succs[2]) == [3, 4]
    assert g.succs[5] == [3]


def test_branch_ipdoms_match_core_cfg_everywhere():
    progs = [b.program for b in make_suite(W8)]
    progs += [prog for _, prog, _ in tprogen.corpus(20)]
    for prog in progs:
        assert ProgramCFG(prog).branch_ipdoms == \
            immediate_postdominators(prog)


def test_bad_control_target_is_redirected_not_fatal():
    g = ProgramCFG(assemble("BRA 99"))
    assert g.bad_targets == [0]
    assert g.succs[0] == [g.sink]


@pytest.mark.parametrize("bench", make_suite(W8), ids=lambda b: b.name)
def test_suite_program_has_zero_errors(bench):
    report = analyze_program(bench.program, W8, name=bench.name)
    assert report.ok, report.render()
    assert not report.warnings, report.render()


def test_progen_corpus_all_distributions_zero_errors():
    triples = tprogen.corpus(40)
    assert len(triples) > 80
    for label, prog, cfg in triples:
        assert analyze_program(prog, cfg, name=label).ok


def test_yieldless_spinlock_triggers_exactly_spin_loop_warning():
    report = analyze_program(P.spinlock_no_yield_program(), W8)
    assert codes(report) == ["spin-loop"]
    assert report.diagnostics[0].severity is Severity.WARN
    assert not analyze_program(P.spinlock_program(), W8).diagnostics


def test_fig6_break_is_info_removing_it_is_error():
    with_break = analyze_program(P.fig6_program(), W8)
    assert with_break.ok
    assert set(codes(with_break)) == {"early-reconvergence"}
    without = analyze_program(P.fig6_no_break_program(), W8)
    assert not without.ok
    assert all(c == "reconvergence" for c in codes(without))


def test_warpsync_split_rendezvous_is_error():
    split = assemble("""
        LANEID R1
        ISETP.GE P0, R1, 2
        @P0 BRA x
        WARPSYNC 15
        BRA j
    x:
        WARPSYNC 15
    j:
        EXIT
    """)
    report = analyze_program(split, MachineConfig(n_threads=4))
    assert "warpsync-split" in codes(report)
    assert not report.ok
    good = analyze_program(P.warpsync_program(4), MachineConfig(n_threads=4))
    assert good.ok
    assert codes(good) == ["unannotated-branch"]


def test_bad_target_diagnostic():
    report = analyze_program(assemble("BRA 99"))
    assert codes(report) == ["bad-target"]
    assert not report.ok


def test_bssy_target_must_be_matching_bsync():
    assert "bssy-target" in codes(analyze_program(
        assemble("BSSY B0, 2\nNOP\nNOP\nEXIT")))
    assert "bssy-target" in codes(analyze_program(
        assemble("BSSY B0, 2\nNOP\nBSYNC B1\nEXIT")))


def test_bx_out_of_range_is_error():
    report = analyze_program(assemble("BSYNC B9\nEXIT"),
                             MachineConfig(n_bx=8))
    assert "bad-bx" in codes(report)


def test_fig5_without_spill_is_bx_clobber():
    clobbered = P.FIG5_ASM.replace(
        "    BMOV R0, B0         ; spill: R0 <- B0  (Fig 5 step 2)", "    NOP")
    assert "BMOV R0, B0" not in clobbered
    assert "bx-clobber" in codes(analyze_program(assemble(clobbered), W8))
    assert analyze_program(P.fig5_program(), W8).ok


def test_unreachable_and_fall_off_end_warnings():
    report = analyze_program(assemble("""
        BRA done
        MOV R1, 1
        MOV R2, 2
    done:
        MOV R3, 3
    """))
    cs = codes(report)
    assert "unreachable" in cs and "fall-off-end" in cs
    assert report.ok


def test_infinite_loop_warning():
    report = analyze_program(assemble("loop:\nMOV R1, 1\nBRA loop"))
    assert "infinite-loop" in codes(report)


def test_verify_program_raises_with_report_attached():
    with pytest.raises(StaticAnalysisError) as exc_info:
        verify_program(P.fig6_no_break_program(), W8, name="fig6nb")
    report = exc_info.value.report
    assert report.name == "fig6nb" and not report.ok
    assert "reconvergence" in str(exc_info.value)
    verify_program(P.spinlock_no_yield_program(), W8)
    with pytest.raises(StaticAnalysisError):
        verify_program(P.spinlock_no_yield_program(), W8, strict=True)


def test_asm_error_carries_line_col_and_caret():
    src = "    MOV R1, 1\n    BRA nowhere\n    EXIT"
    with pytest.raises(AsmError) as exc_info:
        assemble(src)
    err = exc_info.value
    assert err.lineno == 2
    assert err.col == src.splitlines()[1].find("nowhere") + 1
    assert err.source == "    BRA nowhere"
    assert "line 2" in str(err) and "^" in str(err)


def test_asm_error_missing_operand_names_line():
    with pytest.raises(AsmError) as exc_info:
        assemble("MOV R1, 1\nBRA")
    assert exc_info.value.lineno == 2
    assert "missing operand" in exc_info.value.reason


def test_asm_error_bad_guard_has_context():
    with pytest.raises(AsmError) as exc_info:
        assemble("@Q0 MOV R1, 1")
    assert exc_info.value.lineno == 1
    assert "bad predicate" in exc_info.value.reason


def test_diagnostics_quote_disassembled_instruction():
    prog = P.fig6_no_break_program()
    report = analyze_program(prog, W8)
    assert report.diagnostics
    for d in report.diagnostics:
        assert d.line == disassemble_line(prog[d.pc]) and d.line
        assert f"{d.pc:4d}: {d.line}" in disassemble(prog)


def test_disassemble_line_roundtrip_via_disassemble():
    prog = P.fig5_program()
    lines = disassemble(prog).splitlines()
    assert len(lines) == prog.shape[0]
    for pc, row in enumerate(prog):
        assert lines[pc] == f"{pc:4d}: {disassemble_line(row)}"


def test_lint_cli_reports_pc_and_disasm(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main
    bad = tmp_path / "bad.asm"
    bad.write_text(P.FIG6_NO_BREAK_ASM)
    assert main([str(bad)]) == 1
    out = capsys.readouterr().out
    assert "[error] reconvergence" in out
    prog = P.fig6_no_break_program()
    for d in analyze_program(prog, W8).errors:
        assert f"pc {d.pc:4d}" in out
        assert disassemble_line(prog[d.pc]) in out


def test_lint_cli_json_and_strict(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main
    spin = tmp_path / "spin.asm"
    spin.write_text(P.SPINLOCK_NO_YIELD_ASM)
    assert main([str(spin), "--json"]) == 0
    obj = json.loads(capsys.readouterr().out)
    assert obj["ok"] and [d["code"] for d in obj["diagnostics"]] == \
        ["spin-loop"]
    assert set(obj["fingerprint"]["features"]) == set(FEATURES)
    assert main([str(spin), "--strict"]) == 1
    capsys.readouterr()


def test_lint_cli_asm_error_exit_2(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main
    broken = tmp_path / "broken.asm"
    broken.write_text("BRA nowhere\n")
    with pytest.raises(SystemExit) as exc_info:
        main([str(broken)])
    assert exc_info.value.code == 2
    assert "line 1" in capsys.readouterr().err


@pytest.mark.parametrize("args", [
    ["--suite", "--fingerprint"], ["--suite", "--json"],
    ["--suite", "--strict", "--fix", "--select", "spin-loop",
     "--format=github"]])
def test_lint_cli_output_equals_reference(args, capsys):
    from repro.analysis.__main__ import main as jmain
    from repro_torch.analysis.__main__ import main
    rc = main(list(args))
    mine = capsys.readouterr()
    jrc = jmain(list(args))
    ref = capsys.readouterr()
    assert (rc, mine.out, mine.err) == (jrc, ref.out, ref.err)
    assert rc == 0


def test_fingerprint_shape_and_self_distance():
    fp = fingerprint(P.spinlock_program())
    assert len(fp) == len(FEATURES)
    assert distance(fp, fp) == 0.0
    other = fingerprint(P.diamond_program())
    d = distance(fp, other)
    assert 0.0 < d <= 1.0 and d == distance(other, fp)


def test_fingerprint_meta_roundtrips_through_json():
    meta = fingerprint_meta(P.fig5_program())
    assert tuple(json.loads(json.dumps(meta))["f"]) == \
        fingerprint(P.fig5_program())


def test_fingerprint_distinguishes_structures():
    spin = fingerprint(P.spinlock_program())
    assert distance(spin, fingerprint(assemble(P.SPINLOCK_ASM))) == 0.0
    assert distance(spin, fingerprint(P.diamond_program())) > 0.1


def test_simulator_verify_flag():
    bad = P.fig6_no_break_program()
    for mech in ("hanoi", "hanoi_torch"):
        sim = Simulator(mech, device="cpu")
        assert sim.run(bad, W8, fuel=256) is not None
        with pytest.raises(StaticAnalysisError):
            sim.run(bad, W8, verify=True)
        with pytest.raises(StaticAnalysisError):
            sim.run_batch([P.diamond_program(), bad], W8, verify=True)
        strict_sim = Simulator(mech, device="cpu", verify=True)
        with pytest.raises(StaticAnalysisError):
            strict_sim.run(bad, W8)
        assert strict_sim.run(bad, W8, verify=False,
                              fuel=256).status is not None


def _write_archive(tmp_path):
    from repro_torch.engine.sinks import RotatingJsonlSink
    d = str(tmp_path / "arch")
    sink = RotatingJsonlSink(d)
    sim = Simulator("hanoi", sink=sink)
    for name, prog in [("spin", P.spinlock_program()),
                       ("fig5", P.fig5_program()),
                       ("fig6", P.fig6_program()),
                       ("diamond", P.diamond_program())]:
        sim.run(prog, W8, name=name, record_trace=True)
    sink.flush()
    sink.close()
    return d


def test_archive_index_carries_fingerprints(tmp_path):
    from repro_torch.archive import ArchiveIndex
    idx = ArchiveIndex.ensure(_write_archive(tmp_path))
    assert len(idx) == 4
    for e in idx.entries:
        assert e.fp is not None and len(e.fp) == len(FEATURES)
    assert idx.entries[0].fp == fingerprint(P.spinlock_program())


def test_rank_similar_self_match_first_at_zero(tmp_path):
    from repro_torch.archive import ArchiveIndex
    idx = ArchiveIndex.ensure(_write_archive(tmp_path))
    for e in idx.entries:
        ranked = idx.rank_similar(e.fp)
        assert ranked[0] == (e.run_id, 0.0) and len(ranked) == len(idx)
        assert all(ranked[i][1] <= ranked[i + 1][1]
                   for i in range(len(ranked) - 1))


def test_similar_cli_by_run_id_and_asm(tmp_path, capsys):
    from repro_torch.archive.__main__ import main
    d = _write_archive(tmp_path)
    assert main(["similar", d, "--to", "run-000001", "--top", "2"]) == 0
    assert "run-000001  d=0.0000" in capsys.readouterr().out
    q = tmp_path / "q.asm"
    q.write_text(P.SPINLOCK_ASM)
    assert main(["similar", d, "--to", str(q), "--json"]) == 0
    obj = json.loads(capsys.readouterr().out)
    assert obj["ranked"][0] == {"id": "run-000000", "distance": 0.0}


def test_similar_cli_unknown_run_id(tmp_path, capsys):
    from repro_torch.archive.__main__ import main
    d = _write_archive(tmp_path)
    assert main(["similar", d, "--to", "run-999999"]) == 1
    assert "unknown run id" in capsys.readouterr().err


def test_old_sidecar_version_transparently_rebuilt(tmp_path):
    from repro_torch.archive import ArchiveIndex
    from repro_torch.archive.index import INDEX_KIND, index_path
    d = _write_archive(tmp_path)
    idx = ArchiveIndex.ensure(d)
    header = {"kind": INDEX_KIND, "version": 1, "prefix": "traces",
              "files": [list(f) for f in idx.files], "runs": len(idx)}
    with open(index_path(d), "w", encoding="utf-8") as fh:
        fh.write(json.dumps(header) + "\n")
        for e in idx.entries:
            row = e.to_json()
            del row["fp"]
            fh.write(json.dumps(row) + "\n")
    assert ArchiveIndex.load(d) is None
    assert all(e.fp is not None for e in ArchiveIndex.ensure(d).entries)


# ---------------------------------------------------------------------------
# the cases of tests/test_transform.py, on the port
# ---------------------------------------------------------------------------

def _roundtrip(program, cfg):
    s = strip_annotations(program, cfg)
    return s, synthesize_annotations(s.program, cfg)


@pytest.mark.parametrize("bench", SUITE, ids=[b.name for b in SUITE])
def test_roundtrip_suite_bit_equal(bench):
    s, r = _roundtrip(bench.program, W8)
    verify_program(r.program, W8, strict=True)
    if bench.name in KNOWN_DEVIATIONS:
        assert not np.array_equal(r.program, np.asarray(bench.program))
    else:
        np.testing.assert_array_equal(r.program, np.asarray(bench.program))


def test_roundtrip_corpus_bit_equal():
    deviations = []
    for label, prog, cfg in tprogen.corpus(20):
        s, r = _roundtrip(prog, cfg)
        verify_program(r.program, cfg, strict=True)
        if not np.array_equal(r.program, np.asarray(prog)):
            deviations.append(label)
    assert not deviations


def _spill_regs(*programs) -> list[int]:
    return sorted({int(row[F_DST]) for prog in programs
                   for row in np.asarray(prog)
                   if row[F_OP] == int(Op.BMOV_B2R)})


@pytest.mark.parametrize("mech", SINGLE_WARP)
def test_fig5_roundtrip_equivalent_under_every_mechanism(mech):
    bench = next(b for b in SUITE if b.name == "FIG5")
    s, r = _roundtrip(bench.program, W8)
    back = dict(r.pc_map)
    comp = {o: back[m] for o, m in dict(s.pc_map).items() if m in back}
    vals = set(comp.values())
    ra = SIM.run(bench.program, W8, mechanism=mech)
    rb = SIM.run(r.program, W8, mechanism=mech)
    ta = [(comp[pc], int(m)) for pc, m in ra.trace if pc in comp]
    tb = [(pc, int(m)) for pc, m in rb.trace if pc in vals]
    assert sorted(ta) == sorted(tb), f"{mech}: projected traces differ"
    if mech == "simt_stack":
        assert ta == tb
    assert ra.status == rb.status
    np.testing.assert_array_equal(ra.mem, rb.mem)
    keep = [c for c in range(ra.regs.shape[1])
            if c not in _spill_regs(bench.program, r.program)]
    np.testing.assert_array_equal(ra.regs[:, keep], rb.regs[:, keep])


def test_progen_unannotated_variant_preserves_streams():
    (pa, ma), cfg = tprogen.make_program(3, 8, sync_features=True)
    (pu, mu), cfg_u = tprogen.make_program(3, 8, sync_features=True,
                                           unannotated=True)
    np.testing.assert_array_equal(ma, mu)
    assert cfg == cfg_u and len(pu) < len(pa)
    np.testing.assert_array_equal(synthesize_annotations(pu, cfg).program,
                                  np.asarray(pa))


def test_unannotated_corpus_synthesizes_strict_clean():
    for label, prog, cfg in tprogen.corpus(10, unannotated=True):
        r = synthesize_annotations(prog, cfg)
        assert verify_program(r.program, cfg, strict=True).ok, label


def test_ipdom_at_virtual_sink_is_skipped():
    prog = assemble("""
        ISETP.LT P0, R0, 4
    @P0 BRA away
        EXIT
    away:
        EXIT
    """)
    r = synthesize_annotations(prog, W8)
    assert not r.changed
    assert [x.code for x in r.skipped] == ["ipdom-sink"]
    np.testing.assert_array_equal(r.program, prog)


def _deep_nest(depth_body=True):
    cond = ["ISETP.LT P0, R1, 6"]
    body = Raw(["IADDI R5, R5, 1"])
    nodes = [Raw(["LANEID R1", "MOVR R5, R1"]),
             If(cond, 0, If(cond, 0, If(cond, 0, body, body), body), body)]
    if depth_body:
        nodes.append(Raw(["IADDI R5, R5, 7"]))
    return Seq(nodes)


def test_spill_chain_matches_structured_compiler():
    tiny = MachineConfig(n_threads=8, n_bx=2)
    prog = compile_structured(_deep_nest(), tiny)
    assert any(int(r[F_OP]) == int(Op.BMOV_B2R) for r in np.asarray(prog))
    s, r = _roundtrip(prog, tiny)
    assert r.spills > 0
    np.testing.assert_array_equal(r.program, np.asarray(prog))
    assert "stack-depth" in verify_program(r.program, tiny).codes()


def test_yield_insertion_is_idempotent():
    spin = assemble(P.SPINLOCK_NO_YIELD_ASM)
    once = synthesize_annotations(spin, W4)
    assert once.yields == 1
    twice = synthesize_annotations(once.program, W4)
    assert not twice.changed
    np.testing.assert_array_equal(twice.program, once.program)
    slock = next(b for b in SUITE if b.name == "SLOCK")
    assert not synthesize_annotations(slock.program, W8).changed


CALL_RET_UNANNOTATED = """
    LANEID R1
    MOV R9, ret1
    ISETP.GE P0, R1, 4
@P0 BRA docall
    MOV R2, 5
    BRA join
docall:
    CALL square
ret1:
join:
    IADDI R4, R2, 8
    EXIT
square:
    MOVR R2, R1
    IMUL R2, R2, R2
    RET R9
"""


def test_call_ret_crossing_regions_are_refused():
    calls = next(b for b in SUITE if b.name == "CALLS")
    assert not strip_annotations(calls.program, W8).changed
    r = synthesize_annotations(calls.program, W8)
    assert not r.changed and not r.refused
    unannotated = assemble(CALL_RET_UNANNOTATED)
    r = synthesize_annotations(unannotated, W8)
    assert not r.changed
    assert r.refused and all(x.code == "call-ret" for x in r.refused)
    assert "CALL" in r.refused[0].message
    np.testing.assert_array_equal(r.program, unannotated)
    with pytest.raises(TransformError, match="refused"):
        synthesize_annotations(unannotated, W8, strict=True)


def test_spinlock_no_yield_repair_terminates_and_clears_warning():
    spin = assemble(P.SPINLOCK_NO_YIELD_ASM)
    assert "spin-loop" in analyze_program(spin, W4).codes()
    r = synthesize_annotations(spin, W4)
    assert "spin-loop" not in analyze_program(r.program, W4).codes()
    for mech in ("hanoi", "hanoi_torch"):
        res = SIM.run(r.program, W4, mechanism=mech)
        assert res.ok and int(res.mem[1]) == 4


def test_cost_estimate_rank_correlates_with_cycle_engine():
    from repro_torch.timing import CycleConfig, simulate_cycle
    est, cyc = [], []
    for bench in SUITE:
        res = SIM.run(bench.program, W8, mechanism="hanoi")
        tr = simulate_cycle([res.trace], bench.program, 8, CycleConfig())
        est.append(estimate(bench.program, W8).issue_cycles)
        cyc.append(tr.cycles)
    assert rank_correlation(est, cyc) >= 0.70


def test_cost_estimate_structure_fields():
    from repro_torch.timing import CycleConfig
    gaus = next(b for b in SUITE if b.name == "GAUS0")
    e = estimate(gaus.program, W8)
    assert e.issue_cycles > 0 and e.weighted_instructions > 0
    assert e.stack_depth >= 1 and e.region_sizes
    assert 0.0 < e.divergent_fraction < 1.0
    assert 0.0 <= e.stall_fraction <= 1.0
    slock = next(b for b in SUITE if b.name == "SLOCK")
    assert estimate(slock.program, W8).spin_loops == 1
    slow = estimate(gaus.program, W8,
                    cycle_cfg=CycleConfig(memory_latency=300))
    assert slow.issue_cycles > e.issue_cycles


def test_rank_correlation_basics():
    assert rank_correlation([1, 2, 3], [10, 20, 30]) == pytest.approx(1.0)
    assert rank_correlation([1, 2, 3], [3, 2, 1]) == pytest.approx(-1.0)
    assert rank_correlation([1, 1, 1], [1, 2, 3]) == 0.0
    assert rank_correlation([], []) == 0.0
    with pytest.raises(ValueError):
        rank_correlation([1], [1, 2])


def test_analyze_cache_key_includes_machine_knobs():
    prog = compile_structured(_deep_nest(depth_body=False),
                              MachineConfig(n_threads=8))
    deep = analyze_program(prog, MachineConfig(n_threads=8, n_bx=2))
    assert "stack-depth" in deep.codes()
    assert "stack-depth" not in analyze_program(prog, W8).codes()
    msg16 = next(d for d in analyze_program(
        prog, MachineConfig(n_threads=8, n_bx=2, n_regs=16)).warnings
        if d.code == "stack-depth").message
    msg8 = next(d for d in analyze_program(
        prog, MachineConfig(n_threads=8, n_bx=2, n_regs=8)).warnings
        if d.code == "stack-depth").message
    assert msg16 != msg8 and "16" in msg16 and "8" in msg8


def test_lint_cli_fix_select_ignore_github(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main
    spin = tmp_path / "spin.asm"
    spin.write_text(P.SPINLOCK_NO_YIELD_ASM)
    assert main([str(spin), "--strict"]) == 1
    capsys.readouterr()
    assert main([str(spin), "--strict", "--fix"]) == 0
    assert "yield(s)" in capsys.readouterr().out
    assert main([str(spin), "--strict", "--ignore", "spin-loop"]) == 0
    assert main([str(spin), "--strict", "--select", "bad-target"]) == 0
    assert main([str(spin), "--strict", "--select", "spin-loop"]) == 1
    capsys.readouterr()
    assert main([str(spin), "--format=github"]) == 0
    out = capsys.readouterr().out
    assert "::warning " in out and "title=spin-loop" in out
    assert f"file={spin}" in out


def test_simulator_synthesize_kwarg():
    spin = assemble(P.SPINLOCK_NO_YIELD_ASM)
    for mech in ("hanoi", "hanoi_torch"):
        with pytest.raises(StaticAnalysisError):
            SIM.run(spin, W4, mechanism=mech, verify="strict")
        res = SIM.run(spin, W4, mechanism=mech, verify="strict",
                      synthesize=True)
        assert res.ok and int(res.mem[1]) == 4
        outs = SIM.run_batch([spin, spin], W4, mechanism=mech,
                             verify="strict", synthesize=True)
        assert all(r.ok for r in outs)


def test_analysis_cli_runs_as_a_module():
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--suite"],
        cwd=root, env={"PYTHONPATH": str(root / "src"),
                       "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
