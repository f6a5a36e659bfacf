"""Quickstart: the paper's core artifacts in 60 seconds.

Port of the repo's ``examples/quickstart.py``.  Everything runs through
the unified ``repro_torch.engine`` API — one Simulator, any mechanism by
name.  The device mechanisms run on ``--device``: the card by default
(``hanoi_torch`` is kernel K1, ``sm_torch`` kernels K1 and K2), their plain
twins with ``--device cpu``; the numpy mechanisms run on the host.

1. assemble the Fig 3/7 spinlock and watch pre-Volta (SIMT-Stack) deadlock
   while Hanoi completes it via YIELD + late BSYNC;
2. reproduce the Fig 6 early-reconvergence-with-BREAK walkthrough;
3. compare Hanoi's control-flow trace (``hanoi_torch``) against the
   Turing-oracle heuristic (the paper's Fig 9 discrepancy metric) on a
   BFS-like benchmark;
4. show the Volta-style per-thread-PC scheduler's forward-progress
   guarantee (the YIELD-less spinlock terminates where Hanoi hangs) and a
   per-SM multi-warp interleaving run;
5. drive the queue-fed simulation service end to end: mixed-mechanism
   admission, signature coalescing onto the native batch runner (one K1
   launch a ``hanoi_torch`` group), a sharded (SM, policy) cell, rotating
   JSONL archival, and service stats;
6. read the durable archive back (``repro_torch.archive``), replay every run
   offline — including the per-warp SM-cell runs, which archive with the
   full replay payload — and verify the replayed traces are bit-equal to
   what was served: the paper's Fig 9 discrepancy metric, from the archive;
7. index the archive (O(1) run lookup via the ``{prefix}.index.jsonl``
   sidecar), fetch one SM warp by id without scanning, and replay its
   whole cell;
8. price schedules on the event-driven cycle engine (``repro_torch.timing``):
   the Fig 10 IPC delta with a per-cycle stall taxonomy via
   ``compare(timing="cycle")``, then re-derive an archived SM cell's IPC
   offline from its traces — bit-equal to the ``sm_timing`` stamp — and
   re-price it under different memory latencies without re-running
   anything;
9. run the same SM cell on ``sm_torch`` — the whole SM as one launch of
   K1 (lane execution) and one of K2 (issue scheduling) — and check it is
   bit-identical to the Python interleaver;
10. scale out: a 2-process service (``procs=2`` — signature-affine shard
    routing, numpy groups chunked across shards) warmed from a persistent
    kernel cache (``warm_start=``), then restarted to prove the
    zero-miss contract from its own kernel-cache counters;
11. statically verify programs without running them (``repro_torch.analysis``):
    lint the Fig 6 ablation (its missing BREAK is a ``reconvergence``
    error), watch the service reject it at admission with the full
    diagnostic report on the ticket, fix it, then rank archived runs by
    control-flow similarity from the sidecar index alone — the paper's
    pathologies, searchable without replaying a trace.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
(the ``main()`` guard is required: section 10 spawns worker processes and
the spawn start method re-imports this module in each child)
"""
import argparse
import tempfile

from repro_torch.core import MachineConfig, disassemble
from repro_torch.core.programs import (fig6_program, make_suite,
                                       spinlock_no_yield_program,
                                       spinlock_program)
from repro_torch.engine import RotatingJsonlSink, Simulator, SimStatus
from repro_torch.kernels import ops


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device of hanoi_torch / sm_torch (default: "
                         "the card; 'cpu' runs their plain twins)")
    device = ap.parse_args(argv).device
    W = 8
    CFG = MachineConfig(n_threads=W, max_steps=40_000)
    sim = Simulator("hanoi", device=device)

    # --- 1. spinlock: pre-Volta deadlock vs Hanoi ------------------------------
    prog = spinlock_program()
    print("=== spinlock (Fig 3/7) ===")
    print(disassemble(prog))
    pre = sim.run(prog, CFG, mechanism="simt_stack")
    post = sim.run(prog, CFG, mechanism="hanoi")
    print(f"\npre-Volta SIMT-Stack: status={pre.status.value} "
          f"(critical sections completed: {int(pre.mem[1])}/{W})")
    print(f"Hanoi:                status={post.status.value} "
          f"counter={int(post.mem[1])}/{W} (mutual exclusion held)")
    assert pre.status is SimStatus.OUT_OF_FUEL and post.status is SimStatus.OK

    # --- 2. early reconvergence with BREAK (Fig 6) ------------------------------
    r = sim.run(fig6_program(), MachineConfig(n_threads=4, max_steps=512))
    print("\n=== Fig 6: BREAK enables reconvergence BEFORE the IPDom ===")
    print(f"completed: {r.ok}; "
          f"early-reconverged mask seen in trace: "
          f"{any(m == 0b1110 for _, m in r.trace)}")

    # --- 3. trace discrepancy vs the hardware heuristic (Fig 9) -----------------
    CFG32 = MachineConfig(n_threads=32, max_steps=60_000)
    bench = next(b for b in make_suite(CFG32) if b.name == "BFSD")
    report = sim.compare(["hanoi_torch", "turing_oracle"], [bench], CFG32,
                         pairs=[("hanoi_torch", "turing_oracle")],
                         timing=False)
    row = report.pair("hanoi_torch", "turing_oracle")[0]
    print("\n=== Fig 9/10: BFSD — Hanoi enforces reconvergence, hardware skips ===")
    print(f"trace discrepancy: {row.discrepancy_pct:.1f}%")
    print(f"SIMD utilization:  hanoi={row.util_a:.3f} hw={row.util_b:.3f}")

    # --- 4. post-Volta per-thread PCs + per-SM multi-warp interleaving ----------
    noyield = spinlock_no_yield_program()
    hang = sim.run(noyield, CFG)                       # Hanoi: SS V-G ablation
    its = sim.run(noyield, CFG, mechanism="volta_itps")
    print("\n=== YIELD-less spinlock: stack mechanisms hang, per-thread PCs "
          "don't ===")
    print(f"Hanoi:      status={hang.status.value} (needs YIELD to make "
          f"progress)")
    print(f"volta_itps: status={its.status.value} counter={int(its.mem[1])}/{W} "
          f"(scheduler's forward-progress guarantee)")
    assert not hang.ok and its.ok and int(its.mem[1]) == W

    bench = next(b for b in make_suite(CFG) if b.name == "RBFS0")
    sm = sim.run_sm(bench, CFG, n_warps=4, inner="hanoi",
                    policy="greedy_then_oldest")
    print(f"\n=== per-SM: 4 warps of RBFS0 under GTO ===")
    print(f"status={sm.status.value} slots={sm.steps} cycles={sm.cycles} "
          f"thread-IPC={sm.ipc:.2f} util={sm.utilization:.3f}")
    assert sm.ok

    # --- 5. the simulation service: coalesced, sharded, archived ----------------
    from repro_torch.service import SimulationService

    suite8 = make_suite(CFG, datasets=1)
    benches = [b for b in suite8 if b.name in ("HOTS0", "GAUS0", "RBFS0",
                                               "DIAMOND")]
    with tempfile.TemporaryDirectory() as tmp:
        archive = RotatingJsonlSink(tmp, max_bytes=1 << 20)
        with SimulationService(default_mechanism="hanoi_torch", max_batch=8,
                               max_wait_s=0.01, workers=2, device=device,
                               archive=archive) as svc:
            # mixed admission: a homogeneous hanoi_torch group + numpy
            # singles
            tickets = [svc.submit(b, CFG) for b in benches]          # K1
            tickets += [svc.submit(benches[0], CFG, mechanism=m)       # numpy
                        for m in ("hanoi", "simt_stack")]
            cell = svc.submit_sm(benches[2], CFG, n_warps=4, inner="hanoi",
                                 policy="greedy_then_oldest")          # SM shard
            svc.flush()
            results = [t.result() for t in tickets]
            sm_cell = cell.result()
            stats = svc.stats()
        archive.flush()
        archive.close()
        print("\n=== simulation service: one queue over every mechanism ===")
        print(f"completed={stats.completed} (sm_jobs={stats.sm_jobs}) "
              f"batches={stats.batches} native={stats.native_batches} "
              f"(x{stats.native_warps} warps) mean-fill={stats.mean_fill:.1f}")
        print(f"p50={stats.latency_p50_s * 1e3:.1f}ms "
              f"p99={stats.latency_p99_s * 1e3:.1f}ms "
              f"archived {archive.runs_written} runs -> "
              f"{len(archive.paths)} file(s)")
        # the homogeneous hanoi_torch group went through the native runner
        assert all(r.meta["service"]["native"] for r in results[:4])
        assert all(r.ok for r in results) and sm_cell.ok
        # stats and archive both count warps: 6 single-warp + the 4 SM warps
        assert stats.completed == len(results) + sm_cell.n_warps
        assert archive.runs_written == stats.completed

        # --- 6. offline archive replay: Fig 9 from the durable archive ----------
        from repro_torch.archive import ArchiveReader, Replayer

        def replayer():
            return Replayer(simulator=Simulator(device=device))

        reader = ArchiveReader(tmp)
        replay = replayer().replay(reader)       # self-replay: integrity check
        print("\n=== archive replay: the served traces, re-run offline ===")
        print(f"read {reader.report.runs} archived runs "
              f"(clean={reader.report.clean}); replayed {replay.replayed} "
              f"incl. {len(replay.by_sm_cell())} SM cell(s)")
        print(f"self-replay discrepancy: "
              f"{replay.mean_discrepancy() * 100:.2f}% (bit-equal traces)")
        # deterministic mechanisms => replay reproduces the archive exactly
        assert replay.mean_discrepancy() == 0.0
        # the per-warp SM-cell archives now carry the full replay payload and
        # group back into their cell in the report
        assert replay.skipped_unreplayable == 0
        assert replay.replayed == archive.runs_written
        (cell_agg,) = replay.by_sm_cell().values()
        assert cell_agg.count == sm_cell.n_warps and cell_agg.max == 0.0

        # --- 7. archive index: O(1) lookup, then replay one cell by id ----------
        from repro_torch.archive import ArchiveIndex

        idx = ArchiveIndex.build(tmp)            # sidecar {prefix}.index.jsonl
        # the replayed rows already know which runs were SM warps — fetch just
        # those by id (each get is one seek + read, no archive scan)
        sm_ids = [f"run-{row.index:06d}" for row in replay.rows
                  if row.sm_cell is not None]
        warp = reader.get(sm_ids[0])
        print("\n=== indexed lookup: one SM warp by run id ===")
        print(f"indexed {len(idx)} runs; {sm_ids[0]} -> warp "
              f"{warp.meta['sm_warp']}/{warp.meta['sm_warps']} of cell "
              f"{warp.sm_cell} ({warp.meta['sm_policy']}, {warp.program})")
        # replay exactly that cell: its warps, fetched by id
        cell_runs = [r for r in (reader.get(i) for i in sm_ids)
                     if r.sm_cell == warp.sm_cell]
        cell_replay = replayer().replay(cell_runs)
        assert cell_replay.replayed == sm_cell.n_warps
        assert cell_replay.mean_discrepancy() == 0.0

        # --- 8. cycle-accurate timing: Fig 10 IPC delta + offline re-pricing ----
        from repro_torch.core.timing import TimingConfig

        rep10 = sim.compare(["hanoi", "simt_stack"], [benches[0]], CFG,
                            timing="cycle")      # scoreboard cycle engine
        r10 = rep10.pair("hanoi", "simt_stack")[0]
        t_h = rep10.timing_results[(r10.program, "hanoi")]
        print("\n=== Fig 10 on the cycle engine: IPC delta + stall taxonomy ===")
        print(f"{r10.program}: ipc_delta={r10.ipc_delta_pct:+.2f}% "
              f"(hanoi ipc={t_h.ipc:.3f}; stalls {t_h.stall_breakdown})")
        assert t_h.cycles == (t_h.busy_cycles + t_h.scoreboard_stall_cycles
                              + t_h.memory_stall_cycles)
        # archived SM cells carry an sm_timing stamp: re-derive IPC offline
        # (bit-equal under the config it ran with), then re-price it under
        # slower memory without re-running any mechanism
        (td,) = replayer().rederive_timing(reader)
        assert td.matches_archive and td.result.cycles == sm_cell.cycles
        (slow,) = replayer().rederive_timing(
            reader, timing_cfg=TimingConfig(memory_latency=300))
        print(f"SM cell re-derived offline: ipc={td.ipc:.2f} "
              f"(stamp=match); at memory_latency=300: ipc={slow.ipc:.2f}")

    # --- 9. sm_torch: the whole SM as one K1 and one K2 launch ------------------
    k1, k2 = ops.hanoi_run.launches, ops.sm_schedule.launches
    torch_cell = sim.run_sm(benches[2], CFG, n_warps=4, inner="hanoi_torch",
                            policy="greedy_then_oldest",
                            sm_mechanism="sm_torch")
    k1, k2 = ops.hanoi_run.launches - k1, ops.sm_schedule.launches - k2
    py_cell = sim.run_sm(benches[2], CFG, n_warps=4, inner="hanoi",
                         policy="greedy_then_oldest",
                         sm_mechanism="sm_interleave")
    print("\n=== sm_torch: one K1 + one K2 launch, bit-equal to the "
          "interleaver ===")
    print(f"{benches[2].name}: {torch_cell.n_warps} warps -> "
          f"slots={torch_cell.steps} cycles={torch_cell.cycles} "
          f"stalls={torch_cell.stall_breakdown}")
    print(f"kernel launches: K1={k1} K2={k2} (0 on the CPU: the plain "
          f"twins); wall {torch_cell.wall_time_s * 1e3:.2f}ms")
    assert torch_cell.sm_trace == py_cell.sm_trace     # bit-identical schedule
    assert torch_cell.cycles == py_cell.cycles
    assert torch_cell.stall_breakdown == py_cell.stall_breakdown
    assert torch_cell.mechanism == "sm_torch"
    assert (k1, k2) == ((0, 0) if device == "cpu" else (1, 1))

    # --- 10. process tier: 2 shard processes + a warmed kernel cache ------------
    # Numpy mechanisms serialize behind the GIL; procs=2 spawns two shard
    # processes and chunks homogeneous numpy groups across them, while
    # hanoi_torch groups stay affine to one shard (kernel-cache locality).
    # The warm_start directory persists the hot launch keys: a restarted
    # service launches each once before admitting traffic, so hot signatures
    # take no kernel-cache miss.  Groups form by run()'s manual flush only
    # (a long max_wait_s), so the restart sees the same keys.
    import shutil

    from repro_torch.engine import as_request

    warm_dir = tempfile.mkdtemp(prefix="repro-quickstart-cache-")
    reqs = [as_request(b, CFG) for b in benches[:4]]
    with SimulationService(default_mechanism="hanoi", procs=2, device=device,
                           max_wait_s=600, warm_start=warm_dir) as svc:
        out = svc.run(reqs, timeout=300)                 # chunked across shards
        tx = svc.run(reqs[:2], mechanism="hanoi_torch", timeout=600)  # affine
        st = svc.stats()
    print("\n=== process tier: 2 shards, signature-affine routing ===")
    shard_of = lambda r: r.meta["service"]["shard"]
    print(f"numpy group spread over shards {sorted({shard_of(r) for r in out})}; "
          f"hanoi_torch group affine to shard {shard_of(tx[0])}")
    print(f"shards: " + " ".join(f"s{s.shard}(pid {s.pid}): {s.completed} ok"
                                 for s in st.shards))
    print(f"kernel cache: {st.cache_misses} miss(es) recorded -> {warm_dir}")
    assert all(a.status == b.status for a, b in
               zip(out, (sim.run(r) for r in reqs)))

    # restart: the warmed service serves the same hanoi_torch signature with
    # ZERO serve-time kernel-cache misses
    with SimulationService(default_mechanism="hanoi_torch", procs=2,
                           device=device, max_wait_s=600,
                           warm_start=warm_dir) as svc:
        svc.run(reqs[:2], timeout=600)
        st2 = svc.stats()
    shutil.rmtree(warm_dir, ignore_errors=True)
    print(f"warm restart: {st2.warm_signatures} sig(s) warmed "
          f"({st2.warm_loaded} loaded, {st2.warm_retraced} missed), "
          f"serve-time misses={st2.cache_misses}")
    assert st2.warm_signatures >= 1
    assert st2.cache_misses == st2.warm_retraced == 0    # zero-miss contract

    # --- 11. static analysis: lint -> admission rejection -> similarity ---------
    from repro_torch.analysis import StaticAnalysisError, analyze_program
    from repro_torch.core.programs import fig5_program, fig6_no_break_program

    broken = fig6_no_break_program()                 # Fig 6 minus its BREAK
    report = analyze_program(broken, CFG, name="fig6-no-break")
    print("\n=== static analysis: the Fig 6 ablation fails the verifier ===")
    print(report.render())
    assert not report.ok and "reconvergence" in report.codes()

    # the service refuses it at admission — no shard ever sees the request;
    # the ticket carries the same structured report as its exception
    with SimulationService(default_mechanism="hanoi", workers=1,
                           device=device) as svc:
        bad_ticket = svc.submit(broken, CFG, name="fig6-no-break")
        good_ticket = svc.submit(fig6_program(), CFG, name="fig6")
        svc.flush()
        rejection = bad_ticket.exception()
        assert isinstance(rejection, StaticAnalysisError)
        assert not rejection.report.ok
        assert good_ticket.result().ok               # the BREAK makes it legal
        st11 = svc.stats()
    print(f"service admission: submitted={st11.submitted} "
          f"rejected={st11.rejected} completed={st11.completed} "
          f"(the broken program never reached a shard)")
    assert st11.rejected == 1 and st11.failed == 0

    # archived nearest neighbors, ranked from the sidecar index alone —
    # no archive file opened, nothing replayed
    from repro_torch.analysis import fingerprint
    from repro_torch.archive import ArchiveIndex

    with tempfile.TemporaryDirectory() as tmp11:
        arch11 = RotatingJsonlSink(tmp11)
        lab = Simulator("hanoi", sink=arch11, device=device)
        for b in make_suite(CFG, datasets=1):
            lab.run(b, CFG)
        arch11.flush()
        arch11.close()
        idx = ArchiveIndex.ensure(tmp11)             # entries carry CFG fps
        ranked = idx.rank_similar(fingerprint(fig5_program()), top=3)
        by_id = {e.run_id: e.program for e in idx.entries}
        print(f"nearest archived control flow to Fig 5 "
              f"({len(idx)} runs indexed, sidecar only):")
        for rid, d in ranked:
            print(f"  {rid}  d={d:.4f}  {by_id[rid]}")
        assert by_id[ranked[0][0]] == "FIG5" and ranked[0][1] == 0.0

    # --- 12. annotation synthesis: strip Fig 5, get the compiler back ---------
    import numpy as np

    from repro_torch.analysis import strip_annotations, synthesize_annotations
    from repro_torch.core.programs import SPINLOCK_NO_YIELD_ASM, fig5_program
    from repro_torch.core.asm import assemble

    print("\n=== annotation synthesis: strip -> resynthesize Fig 5 ===")
    fig5 = fig5_program()
    stripped = strip_annotations(fig5, CFG)
    resynth = synthesize_annotations(stripped.program, CFG)
    print(f"stripped {len(stripped.removed)} annotation instruction(s); "
          f"synthesizer placed {resynth.regions} region(s) back")
    assert resynth.report.ok
    # Fig 5 hand-forces B0 reuse + an R0 spill; the allocator uses two Bx
    # registers instead — same control flow, cleaner annotation.  The
    # DIAMOND kernel round-trips bit-equal, trace included:
    diamond = next(b for b in make_suite(CFG, datasets=1)
                   if b.name == "DIAMOND")
    d_round = synthesize_annotations(
        strip_annotations(diamond.program, CFG).program, CFG)
    assert np.array_equal(d_round.program, np.asarray(diamond.program))
    ta = sim.run(diamond.program, CFG).trace
    tb = sim.run(d_round.program, CFG).trace
    assert ta == tb
    print("DIAMOND: strip -> synthesize is bit-equal (trace identical)")

    # service auto-repair: the YIELD-less spinlock is rejected under
    # strict admission — unless auto_annotate routes it through the
    # synthesizer, which inserts the YIELD and admits the repair
    spin_hang = assemble(SPINLOCK_NO_YIELD_ASM)
    with SimulationService(default_mechanism="hanoi", workers=1,
                           verify="strict", auto_annotate=True,
                           device=device) as svc:
        t12 = svc.submit(spin_hang, CFG, name="spinlock-no-yield")
        svc.flush()
        repaired_res = t12.result()
        st12 = svc.stats()
    assert repaired_res.ok and int(repaired_res.mem[1]) == W
    print(f"service auto-repair: repaired={st12.repaired} rejected="
          f"{st12.rejected} -> spinlock completed {int(repaired_res.mem[1])}"
          f"/{W} critical sections (YIELD synthesized at admission)")
    assert st12.repaired == 1 and st12.rejected == 0

    print("\nquickstart OK")


if __name__ == "__main__":   # required: section 10 spawns processes,
    main()                   # and spawn children re-import this file
