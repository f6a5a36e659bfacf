"""Serving driver (port of ``repro.launch.serve``): greedy decoding of a
batch of prompts through ``decode_step``, with the prompt teacher-forced
position by position, plus the control-flow *simulation service* endpoint.

``serve_simulations`` (``--mode sim``) is a thin client of
:class:`repro_torch.service.SimulationService` — the queue-fed, coalescing,
sharded simulation service: requests are admitted one by one, coalesced by
execution signature, run in one launch of K1 a homogeneous ``hanoi_torch``
group, archived through a (rotating) JSONL sink, and reported with service
metrics.  ``--mode replay`` reads such an archive back
(:mod:`repro_torch.archive`), re-runs every replayable request and reports
the trace-discrepancy aggregate; with ``--watch`` it tails a growing
archive.  Every mode runs on the card unless ``--device cpu`` is given.

Usage:
  python -m repro_torch.launch.serve --arch llama3.2-1b --batch 4 \\
      --prompt-len 16 --gen-len 32
  python -m repro_torch.launch.serve --mode sim --batch 64
  python -m repro_torch.launch.serve --mode sim --device cpu \\
      --mix hanoi_torch,hanoi --batch 8 --procs 2 [--warm-start DIR]
  python -m repro_torch.launch.serve --mode sim --sm-warps 8 --sm-policy \\
      greedy_then_oldest --bench RBFS0
  python -m repro_torch.launch.serve --mode sim --batch 16 --record-trace \\
      --archive-dir sim-archive
  python -m repro_torch.launch.serve --mode replay --archive-dir \\
      sim-archive [--watch --watch-idle-s 30]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve
from repro_torch.models import (Transformer, cache_struct, decode_step,
                                init_params, model_struct)


def serve(arch: str, *, smoke: bool = True, batch: int = 4,
          prompt_len: int = 16, gen_len: int = 32, max_len: int = 256,
          seed: int = 0, greedy: bool = True,
          params: Transformer | None = None, device=None) -> dict:
    """Greedy-decode ``batch`` prompts drawn from ``seed``.

    ``params`` defaults to random f32 weights drawn from ``seed`` on
    ``device``; pass the JAX package's weights (``models.convert``) to
    reproduce its tokens.  ``greedy`` is kept for the JAX signature: both
    decode greedily.  An encoder or a frontend model is refused, with the
    JAX package's exception type, before anything is drawn."""
    cfg = get_config(arch, smoke=smoke)
    if not (cfg.is_decoder and cfg.frontend == "token"):
        raise AssertionError(f"{arch} is not a token decoder")
    dev = resolve(device)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = Transformer(cfg, init_params(model_struct(cfg), gen,
                                              device=dev))
    caches = init_params(cache_struct(cfg, batch, max_len), None, device=dev)

    rng = np.random.default_rng(seed)
    prompts = rng.integers(2, cfg.vocab_size,
                           size=(batch, prompt_len)).astype(np.int32)
    tokens = torch.from_numpy(prompts).to(dev)
    out_tokens = []
    with torch.inference_mode():
        t0 = time.perf_counter()
        for i in range(prompt_len + gen_len - 1):
            tok = tokens[:, i:i + 1] if i < prompt_len else out_tokens[-1]
            logits, caches = decode_step(params, cfg, caches, tok, i)
            if i >= prompt_len - 1:
                out_tokens.append(
                    torch.argmax(logits[:, -1:], dim=-1).to(torch.int32))
        gen = torch.cat(out_tokens, dim=1).cpu().numpy()
        dt = time.perf_counter() - t0
    steps = prompt_len + gen_len - 1
    return {"generated": gen, "steps": steps, "wall_s": dt,
            "tokens_per_s": batch * steps / dt}


def serve_simulations(requests, *, mechanism: str = "hanoi_torch",
                      device=None, sink=None, max_workers: int | None = None,
                      max_batch: int = 64, max_wait_s: float = 0.005,
                      procs: int = 0, warm_start: str | None = None,
                      service=None) -> dict:
    """Serve a batch of control-flow simulation requests.

    ``requests`` is a sequence of ``repro_torch.engine.SimRequest`` (or
    Benchmark / ndarray program) objects.  Thin client of
    :class:`repro_torch.service.SimulationService` on ``device`` (None: the
    card): requests are admitted, coalesced by execution signature, and
    dispatched (one launch of K1 a homogeneous ``hanoi_torch`` group);
    results come back in submission order.  ``sink`` becomes the service
    archive and ``max_workers`` the worker-pool size.  Pass an
    already-running ``service`` to reuse one across calls (its own archive
    and device apply; combining ``service`` with ``sink`` is rejected rather
    than silently ignoring the sink); otherwise a private service is spun
    up and drained for this batch.

    ``procs > 0`` turns on the process-backed execution tier: N spawned
    shard processes with signature-affine routing (numpy groups chunk
    across shards, escaping the GIL).  ``warm_start`` names a persistent
    kernel-cache directory — hot signatures recorded there are prepared
    before the service admits traffic, so a restarted service serves its
    first hot-path batch with no kernel-cache miss.
    """
    from repro_torch.service import SimulationService

    t0 = time.perf_counter()
    if service is not None:
        if sink is not None:
            raise ValueError(
                "pass sink= when serve_simulations creates the service, or "
                "construct the shared service with archive=; a sink given "
                "alongside service= would be silently ignored")
        results = service.run(requests, mechanism=mechanism)
        stats = service.stats()
    else:
        with SimulationService(default_mechanism=mechanism, device=device,
                               archive=sink, workers=max_workers or 2,
                               max_batch=max_batch, max_wait_s=max_wait_s,
                               procs=procs, warm_start=warm_start or None
                               ) as svc:
            results = svc.run(requests)
            stats = svc.stats()
    dt = time.perf_counter() - t0
    n_ok = sum(1 for r in results if r.ok)
    return {"results": results, "wall_s": dt,
            "warps_per_s": len(results) / max(dt, 1e-9),
            "ok": n_ok, "failed": len(results) - n_ok,
            "mechanism": mechanism, "stats": stats}


def _sim_main(args) -> None:
    from repro_torch.core import MachineConfig
    from repro_torch.core.programs import make_suite
    from repro_torch.engine import RotatingJsonlSink, SimRequest
    from repro_torch.service import SimulationService

    cfg = MachineConfig(n_threads=8, mem_size=64, max_steps=8192)
    suite = make_suite(cfg, datasets=1)
    bench = next((b for b in suite if b.name == args.bench), None)
    if bench is None:
        raise SystemExit(f"unknown benchmark {args.bench!r}; available: "
                         + ", ".join(b.name for b in suite))
    archive = (RotatingJsonlSink(args.archive_dir)
               if args.archive_dir else None)
    # --auto-annotate implies strict admission: spin-loop (the repairable
    # hazard) is warn-level, so repair only ever triggers under strict
    verify: "bool | str" = not args.no_verify
    if args.auto_annotate and verify:
        verify = "strict"
    service = SimulationService(
        default_mechanism=args.mechanism, device=args.device,
        archive=archive, workers=args.workers, max_batch=args.max_batch,
        max_wait_s=args.max_wait_ms / 1000.0,
        procs=args.procs, warm_start=args.warm_start or None,
        verify=verify, auto_annotate=args.auto_annotate)
    try:
        with service as svc:
            if args.sm_warps:
                # per-SM mode: one sharded (SM, policy) cell on the pool
                sm = svc.submit_sm(bench, cfg, n_warps=args.sm_warps,
                                   inner=args.mechanism,
                                   policy=args.sm_policy).result()
                print(f"[serve:sim] SM x{sm.n_warps} warps of {args.bench} "
                      f"via {sm.mechanism} over {sm.inner} ({sm.policy}): "
                      f"status={sm.status.value} "
                      f"slots={sm.steps} cycles={sm.cycles} ipc={sm.ipc:.2f} "
                      f"util={sm.utilization:.3f}")
                return
            rng = np.random.default_rng(0)
            mix = (args.mix.split(",") if args.mix else [args.mechanism])
            reqs, mechs = [], []
            for i in range(args.batch):
                reqs.append(SimRequest(
                    program=bench.program, cfg=cfg,
                    init_mem=rng.integers(0, 8, size=cfg.mem_size)
                    .astype(np.int32),
                    record_trace=args.record_trace, name=f"req{i}"))
                mechs.append(mix[i % len(mix)])
            t0 = time.perf_counter()
            tickets = [svc.submit(r, mechanism=m)
                       for r, m in zip(reqs, mechs)]
            svc.flush()
            results = [t.result() for t in tickets]
            dt = time.perf_counter() - t0
            stats = svc.stats()
    finally:
        if archive is not None:     # both branches: drain the writer before
            archive.close()         # exit or queued runs are silently lost
    n_ok = sum(1 for r in results if r.ok)
    mix_label = "+".join(mix)
    print(f"[serve:sim] {args.batch} x {args.bench} via {mix_label} on "
          f"{args.device or 'cuda'}: {n_ok} ok / {len(results) - n_ok} "
          f"failed in "
          f"{dt:.3f}s ({len(results) / max(dt, 1e-9):.0f} warps/s)"
          + (f" repaired={stats.repaired}" if stats.repaired else ""))
    print(f"[serve:sim] batches={stats.batches} "
          f"native={stats.native_batches} ({stats.native_warps} warps) "
          f"fill={stats.mean_fill:.1f} "
          f"p50={stats.latency_p50_s * 1e3:.1f}ms "
          f"p99={stats.latency_p99_s * 1e3:.1f}ms "
          + (f"archived={archive.runs_written} runs in "
             f"{len(archive.paths)} file(s)" if archive else ""))
    if stats.procs:
        shard_lbl = " ".join(
            f"s{s.shard}:{s.completed}ok/{s.failed}bad" for s in stats.shards)
        print(f"[serve:sim] procs={stats.procs} [{shard_lbl}] "
              f"cache hits={stats.cache_hits} misses={stats.cache_misses} "
              f"disk={stats.cache_disk_hits} "
              f"warm={stats.warm_loaded}+{stats.warm_retraced}re "
              f"trace={stats.cache_trace_time_s:.2f}s")


def _replay_main(args) -> None:
    from repro_torch.archive import ArchiveReader, Replayer
    from repro_torch.engine import Simulator

    if not args.archive_dir:
        raise SystemExit("--mode replay requires --archive-dir")
    reader = ArchiveReader(args.archive_dir, prefix=args.archive_prefix)
    replayer = Replayer(args.replay_mechanism or None,
                        simulator=Simulator(device=args.device))
    t0 = time.perf_counter()
    if args.watch:
        # streaming replay: tail the (possibly still-growing) archive,
        # folding each batch of newly appended runs into a rolling
        # aggregate until --limit runs arrive or the archive goes idle
        def progress(report, n_new):
            agg = report.overall()
            rolling = agg.render() if report.rows else "n=0"
            print(f"[serve:replay] +{n_new} run(s) -> "
                  f"{report.replayed} replayed; rolling {rolling}",
                  flush=True)
        report = replayer.watch(
            reader, poll_s=args.watch_poll_ms / 1000.0,
            idle_timeout_s=args.watch_idle_s or None,
            max_runs=args.limit or None, progress=progress)
    else:
        report = replayer.replay(reader, limit=args.limit or None)
    dt = time.perf_counter() - t0
    print(report.render())
    print(f"[serve:replay] {report.replayed} run(s) in {dt:.3f}s "
          f"({report.replayed / max(dt, 1e-9):.0f} warps/s)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["lm", "sim", "replay"], default="lm")
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--mechanism", default="hanoi_torch",
                    help="[sim] control-flow mechanism to serve with "
                         "(any registered name, e.g. volta_itps)")
    ap.add_argument("--bench", default="GAUS0",
                    help="[sim] benchmark program to serve")
    ap.add_argument("--sm-warps", type=int, default=0,
                    help="[sim] run N warps per SM through --mechanism "
                         "(0 = single-warp batch mode)")
    ap.add_argument("--sm-policy", default="round_robin",
                    choices=["round_robin", "greedy_then_oldest"],
                    help="[sim] SM warp-scheduler policy for --sm-warps")
    ap.add_argument("--mix", default="",
                    help="[sim] comma-separated mechanisms to round-robin "
                         "requests over (exercises mixed-batch coalescing)")
    ap.add_argument("--procs", type=int, default=0,
                    help="[sim] size of the process-backed execution tier; "
                         "0 (default) keeps the in-process thread pool, "
                         "N>0 spawns N shard processes with "
                         "signature-affine routing")
    ap.add_argument("--warm-start", default="",
                    help="[sim] persistent kernel-cache directory; hot "
                         "signatures recorded there are prepared (libraries "
                         "loaded, one launch each) before the service "
                         "admits traffic")
    ap.add_argument("--workers", type=int, default=2,
                    help="[sim] service worker threads")
    ap.add_argument("--no-verify", action="store_true",
                    help="[sim] skip static pre-admission analysis "
                         "(repro_torch.analysis); by default error-level "
                         "programs are rejected at admission")
    ap.add_argument("--auto-annotate", action="store_true",
                    help="[sim] repair rejected programs through the "
                         "annotation synthesizer (BSSY/BSYNC/BMOV/YIELD) "
                         "and admit the rewrite instead of rejecting; "
                         "implies strict admission unless --no-verify")
    ap.add_argument("--max-batch", type=int, default=64,
                    help="[sim] coalescer size-flush threshold")
    ap.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="[sim] coalescer deadline-flush threshold (ms)")
    ap.add_argument("--archive-dir", default="",
                    help="[sim] archive traces to rotating JSONL files in "
                         "this directory; [replay] the archive to replay")
    ap.add_argument("--record-trace", action="store_true",
                    help="[sim] record control-flow traces on served "
                         "requests (required for a replayable/diffable "
                         "archive; off by default to keep serving lean)")
    ap.add_argument("--archive-prefix", default="traces",
                    help="[replay] archive file prefix")
    ap.add_argument("--replay-mechanism", default="",
                    help="[replay] mechanism to replay under (default: "
                         "each run's archived mechanism — the self-replay "
                         "integrity check)")
    ap.add_argument("--limit", type=int, default=0,
                    help="[replay] replay at most N runs (0 = all; with "
                         "--watch, stop after N runs)")
    ap.add_argument("--watch", action="store_true",
                    help="[replay] streaming mode: tail a growing archive "
                         "and replay newly appended runs incrementally "
                         "with a rolling aggregate")
    ap.add_argument("--watch-poll-ms", type=float, default=250.0,
                    help="[replay] --watch poll interval (ms)")
    ap.add_argument("--watch-idle-s", type=float, default=0.0,
                    help="[replay] exit --watch after this long with no "
                         "new runs (0 = watch until --limit/interrupt)")
    args = ap.parse_args(argv)
    if args.mode == "sim":
        _sim_main(args)
        return
    if args.mode == "replay":
        _replay_main(args)
        return
    res = serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                gen_len=args.gen_len, device=args.device)
    print(f"[serve] generated {res['generated'].shape} tokens in "
          f"{res['wall_s']:.2f}s ({res['tokens_per_s']:.1f} tok/s)")
    print(res["generated"][:, :10])


if __name__ == "__main__":
    main()
