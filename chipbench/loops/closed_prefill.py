"""A closed loop of prefills with one batch in flight: a prefill worker fed
from a full queue, or a batch ingest of documents.

Set-up draws the weights and a pool of ``pool`` batches of ``batch`` x
``seq`` token ids, uniform over the vocabulary, on the device from the
seed, and runs ``warmup_steps`` steps of the cell's own shape.  A step
hands the next batch of the pool to the program's ``prefill``, waits for
the device, and records its wall; every request of the batch shares it.
Each step's served tokens (the greedy token at every position) are kept
for the check.  The window ends with the first step that ends
``--seconds`` after the window began.  A ``--trace 1`` run then traces
``trace_steps`` more steps (a warm-up step first, untraced).

After the window: the sample of requests the check compares is drawn from
the seed (:func:`chipbench.check.sample`), the last step's logits and
caches of those in it kept, everything
else of the program's output freed; then the plain reference judges them.
"""
from __future__ import annotations

import statistics
import sys
import time

import torch

from chipbench import check, weights
from chipbench.harness import Run, load_module


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def port_config(conf: dict):
    """The program's ModelConfig for a configuration file: the prefill
    config of its arch with every size and knob the file states."""
    from repro_torch.launch.steps import prefill_config
    fields = dict(conf["model"])
    fields["layer_plan"] = tuple((tuple(p), r) for p, r in
                                 fields["layer_plan"])
    return prefill_config(conf["arch"]).replace(**fields).validate()


def setup(cell, seed: int, dev):
    """(cfg, model, tree, pool) for a run of ``cell`` from ``seed``."""
    from repro_torch.models import Transformer, model_struct
    cfg = port_config(cell.conf)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = getattr(torch, cell.conf["dtype"])
    tree = weights.draw(model_struct(cfg), cell.conf.get("draw", {}), gen,
                        dtype, dev)
    t = cell.traffic
    pool = torch.randint(0, cfg.vocab_size, (t["pool"], t["batch"], t["seq"]),
                         generator=gen, dtype=torch.int32, device=dev)
    return cfg, Transformer(cfg, tree), tree, pool


def run(cell, seed: int, seconds: float, trace: bool, dev, *,
        t_start: float, root, prefill=None, control: bool = False) -> Run:
    """One run of ``cell``.  ``prefill`` replaces the program's entry (a
    test plants a fault there); ``control`` also reads the lower-precision
    control's numbers (``chipbench/readings.py``)."""
    from repro_torch.kernels import ops
    if prefill is None:
        from repro_torch.launch.steps import prefill
    t = cell.traffic
    B, S, P = t["batch"], t["seq"], t["pool"]
    cfg, model, tree, pool = setup(cell, seed, dev)
    r = Run(cell=cell, cfg=cfg, device=dev, seed=seed,
            tokens_per_step=B * S, requests_per_step=B)

    def step(i):
        return prefill(model, cfg, {"tokens": pool[i % P]})

    for i in range(t["warmup_steps"]):
        out = step(i)
        out[0].argmax(-1)           # the served tokens' kernel, warmed too
        out = None
        _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kernels = cell.conf.get("launches", {})
    launches0 = {k: getattr(ops, k).launches for k in kernels}
    served = []
    out = None
    t0 = time.perf_counter()
    r.setup_s = t0 - t_start
    while True:
        out = None
        a = time.perf_counter()
        out = step(r.steps)
        b = time.perf_counter()
        _sync(dev)
        c = time.perf_counter()
        r.walls.append(c - a)
        r.enqueue.append(b - a)
        served.append(out[0].argmax(-1))
        r.steps += 1
        if c - t0 >= seconds:
            break
    _sync(dev)
    r.window_s = time.perf_counter() - t0
    r.launches = {k: (getattr(ops, k).launches - launches0[k]) / r.steps
                  for k in kernels}
    print(f"window: {r.steps} steps in {r.window_s:.3f} s; step wall ms "
          f"min {1e3 * min(r.walls):.2f} median "
          f"{1e3 * statistics.median(r.walls):.2f} max "
          f"{1e3 * max(r.walls):.2f}; enqueue ms median "
          f"{1e3 * statistics.median(r.enqueue):.2f}", file=sys.stderr)
    if dev.type == "cuda":
        r.peak_bytes = torch.cuda.max_memory_allocated(dev)

    ids = check.sample(seed, r.steps, B, t["check_requests"])
    judged = check.keep(ids, served, out[0], out[1], pool, B)
    out = served = None
    if trace:
        from chipbench import trace as tracing
        r.trace = tracing.capture(lambda i: step(r.steps + i),
                                  t["trace_steps"], lambda: _sync(dev))
    ref = load_module("reference", cell.conf["reference"], root / "chipbench")
    r.checks, r.readings, r.control = check.judge(
        ref, tree, cell.conf, judged, r.launches, control=control)
    r.correct = all(v <= lim for v, lim in r.checks.values())
    return r
