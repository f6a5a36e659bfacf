"""How ``correct`` is decided for a prefill cell.

After the window a sample of the finished requests, drawn from the seed, is
compared with the plain reference (``chipbench/reference/``) run in f32 on
the same prompts and the same weights.  The numbers:

* ``gap_mean``: at every position of a sampled request, the token the
  program serves (its greedy token) is scored by the reference's logits:
  the gap by which its reference logit lies below the reference's best.
  The mean over the request's positions; the worst request.  It reads
  every layer the logits pass through.
* ``cache_err_first``: the first layer's caches that the last step returned
  for its sampled rows (attention's k and v; RWKV-6's shifts and wkv
  state), each leaf by its relative Frobenius error against the
  reference's; the worst.
* ``cache_err``: the same over every layer.
* ``kl_mean``: the logits by value, on the sampled requests of the last
  step (whose logits are still held): at each position the KL divergence
  of the program's next-token distribution from the reference's, in nats;
  the mean over a request's positions, the worst request.  It reads what
  the greedy token cannot: a scale or temperature on the head, an error
  in the final norm.
* ``kl_max``: the same, the widest over every position.
* ``gap_max``: the widest gap over every sampled position.
* ``launches_off``: how far the window's kernel launches a step (K3, K5, by
  the program's own counters) lie from what the configuration states;
  exact, so the timed path ran through the kernels.

A configuration holds the numbers its ``limits`` name, and
``launches_off`` at 0; the others are printed as readings.  The limits and
the readings they were set from are in ``PERF.md``.  The control (the
reference with its weights in fp8, ``reference.common.FP8``) is read by
``chipbench/readings.py`` and the tests, never by a run.
"""
from __future__ import annotations

import random

import torch

from chipbench.reference.common import EXACT, FP8


def sample(seed: int, steps: int, batch: int, n: int) -> list[int]:
    """``n`` request ids (step * batch + row) drawn from the seed among the
    ``steps * batch`` finished, one at least from the last step (whose
    caches are still held)."""
    rng = random.Random(f"chipbench.sample.{seed}")
    total = steps * batch
    ids = rng.sample(range(total), min(n, total))
    if all(i // batch != steps - 1 for i in ids):
        ids[0] = (steps - 1) * batch + rng.randrange(batch)
    return sorted(ids)


def _layer_caches(caches, row: int) -> list[dict]:
    """The program's stacked caches (a segment's ``{position: {name:
    [repeat, B, ...]}}``) as one dict a layer, of row ``row``."""
    out = []
    for seg in caches:
        positions = sorted(seg, key=int)
        repeat = next(iter(seg[positions[0]].values())).shape[0]
        for r in range(repeat):
            for j in positions:
                out.append({n: t[r, row].clone() for n, t in seg[j].items()})
    return out


def keep(ids, served, last_logits, last_caches, pool, batch: int) -> dict:
    """What the check needs of the program's output, copied out so the
    rest can be freed: each sampled request's prompt and served tokens,
    and the logits and caches of those in the last step."""
    last = len(served) - 1
    out = {"tokens": [], "served": [], "caches": {}, "logits": {}}
    for n, i in enumerate(ids):
        step, row = divmod(i, batch)
        out["tokens"].append(pool[step % pool.shape[0], row].clone())
        out["served"].append(served[step][row].clone())
        if step == last:
            out["caches"][n] = _layer_caches(last_caches, row)
            out["logits"][n] = last_logits[row].clone()
    return out


def gaps(ref_logits, tokens):
    """[N, S]: the reference's best logit less its logit of ``tokens``."""
    best = ref_logits.max(-1).values
    return best - ref_logits.gather(-1, tokens.long()[..., None])[..., 0]


def kl(ref_logits, logits):
    """[S]: at each position, KL(reference || program) of the next-token
    distributions, in nats."""
    p = torch.log_softmax(ref_logits.float(), -1)
    q = torch.log_softmax(logits.float(), -1)
    return (p.exp() * (p - q)).sum(-1)


def cache_errs(got: list, ref_caches: list, n: int) -> list[float]:
    """Request ``n``'s caches ``got`` (a dict a layer) against the
    reference's (batched over requests): each layer's worst leaf by its
    relative error."""
    out = []
    for mine, want in zip(got, ref_caches, strict=True):
        worst = 0.0
        for name, t in mine.items():
            w = want[name][n].float()
            err = (t.float() - w).norm() / w.norm().clamp_min(1e-30)
            worst = max(worst, float(err))
        out.append(worst)
    return out


def numbers(ref_logits, ref_caches, served, caches: dict,
            logits: dict) -> dict:
    """The check's numbers for served tokens [N, S], caches and logits
    (request index -> a dict a layer, or its logits [S, V])."""
    g = gaps(ref_logits, served)
    out = {"gap_mean": float(g.mean(-1).max()), "gap_max": float(g.max())}
    if logits:
        kls = [kl(ref_logits[n], t) for n, t in logits.items()]
        out["kl_max"] = max(float(k.max()) for k in kls)
        out["kl_mean"] = max(float(k.mean()) for k in kls)
    if caches:
        errs = [cache_errs(c, ref_caches, n) for n, c in caches.items()]
        out["cache_err_first"] = max(e[0] for e in errs)
        out["cache_err"] = max(max(e) for e in errs)
    return out


def judge(ref, tree, conf: dict, judged: dict, launches: dict, *,
          control: bool = False) -> tuple[dict, dict, dict]:
    """(checks: name -> (value, limit) for the numbers the configuration
    holds, every number's reading, the control's readings or {})."""
    tokens = torch.stack(judged["tokens"])
    logits, caches = ref.forward(tree, conf, tokens, EXACT)
    readings = numbers(logits, caches, torch.stack(judged["served"]),
                       judged["caches"], judged["logits"])
    want = conf.get("launches", {})
    readings["launches_off"] = float(sum(abs(launches.get(k, 0) - v)
                                         for k, v in want.items()))
    limits = {**conf["limits"], "launches_off": 0}
    checks = {k: (readings[k], lim) for k, lim in limits.items()}
    ctrl = {}
    if control:
        c_logits, c_caches = ref.forward(tree, conf, tokens, FP8)
        ctrl = numbers(logits, caches, c_logits.argmax(-1), {
            n: [{k: v[n] for k, v in layer.items()} for layer in c_caches]
            for n in judged["caches"]},
            {n: c_logits[n] for n in judged["logits"]})
    return checks, readings, ctrl
