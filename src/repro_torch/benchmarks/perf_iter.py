"""The hypothesis -> change -> measure loop over the chosen cells (port of
``benchmarks/perf_iter.py``), on the port's dry run.

Cells, as the JAX package chose them:

* internlm2-20b x train_4k   — the deepest dense training cell (auto-fit
                               raises its microbatches, so weight gathers
                               repeat);
* mixtral-8x7b  x train_4k   — MoE training;
* hubert-xlarge x prefill_32k — the encoder's bidirectional attention, the
                               cell closest to the paper's divergence-
                               aware attention tiling;
* internlm2-20b x decode_32k, rwkv6-3b x train_4k, internlm2-20b and
  mixtral-8x7b x prefill_32k.

Each variant keeps the JAX package's cell and ``build_cell`` kwargs and
states what it should change; the port's terms are measured by running
it (one rank of the production (16, 16) mesh on the meta device,
``launch/dryrun.py``), and no number of the JAX package's (a TPU's) is
carried over.  The rwkv6-3b variant runs the RWKV-6 layers'
tensor-parallel form (``models/recurrent.py``).  The JAX package's two
``rwkv_unroll`` variants are not kept: the unroll of a ``lax.scan`` body
has no counterpart in eager PyTorch, whose RWKV-6 layer is one kernel
launch (K5) or one Python loop.

Runs in a fresh process (one fake world of 256 ranks):
    PYTHONPATH=src python -m repro_torch.benchmarks.perf_iter
        [--out build/repro_torch/perf.json] [--only SUBSTRING]
"""
from __future__ import annotations

import argparse
import json
import os
import traceback

# (arch, shape, variant, build_cell kwargs, hypothesis)
PLAN = [
    ("internlm2-20b", "train_4k", "V1_zero1",
     dict(param_mode="zero1", microbatches=16),
     "ZeRO-1 bf16 compute params (TP-only, replicated over data) remove "
     "the per-use FSDP weight all-gathers: the all-gather bytes should "
     "fall, unless the sequence-parallel activation gathers dominate."),
    ("internlm2-20b", "train_4k", "V5_zero1_chunked_mb8",
     dict(param_mode="zero1", attn_impl="chunked", microbatches=8),
     "Chunked attention removes the O(S^2) score buffers, so fewer "
     "microbatches fit and the activation gathers a step fall."),
    ("internlm2-20b", "train_4k", "V6_zero1_chunked_mb4",
     dict(param_mode="zero1", attn_impl="chunked", microbatches=4),
     "Halving the microbatches again halves the activation gathers, if "
     "the peak still fits the card."),
    ("mixtral-8x7b", "train_4k", "V1_zero1",
     dict(param_mode="zero1", microbatches=8),
     "Weight-gather elimination for the 47B MoE: the replicated bf16 "
     "params and their gradient buffer may not fit beside the "
     "activations."),
    ("mixtral-8x7b", "train_4k", "V4_fsdp_chunked_mb2",
     dict(attn_impl="chunked", microbatches=2),
     "Keep FSDP and shrink the activations with chunked attention, so "
     "that fewer microbatches fit."),
    ("hubert-xlarge", "prefill_32k", "V1_chunked",
     dict(attn_impl="chunked"),
     "Chunked attention: no 32k x 32k score tensor, so the peak falls; "
     "bidirectional attention has only FULL tiles, so the FLOPs stay."),
    ("internlm2-20b", "decode_32k", "V1_no_fsdp",
     dict(fsdp=False),
     "Keep the bf16 weights TP-resident for decode: no weight gathers "
     "over data a token."),
    ("rwkv6-3b", "train_4k", "V3_chunked_matmul",
     dict(rwkv_impl="chunked"),
     "Chunked-parallel wkv turns the recurrence into products: less "
     "state traffic, more FLOPs."),
    ("internlm2-20b", "prefill_32k", "V1_chunked",
     dict(attn_impl="chunked"),
     "Chunked attention fits the prefill's scores; causal chunking keeps "
     "the FULL tiles, so the FLOPs stay."),
    ("mixtral-8x7b", "prefill_32k", "V1_chunked",
     dict(attn_impl="chunked"),
     "The sliding window's EMPTY bands are skipped, so the FLOPs and the "
     "peak fall (the path-never-scheduled saving at tile granularity)."),
]

DEFAULT_OUT = os.path.join("build", "repro_torch", "perf.json")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--only", help="substring filter on variant name")
    args = ap.parse_args(argv)

    from repro_torch.launch.dryrun import run_cell

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["variant"]) for r in results}

    for arch, shape, variant, kw, hypothesis in PLAN:
        if (arch, shape, variant) in done:
            continue
        if args.only and args.only not in variant:
            continue
        print(f"[perf] {arch} x {shape} :: {variant}", flush=True)
        try:
            rec = run_cell(arch, shape, False, **kw)
        except Exception as e:
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape, "status": "error",
                   "error": f"{type(e).__name__}: {e}"}
        rec["variant"] = variant
        rec["kwargs"] = {k: str(v) for k, v in kw.items()}
        rec["hypothesis"] = hypothesis
        results.append(rec)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(f"[perf] wrote {args.out}")


if __name__ == "__main__":
    main()
