#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from the checkout's sources, holds
each against its plain PyTorch version on the card, drives the port's main
path at the full width of llama3.2-1b (a bf16 prefill of 4 x 2048 tokens
through the flash-attention kernel, then ``serve`` answering 4 requests),
times the kernel beside its bound, its plain version and PyTorch's own
attention, and prints one JSON line of kernel numbers and, last, one JSON
line naming the device.  Any failed phase, or no GPU, exits non-zero before
that last line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SEED = 0

# NVIDIA H100 SXM data sheet, dense: tensor-core bf16 and CUDA-core f32
# peaks, and HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12

# llama3.2-1b attention at the prefill shape: B, S, H, K, hd
PREFILL_B, PREFILL_S = 4, 2048
TOLERANCE = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# last-position logits, flash vs reference prefill, both bf16 end to end
PREFILL_LOGITS_TOL = 5e-2


def phase(name: str, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{name}] {body}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke failed: {what}")


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of one call of ``fn`` on the card, over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs only "
              "on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import prefill, prefill_config
    from repro_torch.models import Transformer, init_params, model_struct

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device ------------------------------------------------------------
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    phase("device", kind=repr(kind), count=count, torch=torch.__version__,
          cuda=torch.version.cuda)
    print(smi, flush=True)

    # 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    phase("build", kernels=",".join(logs),
          seconds=f"{time.perf_counter() - t0:.1f}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "entry function" in line or "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # 3. kernel check: kernel vs plain on the same inputs --------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def qkv(B, S, H, K, hd, dtype):
        return tuple(torch.randn((B, S, n, hd), generator=gen, device=dev)
                     .to(dtype) for n in (H, K, K))

    cases = [
        ("llama_causal_f32", 4, 2048, 32, 8, 64, True, 0, torch.float32),
        ("llama_causal_bf16", 4, 2048, 32, 8, 64, True, 0, torch.bfloat16),
        ("window_256", 2, 1024, 32, 8, 64, True, 256, torch.bfloat16),
        ("non_causal", 2, 512, 32, 8, 64, False, 0, torch.float32),
        ("ragged_1000", 2, 1000, 32, 8, 64, True, 0, torch.float32),
    ]
    errs = {}
    for name, B, S, H, K, hd, causal, window, dtype in cases:
        q, k, v = qkv(B, S, H, K, hd, dtype)
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        blk = min(fa.DEFAULT_BQ, max(8, S))
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, bq=blk, bk=blk)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        errs[name] = err
        tol = TOLERANCE[dtype]
        phase("kernel_check", kernel="flash_attention", case=name,
              shape=f"B{B}xS{S}xH{H}xK{K}xhd{hd}", dtype=str(dtype)[6:],
              causal=causal, window=window, max_abs_err=f"{err:.3e}",
              tol=tol)
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        check(err <= tol, f"{name}: max abs err {err} > {tol}")
        del q, k, v, got, want

    # 4. prefill: the main path through the kernel --------------------------
    cfg = prefill_config("llama3.2-1b", attn_impl="flash")
    params = init_params(model_struct(cfg), gen, dtype=torch.bfloat16,
                         device=dev)
    model = Transformer(cfg, params)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S),
                           generator=gen, device=dev)
    batch = {"tokens": tokens}
    prefill(model, cfg, batch)          # warm-up: cuBLAS plans, allocator
    ops.flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = prefill(model, cfg, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = ops.flash_attention.launches
    check(launches == cfg.n_layers,
          f"prefill launched flash_attention {launches} times, "
          f"expected {cfg.n_layers}")
    check(logits.shape == (PREFILL_B, PREFILL_S, cfg.vocab_size),
          f"prefill logits shape {tuple(logits.shape)}")
    check(caches[0]["0"]["k"].shape == (cfg.n_layers, PREFILL_B, PREFILL_S,
                                        cfg.n_kv_heads, cfg.hd),
          "prefill cache shape")
    last = logits[:, -1].float()
    del logits, caches
    ref_logits, _ = prefill(model, cfg.replace(attn_impl="reference"), batch)
    ref_last = ref_logits[:, -1].float()
    del ref_logits
    logit_err = (last - ref_last).abs().max().item()
    phase("prefill", arch=cfg.name, params="bf16",
          tokens=f"{PREFILL_B}x{PREFILL_S}", flash_launches=launches,
          wall_s=f"{prefill_s:.4f}",
          tok_per_s=f"{PREFILL_B * PREFILL_S / prefill_s:.1f}",
          last_logits_max_abs_err_vs_reference=f"{logit_err:.3e}",
          tol=PREFILL_LOGITS_TOL,
          ref_logits_max_abs=f"{ref_last.abs().max().item():.3e}")
    check(bool(torch.isfinite(last).all()), "prefill logits not finite")
    check(logit_err <= PREFILL_LOGITS_TOL,
          f"prefill logits differ from the reference by {logit_err}")
    del model, params, last, ref_last
    torch.cuda.empty_cache()

    # 5. serve: full width, f32, greedy decode of 4 requests -----------------
    serve("llama3.2-1b", smoke=False, batch=4, prompt_len=2, gen_len=2,
          seed=SEED, device=dev)        # warm-up: cuBLAS f32 plans
    ops.flash_attention.launches = 0
    res = serve("llama3.2-1b", smoke=False, batch=4, prompt_len=16,
                gen_len=32, seed=SEED, device=dev)
    gen_tokens = res["generated"]
    phase("serve", arch="llama3.2-1b", params="f32", batch=4, prompt_len=16,
          gen_len=32, shape=gen_tokens.shape, wall_s=f"{res['wall_s']:.4f}",
          tok_per_s=f"{res['tokens_per_s']:.1f}",
          flash_launches=ops.flash_attention.launches)
    print(f"  tokens[0]={gen_tokens[0].tolist()}")
    check(gen_tokens.shape == (4, 32), f"serve shape {gen_tokens.shape}")
    check(bool(((gen_tokens >= 0)
                & (gen_tokens < get_config("llama3.2-1b").vocab_size)).all()),
          "serve tokens out of the vocabulary")
    torch.cuda.empty_cache()

    # 6. kernel times at the prefill shape ----------------------------------
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = qkv(PREFILL_B, PREFILL_S, H, K, hd, torch.bfloat16)
    ms = cuda_time_ms(lambda: ops.flash_attention(q, k, v, causal=True), 20)
    plain_ms = cuda_time_ms(lambda: fa.flash_attention_plain(
        q, k, v, causal=True), 5, warmup=1)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 20)
    flops = fa.attention_flops(PREFILL_B, PREFILL_S, PREFILL_S, H, hd,
                               causal=True, window=0)
    nbytes = fa.attention_bytes(q, k, v)
    t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    phase("kernel_time", kernel="flash_attention",
          shape=f"B{PREFILL_B}xS{PREFILL_S}xH{H}xK{K}xhd{hd}", dtype="bf16",
          ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
          library_ms=f"{library_ms:.4f}", flops=flops, bytes=nbytes,
          bound_ms=f"{bound_ms:.4f}",
          roofline_share=f"{bound_ms / ms:.4f}")

    # 7. kernels line, device line -------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:110",
        "launches": launches,
        "max_abs_err": errs["llama_causal_bf16"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
