#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from the checkout's sources (the
Hanoi step machine K1, flash attention K3, the RG-LRU scan K4, the RWKV-6
scan K5) and reports each kernel's ptxas registers and spills; shows that K3's bf16 kernel runs on the
tensor cores (its HMMA instructions, and no register spills); holds each
kernel against its plain PyTorch version on the card (K3 at hd 64, 128, 256
and 320, in bf16 and f32; K4 and K5, split over time, against twins that
walk the same segments: K4's h and K5's s_last bit for bit, also at a
length of many resident waves, and the same bits from two launches; K1
against its plain twin bit for bit in every field of the simulator's
state, at 4, 8 and 32 threads, 2 and 8 Bx registers, majority-first on and
off, with oracle skips, over the paper's figures, the spinlock and the
suite); and drives the port's main paths at full width, with random
weights or data drawn from a seed:

- llama3.2-1b: a bf16 prefill of 4 x 2048 tokens through K3 (hd 64);
- recurrentgemma-2b: a bf16 prefill of 4 x 2048 through K3 (hd 256), held
  against the reference-attention prefill, and layer 0's RG-LRU with
  ``use_kernel=True`` through K4, held against its plain branch;
- rwkv6-3b: a bf16 prefill of 4 x 2048 through the per-token wkv scan, held
  against the chunked form, and layer 0's time mix with ``use_kernel=True``
  through K5, held against the scan;
- ``serve`` of 4 requests on each of the three models, in f32;
- the simulator: ``Simulator.run_batch(mechanism="hanoi_torch")`` over
  8,448 simulated warps (one full residency of the card, 132 SMs x 64
  warps; the suite's 23 programs in turn, each warp with its own memory)
  at the paper's evaluation config, in one launch of K1, every warp held
  to the twin and one warp of each program to the numpy ``run_hanoi``;
  then Fig 9 through ``compare``: ``hanoi_torch`` against ``hanoi``
  (discrepancy 0) and against ``turing_oracle`` (the numpy ``hanoi``'s
  discrepancies, row for row).

Every kernel's launch count is set to 0 just before each path and read just
after it; a path that launches a kernel another number of times than it
should fails the run.  Then it times each kernel beside its bound, its plain
version and, where one exists, one PyTorch call computing the same function,
prints one JSON line of kernel numbers and, last, one JSON line naming the
device.  Any failed phase, or no GPU, exits non-zero before that last line.
"""
from __future__ import annotations

import collections
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0

# NVIDIA H100 SXM data sheet, dense: tensor-core bf16 and CUDA-core f32
# peaks, and HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12

PREFILL_B, PREFILL_S = 4, 2048
RAGGED_S = 1000          # a sequence length no kernel tile divides
LONG_S = 16384           # K4/K5: many more segments than one resident wave
TOLERANCE = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# K4 rounds each product and sum as its plain twin does (bit-equal
# expected); K5 carries the same state bit for bit and sums out over k in
# another order.  These are the JAX package's own kernel tolerances.
RGLRU_TOL, RWKV_TOL = 1e-5, 1e-4
# last-position logits of two prefills of one model (flash vs reference
# attention in bf16; per-token vs chunked wkv in f32), relative to the
# largest logit.  rwkv6-3b is compared in f32: through its 32 bf16 layers
# one rounding flip grows to ~10% of the logits whichever form is right.
PREFILL_LOGITS_RTOL = {torch.bfloat16: 5e-2, torch.float32: 1e-3}
# a layer with use_kernel=True against its plain branch, f32, on layer 0's
# weights: the log-depth RG-LRU scan and the per-token wkv scan round in
# other orders than the kernels
LAYER_TOL = 1e-4
# the simulator's full-size batch: one full residency of an H100 (132 SMs x
# 64 warps), and the paper's evaluation config (Simulator.compare's default)
SIM_WARPS = 132 * 64
# one dependent shared-memory round trip a scheduler slot, at the data
# sheet's 1.98 GHz boost clock: the latency half of K1's bound
SLOT_CYCLES, CLOCK_HZ = 30, 1.98e9


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


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes of each entry function in an ``nvcc
    -Xptxas -v`` log, by its short name (``rwkv6_scan_kernel<64>``,
    ``hanoi_kernel``) where those are unique, else by its mangled name."""
    report, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            report[entry] = {}
        elif entry and "spill stores" in line:
            words = line.replace(",", "").split()
            report[entry]["spill_stores"] = int(
                words[words.index("spill") - 2])
            report[entry]["spill_loads"] = int(words[-4])
        elif entry and "Used" in line and "registers" in line:
            words = line.split()
            report[entry]["registers"] = int(words[words.index("Used") + 1])
    short = {}
    for entry in report:
        # the template's name, after its length in the mangled name
        names = [entry[i + 2:i + 2 + int(entry[i:i + 2])]
                 for i in range(len(entry) - 1) if entry[i:i + 2].isdigit()]
        name = next((n for n in names if n.endswith("kernel")
                     and n[0].isalpha() and (n + "I" in entry
                                             or n + "E" in entry)), None)
        if name and name + "I" in entry:        # a template's instance
            name = "{}<{}>".format(name, ",".join(
                re.findall(r"Li(\d+)E", entry)))
        short[entry] = name
    if all(short.values()) and len(set(short.values())) == len(short):
        return {short[e]: v for e, v in report.items()}
    return report


def max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def bound(flops: int, nbytes: int, dtype) -> tuple[float, str]:
    """The least time (ms) the card could take, and what bounds it."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs only "
              "on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core import hanoi as hanoi_core
    from repro_torch.core import interp, programs
    from repro_torch.core.isa import MachineConfig
    from repro_torch.engine import SimRequest, Simulator, as_request
    from repro_torch.engine import get_mechanism
    from repro_torch.service.planner import plan_dispatch
    from repro_torch.engine.adapters import _batch_arrays, padded_len
    from repro_torch.kernels import _build
    from repro_torch.kernels import hanoi_step as hs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import prefill, prefill_config
    from repro_torch.models import Transformer, init_params, model_struct
    from repro_torch.models import recurrent
    from repro_torch.models.base import Params, tree_map
    from repro_torch.models.layers import embed, rmsnorm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    counters = {"flash_attention": ops.flash_attention,
                "rglru_scan": ops.rglru_scan, "rwkv6_scan": ops.rwkv6_scan,
                "hanoi_run": ops.hanoi_run}
    launches = {name: {} for name in counters}     # kernel -> path -> count

    def run_path(path: str, fn, expect: dict):
        """Drive one main path with every launch count set to 0 just before
        it; read the counts just after and hold them to ``expect``.
        Returns (fn's result, wall seconds, the counts)."""
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {name: c.launches for name, c in counters.items()}
        for name, n in got.items():
            if n:
                launches[name][path] = n
            check(n == expect.get(name, 0),
                  f"{path} launched {name} {n} times, expected "
                  f"{expect.get(name, 0)}")
        return out, wall, got

    # 1. device ------------------------------------------------------------
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    phase("device", kind=repr(kind), count=count, torch=torch.__version__,
          cuda=torch.version.cuda)
    print(smi, flush=True)

    # 2. build: one nvcc per kernel, all started together --------------------
    t0 = time.perf_counter()
    logs = _build.build()
    phase("build", kernels=",".join(logs),
          seconds=f"{time.perf_counter() - t0:.1f}")
    ptxas = {name: ptxas_report(log) for name, log in logs.items()}
    for name in ("rglru_scan", "rwkv6_scan", "hanoi_step"):
        phase("ptxas", kernel=name, report=json.dumps(ptxas[name]))
        check(bool(ptxas[name]) and all("registers" in v and "spill_stores"
                                        in v for v in ptxas[name].values()),
              f"{name}: no ptxas registers and spills in its build log")
    entry = ""
    for name, log in logs.items():
        for line in log.splitlines():
            if "entry function" in line:
                entry = line.split("'")[1]
            if "entry function" in line or "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
            # no tensor-core (bf16) instantiation of K3 may spill
            if "tc_kernel" in entry and "spill" in line:
                check(" 0 bytes spill stores, 0 bytes spill loads" in line,
                      f"{entry} spills: {line.strip()}")
    sass = subprocess.run(
        [_build.cuda_tool("cuobjdump"), "-sass",
         str(_build.library_path("flash_attention"))],
        capture_output=True, text=True, timeout=300, check=True).stdout
    n_mma = {op: sum(f" {op}." in ln for ln in sass.splitlines())
             for op in ("HMMA", "HGMMA")}
    phase("sass", kernel="flash_attention", **n_mma)
    check(n_mma["HMMA"] + n_mma["HGMMA"] > 0,
          "the flash-attention library has no tensor-core instruction")

    # 3. kernel check: each kernel vs its plain twin on the same inputs -----
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def qkv(B, S, H, K, hd, dtype):
        return tuple(randn(B, S, n, hd, dtype=dtype) for n in (H, K, K))

    def rglru_inputs(B, S, W):
        a = torch.rand((B, S, W), generator=gen, device=dev) * 0.499 + 0.5
        return a, randn(B, S, W)

    def rwkv_inputs(B, S, H, hd):
        r, k, v = (randn(B, S, H, hd) for _ in range(3))
        # the model's decay form: w = exp(-exp(z)), z clipped to [-8, 4]
        w = torch.exp(-torch.exp(randn(B, S, H, hd).clamp(-8.0, 4.0)))
        return r, k, v, w, randn(H, hd) * 0.1

    lcfg, gcfg, rcfg = (get_config(a) for a in
                        ("llama3.2-1b", "recurrentgemma-2b", "rwkv6-3b"))
    B, S = PREFILL_B, PREFILL_S
    llama_attn = (lcfg.n_heads, lcfg.n_kv_heads, lcfg.hd)
    rgemma_attn = (gcfg.n_heads, gcfg.n_kv_heads, gcfg.hd)
    # K3's other head dims, not yet on a ported model's path: hd 128 with
    # GQA 4:1 (llama3-8b's 32/8 heads), and gemma3-4b's local layers (d 2560
    # over 8 heads is hd 320, 4 kv heads, window 1024; the port has no
    # gemma3 config yet, so these are literals)
    hd128_attn, gemma3_attn, gemma3_window = (32, 8, 128), (8, 4, 320), 1024
    rwkv_heads = (rcfg.d_model // rcfg.rwkv_head_dim, rcfg.rwkv_head_dim)
    errs = {}
    attn_cases = [
        ("llama_causal_f32", B, S, *llama_attn, True, 0, torch.float32),
        ("llama_causal_bf16", B, S, *llama_attn, True, 0, torch.bfloat16),
        ("window_s/8", 2, S // 2, *llama_attn, True, S // 8, torch.bfloat16),
        ("non_causal", 2, S // 4, *llama_attn, False, 0, torch.float32),
        ("ragged", 2, RAGGED_S, *llama_attn, True, 0, torch.float32),
        ("rgemma_bf16", B, S, *rgemma_attn, True, gcfg.window_size,
         torch.bfloat16),
        ("rgemma_ragged_f32", 1, RAGGED_S, *rgemma_attn, True,
         RAGGED_S * 3 // 10, torch.float32),
        ("hd128_bf16", B, S, *hd128_attn, True, 0, torch.bfloat16),
        ("hd128_ragged_f32", 1, RAGGED_S, *hd128_attn, True, 0,
         torch.float32),
        ("gemma3_local_bf16", B, S, *gemma3_attn, True, gemma3_window,
         torch.bfloat16),
        ("gemma3_global_ragged_bf16", 2, RAGGED_S, *gemma3_attn, True, 0,
         torch.bfloat16),
        ("gemma3_local_ragged_f32", 1, RAGGED_S, *gemma3_attn, True,
         RAGGED_S * 3 // 10, torch.float32),
    ]
    for name, B, S, H, K, hd, causal, window, dtype in attn_cases:
        q, k, v = qkv(B, S, H, K, hd, dtype)
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        bq, bk = fa.tiles(S, S, hd, dtype=dtype)
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, bq=bq, bk=bk)
        torch.cuda.synchronize()
        err = errs[name] = max_err(got, want)
        tol = TOLERANCE[dtype]
        phase("kernel_check", kernel="flash_attention", case=name,
              shape=f"B{B}xS{S}xH{H}xK{K}xhd{hd}", dtype=str(dtype)[6:],
              causal=causal, window=window, tiles=f"{bq}x{bk}",
              max_abs_err=f"{err:.3e}", tol=tol)
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        check(err <= tol, f"{name}: max abs err {err} > {tol}")
        del q, k, v, got, want

    # K4 and K5 split time into segments; each twin walks the kernel's
    # segments, so K4's h and K5's s_last must be bit-equal to it.  The
    # long cases have many more segments than the card holds at once: the
    # ticketed carry chain must make progress, and a second launch must
    # give the same bits.
    bits = {}
    for name, (B, S, W) in [
            ("rglru_prefill", (PREFILL_B, PREFILL_S, gcfg.lru_width)),
            ("rglru_ragged", (PREFILL_B, RAGGED_S, gcfg.lru_width - 60)),
            ("rglru_long", (PREFILL_B, LONG_S, gcfg.lru_width))]:
        a, b = rglru_inputs(B, S, W)
        got = ops.rglru_scan(a, b, seg=rg.DEFAULT_SEG)
        want = rg.rglru_scan_plain(a, b, seg=rg.DEFAULT_SEG)
        again = ops.rglru_scan(a, b, seg=rg.DEFAULT_SEG)
        torch.cuda.synchronize()
        err = errs[name] = max_err(got, want)
        bits[name] = {"bit_equal": bool(torch.equal(got, want)),
                      "repeat_bit_equal": bool(torch.equal(got, again))}
        phase("kernel_check", kernel="rglru_scan", case=name,
              shape=f"B{B}xS{S}xW{W}", dtype="float32", seg=rg.DEFAULT_SEG,
              max_abs_err=f"{err:.3e}", tol=RGLRU_TOL, **bits[name])
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        check(err <= RGLRU_TOL, f"{name}: max abs err {err} > {RGLRU_TOL}")
        check(all(bits[name].values()), f"{name}: h not bit-equal {bits}")
        del a, b, got, want, again

    for name, (B, S, H, hd) in [
            ("rwkv_prefill", (PREFILL_B, PREFILL_S, *rwkv_heads)),
            ("rwkv_ragged", (PREFILL_B, RAGGED_S, *rwkv_heads)),
            ("rwkv_long", (PREFILL_B, LONG_S, *rwkv_heads))]:
        ins = rwkv_inputs(B, S, H, hd)
        out, s_last = ops.rwkv6_scan(*ins, seg=rw.DEFAULT_SEG)
        want, s_want = rw.rwkv6_scan_plain(*ins, seg=rw.DEFAULT_SEG)
        out2, s_last2 = ops.rwkv6_scan(*ins, seg=rw.DEFAULT_SEG)
        torch.cuda.synchronize()
        out_err, s_err = max_err(out, want), max_err(s_last, s_want)
        err = errs[name] = max(out_err, s_err)
        bits[name] = {"bit_equal": bool(torch.equal(s_last, s_want)),
                      "repeat_bit_equal": bool(torch.equal(out, out2)
                                               and torch.equal(s_last,
                                                               s_last2))}
        phase("kernel_check", kernel="rwkv6_scan", case=name,
              shape=f"B{B}xS{S}xH{H}xhd{hd}", dtype="float32",
              seg=rw.DEFAULT_SEG, out_max_abs_err=f"{out_err:.3e}",
              s_last_max_abs_err=f"{s_err:.3e}",
              out_max_abs=f"{want.abs().max().item():.3e}", tol=RWKV_TOL,
              **bits[name])
        check(bool(torch.isfinite(out).all() and torch.isfinite(s_last).all()),
              f"{name}: non-finite output")
        check(err <= RWKV_TOL, f"{name}: max abs err {err} > {RWKV_TOL}")
        check(all(bits[name].values()),
              f"{name}: s_last not bit-equal {bits}")
        del ins, out, s_last, want, s_want, out2, s_last2
    torch.cuda.empty_cache()

    # K1 against its twin on the same operands, bit for bit in every field
    # of the state: the figures, the spinlock and the suite (also with every
    # BSYNC an oracle skip), at 4, 8 and 32 threads; 8 Bx registers with
    # majority-first, 2 without.  Two launches must give the same bits.
    def hanoi_operands(reqs, cfg, skip_pcs=None):
        L = padded_len(max(r.program.shape[0] for r in reqs))
        arrays = _batch_arrays(reqs, cfg, L)
        for i, pcs in enumerate(skip_pcs or ()):
            arrays[1][i, list(pcs)] = True
        return L, [torch.from_numpy(a).to(dev) for a in arrays]

    def state_diff(a, b):
        """The fields in which two states differ, and the largest
        difference there."""
        bad, err = [], 0
        for k in hanoi_core.HanoiState._fields:
            x, y = getattr(a, k), getattr(b, k)
            if not torch.equal(x, y):
                bad.append(k)
                err = max(err, (x.long() - y.long()).abs().max().item())
        return bad, err

    k1_checks = {}
    for W in (4, 8, 32):
        for n_bx, majority in ((8, True), (2, False)):
            cfg = MachineConfig(n_threads=W, n_bx=n_bx, max_steps=4096)
            reqs, skip_pcs = [], []
            for prog in (programs.fig5_program(), programs.fig6_program(),
                         programs.warpsync_program(W),
                         programs.spinlock_program()):
                reqs.append(SimRequest(program=prog, cfg=cfg))
                skip_pcs.append(())
            for b in programs.make_suite(cfg):
                bsyncs = np.flatnonzero(b.program[:, 0] == 4).tolist()
                for pcs in (b.skip_bsync_pcs, bsyncs):   # and every BSYNC
                    reqs.append(SimRequest(program=b.program, cfg=cfg,
                                           init_mem=b.init_mem))
                    skip_pcs.append(pcs)
            _, ins = hanoi_operands(reqs, cfg, skip_pcs)
            got = ops.hanoi_run(*ins, cfg, majority_first=majority)
            again = ops.hanoi_run(*ins, cfg, majority_first=majority)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = hanoi_core.hanoi_run_plain(*ins, cfg,
                                              majority_first=majority)
            torch.cuda.synchronize()
            twin_s = time.perf_counter() - t0
            bad, err = state_diff(got, want)
            repeat_bad, _ = state_diff(got, again)
            case = f"w{W}_bx{n_bx}_{'majority' if majority else 'minority'}"
            k1_checks[case] = {"bit_equal": not bad,
                               "repeat_bit_equal": not repeat_bad,
                               "max_abs_err": err}
            phase("kernel_check", kernel="hanoi_step", case=case,
                  warps=len(reqs), longest_warp_slots=int(
                      (cfg.max_steps - want.fuel).max()),
                  twin_s=f"{twin_s:.2f}", differing_fields=bad,
                  **k1_checks[case])
            check(not bad, f"K1 {case}: {bad} differ from the twin")
            check(not repeat_bad, f"K1 {case}: a second launch differs "
                  f"in {repeat_bad}")
            del ins, got, again, want
    torch.cuda.empty_cache()

    # 4. full-width bf16 prefills: the main paths through K3 ----------------
    tokens = torch.randint(0, 65536, (PREFILL_B, PREFILL_S), generator=gen,
                           device=dev)

    def last_logits(model, cfg, batch):
        logits, _ = prefill(model, cfg, batch)
        return logits[:, -1].float()

    def prefill_phase(arch, cfg, other_cfg, expect, check_dtype):
        """Warm up, drive the bf16 prefill as a main path, and hold the
        last-position logits of ``cfg``'s prefill against ``other_cfg``'s
        on the same weights, in ``check_dtype``.  Returns the model (bf16)
        and the main path's caches."""
        params = init_params(model_struct(cfg), gen, dtype=torch.bfloat16,
                             device=dev)
        model = Transformer(cfg, params)
        batch = {"tokens": tokens % cfg.vocab_size}
        prefill(model, cfg, batch)      # warm-up: cuBLAS plans, allocator
        (logits, caches), wall, got = run_path(
            f"{arch} prefill", lambda: prefill(model, cfg, batch), expect)
        check(logits.shape == (PREFILL_B, PREFILL_S, cfg.vocab_size),
              f"{arch} prefill logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits[:, -1]).all()),
              f"{arch}: logits not finite")
        last = logits[:, -1].float()
        del logits
        check_model = model
        if check_dtype != torch.bfloat16:
            check_model = Transformer(cfg, tree_map(
                lambda t: t.to(check_dtype), params))
            last = last_logits(check_model, cfg, batch)
        ref_last = last_logits(check_model, other_cfg, batch)
        del check_model
        err, ref_max = max_err(last, ref_last), ref_last.abs().max().item()
        rtol = PREFILL_LOGITS_RTOL[check_dtype]
        phase("prefill", arch=arch, params="bf16",
              tokens=f"{PREFILL_B}x{PREFILL_S}", launches=got,
              wall_s=f"{wall:.4f}",
              tok_per_s=f"{PREFILL_B * PREFILL_S / wall:.1f}",
              check_dtype=str(check_dtype)[6:],
              last_logits_max_abs_err=f"{err:.3e}",
              ref_logits_max_abs=f"{ref_max:.3e}", rtol=rtol)
        check(err <= rtol * ref_max,
              f"{arch} prefill: last logits differ by {err} "
              f"(largest {ref_max})")
        return model, caches

    def layer_phase(arch, model, cfg, layer_fn, sub, kernel):
        """Layer 0's temporal mix at 4 x 2048 in f32 with use_kernel=True,
        as a main path, against its plain branch on the same weights."""
        lp = getattr(model.segments[0][0], "0")
        params = Params({n: t.float()
                         for n, t in getattr(lp, sub).named_parameters()})
        with torch.inference_mode():
            x = rmsnorm(lp.ln1, embed(model.embed, tokens % cfg.vocab_size,
                                      cfg).float(), cfg.norm_eps)
            (out, state), wall, got = run_path(
                f"{arch} layer 0", lambda: layer_fn(params, x, cfg=cfg,
                                                    use_kernel=True),
                {kernel: 1})
            want, want_state = layer_fn(params, x, cfg=cfg)
        state_errs = {n: max_err(state[n], want_state[n]) for n in want_state}
        out_err = max_err(out, want)
        phase("layer", arch=arch, layer=f"0.{sub}", dtype="float32",
              shape=tuple(x.shape), launches=got, wall_s=f"{wall:.4f}",
              out_max_abs_err=f"{out_err:.3e}",
              out_max_abs=f"{want.abs().max().item():.3e}",
              state_max_abs_err={n: f"{e:.3e}" for n, e in
                                 state_errs.items()}, tol=LAYER_TOL)
        check(bool(torch.isfinite(out).all()), f"{arch} layer: not finite")
        check(max(out_err, *state_errs.values()) <= LAYER_TOL,
              f"{arch} layer 0 with use_kernel=True differs from the plain "
              f"branch: out {out_err}, state {state_errs}")

    cfg = prefill_config("llama3.2-1b", attn_impl="flash")
    model, caches = prefill_phase("llama3.2-1b", cfg,
                                  cfg.replace(attn_impl="reference"),
                                  {"flash_attention": cfg.n_layers},
                                  torch.bfloat16)
    check(caches[0]["0"]["k"].shape == (cfg.n_layers, PREFILL_B, PREFILL_S,
                                        cfg.n_kv_heads, cfg.hd),
          "llama prefill cache shape")
    del model, caches
    torch.cuda.empty_cache()

    cfg = prefill_config("recurrentgemma-2b", attn_impl="flash")
    n_local = cfg.kinds.count("local")
    model, caches = prefill_phase("recurrentgemma-2b", cfg,
                                  cfg.replace(attn_impl="reference"),
                                  {"flash_attention": n_local},
                                  torch.bfloat16)
    repeat = cfg.layer_plan[0][1]
    check(caches[0]["0"]["h"].shape == (repeat, PREFILL_B, cfg.lru_width)
          and caches[0]["2"]["k"].shape == (repeat, PREFILL_B, PREFILL_S,
                                            cfg.n_kv_heads, cfg.hd),
          "recurrentgemma prefill cache shapes")
    del caches
    layer_phase("recurrentgemma-2b", model, cfg, recurrent.rglru, "rglru",
                "rglru_scan")
    del model
    torch.cuda.empty_cache()

    # The chunked form is exact only while a chunk's summed log-decay stays
    # above its -30 clip; at this init's decays (~e^-1 a step) that holds
    # for 16-token chunks and not for the default 64.
    cfg = prefill_config("rwkv6-3b")
    model, caches = prefill_phase(
        "rwkv6-3b", cfg, cfg.replace(rwkv_impl="chunked", rwkv_chunk=16), {},
        torch.float32)
    check(caches[0]["0"]["wkv"].shape == (cfg.n_layers, PREFILL_B,
                                          *rwkv_heads, rwkv_heads[1]),
          "rwkv6 prefill cache shape")
    del caches
    layer_phase("rwkv6-3b", model, cfg, recurrent.rwkv6_time_mix, "tm",
                "rwkv6_scan")
    del model
    torch.cuda.empty_cache()

    # 5. serve: full width, f32, greedy decode of 4 requests -----------------
    for arch in ("llama3.2-1b", "recurrentgemma-2b", "rwkv6-3b"):
        serve(arch, smoke=False, batch=4, prompt_len=2, gen_len=2,
              seed=SEED, device=dev)    # warm-up: cuBLAS f32 plans
        res, _, got = run_path(f"{arch} serve", lambda: serve(
            arch, smoke=False, batch=4, prompt_len=16, gen_len=32,
            seed=SEED, device=dev), {})
        gen_tokens = res["generated"]
        phase("serve", arch=arch, params="f32", batch=4, prompt_len=16,
              gen_len=32, shape=gen_tokens.shape,
              wall_s=f"{res['wall_s']:.4f}",
              tok_per_s=f"{res['tokens_per_s']:.1f}", launches=got)
        print(f"  tokens[0]={gen_tokens[0].tolist()}")
        check(gen_tokens.shape == (4, 32), f"{arch} serve shape "
              f"{gen_tokens.shape}")
        check(bool(((gen_tokens >= 0)
                    & (gen_tokens < get_config(arch).vocab_size)).all()),
              f"{arch} serve tokens out of the vocabulary")
        torch.cuda.empty_cache()

    # 5b. the simulator at full size: one launch of K1 through run_batch ----
    sim_cfg = MachineConfig(n_threads=32, mem_size=256, max_steps=60_000)
    suite = programs.make_suite(sim_cfg)
    # warp w runs the suite's program w mod 23 on memory drawn by the
    # suite's own generator from SEED + w.  A program the suite runs on
    # zeroed memory (the spinlock, CALLS, the figures) keeps it: a spinlock
    # whose lock word starts taken spins until its 60,000 slots are spent.
    reqs = [SimRequest(program=b.program, cfg=sim_cfg, name=b.name,
                       init_mem=None if b.init_mem is None
                       else programs._mem(sim_cfg, SEED + w))
            for w, b in ((w, suite[w % len(suite)])
                         for w in range(SIM_WARPS))]
    sim = Simulator()
    warm = sim.run_batch(reqs[:len(suite)], mechanism="hanoi_torch")
    results, sim_wall, got = run_path(
        "simulator run_batch",
        lambda: sim.run_batch(reqs, mechanism="hanoi_torch"),
        {"hanoi_run": 1})
    check(len(results) == SIM_WARPS, "run_batch lost results")
    L, ins = hanoi_operands(reqs, sim_cfg)
    k1_state = ops.hanoi_run(*ins, sim_cfg)       # the kernel's whole state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    twin = hanoi_core.hanoi_run_plain(*ins, sim_cfg)
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t0
    bad, k1_err = state_diff(k1_state, twin)
    check(not bad, f"K1 at full size: {bad} differ from the twin")
    # run_batch's results against the twin, warp by warp
    n = twin.trace_n.long()
    width = int(n.max())
    keep = torch.arange(width, device=dev) < n.unsqueeze(1)
    twin_pcs = twin.trace_pc[:, :width][keep].cpu().numpy()
    twin_masks = twin.trace_mask[:, :width][keep].cpu().numpy() \
        .view(np.uint32)
    host = {k: getattr(twin, k).cpu().numpy() for k in
            ("regs", "preds", "mem", "finished", "steps", "fuel", "error")}
    got_pcs = np.fromiter((pc for r in results for pc, _ in r.trace),
                          np.int64, int(n.sum()))
    got_masks = np.fromiter((m for r in results for _, m in r.trace),
                            np.int64, int(n.sum()))
    check(np.array_equal(got_pcs, twin_pcs)
          and np.array_equal(got_masks, twin_masks)
          and [len(r.trace) for r in results] == n.tolist(),
          "run_batch traces differ from the twin's")
    for f, k in (("regs", "regs"), ("preds", "preds"), ("mem", "mem")):
        check(np.array_equal(np.stack([getattr(r, f) for r in results]),
                             host[k]), f"run_batch {f} differ from the twin")
    check([(r.finished, r.steps, r.fuel_left, r.error is None)
           for r in results]
          == [(int(a), int(b), int(c), int(d) == 0) for a, b, c, d in zip(
              host["finished"], host["steps"], host["fuel"],
              host["error"])], "run_batch counters differ from the twin")
    # one warp of each program against the numpy run_hanoi, timed
    t0 = time.perf_counter()
    refs = [interp.run_hanoi(r.program, sim_cfg, init_mem=r.init_mem)
            for r in reqs[:len(suite)]]
    numpy_s = time.perf_counter() - t0
    for r, ref in zip(results, refs):
        check(r.trace == tuple(ref.trace)
              and np.array_equal(r.regs, ref.regs)
              and np.array_equal(r.preds, ref.preds)
              and np.array_equal(r.mem, ref.mem)
              and (r.finished, r.steps, r.fuel_left)
              == (ref.finished, ref.steps, ref.fuel_left),
              f"{r.mechanism} {reqs[results.index(r)].name} differs from "
              "the numpy run_hanoi")
    slots = (sim_cfg.max_steps - twin.fuel).long()
    numpy_slots = sum(sim_cfg.max_steps - ref.fuel_left for ref in refs)
    k1_ms = cuda_time_ms(lambda: ops.hanoi_run(*ins, sim_cfg), 5, warmup=1)
    # the trace buffers' -1 / 0 fill alone, as PyTorch's fill kernels do it
    fill_ms = cuda_time_ms(lambda: (k1_state.trace_pc.fill_(-1),
                                    k1_state.trace_mask.fill_(0)), 5)
    k1_bytes = hs.run_bytes(k1_state, L)
    t_bytes = k1_bytes / PEAK_BYTES_PER_S * 1e3
    t_slots = int(slots.max()) * SLOT_CYCLES / CLOCK_HZ * 1e3
    k1_bound = (max(t_bytes, t_slots),
                "bytes" if t_bytes >= t_slots else "operations")
    sim_numbers = {
        "warps": SIM_WARPS, "cfg": dict(sim_cfg._asdict()), "L": L,
        "slots": int(slots.sum()), "longest_warp_slots": int(slots.max()),
        "run_batch_wall_s": sim_wall,
        "run_batch_exec_s": sum(r.wall_time_s for r in results),
        "warps_per_s": SIM_WARPS / sim_wall,
        "slots_per_s": int(slots.sum()) / sim_wall,
        "k1_ms": k1_ms, "twin_s": twin_s, "trace_fill_ms": fill_ms,
        "numpy_run_hanoi_s": numpy_s,
        "numpy_host_slots_per_s": numpy_slots / numpy_s,
        "k1_bytes": k1_bytes, "bound_ms_bytes": t_bytes,
        "bound_ms_slots": t_slots,
        "smem_per_cta": hs.smem_bytes(sim_cfg, L)}
    phase("simulator", mechanism="hanoi_torch", launches=got,
          statuses=dict(collections.Counter(r.status.value for r in results)),
          **{k: (f"{v:.4f}" if isinstance(v, float) else v)
             for k, v in sim_numbers.items()})
    del warm, results, k1_state, twin, ins, host, got_pcs, got_masks
    torch.cuda.empty_cache()

    # 5c. Fig 9 through compare, on the card ------------------------------------
    groups = len(plan_dispatch(get_mechanism("hanoi_torch"), [
        as_request(b, sim_cfg) for b in suite]))
    same, _, got = run_path(
        "fig9 hanoi_torch vs hanoi",
        lambda: sim.compare(["hanoi_torch", "hanoi"], timing=False),
        {"hanoi_run": groups})
    check(len(same.rows) == 2 * len(suite)
          and all(r.discrepancy == 0.0 for r in same.rows),
          "hanoi_torch and hanoi traces differ")
    oracle, _, got = run_path(
        "fig9 hanoi_torch vs turing_oracle",
        lambda: sim.compare("hanoi_torch", baseline="turing_oracle",
                            timing=False), {"hanoi_run": groups})
    ref = sim.compare("hanoi", baseline="turing_oracle", timing=False)
    rows = oracle.pair("hanoi_torch", "turing_oracle")
    ref_rows = ref.pair("hanoi", "turing_oracle")
    check([(r.program, r.discrepancy) for r in rows]
          == [(r.program, r.discrepancy) for r in ref_rows],
          "hanoi_torch's Fig 9 rows differ from the numpy hanoi's")
    fig9_mean = oracle.mean_discrepancy("hanoi_torch", "turing_oracle")
    phase("fig9", pair="hanoi_torch/turing_oracle", launches=got,
          mean_discrepancy_pct=f"{100 * fig9_mean:.4f}", paper_pct=1.03,
          rows={r.program: f"{100 * r.discrepancy:.4f}" for r in rows},
          hanoi_torch_vs_hanoi_max=max(r.discrepancy for r in same.rows))

    # 6. kernel times at the main paths' shapes ------------------------------
    def attention_times(B, S, H, K, hd, window):
        q, k, v = qkv(B, S, H, K, hd, torch.bfloat16)
        bq, bk = fa.tiles(S, S, hd, dtype=torch.bfloat16)
        ms = cuda_time_ms(lambda: ops.flash_attention(
            q, k, v, causal=True, window=window), 20)
        plain_ms = cuda_time_ms(lambda: fa.flash_attention_plain(
            q, k, v, causal=True, window=window, bq=bq, bk=bk), 5, warmup=1)
        # a window that reaches past S leaves the causal mask SDPA takes
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = None
        if 0 < window < S:
            i = torch.arange(S, device=dev)
            diff = i[:, None] - i[None, :]
            mask = (diff >= 0) & (diff < window)
        library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=mask is None,
            enable_gqa=True), 20)
        flops = fa.attention_flops(B, S, S, H, hd, causal=True,
                                   window=window)
        nbytes = fa.attention_bytes(q, k, v)
        bound_ms, bound_by = bound(flops, nbytes, torch.bfloat16)
        shape = f"B{B}xS{S}xH{H}xK{K}xhd{hd}"
        phase("kernel_time", kernel="flash_attention", shape=shape,
              dtype="bf16", window=window, ms=f"{ms:.4f}",
              plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
              flops=flops, bytes=nbytes, bound_ms=f"{bound_ms:.4f}",
              bound_by=bound_by, roofline_share=f"{bound_ms / ms:.4f}")
        return {"shape": shape, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms}

    attn_llama = attention_times(PREFILL_B, PREFILL_S, *llama_attn, 0)
    attn_rgemma = attention_times(PREFILL_B, PREFILL_S, *rgemma_attn,
                                  gcfg.window_size)
    attn_hd128 = attention_times(PREFILL_B, PREFILL_S, *hd128_attn, 0)
    attn_gemma3 = attention_times(PREFILL_B, PREFILL_S, *gemma3_attn,
                                  gemma3_window)

    # K4 and K5 at the prefill shape, at their default segment length and
    # at the others the kernels take (the sweep the defaults come from)
    def scan_sweep(kernel, fn, segs, iters):
        sweep = {seg: cuda_time_ms(lambda: fn(seg), iters) for seg in segs}
        phase("kernel_sweep", kernel=kernel,
              ms={seg: f"{ms:.4f}" for seg, ms in sweep.items()})
        return sweep

    a, b = rglru_inputs(PREFILL_B, PREFILL_S, gcfg.lru_width)
    rglru_shape = f"B{PREFILL_B}xS{PREFILL_S}xW{gcfg.lru_width}"
    rglru_sweep = scan_sweep(
        "rglru_scan", lambda seg: ops.rglru_scan(a, b, seg=seg),
        (4, 8, rg.DEFAULT_SEG, rg.MAX_SEG), 20)
    rglru_ms = cuda_time_ms(lambda: ops.rglru_scan(a, b), 20)
    rglru_plain_ms = cuda_time_ms(lambda: rg.rglru_scan_plain(a, b), 3,
                                  warmup=1)
    rglru_bound = bound(rg.scan_flops(a), rg.scan_bytes(a), torch.float32)
    rglru_scratch = sum(4 * n for n in rg.scratch_shape(
        PREFILL_B, PREFILL_S, gcfg.lru_width, rg.DEFAULT_SEG))
    phase("kernel_time", kernel="rglru_scan", shape=rglru_shape,
          dtype="float32", seg=rg.DEFAULT_SEG, ms=f"{rglru_ms:.4f}",
          plain_ms=f"{rglru_plain_ms:.4f}", library_ms=None,
          flops=rg.scan_flops(a), bytes=rg.scan_bytes(a),
          scratch_bytes=rglru_scratch, bound_ms=f"{rglru_bound[0]:.4f}",
          bound_by=rglru_bound[1],
          roofline_share=f"{rglru_bound[0] / rglru_ms:.4f}")
    del a, b

    ins = rwkv_inputs(PREFILL_B, PREFILL_S, *rwkv_heads)
    rwkv_shape = "B{}xS{}xH{}xhd{}".format(PREFILL_B, PREFILL_S, *rwkv_heads)
    rwkv_sweep = scan_sweep(
        "rwkv6_scan", lambda seg: ops.rwkv6_scan(*ins, seg=seg),
        (16, 32, rw.DEFAULT_SEG, 128), 10)
    rwkv_ms = cuda_time_ms(lambda: ops.rwkv6_scan(*ins), 10)
    rwkv_plain_ms = cuda_time_ms(lambda: rw.rwkv6_scan_plain(*ins), 2,
                                 warmup=1)
    rwkv_bound = bound(rw.scan_flops(ins[0]), rw.scan_bytes(ins[0]),
                       torch.float32)
    rwkv_scratch = sum(4 * n for n in rw.scratch_shape(
        PREFILL_B, PREFILL_S, *rwkv_heads, rw.DEFAULT_SEG))
    phase("kernel_time", kernel="rwkv6_scan",
          shape=rwkv_shape, dtype="float32", seg=rw.DEFAULT_SEG,
          ms=f"{rwkv_ms:.4f}", plain_ms=f"{rwkv_plain_ms:.4f}",
          library_ms=None, flops=rw.scan_flops(ins[0]),
          bytes=rw.scan_bytes(ins[0]), scratch_bytes=rwkv_scratch,
          bound_ms=f"{rwkv_bound[0]:.4f}", bound_by=rwkv_bound[1],
          roofline_share=f"{rwkv_bound[0] / rwkv_ms:.4f}")
    del ins

    # 7. kernels line, device line -------------------------------------------
    no_library = ("no single PyTorch call computes this recurrence "
                  "(torch has no scan)")
    print(json.dumps({"kernels": [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:110",
         "launches": sum(launches["flash_attention"].values()),
         "launches_by_path": launches["flash_attention"],
         "max_abs_err": errs["llama_causal_bf16"], **attn_llama,
         "hd256": {"max_abs_err": errs["rgemma_bf16"], **attn_rgemma},
         "hd128": {"max_abs_err": errs["hd128_bf16"], **attn_hd128},
         "hd320": {"max_abs_err": errs["gemma3_local_bf16"],
                   **attn_gemma3}},
        {"name": "rglru_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru_scan.py:46",
         "launches": sum(launches["rglru_scan"].values()),
         "launches_by_path": launches["rglru_scan"],
         "max_abs_err": errs["rglru_prefill"],
         "shape": rglru_shape, "seg": rg.DEFAULT_SEG,
         "ms": rglru_ms, "plain_ms": rglru_plain_ms,
         "bound_ms": rglru_bound[0], "bound_by": rglru_bound[1],
         "library_ms": None, "library_note": no_library,
         "sweep_ms": rglru_sweep, "scratch_bytes": rglru_scratch,
         "ptxas": ptxas["rglru_scan"],
         **{case: bits[case] for case in bits if case.startswith("rglru")}},
        {"name": "rwkv6_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/rwkv6_scan.cu",
         "replaces": "src/repro/kernels/rwkv6_scan.py:52",
         "launches": sum(launches["rwkv6_scan"].values()),
         "launches_by_path": launches["rwkv6_scan"],
         "max_abs_err": errs["rwkv_prefill"],
         "shape": rwkv_shape, "seg": rw.DEFAULT_SEG,
         "ms": rwkv_ms, "plain_ms": rwkv_plain_ms,
         "bound_ms": rwkv_bound[0], "bound_by": rwkv_bound[1],
         "library_ms": None, "library_note": no_library,
         "sweep_ms": rwkv_sweep, "scratch_bytes": rwkv_scratch,
         "ptxas": ptxas["rwkv6_scan"],
         **{case: bits[case] for case in bits if case.startswith("rwkv")}},
        {"name": "hanoi_step", "route": "cuda",
         "source": "src/repro_torch/csrc/hanoi_step.cu",
         "replaces": "src/repro/core/hanoi.py:470",
         "launches": sum(launches["hanoi_run"].values()),
         "launches_by_path": launches["hanoi_run"],
         "max_abs_err": k1_err,
         "shape": f"{SIM_WARPS} warps x 32 threads, max_steps 60000",
         "ms": k1_ms, "plain_ms": twin_s * 1e3,
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
         "library_ms": None,
         "library_note": "no PyTorch call interprets a program",
         "ptxas": ptxas["hanoi_step"], "checks": k1_checks,
         "simulator": sim_numbers, "fig9_mean_discrepancy": fig9_mean},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
