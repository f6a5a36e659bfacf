"""Kernel benchmarks: divergence-aware tile census per assigned-arch
attention pattern (the Hanoi EMPTY/PARTIAL/FULL saving at tile
granularity), warp-level SIMD utilization per control-flow mechanism (via
the unified :mod:`repro_torch.engine` API — the same EMPTY/PARTIAL/FULL
economics one level down), and kernel times at the reference's shapes.

Port of the repo's ``benchmarks/bench_kernels.py``.  Where the reference
times its Pallas kernels in interpret mode against their jnp references on
the CPU, this times the hand-written kernels K3 (flash attention), K4
(RG-LRU scan) and K5 (RWKV-6 wkv scan) on the card, with CUDA events,
beside their plain twins on the same tensors.  With ``device="cpu"`` it
times the twins only, on the host clock, and the row names say so.

Run:  PYTHONPATH=src python -m repro_torch.benchmarks.bench_kernels \\
          [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.device import resolve
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import rwkv6_scan as rw
from repro_torch.kernels.flash_attention import tile_stats


def tile_census_rows() -> list[dict]:
    cases = [
        ("llama/minitron/internlm causal 4k", 4096, 4096, True, 0),
        ("gemma3 local (w=1024) 4k", 4096, 4096, True, 1024),
        ("gemma3 local (w=1024) 32k", 32768, 32768, True, 1024),
        ("mixtral SWA (w=4096) 32k", 32768, 32768, True, 4096),
        ("recurrentgemma local (w=2048) 32k", 32768, 32768, True, 2048),
        ("hubert bidirectional 32k", 32768, 32768, False, 0),
    ]
    rows = []
    for name, sq, sk, causal, w in cases:
        st = tile_stats(sq, sk, causal=causal, window=w, bq=128, bk=128)
        rows.append({"case": name, **st})
    return rows


def mechanism_utilization_rows(device=None) -> list[dict]:
    """Warp-level SIMD utilization of each control-flow mechanism on the
    divergence-heavy BFS benchmark — the lane-granularity analogue of the
    tile census above, computed through the unified engine API.  The
    device mechanisms (``hanoi_torch``, ``sm_torch``) run on ``device``."""
    from repro_torch.core import MachineConfig
    from repro_torch.core.programs import make_suite
    from repro_torch.engine import Simulator, available_mechanisms

    cfg = MachineConfig(n_threads=8, mem_size=64, max_steps=8192)
    bench = next(b for b in make_suite(cfg, datasets=1) if b.name == "BFSD")
    sim = Simulator(device=device)
    rows = []
    for mech in available_mechanisms():
        res = sim.run(bench, cfg, mechanism=mech)
        rows.append({"mechanism": mech, "utilization": res.utilization,
                     "steps": res.steps, "status": res.status.value})
    return rows


def _time_us(fn, dev: torch.device, reps: int = 3) -> float:
    """Mean µs of one call of ``fn`` after one warm-up call: CUDA events
    around ``reps`` calls on the card, the host clock on the CPU."""
    fn()
    if dev.type == "cpu":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e6
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps * 1e3


def kernel_timing_rows(device=None) -> list[dict]:
    """K3, K4 and K5 at the reference's shapes, each beside its plain twin
    on the same inputs.  On the CPU only the twins run."""
    dev = resolve(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    on_card = dev.type != "cpu"

    def pair(name, kernel, plain, reps):
        if on_card:
            return [{"kernel": f"{name}(cuda)",
                     "us": _time_us(kernel, dev, reps)},
                    {"kernel": f"{name}(plain)",
                     "us": _time_us(plain, dev, 1)}]
        return [{"kernel": f"{name}(plain on cpu)",
                 "us": _time_us(plain, dev, 1)}]

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    rows = []
    B, S, H, hd = 1, 256, 4, 64
    q, k, v = normal(B, S, H, hd), normal(B, S, H, hd), normal(B, S, H, hd)
    rows += pair("flash_attention",
                 lambda: ops.flash_attention(q, k, v, causal=True, bq=64,
                                             bk=64),
                 lambda: fa.flash_attention_plain(q, k, v, causal=True,
                                                  bq=64, bk=64), 20)
    a, b = uniform(0.5, 0.99, 2, 256, 128), normal(2, 256, 128)
    rows += pair("rglru_scan", lambda: ops.rglru_scan(a, b),
                 lambda: rg.rglru_scan_plain(a, b), 20)
    r = normal(1, 128, 2, 16)
    w = uniform(0.8, 0.99, 1, 128, 2, 16)
    u = normal(2, 16) * 0.1
    rows += pair("rwkv6_scan", lambda: ops.rwkv6_scan(r, r, r, w, u),
                 lambda: rw.rwkv6_scan_plain(r, r, r, w, u), 20)
    return rows


def main(argv: "list[str] | None" = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain twins)")
    args = ap.parse_args(argv)
    print("== divergence-aware tile census (Hanoi EMPTY-tile skipping) ==")
    for r in tile_census_rows():
        print(f"  {r['case']:38s} kept={r['flops_kept_frac']:6.1%} "
              f"(empty={r['empty']}, partial={r['partial']}, "
              f"full={r['full']})")
    print("== SIMD utilization per mechanism (BFSD, repro_torch.engine) ==")
    for r in mechanism_utilization_rows(args.device):
        print(f"  {r['mechanism']:14s} util={r['utilization']:6.1%} "
              f"steps={r['steps']:5d} status={r['status']}")
    print("== kernel times (CUDA events on the card; the host clock for "
          "the plain twins on the CPU) ==")
    for r in kernel_timing_rows(args.device):
        print(f"  {r['kernel']:28s} {r['us']:12.1f} us")


if __name__ == "__main__":
    main()
