"""The port's benchmarks and quickstart (``repro_torch.benchmarks``,
``repro_torch.examples.quickstart``) on the CPU against the repo's
``benchmarks/`` and ``examples/``: every ported table row equal to the
reference's on the same inputs, with the device mechanisms' names mapped
(``hanoi_jax`` -> ``hanoi_torch``, ``sm_jax`` -> ``sm_torch``), at a
reduced grid where the reference's is slow; the gates of ``bench_sm`` and
``bench_timing``; ``run``'s rows and names; the quickstart to its end.

The device mechanisms run their plain twins here (``device="cpu"``);
integer results are exact, so rows compare with ``==``.  The reference
benchmarks are loaded from their files.  The machine with the card has no
JAX: there this module skips as a whole."""
import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytest.importorskip("jax")

from repro_torch.benchmarks import bench_control_flow as tbcf   # noqa: E402
from repro_torch.benchmarks import bench_kernels as tbk         # noqa: E402
from repro_torch.benchmarks import bench_sm as tbsm             # noqa: E402
from repro_torch.benchmarks import bench_timing as tbt          # noqa: E402
from repro_torch.benchmarks import run as trun                  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
NAMES = {"hanoi_jax": "hanoi_torch", "sm_jax": "sm_torch"}


def _reference(name):
    """The repo's ``benchmarks/<name>.py``, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def rbcf():
    return _reference("bench_control_flow")


@pytest.fixture(scope="module")
def rbk():
    return _reference("bench_kernels")


@pytest.fixture(scope="module")
def ref_mech_rows(rbk):
    return rbk.mechanism_utilization_rows()


def _reference_census():
    """The reference's ``tile_census_rows``, its tiles classified by the
    reference's own ``_tile_class`` over the whole grid at once (its
    ``tile_stats`` calls it a tile at a time: ~50 s for these cases)."""
    import jax.numpy as jnp
    from repro.kernels import flash_attention as jfa
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
        grid = (-(-sq // 128), -(-sk // 128))
        qs = jnp.arange(grid[0])[:, None] * 128
        ks = jnp.arange(grid[1])[None, :] * 128
        empty, full = (jnp.broadcast_to(a, grid) for a in jfa._tile_class(
            qs, ks, 128, 128, causal=causal, window=w, kv_len=sk))
        n_empty = int(empty.sum())
        n_full = int((full & ~empty).sum())
        total = int(empty.size)
        n_partial = total - n_empty - n_full
        rows.append({"case": name, "total": total, "empty": n_empty,
                     "full": n_full, "partial": n_partial,
                     "flops_kept_frac": (n_full + n_partial) / total,
                     "mask_overhead_frac":
                     n_partial / max(1, n_full + n_partial)})
    return rows


@pytest.fixture(scope="module")
def report():
    return tbcf.compare_report(CPU)


def test_control_flow_tables_equal_reference(rbcf, report):
    assert report.mechanisms == ("hanoi_torch", "turing_oracle")
    assert tbcf.trace_discrepancy_rows(report) \
        == rbcf.trace_discrepancy_rows()
    assert tbcf.ipc_rows(report) == rbcf.ipc_rows()
    want = rbcf.summary()
    assert tbcf.summary(report) == want
    assert want["executions"] == 23 and want["nonzero_benches"] == ["BFSD"]


def test_control_flow_numpy_hanoi_gives_the_same_tables(report):
    host = tbcf.compare_report(CPU, mechanism="hanoi")
    assert tbcf.trace_discrepancy_rows(host) \
        == tbcf.trace_discrepancy_rows(report)
    assert tbcf.ipc_rows(host) == tbcf.ipc_rows(report)


def test_hw_cost_rows_equal_reference(rbcf):
    assert tbcf.hw_cost_rows() == rbcf.hw_cost_rows()


def test_engine_throughput_measures_both_arms():
    thr = tbcf.engine_throughput(n_warps=4, reps=1, device=CPU)
    assert thr["n_warps"] == 4
    assert thr["torch_warps_per_s"] > 0 and thr["numpy_warps_per_s"] > 0
    assert thr["speedup"] == pytest.approx(
        thr["torch_warps_per_s"] / thr["numpy_warps_per_s"])


def test_sm_sweep_rows_equal_reference_on_a_slice():
    rbsm = _reference("bench_sm")
    kw = dict(benches=("GAUS0", "DIAMOND"), warp_counts=(1, 4))
    want = rbsm.sm_sweep_rows(**kw)
    got = tbsm.sm_sweep_rows(**kw, device=CPU)
    assert got == want and len(got) == 16
    assert tbsm.occupancy_summary(got) == rbsm.occupancy_summary(want)


def test_sm_torch_smoke_small_grid_is_bit_equal():
    res = tbsm.sm_torch_smoke(benches=("GAUS0", "DIAMOND"), timed_cells=8,
                              device=CPU)
    assert res["mismatches"] == []
    assert res["equality_cells"] == 6 and res["cells"] == 8
    assert len(res["policies"]) == 3
    # three equality groups (one a policy) and the timed grid's one, twice
    assert res["sm_torch_batches"] == 5
    assert res["ok"] == (res["speedup"] >= res["min_speedup"] == 10.0)


def test_bench_timing_smoke_gates(capsys):
    assert tbt.main(["--smoke", "--device", CPU]) == 0
    out = capsys.readouterr().out
    assert out.count("[gate]") == 3
    assert tbt.GATE_EVENTS_PER_S == _reference("bench_timing") \
        .GATE_EVENTS_PER_S == 20_000


def test_tile_census_rows_equal_reference():
    from repro.kernels import flash_attention as jfa
    want = _reference_census()
    # the whole-grid classification is the reference's tile_stats
    assert want[1] == {"case": want[1]["case"], **jfa.tile_stats(
        4096, 4096, causal=True, window=1024, bq=128, bk=128)}
    assert tbk.tile_census_rows() == want


def test_mechanism_utilization_rows_equal_reference(ref_mech_rows):
    want = [{**r, "mechanism": NAMES.get(r["mechanism"], r["mechanism"])}
            for r in ref_mech_rows]
    assert tbk.mechanism_utilization_rows(CPU) == want
    assert {r["mechanism"] for r in want} >= set(NAMES.values())


def test_kernel_timing_rows_name_the_twins_on_cpu():
    rows = tbk.kernel_timing_rows(CPU)
    assert [r["kernel"] for r in rows] == [
        "flash_attention(plain on cpu)", "rglru_scan(plain on cpu)",
        "rwkv6_scan(plain on cpu)"]
    assert all(r["us"] > 0 for r in rows)


def test_run_engine_api_equals_reference(capsys):
    want = _reference("run").engine_api_smoke()
    got = trun.engine_api_smoke(CPU)
    assert [(n, d) for n, _, d in got] == [(n, d) for n, _, d in want]
    trun.main(["--engine-api", "--device", CPU])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert out[1].startswith("engine_api_smoke,")
    assert out[1].split(",", 2)[2] == want[0][2]
    assert out[2].startswith("# total")


def test_run_rows_have_the_reference_names_and_values(rbcf,
                                                      ref_mech_rows):
    rows = trun.all_rows(CPU)
    s = rbcf.summary()
    h8 = next(r for r in rbcf.hw_cost_rows() if r["n_bx"] == 8)
    want = [
        ("fig9_trace_discrepancy",
         f"avg={s['avg_discrepancy_pct']:.2f}%;"
         f"zero={s['zero_discrepancy']}/{s['executions']}"),
        ("fig10_ipc_delta",
         f"avg_abs={s['avg_abs_ipc_delta_pct']:.2f}%;"
         f"bfsd_gain={s['bfsd_ipc_gain_pct']:.1f}%;"
         f"bfsd_util_gain={s['bfsd_util_gain_pct']:.1f}%"),
        ("sec9a_hw_cost",
         f"hanoi={h8['hanoi_bytes']}B;simt={h8['simt_stack_bytes']}B;"
         f"saving={h8['saving_frac']:.1%}"),
        ("engine_throughput", None),
        ("engine_api_smoke", _reference("run").engine_api_smoke()[0][2]),
        *((f"tiles[{r['case']}]",
           f"kept={r['flops_kept_frac']:.3f};"
           f"partial={r['partial']};empty={r['empty']}")
          for r in _reference_census()),
        *((f"mech_util[{NAMES.get(r['mechanism'], r['mechanism'])}]",
           f"util={r['utilization']:.3f};steps={r['steps']}")
          for r in ref_mech_rows),
        *((f"kernel[{k}(plain on cpu)]", "")
          for k in ("flash_attention", "rglru_scan", "rwkv6_scan")),
    ]
    assert [n for n, _, _ in rows] == [n for n, _ in want]
    for (name, us, derived), (_, expect) in zip(rows, want):
        assert us >= 0, name
        if expect is not None:
            assert derived == expect, name
    thr = rows[3][2]
    assert thr.startswith("torch=") and ";numpy=" in thr \
        and thr.endswith("x")


def test_quickstart_runs_to_its_end():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.quickstart",
         "--device", CPU], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env={"PYTHONPATH": str(ROOT / "src"),
                          "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    out = res.stdout
    assert out.rstrip().endswith("quickstart OK")
    for section in ("=== spinlock (Fig 3/7) ===",
                    "=== sm_torch: one K1 + one K2 launch",
                    "=== process tier: 2 shards",
                    "warm restart:", "serve-time misses=0",
                    "=== annotation synthesis"):
        assert section in out, section


def test_benchmarks_run_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        tbcf.compare_report()
    with pytest.raises(RuntimeError, match="GPU"):
        tbk.kernel_timing_rows()
    with pytest.raises(RuntimeError, match="GPU"):
        trun.engine_api_smoke()
