"""The harness on the CPU: discovery by name, the limits on names, units
and entries of ``BENCHMARK.json``, and the shape of a run's last line."""
from __future__ import annotations

import json
import re
import time

import pytest

from chipbench import harness
from chipbench.tests.smoke_root import ROOT, make_root

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LIMITS = {"gap_mean": 10.0, "cache_err_first": 1.0}
# The result object's keys, in order: the driver's five, ``breakdown`` in a
# traced run, and last the numbers compared, each beside its limit.
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(root, workload, trace=False, seconds=0.2):
    return harness.execute(workload, 2 ** 31 + 11, seconds, trace, root=root,
                           t_start=time.perf_counter(), device="cpu")


def test_benchmark_json_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
    for e in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for e in BENCH["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    for e in BENCH["per_layer"]:
        assert set(e) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("chipbench/")
        assert (ROOT / c["file"]).is_file()
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert (ROOT / "chipbench" / "traffic"
                / f"{w['traffic']}.json").is_file()
    for text in [c["why"] for c in BENCH["configs"] + BENCH["workloads"]] \
            + [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"] == ["python3", "chipbench/run.py"]
    assert BENCH["paths"] == ["chipbench"]


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        cell = harness.find_cell(ROOT, w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e
        for m in cell.end_to_end + cell.per_layer:
            assert harness.reader(m["name"], ROOT / "chipbench")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= cells


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_has_the_result_keys(tmp_path, trace):
    root = make_root(tmp_path, LIMITS)
    run, line = _run(root, "rwkv6-3b.smoke", trace=trace)
    out = json.loads(line)
    assert list(out) == LINE_KEYS + (["breakdown"] if trace else []) \
        + ["checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] == run.steps * 2
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for name, c in out["checks"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    if trace:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(out["device"])


def test_a_new_cell_config_and_metric_are_found_by_name(tmp_path):
    """A later PR adds files and entries, and edits no file."""
    root = make_root(tmp_path, LIMITS)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    conf = json.loads((root / "chipbench/configs/rwkv6-3b-smoke.json")
                      .read_text())
    conf["name"] = "rwkv-other"
    (root / "chipbench/configs/rwkv-other.json").write_text(json.dumps(conf))
    (root / "chipbench/traffic/other.json").write_text(json.dumps({
        "kind": "closed_prefill", "batch": 1, "seq": 40, "pool": 2,
        "warmup_steps": 1, "check_requests": 1, "trace_steps": 1}))
    (root / "chipbench/metrics/answer_s.py").write_text(
        "def read(run):\n    return 42.0 + run.cell.traffic['seq']\n")
    bench["configs"].append({"name": "rwkv-other", "source": "-",
                             "file": "chipbench/configs/rwkv-other.json",
                             "reduced": [], "why": "t"})
    bench["workloads"].append({"name": "rwkv-other.other",
                               "config": "rwkv-other", "traffic": "other",
                               "chips": 1, "why": "t"})
    bench["end_to_end"].append({"name": "answer_s", "unit": "s",
                                "better": "lower", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["rwkv-other.other"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    _, line = _run(root, "rwkv-other.other")
    assert json.loads(line)["metrics"]["answer_s"]["value"] == 82.0
    _, line = _run(root, "rwkv6-3b.smoke")
    assert "answer_s" not in json.loads(line)["metrics"]


def test_unknown_names_fail(tmp_path):
    root = make_root(tmp_path, LIMITS)
    with pytest.raises(KeyError):
        harness.find_cell(root, "no-such-cell")
    with pytest.raises(FileNotFoundError):
        harness.load_module("metrics", "no_such_metric", root / "chipbench")


def test_no_card_exits_nonzero_and_prints_no_result(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", BENCH["workloads"][0]["name"],
                       "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_sample_is_drawn_from_the_seed():
    from chipbench.check import sample
    a = sample(2 ** 31 + 5, 120, 4, 4)
    assert a == sample(2 ** 31 + 5, 120, 4, 4) != sample(6, 120, 4, 4)
    assert len(set(a)) == 4 and any(i // 4 == 119 for i in a)
    assert sample(1, 3, 1, 1) == [2]
