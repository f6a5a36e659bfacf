"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
references load nothing of the program.  Module names are compared whole
by their top-level part: the program's ``repro_torch`` is not the JAX
package's ``repro``."""
from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "chipbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _modules() -> list[str]:
    """Every module under chipbench/ but its tests, as a dotted name."""
    out = []
    for p in sorted(BENCH.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        if "tests" in rel.parts:
            continue
        out.append(".".join(rel.parts))
    return out


def _loaded_after(code: str) -> set[str]:
    prog = (f"import sys; sys.path[:0] = [{str(ROOT / 'src')!r}, "
            f"{str(ROOT)!r}]\n{code}\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    res = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, cwd=ROOT, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


def test_every_module_imports_without_jax():
    code = "import importlib\nfor m in %r:\n    importlib.import_module(m)" \
        % (_modules(),)
    assert not _loaded_after(code) & FORBIDDEN


def test_a_run_loads_no_jax():
    """A whole run of a smoke cell on the CPU, program included: what the
    harness's own check reads after the window."""
    code = (
        "import tempfile, time\nfrom pathlib import Path\n"
        "from chipbench.tests.smoke_root import make_root\n"
        "from chipbench import harness\n"
        "root = make_root(Path(tempfile.mkdtemp()), "
        "{'gap_mean': 10.0, 'cache_err_first': 1.0})\n"
        "for w in ('deepseek-moe-16b.smoke', 'rwkv6-3b.smoke'):\n"
        "    run, line = harness.execute(w, 1, 0.2, False, root=root,\n"
        "        t_start=time.perf_counter(), device='cpu')\n"
        "    assert run.correct, line\n"
        "assert not harness.forbidden_modules()")
    loaded = _loaded_after(code)
    assert "repro_torch" in loaded
    assert not loaded & FORBIDDEN


def test_references_load_nothing_of_the_program():
    refs = sorted(p for p in (BENCH / "reference").glob("*.py"))
    for p in refs:
        for node in ast.walk(ast.parse(p.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {"repro_torch"}, \
                    (p.name, n)
    code = "\n".join(f"import chipbench.reference.{p.stem}" for p in refs)
    loaded = _loaded_after(code)
    assert not loaded & (FORBIDDEN | {"repro_torch"})
