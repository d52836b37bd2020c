"""The benchmark's files: names, lookup by name, imports, and the frozen copies."""

import ast
import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from conftest import BENCH, bench_json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_and_units_use_only_the_allowed_characters():
    b = bench_json()
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["config"] for w in b["workloads"]] + [w["traffic"] for w in b["workloads"]]
    names += [k for c in b["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in b["end_to_end"] + b["per_layer"])
    for text in ([w["why"] for w in b["workloads"]] + [c["source"] for c in b["configs"]]
                 + [m["layer"] for m in b["per_layer"]] + b["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", [w["name"] for w in bench_json()["workloads"]])
def test_every_cell_finds_its_files_by_name(cell):
    from lib import cells

    c = cells.load(cell)
    assert c.config["name"] == c.entry["config"]
    assert cells.job(c).run and cells.reference(c).check
    assert c.limits, f"no limits for {cell}"
    for m in c.per_layer:
        assert cells.reader(m["name"]).read


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_is_new_files_and_one_new_entry(tmp_path):
    """A cell added to a copy: one entry in BENCHMARK.json and a traffic file
    and a limits file of its own; the copy then finds all of it by name, and
    no other file changes."""
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path)
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["workloads"].append(dict(b["workloads"][0], name="torus1e6.dummy", traffic="fit_dummy"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    traffic = dict(json.loads((BENCH / "traffic/fit_kmeans.json").read_text()), check_rows=512)
    (tmp_path / "benchmark/traffic/fit_dummy.json").write_text(json.dumps(traffic))
    (tmp_path / "benchmark/limits/torus1e6.dummy.json").write_text(
        (BENCH / "limits/torus1e6.kmeans.json").read_text())
    probe = ("import sys; sys.path[:0] = ['benchmark']; from lib import cells; "
             "c = cells.load('torus1e6.dummy'); cells.job(c); cells.reference(c); "
             "[cells.reader(m['name']) for m in c.per_layer]; print(c.traffic['check_rows'])")
    out = subprocess.run([sys.executable, "-B", "-c", probe], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "512"
    after = _digests(tmp_path)
    changed = {p for p in before if before[p] != after.get(p)}
    assert changed == {Path("BENCHMARK.json")}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


def test_nothing_under_benchmark_imports_jax_or_the_jax_package():
    bad = {"jax", "jaxlib", "flax", "flgp_tpu"}
    found = {(str(p.relative_to(BENCH)), name) for p in BENCH.rglob("*.py")
             for name in _imports(p) if name.split(".")[0] in bad}
    assert not found
    names = [json.loads(p.read_text())["wraps"] for p in (BENCH / "spans").glob("*.json")]
    assert all(m.split(".")[0] == "flgp_tpu_torch" for w in names for m, _ in w)


def test_the_reference_imports_nothing_of_the_program():
    for p in (BENCH / "reference").glob("*.py"):
        assert all(name.split(".")[0] != "flgp_tpu_torch" for name in _imports(p)), p


def test_the_roofline_copy_gives_the_bounds_of_perf_md_at_the_torus_shape():
    """PERF.md §6: K1 0.0917 ms and K2 0.1553 ms, both set by operations, at
    n = 1e6, s = 1024, r = 3, d = 2; K1 0.9842 ms at the multiclass d = 784."""
    from lib.roofline import bound, work

    assert bound(work("knn", 1_000_000, 3, 1024, 2)) == pytest.approx((0.0917, "operations"),
                                                                      abs=5e-5)
    ms, by = bound(work("lae_weights", 1_000_000, 3, 1024, 2))
    assert (round(ms, 4), by) == (0.1553, "operations")
    assert round(bound(work("knn", 70_000, 3, 600, 784))[0], 4) == 0.9842


def test_the_ess_copy_matches_an_ar1_chain():
    """AR(1) with coefficient φ has ESS n·(1 − φ)/(1 + φ) per chain."""
    from lib.ess import ess

    rng = np.random.default_rng(0)
    phi, n, chains = 0.5, 20000, 4
    x = np.zeros((n, chains, 1))
    eps = rng.normal(size=(n, chains, 1))
    x[0] = eps[0] / np.sqrt(1 - phi**2)
    for i in range(1, n):
        x[i] = phi * x[i - 1] + eps[i]
    want = n * chains * (1 - phi) / (1 + phi)
    assert ess(x)[0] == pytest.approx(want, rel=0.08)
