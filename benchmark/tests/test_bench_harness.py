"""The benchmark's spec, files and isolation, on the CPU.

Run from the repository root: python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import ast
import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import tiny

REPO = tiny.REPO
BENCH = REPO / "benchmark"
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "workloads"}
# the spec with the held-out cells added back (held/<cell>.json)
FULL = json.loads(json.dumps(SPEC))
for _held in sorted((BENCH / "held").glob("*.json")):
    for _key, _entries in json.loads(_held.read_text()).items():
        FULL[_key].extend(_entries)


def all_metrics():
    return FULL["end_to_end"] + FULL["per_layer"]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    cmd = SPEC["command"]
    assert len(cmd) <= 32 and all(1 <= len(w) <= 200 for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("m", all_metrics(), ids=lambda m: m["name"])
def test_metric_names_units_and_keys(m):
    assert NAME.match(m["name"])
    assert UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    extra = {"bound"} if m in FULL["end_to_end"] else {"layer", "moves"}
    assert set(m) <= METRIC_KEYS | extra
    assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    cells = {w["name"] for w in FULL["workloads"]}
    assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("spec", [SPEC, FULL], ids=["spec", "with_held"])
def test_end_to_end_bounds_and_sources(spec):
    names = [m["name"] for m in spec["end_to_end"]]
    assert "setup_s" in names and len(names) == len(set(names))
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("spec", [SPEC, FULL], ids=["spec", "with_held"])
def test_per_layer_moves_and_layers(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        moved = e2e[m["moves"]].get("workloads")
        for cell in m["workloads"]:
            assert moved is None or cell in moved
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("spec", [SPEC, FULL], ids=["spec", "with_held"])
def test_cells_and_configs(spec):
    cells = spec["workloads"]
    names = [w["name"] for w in cells]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    used = {w["config"] for w in cells}
    files = set()
    for c in spec["configs"]:
        assert c["name"] in used and NAME.match(c["name"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert (REPO / c["file"]).is_file() and c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in cells:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        traffic = json.loads(
            (BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
        e2e = [m for m in spec["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in spec["per_layer"])


def test_check_budget_fits_24_cells():
    rs = SPEC["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


REFERENCE_FORBIDDEN = ("otslam_tpu_torch", "otslam_tpu", "jax", "jaxlib",
                       "flax")


@pytest.mark.parametrize("path", sorted(
    list((BENCH / "reference").glob("*.py"))
    + list((BENCH / "inputs").glob("*.py"))), ids=lambda p: p.name)
def test_reference_and_inputs_import_no_program(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            assert n.split(".", 1)[0] not in REFERENCE_FORBIDDEN, (path, n)


def test_reference_loads_no_program_module():
    code = ("import sys, benchmark.reference.recon, benchmark.reference."
            "mesh, benchmark.reference.mission; print(sorted({m.split('.')[0]"
            " for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & set(REFERENCE_FORBIDDEN)


RUN_TINY = """
import sys
sys.path.insert(0, {tests!r})
from pathlib import Path
import tiny
from benchmark import harness, run
root = tiny.tiny_root(Path({tmp!r}))
rc = run.main(['--workload', {cell!r}, '--seed', '2147483649',
               '--seconds', '0.5', '--trace', '0'], device='cpu', root=root)
found = sorted({{m.split('.', 1)[0] for m in sys.modules}}
               & set(harness.FORBIDDEN))
print('RC', rc, 'FOUND', found)
"""


@pytest.mark.parametrize("cell", ["recon.captures", "mission.full_room"])
def test_run_loads_no_jax(cell, tmp_path):
    env_tmp = tmp_path / "tmp"
    env_tmp.mkdir()
    code = RUN_TINY.format(tests=str(BENCH / "tests"),
                           tmp=str(tmp_path / "root"), cell=cell)
    (tmp_path / "root").mkdir()
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "TMPDIR": str(env_tmp),
                              "HOME": str(tmp_path)})
    assert "RC 0 FOUND []" in out.stdout, out.stderr[-3000:]


def test_no_card_exits_nonzero_without_a_result():
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "recon.captures", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_bare_benchmark_exits_nonzero(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "recon.captures", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()
                                                     ).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_cell_config_and_metric_added_as_files(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric are new
    files plus entries in BENCHMARK.json; no file already there changes."""
    from benchmark import run
    root = tiny.tiny_root(tmp_path)
    before = _digest(root / "benchmark")
    cfg = json.loads((root / "benchmark/configs/object_recon.json"
                      ).read_text())
    cfg["name"] = "object_recon_coarse"
    cfg["tsdf"].update({"voxel_size": 0.03, "sdf_trunc": 0.12})
    (root / "benchmark/configs/object_recon_coarse.json").write_text(
        json.dumps(cfg))
    traffic = json.loads((root / "benchmark/traffic/captures.json"
                          ).read_text())
    traffic["objects"] = ["cardboard_box"]
    (root / "benchmark/traffic/captures.box.json").write_text(
        json.dumps(traffic))
    (root / "benchmark/metrics/recon.objects_traced.py").write_text(
        "def read(ctx):\n"
        "    return float(len(ctx['stages'])) if ctx.get('stages') else None\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "object_recon_coarse", "source":
                            "https://example.org/coarse", "file":
                            "benchmark/configs/object_recon_coarse.json",
                            "reduced": ["tsdf"], "why": "a test"})
    spec["workloads"].append({"name": "recon.box", "config":
                              "object_recon_coarse", "traffic":
                              "captures.box", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "recon.captures" in m["workloads"]:
            m["workloads"].append("recon.box")
    spec["per_layer"].append({"name": "recon.objects_traced", "unit":
                              "objects", "better": "higher", "source":
                              "program_span", "layer": "entry", "moves":
                              "objects_per_s", "workloads": ["recon.box"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digest(root / "benchmark")
    assert all(after[k] == v for k, v in before.items())
    for trace in (0, 1):
        assert run.main(["--workload", "recon.box", "--seed", "7",
                         "--seconds", "0.3", "--trace", str(trace)],
                        device="cpu", root=root) == 0
