"""The harness: cells found by name from files (a fourth added by files
alone), the result line's shape, the exits without a card, and the imports
that the benchmark and its reference may not make."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
from conftest import TINY_SERVE

import run

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "diner_tpu"}


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_resolves_to_its_files():
    b = bench()
    for w in b["workloads"]:
        cell, entry = run._cell(b, w["name"])
        assert (ROOT / entry["file"]).is_file()
        traffic = run.load_json(BENCH / "traffic" / f"{w['traffic']}.json")
        assert run.generator_class(traffic["kind"]) is not None
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    for m in b["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}


def test_a_fourth_cell_from_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    per-layer metric and their limits as new files and entries, and its
    run.py runs the new cell with no file of the harness edited."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "diner_tpu_torch", tmp_path / "diner_tpu_torch")
    b = bench()
    cfg = json.loads((BENCH / "configs" / "diner_dtu.json").read_text())
    cfg["name"] = "diner_dtu_wide"
    cfg["image_hw"] = [24, 40]
    (tmp_path / "benchmark" / "configs" / "diner_dtu_wide.json").write_text(
        json.dumps(cfg))
    traffic = json.loads((BENCH / "traffic" / "sweep.json").read_text())
    traffic.update(frames_per_session=2, check_frames=1)
    (tmp_path / "benchmark" / "traffic" / "sweep_short.json").write_text(
        json.dumps(traffic))
    (tmp_path / "benchmark" / "limits" / "diner_dtu_wide.sweep_short.json"
     ).write_text(json.dumps({"rgb_mae": 1.0}))
    (tmp_path / "benchmark" / "metrics" / "serve.frames_per_load.py"
     ).write_text("def read(ctx):\n    c = ctx['counts']\n"
                  "    return c['frames'] / c['loads']\n")
    b["configs"].append({"name": "diner_dtu_wide", "source": "test",
                         "file": "benchmark/configs/diner_dtu_wide.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "diner_dtu_wide.sweep_short",
                           "config": "diner_dtu_wide",
                           "traffic": "sweep_short", "chips": 1,
                           "why": "test"})
    b["per_layer"].append({"name": "serve.frames_per_load", "unit": "1",
                           "better": "higher", "source": "program_counter",
                           "layer": "serving", "moves": "render_rays_per_s",
                           "workloads": ["diner_dtu_wide.sweep_short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    tiny = {k: v for k, v in TINY_SERVE.items() if k != "image_hw"}
    code = (f"import sys, json; sys.path.insert(0, {str(tmp_path / 'benchmark')!r});"
            "import run; r = run.run_cell('diner_dtu_wide.sweep_short', 5, 1.0,"
            f" True, device='cpu', overrides={tiny!r});"
            "print(json.dumps(r))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["metrics"]["serve.frames_per_load"]["value"] >= 1
    assert set(r["checks"]) == {"rgb_mae"}
    assert r["attempted"] >= 1


@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line(trace):
    r = run.run_cell("diner_dtu.sweep", 2 ** 31 + 12_345, 1.0, trace,
                     device="cpu", overrides=TINY_SERVE)
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert isinstance(r["correct"], bool) and r["attempted"] >= 1
    assert r["failed"] == 0
    b = bench()
    declared = {m["name"]: m for m in (b["per_layer"] if trace
                                       else b["end_to_end"])}
    for name, m in r["metrics"].items():
        assert m["unit"] == declared[name]["unit"]
        assert m["value"] > 0
    if trace:
        assert {"serve.load_scene_ms", "render.mfu"} <= set(r["metrics"])
        assert r["device"]["window_s"] > 0
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(r["metrics"]) == {"render_rays_per_s", "setup_s"}
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    limits = json.loads(
        (BENCH / "limits" / "diner_dtu.sweep.json").read_text())
    assert {k: c["limit"] for k, c in r["checks"].items()} == limits
    json.dumps(r)


def test_no_card_no_result(tmp_path):
    """Without CUDA the command exits non-zero and prints no result; in a
    directory that holds only the benchmark's files it fails too."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    argv = ["--workload", "diner_dtu.sweep", "--seed", "1", "--seconds", "1",
            "--trace", "0"]
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), *argv],
                         cwd=ROOT, capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "benchmark/run.py", *argv],
                         cwd=tmp_path, capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_nothing_imports_jax_and_the_reference_not_the_port():
    for path in BENCH.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
    for path in (BENCH / "reference").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN | {"diner_tpu_torch",
                                                          "lib", "run"}, \
                (path, name)


def test_a_run_leaves_no_jax_loaded():
    code = ("import sys; sys.path.insert(0, 'benchmark'); import run; "
            f"run.run_cell('diner_dtu.sweep', 3, 0.5, False, device='cpu', "
            f"overrides={TINY_SERVE!r}); print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
