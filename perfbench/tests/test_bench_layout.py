"""BENCHMARK.json against the benchmark's contract, and a cell added by
adding files and entries alone."""

import json
import re
import shutil
import subprocess
import sys

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_configs_and_cells():
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("perfbench/") and c["file"] not in files
        files.add(c["file"])
        body = harness.load_json(harness.ROOT / c["file"])
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert body["source"] == c["source"]
    names = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and _line(w["why"]) and w["chips"] == 1
        assert w["config"] in names
        assert (harness.HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert names == {w["config"] for w in BENCH["workloads"]}


def test_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].startswith("roofline_pct.") or "_roofline" in m["name"]:
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()
    for name in cells:
        cell = harness.load_cell(name)
        assert len(cell.metrics["end_to_end"]) >= 2
        assert cell.metrics["per_layer"]


def test_a_cell_added_by_files_alone(tmp_path):
    """A configuration, a traffic mix and a per-layer metric, each a new
    file, and new entries in BENCHMARK.json: no file that was there
    changes, and the new cell runs and reports the new metric."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(harness.HERE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*")
              if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    cfg = harness.load_json(harness.HERE / "configs" / "htk-mfcc13-16k.json")
    cfg.update(name="htk-mfcc20-16k", source="a test's configuration")
    cfg["features"].update(n_mfcc=20)
    (root / "perfbench/configs/htk-mfcc20-16k.json").write_text(json.dumps(cfg))
    tr = harness.load_json(harness.HERE / "traffic" / "libri_sorted.json")
    tr.update(utterances=6, batch=3, check_batches=2, trace_seconds=0.01,
              lengths_s={"edges": [1, 2], "weights": [1]})
    (root / "perfbench/traffic/short_queries.json").write_text(json.dumps(tr))
    (root / "perfbench/metrics/frames_per_batch.py").write_text(
        "import numpy as np\n\ndef read(run):\n"
        "    return float(np.mean([len(x) for x in run.traced.lengths]))\n")
    bench["configs"].append({"name": "htk-mfcc20-16k", "source": "a test",
                             "file": "perfbench/configs/htk-mfcc20-16k.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "mfcc20.short_queries",
                               "config": "htk-mfcc20-16k",
                               "traffic": "short_queries", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "frames_per_batch", "unit": "rows",
                               "better": "higher", "source": "host_clock",
                               "layer": "a test", "moves": "audio_s_per_s",
                               "workloads": ["mfcc20.short_queries"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(root)!r}, {str(harness.ROOT)!r}]\n"
        "from perfbench import harness\n"
        "from perfbench.tests.hostdev import Host\n"
        "cell = harness.load_cell('mfcc20.short_queries')\n"
        "r, _ = harness.run(cell, 4, 0.02, True, Host())\n"
        "print(json.dumps(r))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"]
    assert result["metrics"]["frames_per_batch"]["value"] == 3.0
    assert all(p.read_bytes() == b for p, b in before.items())
