"""BENCHMARK.json keeps to the benchmark's contract, and every cell,
configuration and metric it names loads by name from its own file."""

import json
import os
import re
import shutil

import pytest

from pmbench import manifest
from pmbench.mode import Mode

from . import small

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest.load()


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "pmbench/run.py"]
    assert BENCH["paths"] == ["pmbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("pmbench/") and c["reduced"] == []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and line(w["why"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] == "sample_s" and line(m["layer"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads(name):
    cell = manifest.cell(BENCH, name)
    assert issubclass(manifest.mode(cell.traffic["mode"]), Mode)
    reported = {m["name"] for m in cell.end_to_end}
    assert {"setup_s", "sample_s"} <= reported
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(manifest.reader(m["name"]))


def test_every_config_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


FIXTURE_MODE = '''
import os

from pmbench.modes.single import Single


class SingleEnd(Single):
    \"\"\"Isolates read as mate 1 alone, one CLI call each.\"\"\"

    def run_one(self, i):
        j = i % len(self.inputs)
        s = self.inputs[j]
        s.c2 = s.c2[:0]
        prefix = os.path.join(self.out, f"slot{j}")
        self.deep = j if 0 <= i < len(self.inputs) else None
        try:
            rc = self.cli([self.panman, s.r1, "-o", prefix])
        finally:
            self.deep = None
        self.collect(s, prefix, rc)
        return 1, int(rc != 0)


MODE = SingleEnd
'''


def test_a_cell_of_new_files_only(tmp_path):
    """A later cell, configuration, traffic mode and metric: new files and
    new entries in BENCHMARK.json, no file of the harness edited; the cell
    runs (at a tiny size, on CPU tensors)."""
    root = tmp_path / "checkout"
    shutil.copytree(manifest.HERE, root / "pmbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    conf = json.load(open(os.path.join(manifest.HERE, "configs",
                                       "sars20k_illumina.json")))
    conf["name"] = "fixture_tree"
    conf["tree"]["n_nodes"] = 999
    (root / "pmbench" / "configs" / "fixture_tree.json").write_text(
        json.dumps(conf))
    traffic = json.load(open(os.path.join(manifest.HERE, "workloads",
                                          "isolate.json")))
    traffic["pairs"] = 1234
    traffic["mode"] = "fixture_single_end"
    (root / "pmbench" / "modes" / "fixture_single_end.py").write_text(
        FIXTURE_MODE)
    (root / "pmbench" / "workloads" / "fixture_isolate.json").write_text(
        json.dumps(traffic))
    (root / "pmbench" / "metrics" / "fixture.count.py").write_text(
        "def read(trace):\n    return trace.n_samples or None\n")
    bench["configs"].append({"name": "fixture_tree", "source": "a fixture",
                             "file": "pmbench/configs/fixture_tree.json",
                             "reduced": [], "why": "a fixture"})
    bench["workloads"].append({"name": "fixture.cell",
                               "config": "fixture_tree",
                               "traffic": "fixture_isolate", "chips": 1,
                               "why": "a fixture"})
    bench["per_layer"].append({"name": "fixture.count", "unit": "count",
                               "better": "higher", "source": "program_span",
                               "layer": "device", "moves": "sample_s",
                               "workloads": ["fixture.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = manifest.cell(manifest.load(str(root)), "fixture.cell", str(root))
    assert cell.config["tree"]["n_nodes"] == 999
    assert cell.traffic["pairs"] == 1234
    assert [m["name"] for m in cell.per_layer] == ["fixture.count"]

    class T:
        n_samples = 3

    assert manifest.reader("fixture.count", str(root))(T()) == 3
    cell = small.tiny("fixture.cell", str(root))
    out, res = small.run(cell, tmp_path)
    assert out["correct"], out["checks"]
    assert out["metrics"]["sample_s"]["value"] > 0
    assert res["info"]["sw_rows_checked"] > 0
