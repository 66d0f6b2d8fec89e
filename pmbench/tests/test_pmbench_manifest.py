"""BENCHMARK.json keeps to the benchmark's contract, and every cell,
configuration and metric it names loads by name from its own file."""

import hashlib
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
NUMBER = re.compile(r"\d+(?:[,.]\d+)*")
BENCH = manifest.load()


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def config_file(root, c) -> dict:
    """The configuration's file.  Its "reduced" ([] where it has none)
    holds one line for each key cut from the source, "<key>: <what was
    cut>", which names the value the source publishes and the value the
    file uses."""
    with open(os.path.join(root, c["file"])) as fh:
        return json.load(fh)


def check_keys_and_names(bench, root=manifest.ROOT):
    """The contract's rules on BENCHMARK.json's keys and names, and on each
    configuration's cuts: an AssertionError names the first one broken."""
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "pmbench/run.py"]
    assert bench["paths"] == ["pmbench"]
    assert 1 <= bench["run_seconds"] <= 51
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("pmbench/")
        cut = c["reduced"]
        assert isinstance(cut, list) and len(cut) <= 16
        assert len(set(cut)) == len(cut), f"{c['name']}: reduced repeats"
        assert all(isinstance(k, str) and NAME.match(k) for k in cut), \
            f"{c['name']}: a reduced key is no name: {cut}"
        conf = config_file(root, c)
        cuts = conf.get("reduced", [])
        for e in cuts:
            assert isinstance(e, str) and line(e) and ":" in e and \
                len(NUMBER.findall(e.split(":", 1)[1])) >= 2, \
                f"{c['name']}: {e!r} gives no published and used value"
        assert [e.split(":", 1)[0] for e in cuts] == cut, \
            f"{c['name']}: reduced {cut} differs from its file's {cuts}"
        assert all(k in conf and k != "reduced" for k in cut), \
            f"{c['name']}: a reduced key is not a key of its file: {cut}"
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and line(w["why"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] == "sample_s" and line(m["layer"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert len(json.dumps(bench)) < 64 * 1024


def test_keys_and_names():
    check_keys_and_names(BENCH)


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


# what small.tiny cut each cell to while it sized every mode's run itself
TINY_TREE = {"n_nodes": 300, "genome_len": 6000, "n_blocks": 8,
             "indel_rate": 0.005}
TINY_TRAFFIC = {"illumina.single": {"pairs": 2500, "inputs": 1, "snps": 6},
                "wastewater.meta": {"pairs": 6000, "inputs": 1},
                "illumina.plate": {"pairs": 4000, "inputs": 1, "snps": 6},
                "ont.single": {"pairs": 2500, "inputs": 1, "snps": 6}}


@pytest.mark.parametrize("name", list(TINY_TRAFFIC))
def test_each_mode_cuts_its_cell_as_before(name):
    """The modes' own ``tiny`` cut the four cells to the sizes small.tiny
    gave them."""
    real = manifest.cell(BENCH, name)
    cell = small.tiny(name)
    assert cell.config == {**real.config, "tree": TINY_TREE}
    assert cell.traffic == {**real.traffic, **TINY_TRAFFIC[name]}


def checkout(tmp_path):
    """A copy of the benchmark's files, as a checkout holds them."""
    root = tmp_path / "checkout"
    shutil.copytree(manifest.HERE, root / "pmbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    return root


def digests(pmbench_dir) -> dict:
    """sha256 of every file under ``pmbench_dir``, by its relative path."""
    out = {}
    for d, dirs, files in os.walk(pmbench_dir):
        dirs[:] = [x for x in dirs if x not in (".cache", "__pycache__")]
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, pmbench_dir)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def assert_harness_unedited(root):
    """Every file of the benchmark is in the checkout, byte for byte."""
    mine, theirs = digests(manifest.HERE), digests(root / "pmbench")
    assert {f: theirs.get(f) for f in mine} == mine


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


FIXTURE_CLADES = '''
import os

from pmbench.frozen import panman as fpanman
from pmbench.modes.single import Single


class Clades(Single):
    \"\"\"Isolates on a tree given as "clades" of "clade_nodes" nodes, one
    block of the genome a clade.\"\"\"

    @classmethod
    def tiny(cls, config, traffic):
        config["tree"].update(clades=6, clade_nodes=50, genome_len=6000)
        traffic.update(pairs=2500, snps=6)
        return config, traffic

    def make_tree(self):
        t = self.config["tree"]
        self.model = fpanman.make_panman_model(
            self.rng(0), n_nodes=t["clades"] * t["clade_nodes"],
            genome_len=t["genome_len"], n_blocks=t["clades"],
            indel_rate=t["indel_rate"])
        self.panman = os.path.join(self.work, "tree.panman")
        fpanman.write_panman(self.panman, self.model)
        self.leaves = self.model.leaves()


MODE = Clades
'''
CUT = "tree: 1,000 clades of 25 nodes in the source, 400 used (a run's time)"


BENCH_TREE = manifest.cell(BENCH, "illumina.single").config["tree"]


def new_cell(tmp_path, stem, mode_src, config, traffic, reduced=()):
    """A copied checkout with one cell more, "fixture.<stem>", of new files
    and entries only: the configuration, traffic mix and mode "<stem>"
    (sars20k_illumina's configuration and the isolate mix, updated by
    ``config`` and ``traffic``).  Returns the checkout and its manifest,
    which the caller writes once it has added what else it needs."""
    root = checkout(tmp_path)
    here = root / "pmbench"
    conf = json.loads((here / "configs" / "sars20k_illumina.json").read_text())
    conf.update(config, name=stem)
    mix = json.loads((here / "workloads" / "isolate.json").read_text())
    mix.update(traffic, mode=stem)
    (here / "configs" / f"{stem}.json").write_text(json.dumps(conf))
    (here / "workloads" / f"{stem}.json").write_text(json.dumps(mix))
    (here / "modes" / f"{stem}.py").write_text(mode_src)
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": stem, "source": "a fixture",
                             "file": f"pmbench/configs/{stem}.json",
                             "reduced": list(reduced), "why": "a fixture"})
    bench["workloads"].append({"name": f"fixture.{stem}", "config": stem,
                               "traffic": stem, "chips": 1,
                               "why": "a fixture"})
    return root, bench


def runs_correct(root, name, tmp_path) -> manifest.Cell:
    """The cell, cut by its mode's ``tiny``, runs correct on CPU tensors,
    and every file of the harness in the checkout is the repo's."""
    cell = small.tiny(name, str(root))
    out, res = small.run(cell, tmp_path)
    assert out["correct"], out["checks"]
    assert out["metrics"]["sample_s"]["value"] > 0
    assert res["info"]["sw_rows_checked"] > 0
    assert_harness_unedited(root)
    return cell


def test_a_cell_of_new_files_only(tmp_path):
    """A later cell, configuration, traffic mode and metric: new files and
    new entries in BENCHMARK.json, no file of the harness edited; the cell
    runs (at a tiny size, on CPU tensors)."""
    root, bench = new_cell(
        tmp_path, "fixture_single_end", FIXTURE_MODE,
        {"tree": {**BENCH_TREE, "n_nodes": 999}}, {"pairs": 1234})
    (root / "pmbench" / "metrics" / "fixture.count.py").write_text(
        "def read(trace):\n    return trace.n_samples or None\n")
    bench["per_layer"].append({"name": "fixture.count", "unit": "count",
                               "better": "higher", "source": "program_span",
                               "layer": "device", "moves": "sample_s",
                               "workloads": ["fixture.fixture_single_end"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    name = "fixture.fixture_single_end"
    cell = manifest.cell(manifest.load(str(root)), name, str(root))
    assert cell.config["tree"]["n_nodes"] == 999
    assert cell.traffic["pairs"] == 1234
    assert [m["name"] for m in cell.per_layer] == ["fixture.count"]

    class T:
        n_samples = 3

    assert manifest.reader("fixture.count", str(root))(T()) == 3
    runs_correct(root, name, tmp_path)


def test_a_cut_cell_with_its_own_tree_of_new_files_only(tmp_path):
    """A configuration cut from its source (its cut in "reduced", in
    BENCHMARK.json and in its file alike), and a mode that draws its own
    tree from keys of its own and sizes its CPU run by its own ``tiny``:
    new files and entries only, every file of the harness as it is; the
    cell runs correct (at its tiny size, on CPU tensors)."""
    root, bench = new_cell(
        tmp_path, "fixture_clades", FIXTURE_CLADES,
        {"reduced": [CUT], "tree": dict(clades=400, clade_nodes=25,
                                        genome_len=16569, indel_rate=0.005)},
        {}, reduced=["tree"])
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    bench = manifest.load(str(root))
    check_keys_and_names(bench, str(root))
    cell = manifest.cell(bench, "fixture.fixture_clades", str(root))
    assert cell.config["reduced"] == [CUT]
    mode = manifest.mode("fixture_clades", str(root))
    assert "tiny" in vars(mode) and "make_tree" in vars(mode)
    cell = runs_correct(root, "fixture.fixture_clades", tmp_path)
    assert cell.config["tree"] == dict(clades=6, clade_nodes=50,
                                       genome_len=6000, indel_rate=0.005)
    assert cell.traffic["pairs"] == 2500 and cell.traffic["inputs"] == 1


@pytest.mark.parametrize("listed,in_file,broken", [
    (["index"], [CUT], "differs from its file's"),
    (["tree"], [], "differs from its file's"),
    (["tree"], ["tree: cut to fit a run"], "no published and used value"),
    (["tree"], ["tree: 400 clades used"], "no published and used value"),
    (["tree"], ["tree 1,000 clades, 400 used"], "no published and used"),
    (["trees"], ["trees: 1,000 clades, 400 used"], "not a key of its file"),
    ([CUT], [CUT], "is no name"),
], ids=["other-key", "absent-in-file", "no-number", "one-number",
        "no-colon", "no-such-key", "entry-as-key"])
def test_a_cut_that_breaks_the_rules_is_refused(tmp_path, listed, in_file,
                                                broken):
    """The rules on "reduced", on a mutated copy of the manifest: a cut
    listed otherwise than in its configuration's file, or one that does not
    give what the source publishes and what is used, is refused; the same
    cut listed alike in both passes."""
    shutil.copytree(os.path.join(manifest.HERE, "configs"),
                    tmp_path / "pmbench" / "configs")
    bench = json.loads(json.dumps(BENCH))
    c = bench["configs"][0]
    path = tmp_path / c["file"]
    conf = json.loads(path.read_text())
    conf["reduced"] = [CUT]
    path.write_text(json.dumps(conf))
    c["reduced"] = ["tree"]
    check_keys_and_names(bench, str(tmp_path))
    conf["reduced"] = in_file
    path.write_text(json.dumps(conf))
    c["reduced"] = listed
    with pytest.raises(AssertionError, match=broken):
        check_keys_and_names(bench, str(tmp_path))

