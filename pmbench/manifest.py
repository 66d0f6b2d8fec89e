"""The benchmark's manifest: BENCHMARK.json at the checkout's root, and the
files it names by name.

  a configuration  pmbench/configs/<config>.json (the entry's ``file``);
                   where it is cut from its source, its "reduced" holds a
                   line "<key>: <cut>" for each key of the entry's
                   "reduced", in the same order, each a top-level key of
                   the file, naming the value the source publishes and the
                   value used
  a traffic mix    pmbench/workloads/<traffic>.json
  a metric reader  pmbench/metrics/<metric>.py, a ``read(trace)`` that
                   returns the metric's value, or None where it finds
                   nothing to read
  a traffic mode   pmbench/modes/<mode>.py (the traffic mix's "mode"), a
                   ``MODE`` class (pmbench.mode.Mode), found by name
                   whatever the mode; it may draw its own tree
                   (``make_tree``) from keys of its own, and cuts its cell
                   for the CPU tests by its ``tiny`` classmethod

A later cell, configuration or metric is new files and new entries here;
no file of the harness changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic mix's contents
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list
    root: str = ROOT  # the checkout whose pmbench/ holds its files


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: dict, name: str, root: str = ROOT) -> Cell:
    """The workload ``name`` with its configuration, traffic and metrics."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(root, "pmbench", "workloads",
                           w["traffic"] + ".json")) as fh:
        traffic = json.load(fh)
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)], root=root)


def reader(metric: str, root: str = ROOT):
    """The ``read`` function of pmbench/metrics/<metric>.py."""
    path = os.path.join(root, "pmbench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "pmbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def mode(name: str, root: str = ROOT):
    """The ``MODE`` class of pmbench/modes/<name>.py (a traffic mix's
    "mode"), a subclass of pmbench.mode.Mode."""
    path = os.path.join(root, "pmbench", "modes", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "pmbench_mode_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.MODE
