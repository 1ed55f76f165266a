"""A cell small enough for the CPU: the circle configuration at 600
aircraft in a 0.3 degree disc, under the cell's own traffic and limits,
in a copy of the benchmark's files."""
import argparse
import json
import os
import shutil

from simbench import cell as cellmod

SIMBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = "circle-100k"
CELL = "tiny.sparse-mvp"


def make_root(tmp) -> str:
    """A checkout-like directory holding ``BENCHMARK.json`` and the
    benchmark's files plus the tiny cell; returns its path."""
    root = os.path.join(str(tmp), "root")
    shutil.copytree(SIMBENCH, os.path.join(root, "simbench"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    m = cellmod.manifest()
    base = {w["config"]: w for w in m["workloads"]}[BASE]
    c = json.load(open(os.path.join(SIMBENCH, "configs", f"{BASE}.json")))
    c.update(name="tiny", nmax=768)
    c["fleet"].update(n_aircraft=600, radius_deg=0.3)
    json.dump(c, open(os.path.join(root, "simbench", "configs",
                                   "tiny.json"), "w"))
    shutil.copy(os.path.join(SIMBENCH, "limits", f"{base['name']}.json"),
                os.path.join(root, "simbench", "limits", f"{CELL}.json"))
    m["configs"].append(dict(name="tiny", source=c["source"],
                             file="simbench/configs/tiny.json", reduced=[],
                             why="a CPU test size"))
    m["workloads"].append(dict(base, name=CELL, config="tiny"))
    json.dump(m, open(os.path.join(root, "BENCHMARK.json"), "w"))
    return root


def args(seed=5, seconds=1.0, trace=0):
    return argparse.Namespace(workload=CELL, seed=seed, seconds=seconds,
                              trace=trace)
