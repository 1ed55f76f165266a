"""A cell of ``BENCHMARK.json`` and the files it names, found by name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<workload>.json`` and ``metrics/<metric>.py``."""
import importlib.util
import json
import os
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def manifest(root=ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _json(*parts, root=HERE):
    with open(os.path.join(root, *parts)) as fh:
        return json.load(fh)


def load(workload: str, root=ROOT) -> Cell:
    """The cell ``workload`` with its configuration, traffic and limits."""
    m = manifest(root)
    w = {c["name"]: c for c in m["workloads"]}.get(workload)
    if w is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    here = os.path.join(root, "simbench")
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=_json("configs", f"{w['config']}.json", root=here),
        traffic=_json("traffic", f"{w['traffic']}.json", root=here),
        limits=_json("limits", f"{workload}.json", root=here),
        end_to_end=m["end_to_end"], per_layer=m["per_layer"])


def reader(metric: str, root=ROOT):
    """The ``read(ctx)`` of ``metrics/<metric>.py``."""
    path = os.path.join(root, "simbench", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"simbench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
