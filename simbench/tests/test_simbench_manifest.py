"""BENCHMARK.json against the benchmark's contract, and the files it
names found by name: a configuration, a traffic mix and a per-layer
metric are each added by new files and entries alone."""
import hashlib
import json
import os
import re
import shutil

import pytest

from simbench import cell as cellmod

ROOT = cellmod.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


@pytest.fixture(scope="module")
def m():
    return cellmod.manifest()


def test_keys_and_sizes(m):
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["simbench"] and m["command"][1] == "simbench/run.py"
    assert 1 <= m["run_seconds"] <= 51
    n = 24      # the most cells a later PR may bring
    assert (2 + 14 * n) * (m["run_seconds"] + 60) + n * 180 + 1200 <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_names_units_and_sources(m):
    metrics = m["end_to_end"] + m["per_layer"]
    for e in m["configs"] + m["workloads"] + metrics:
        assert NAME.match(e["name"]), e["name"]
    for e in metrics:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert e["source"] in SOURCES
    for e in m["end_to_end"]:
        assert e["source"] in SOURCES_E2E and 0.01 <= e["bound"] <= 0.25
        assert set(e) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for e in m["per_layer"]:
        assert set(e) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert "\n" not in e["layer"] and len(e["layer"]) <= 200
        if e["name"].endswith("_roofline"):
            assert e["unit"] == "%"
    names = [e["name"] for e in metrics]
    assert len(names) == len(set(names)) and "setup_s" in names


def test_every_moved_metric_is_reported_in_its_cells(m):
    # the harness reports every metric in every cell: none is limited to
    # some cells, so each moved metric is reported wherever its mover is
    e2e = {x["name"] for x in m["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and m["per_layer"]
    for e in m["end_to_end"] + m["per_layer"]:
        assert "workloads" not in e
    for e in m["per_layer"]:
        assert e["moves"] in e2e
    for w in m["workloads"]:
        cell = cellmod.load(w["name"])
        assert cell.end_to_end == m["end_to_end"]
        assert cell.per_layer == m["per_layer"]


def test_cells_find_their_files_by_name(m):
    used = {w["config"] for w in m["workloads"]}
    assert used == {c["name"] for c in m["configs"]}
    for c in m["configs"]:
        assert c["file"] == f"simbench/configs/{c['name']}.json"
        assert json.load(open(os.path.join(ROOT, c["file"])))["source"] \
            == c["source"]
    for w in m["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cell = cellmod.load(w["name"])
        assert cell.traffic["name"] == w["traffic"]
        assert set(cell.limits)
    for e in m["per_layer"]:
        assert callable(cellmod.reader(e["name"]))


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "simbench")):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    open(p, "rb").read()).hexdigest()
    return out


def test_new_config_mix_and_metric_need_new_files_only(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "simbench"),
                    os.path.join(root, "simbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _digests(root)
    sb = os.path.join(root, "simbench")
    cfg = json.load(open(os.path.join(sb, "configs", "circle-100k.json")))
    cfg.update(name="circle-50k", nmax=50176)
    cfg["fleet"]["n_aircraft"] = 50000
    json.dump(cfg, open(os.path.join(sb, "configs", "circle-50k.json"), "w"))
    mix = json.load(open(os.path.join(sb, "traffic", "sparse-mvp.json")))
    mix.update(name="pallas-mvp", stack=["CDMETHOD PALLAS", "ASAS ON",
                                         "RESO MVP", "OP", "FF"])
    json.dump(mix, open(os.path.join(sb, "traffic", "pallas-mvp.json"), "w"))
    shutil.copy(os.path.join(sb, "limits", "circle-100k.sparse-mvp.json"),
                os.path.join(sb, "limits", "circle-50k.pallas-mvp.json"))
    with open(os.path.join(sb, "metrics", "chunks_per_s.py"), "w") as fh:
        fh.write("def read(ctx):\n    w = ctx.window\n"
                 "    return w['chunks'] / w['wall_s']\n")
    m = json.load(open(os.path.join(root, "BENCHMARK.json")))
    m["configs"].append(dict(m["configs"][0], name="circle-50k",
                             file="simbench/configs/circle-50k.json",
                             source=cfg["source"]))
    m["workloads"].append(dict(m["workloads"][0], name="circle-50k.pallas-mvp",
                               config="circle-50k", traffic="pallas-mvp"))
    m["per_layer"].append(dict(m["per_layer"][0], name="chunks_per_s",
                               unit="1/s", better="higher"))
    json.dump(m, open(os.path.join(root, "BENCHMARK.json"), "w"))
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
    c = cellmod.load("circle-50k.pallas-mvp", root)
    assert c.config["fleet"]["n_aircraft"] == 50000
    assert c.traffic["stack"][0] == "CDMETHOD PALLAS"
    assert [e["name"] for e in c.per_layer][-1] == "chunks_per_s"
    read = cellmod.reader("chunks_per_s", root)

    class Ctx:
        window = dict(chunks=30, wall_s=3.0)
    assert read(Ctx()) == 10.0
