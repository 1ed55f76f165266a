"""FAULT MESHKILL inside the port's serving fabric (JAX
``tests/test_meshchaos.py::test_meshkill_in_fabric_journals_pair_and_
completes``): a BATCH piece on a torch ``SimNode`` thread (CPU, 8
shards of the CPU device) runs SHARD REPLICATE 8 and, a simulated
minute in, FAULT MESHKILL 1.  The worker recovers in-process and sends
MESHLOST; the port's server journals the ``mesh_lost`` / ``resharded``
pair for the piece, no strike and no requeue, the piece completes
exactly once, and HEALTH's mesh section shows epoch 1 on 4 devices,
degraded.  The multi-process killed peer is
``tests/test_torch_multihost.py``.
"""
import json
import os

import pytest
import torch

zmq = pytest.importorskip("zmq")

from bluesky_tpu_torch.network.journal import BatchJournal  # noqa: E402
from bluesky_tpu_torch.parallel import sharding              # noqa: E402

from test_torch_server import Fabric                          # noqa: E402
from torch_parity import no_pacing                            # noqa: E402


def records(jpath):
    recs = []
    if os.path.isfile(jpath):
        with open(jpath, encoding="utf-8") as f:
            for line in f:
                try:
                    recs.append(json.loads(line))
                except json.JSONDecodeError:
                    pass
    return recs


def test_meshkill_in_fabric_journals_pair_and_completes(tmp_path,
                                                        monkeypatch):
    no_pacing(monkeypatch)
    monkeypatch.setattr(sharding, "default_devices",
                        lambda device=None: [torch.device("cpu")] * 8)
    scn = tmp_path / "mesh.scn"
    scn.write_text(
        "00:00:00.00>SCEN MESHCASE\n"
        "00:00:00.00>CRE AAA1 B744 52 4 90 FL200 250\n"
        "00:00:00.00>CRE AAA2 B744 52.2 4.2 90 FL200 250\n"
        "00:00:00.00>SHARD REPLICATE 8\n"
        "00:00:00.00>FF\n"
        "00:01:00.00>FAULT MESHKILL 1\n"
        "00:03:00.00>HOLD\n")
    fab = Fabric(tmp_path, hb_interval=0.5)
    jpath = fab.journal
    try:
        fab.client.stack(f"BATCH {scn}")
        assert fab.wait(lambda: not fab.server.scenarios
                        and not fab.server.inflight
                        and any(r["rec"] == "completed"
                                for r in records(jpath)),
                        timeout=120), records(jpath)
        by = {}
        for r in records(jpath):
            by.setdefault(r["rec"], []).append(r)
        assert len(by.get("completed", [])) == 1
        key = by["completed"][0]["key"]
        assert [r["key"] for r in by.get("mesh_lost", [])] == [key]
        assert [r["key"] for r in by.get("resharded", [])] == [key]
        resh = by["resharded"][0]
        assert resh["epoch"] == 1 and resh["ndev"] == 4 \
            and resh["mode"] == "replicate"
        # the worker recovered in-process: no strike, no requeue
        assert "crashed" not in by and "preempted" not in by
        state = BatchJournal.replay(jpath)
        assert state["pending"] == [] and len(state["completed"]) == 1
        # the HEALTH mesh section rides in on the progress heartbeats
        assert fab.wait(lambda: fab.server.health_payload()
                        .get("mesh", {}).get("epoch") == 1, timeout=30)
        mesh = fab.server.health_payload()["mesh"]
        assert mesh["devices"] == 4 and mesh["mode"] == "replicate" \
            and mesh["degraded"]
        assert "mesh: epoch 1" in fab.server.health_payload()["text"]
    finally:
        fab.close()
