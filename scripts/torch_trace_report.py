"""Merge the port's flight-recorder dumps (``bluesky_tpu_torch/obs/
trace.py``: ``TRACE DUMP``, auto-dumps) into one Perfetto trace and
print a per-chunk table of the port's spans.

Rows are keyed by (pid, seq), the chunk's sequence number, which every
span of one chunk carries (docs/TORCH_TRACING.md): ``sim.step`` and the
spans under it take the ``seq`` of the chunk they dispatch, ``sim.edge``
and its ``sync`` the ``seq`` of the chunk they retire.  Host columns are
wall ms; the device columns (``dev_*``) are filled only by a dump taken
with ``TRACE ON DEVICE``, from the device-timed events on the
``cuda stream`` track.  A name met more than once in a chunk (the runs
of ``step.replay``, the ``sync`` waits) is summed.

    seq  chunk  step  dispatch  edge  sync  latency  dev_replay  dev_eager  dev_asas

The port's counterpart of ``scripts/trace_report.py``, whose table reads
the JAX package's ``chunk_edge``; it loads and merges the dumps as
``scripts/torch_devprof_report.py`` does, reads JSON only and imports
neither JAX nor torch.

Run:
    python scripts/torch_trace_report.py trace-*.json [-o merged.json]
"""
import argparse
import json
import os
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_devprof_report import load, merge  # noqa: E402

DEVICE_TID = "cuda stream"
#: (column, span name, on the device's track)
COLUMNS = (("step", "sim.step", False), ("dispatch", "chunk_dispatch", False),
           ("edge", "sim.edge", False), ("sync", "sync", False),
           ("dev_replay", "step.replay", True),
           ("dev_eager", "step.eager", True),
           ("dev_asas", "asas.interval", True))


def chunk_rows(events):
    """``{(pid, seq): {column: ms, "chunk": n, "latency": ms}}`` of the
    complete events that carry a ``seq``."""
    cols = {(name, dev): col for col, name, dev in COLUMNS}
    rows = defaultdict(dict)
    for ev in events:
        args = ev.get("args") or {}
        seq = args.get("seq")
        if ev.get("ph") != "X" or seq is None:
            continue
        row = rows[(ev.get("pid", 0), seq)]
        row.setdefault("t0", ev["ts"])
        if args.get("chunk") is not None:
            row["chunk"] = args["chunk"]
        if ev.get("name") == "sim.edge" and "latency_ms" in args:
            row["latency"] = args["latency_ms"]
        col = cols.get((ev.get("name"), ev.get("tid") == DEVICE_TID))
        if col is not None:
            row[col] = row.get(col, 0.0) + ev.get("dur", 0) / 1000.0
    return rows


def print_table(rows, out=sys.stdout):
    names = [c for c, _, _ in COLUMNS[:4]] + ["latency"] \
        + [c for c, _, _ in COLUMNS[4:]]
    head = f"{'pid':>7} {'seq':>5} {'chunk':>6} " \
        + " ".join(f"{c:>10}" for c in names)
    print(head, file=out)
    print("-" * len(head), file=out)
    for (pid, seq), row in sorted(rows.items(),
                                  key=lambda kv: kv[1].get("t0", 0)):
        cells = " ".join(f"{row[c]:10.3f}" if c in row else " " * 10
                         for c in names)
        print(f"{pid:>7} {seq:>5} {str(row.get('chunk', '')):>6} {cells}",
              file=out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dumps", nargs="+", help="trace-*.json dump files")
    ap.add_argument("-o", "--out", default=None,
                    help="write the merged Perfetto trace here")
    args = ap.parse_args(argv)
    events = load(args.dumps)
    if not events:
        print("no events found", file=sys.stderr)
        return 1
    if args.out:
        with open(args.out, "w") as f:
            json.dump(merge(events, {"sources": args.dumps}), f)
        print(f"merged {len(events)} events from {len(args.dumps)} "
              f"dump(s) -> {args.out}")
    print_table(chunk_rows(events))
    return 0


if __name__ == "__main__":
    sys.exit(main())
