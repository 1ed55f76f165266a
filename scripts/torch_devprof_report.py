"""Merge a device-profile window of the port (``bluesky_tpu_torch/obs/
devprof.py``) with flight-recorder dumps and print the per-chunk
device-time attribution table.

``PROFILE DEVICE [n] [dir]`` wraps the next n chunk dispatches in a
``torch.profiler`` window.  Two artifact families come out of one
window:

* flight-recorder dumps (``trace-*.json``, written by ``TRACE DUMP``,
  ``obs/trace.Recorder.dump``) carrying the ``devprof_chunk`` complete
  events — one per chunk, with the attribution split measured at the
  host edge (compute / halo / host-edge ms) — plus the
  ``device_profile`` span that brackets the whole window;
* the Chrome trace ``torch.profiler`` exports into the window's
  directory (``<dir>/devprof-<seq>.json``, CPU ops and, on the card,
  CUDA kernels and memcpys).

This script concatenates both into ONE Perfetto JSON (``-o``) so the
host spans and the profiler's timeline land on a shared axis (the
profiler's ``ts`` are relative to its ``baseTimeNanoseconds``, which is
added back to give the recorder's wall-anchored microseconds), and
prints a table from the ``devprof_chunk`` events:

    seq  chunk  compute_ms  halo_ms  edge_ms  device%

Port of ``scripts/devprof_report.py``, with the dump loader and merge of
``scripts/trace_report.py`` that it uses.  It reads JSON only and
imports neither JAX nor torch.

Run:
    python scripts/torch_devprof_report.py trace-*.json \\
        [--profile-dir DIR] [-o merged.json]
"""
import argparse
import glob
import gzip
import json
import os
import sys


def load(paths):
    """Read + concatenate recorder dumps, deduping events that appear in
    more than one (a dump does not clear the ring, so an incident
    auto-dump and a later manual dump from the same process overlap)."""
    events, seen = [], set()
    for p in paths:
        try:
            with open(p) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            print(f"skipping {p}: {e}", file=sys.stderr)
            continue
        evs = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
        for ev in evs:
            if not (isinstance(ev, dict) and "ts" in ev):
                continue
            key = (ev.get("pid"), ev.get("tid"), ev["ts"],
                   ev.get("name"), ev.get("ph"))
            if key in seen:
                continue
            seen.add(key)
            events.append(ev)
    events.sort(key=lambda e: e["ts"])
    return events


def merge(events, meta=None):
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if meta:
        doc["metadata"] = meta
    return doc


def load_profiler_traces(profile_dir):
    """The ``torch.profiler`` Chrome traces of a PROFILE DEVICE
    directory (``devprof-*.json``, or ``.json.gz``): their concatenated
    traceEvents, moved to wall-anchored microseconds, and the paths
    read."""
    events = []
    paths = sorted(p for pat in ("devprof-*.json", "devprof-*.json.gz")
                   for p in glob.glob(os.path.join(profile_dir, pat)))
    for p in paths:
        try:
            opener = gzip.open if p.endswith(".gz") else open
            with opener(p, "rt") as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            print(f"skipping {p}: {e}", file=sys.stderr)
            continue
        evs = doc.get("traceEvents", []) if isinstance(doc, dict) \
            else doc
        base_us = doc.get("baseTimeNanoseconds", 0) / 1e3 \
            if isinstance(doc, dict) else 0.0
        for ev in evs:
            if not isinstance(ev, dict):
                continue
            if base_us and isinstance(ev.get("ts"), (int, float)):
                ev = dict(ev, ts=ev["ts"] + base_us)
            events.append(ev)
    return events, paths


def attribution_rows(events):
    """Rows from devprof_chunk complete events (flight recorder), sorted
    by seq."""
    rows = []
    for ev in events:
        if ev.get("name") != "devprof_chunk" or ev.get("ph") != "X":
            continue
        args = ev.get("args") or {}
        rows.append({
            "seq": args.get("seq"),
            "chunk": args.get("chunk"),
            "compute_ms": args.get("compute_ms"),
            "halo_ms": args.get("halo_ms"),
            "edge_ms": args.get("edge_ms"),
        })
    rows.sort(key=lambda r: (r["seq"] is None, r["seq"]))
    return rows


def print_table(rows, out=sys.stdout):
    head = (f"{'seq':>5} {'chunk':>6} {'compute_ms':>11} "
            f"{'halo_ms':>9} {'edge_ms':>9} {'device%':>8}")
    print(head, file=out)
    print("-" * len(head), file=out)
    for r in rows:
        c = r.get("compute_ms") or 0.0
        h = r.get("halo_ms") or 0.0
        e = r.get("edge_ms") or 0.0
        tot = c + h + e
        pct = (100.0 * c / tot) if tot else 0.0
        print(f"{str(r.get('seq', '')):>5} {str(r.get('chunk', '')):>6}"
              f" {c:>11.2f} {h:>9.2f} {e:>9.2f} {pct:>7.1f}%",
              file=out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dumps", nargs="*",
                    help="flight-recorder trace-*.json dump files")
    ap.add_argument("--profile-dir", default=None,
                    help="PROFILE DEVICE output dir (holds the "
                         "devprof-*.json profiler traces)")
    ap.add_argument("-o", "--out", default=None,
                    help="write the merged Perfetto trace here")
    args = ap.parse_args(argv)

    host = load(args.dumps) if args.dumps else []
    device, dev_paths = ([], [])
    if args.profile_dir:
        device, dev_paths = load_profiler_traces(args.profile_dir)
        if not dev_paths:
            print(f"no profiler traces under {args.profile_dir}",
                  file=sys.stderr)
    if not host and not device:
        print("no events found", file=sys.stderr)
        return 1

    if args.out:
        doc = merge(host + device,
                    {"sources": list(args.dumps) + dev_paths})
        with open(args.out, "w") as f:
            json.dump(doc, f)
        print(f"merged {len(host)} host + {len(device)} device "
              f"events -> {args.out}")

    rows = attribution_rows(host)
    if rows:
        print_table(rows)
    else:
        print("no devprof_chunk events in the host dumps "
              "(was a PROFILE DEVICE window active?)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
