"""Entry point / mode dispatch of the port (port of
``bluesky_tpu/__main__.py``; parity: BlueSky.py:28-119).

Modes:
  (default) / --headless   start a Server broker that spawns sim workers
  --sim                    run one sim worker node (spawned by the server)
  --detached               run an embedded sim with no networking
  --client                 interactive console client (text UI)
  --import-navdata DIR     import a reference-format navdata tree
  --web                    embedded sim + live browser radar UI
  --web --attach           the browser radar of a running server
                           (GuiClient mirror)

The sim runs on ``settings.device``: CUDA unless a config file sets
``device = 'cpu'``; without CUDA and without that key the worker raises
instead of running on the CPU.  The server passes its ``--config-file``
to every worker it spawns, so the workers follow the server's device.
``--sim``, the server and ``--client`` need pyzmq and msgpack;
``--detached`` needs neither.

Example headless session on the card:
  python -m bluesky_tpu_torch --headless &
  python -m bluesky_tpu_torch --client
  > CRE KL204 B744 52 4 90 FL200 250
  > OP

On the CPU, start the server with ``--config-file cpu.cfg``, where
cpu.cfg holds the line ``device = 'cpu'``.

Browser radar on the card (open http://127.0.0.1:8080/):
  python -m bluesky_tpu_torch --web [--web-port 8080] [--scenfile X]
  python -m bluesky_tpu_torch --web --attach      (beside --headless)
``--web`` runs its own Simulation (on the CPU with ``--config-file
cpu.cfg``); ``--web --attach`` needs pyzmq and msgpack.
"""
import argparse
import os
import sys

from . import settings


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="bluesky_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--headless", action="store_true",
                      help="server + workers, no UI")
    mode.add_argument("--sim", action="store_true", help="one sim worker")
    mode.add_argument("--detached", action="store_true",
                      help="embedded sim, no networking")
    mode.add_argument("--client", action="store_true",
                      help="console client")
    mode.add_argument("--web", action="store_true",
                      help="embedded sim + live browser radar UI")
    parser.add_argument("--config-file", default="", help="settings file")
    parser.add_argument("--scenfile", default="", help="startup scenario")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--event-port", type=int, default=None)
    parser.add_argument("--stream-port", type=int, default=None)
    parser.add_argument("--discoverable", action="store_true")
    parser.add_argument("--web-port", type=int, default=8080,
                        help="port for --web mode")
    parser.add_argument("--attach", action="store_true",
                        help="with --web: attach the browser UI to a "
                             "running server (GuiClient mirror) instead "
                             "of embedding a sim; --host/--event-port/"
                             "--stream-port select the server")
    parser.add_argument("--node-id", default="",
                        help="hex worker id assigned by the spawning "
                             "server (crash tracking)")
    parser.add_argument("--upstream", default="",
                        help="chain this server under another: host:port "
                             "of the upstream server's client event port")
    parser.add_argument("--standby", action="store_true",
                        help="broker HA: start the server as a warm "
                             "standby that tails the shared journal "
                             "(point --resume-batch at the leader's "
                             "journal) and takes over leadership "
                             "automatically when the leader's lease "
                             "goes stale")
    parser.add_argument("--resume-batch", default="", metavar="JOURNAL",
                        help="replay a BATCH journal (JSONL WAL) from a "
                             "crashed/preempted server: completed pieces "
                             "are not re-run, in-flight pieces are "
                             "requeued, quarantine decisions persist; "
                             "new records append to the same journal")
    parser.add_argument("--import-navdata", default="", metavar="DIR",
                        help="import a reference-format navdata directory "
                             "(fix.dat/nav.dat/airports.dat/awy.dat/fir/"
                             "apt.zip) into the local cache and exit; the "
                             "imported set is used automatically whenever "
                             "no navdata directory is configured")
    parser.add_argument("--dest", default="",
                        help="with --import-navdata: destination directory "
                             "(default: <cache>/navdata)")
    args = parser.parse_args(argv)
    if args.attach and not args.web:
        parser.error("--attach only applies to --web "
                     "(use: bluesky-tpu --web --attach [--host H])")

    settings.init(args.config_file)

    if args.import_navdata:
        return run_import_navdata(args)
    if args.sim:
        return run_sim(args)
    if args.detached:
        return run_detached(args)
    if args.web:
        return run_web(args)
    if args.client:
        return run_client(args)
    return run_server(args)


def run_import_navdata(args):
    """Import a reference-format navdata tree into the local cache
    (source format per the reference navdatabase/load_navdata_txt.py —
    see navdb/loaders.py).

    Copies the recognized sources to ``--dest`` (default
    settings.imported_navdata_path), parses them once to warm the
    pickle cache, and prints what was loaded.  settings picks the
    imported tree up automatically when no navdata directory is
    configured."""
    import shutil
    from .navdb.loaders import load_navdata

    src = args.import_navdata
    if not os.path.isdir(src):
        print(f"--import-navdata: {src!r} is not a directory",
              file=sys.stderr)
        return 1
    names = ("fix.dat", "nav.dat", "airports.dat", "awy.dat",
             "icao-countries.dat", "apt.zip")
    present = [n for n in names if os.path.isfile(os.path.join(src, n))]
    has_fir = os.path.isdir(os.path.join(src, "fir"))
    if not present and not has_fir:
        print(f"--import-navdata: no recognized navdata files under "
              f"{src!r} (expected any of {', '.join(names)} or fir/)",
              file=sys.stderr)
        return 1

    dest = args.dest or settings.imported_navdata_path
    os.makedirs(dest, exist_ok=True)
    # A re-import REPLACES the previous one: recognized files/dirs the
    # new source does not provide are removed, so the destination is
    # always a faithful copy of ONE source.
    for n in names:
        if n not in present and os.path.isfile(os.path.join(dest, n)):
            os.remove(os.path.join(dest, n))
            print(f"  removed stale {n}")
    if os.path.isdir(os.path.join(dest, "fir")):
        shutil.rmtree(os.path.join(dest, "fir"))
        if not has_fir:
            print("  removed stale fir/")
    for n in present:
        shutil.copy2(os.path.join(src, n), os.path.join(dest, n))
        print(f"  copied {n}")
    if has_fir:
        shutil.copytree(os.path.join(src, "fir"),
                        os.path.join(dest, "fir"))
        print("  copied fir/")

    data = load_navdata(dest, cache_path=settings.cache_path)
    print(f"imported navdata -> {dest}: "
          f"{len(data['wpid'])} waypoints, {len(data['aptid'])} airports, "
          f"{len(data['awid'])} airway legs, {len(data['firs'])} FIRs, "
          f"{len(data.get('rwythresholds', {}))} airports with runway "
          "thresholds (cache warmed)")
    if dest != settings.imported_navdata_path:
        print(f"note: set `navdata_path = {dest!r}` in your settings file "
              "to use a non-default destination")
    return 0


def _start_telnet(sim):
    """Raw-TCP stack bridge on settings.telnet_port (the reference's
    StackTelnetServer, enabled for sim nodes; tools/network.py:151-184);
    ``telnet_port = 0`` turns it off."""
    if not settings.telnet_port:
        return
    from .network.tcpserver import StackTelnetServer
    try:
        sim.telnet = StackTelnetServer(sim, port=settings.telnet_port)
        sim.telnet.start()
        print(f"Telnet stack bridge on port {sim.telnet.port}")
    except OSError as e:
        print(f"Telnet bridge not started: {e}")
        sim.telnet = None


def _serve(node, args):
    """Start the bridge, load the scenario, run the node's loop; stop
    the bridge when the loop ends."""
    _start_telnet(node.sim)
    try:
        if args.scenfile:
            node.sim.stack.ic(args.scenfile)
        node.run()
    finally:
        if node.sim.telnet is not None:
            node.sim.telnet.stop()
            node.sim.telnet = None
    return 0


def _need_zmq(what):
    """None when pyzmq and msgpack import, else the message naming them
    (the networked modes need both; ``--detached`` neither)."""
    try:
        import msgpack  # noqa: F401
        import zmq  # noqa: F401
    except ImportError as e:
        return (f"{what} needs pyzmq and msgpack ({e}); `--detached` "
                "runs without them")
    return None


def run_server(args):
    import signal

    why = _need_zmq("the server")
    if why:
        print(why, file=sys.stderr)
        return 2
    from .network.server import Server
    # Port: the config file's port keys reach the server (JAX's binds
    # its worker-facing and discovery ports at the package defaults
    # whatever the settings say); with no such keys they are the same
    # defaults, and --event-port / --stream-port still win
    ports = {k: getattr(settings, f"{k}_port") for k in
             ("event", "stream", "wevent", "wstream", "discovery")}
    if args.event_port:
        ports["event"] = args.event_port
    if args.stream_port:
        ports["stream"] = args.stream_port
    upstream = None
    if args.upstream:
        host, _, port = args.upstream.rpartition(":")
        upstream = (host or "127.0.0.1", int(port))
    server = Server(headless=True, discoverable=args.discoverable,
                    ports=ports, max_nnodes=settings.max_nnodes,
                    upstream=upstream,
                    resume_journal=args.resume_batch or None,
                    ha_role="standby" if args.standby else None)
    role = f" [{server.ha_role}]" if server.ha_role else ""
    print(f"bluesky_tpu_torch server{role}: clients on "
          f"{server.ports['event']}/{server.ports['stream']}, workers on "
          f"{server.ports['wevent']}/{server.ports['wstream']}")
    if server.journal:
        print(f"bluesky_tpu_torch server: BATCH journal at "
              f"{server.journal.path}")
    # preemption-safe shutdown: SIGTERM (scheduler reclaim) drains the
    # broker loop, QUITs the workers, journals the clean-exit marker
    # and leaves — the journal then resumes the sweep on the next start
    signal.signal(signal.SIGTERM, lambda signum, frame: server.stop())
    server.start()
    server.addnodes(1)
    try:
        # timed-join loop, not a bare join(): an unbounded join can sit
        # in an uninterruptible wait and starve the SIGTERM handler —
        # waking every second guarantees prompt preemption shutdown
        while server.is_alive():
            server.join(timeout=1.0)
    except KeyboardInterrupt:
        server.stop()
        server.join(timeout=5)
    return 0


def run_sim(args):
    why = _need_zmq("--sim")
    if why:
        print(why, file=sys.stderr)
        return 2
    from .simulation.simnode import SimNode
    node = SimNode(event_port=args.event_port,
                   stream_port=args.stream_port,
                   node_id=bytes.fromhex(args.node_id)
                   if args.node_id else None)
    try:
        return _serve(node, args)
    finally:
        _log_launches(node)


def _log_launches(node):
    """Port: a worker's last log line names the CUDA kernel launches of
    its process (``ops.cd_sched.LAUNCHES``, ``ops.cd_pallas.LAUNCHES``,
    the forms launched at least once), so the operator of a spawned
    fleet sees which kernels its pieces ran.  The line goes out in one
    write: spawned workers share the server's output, and an unbuffered
    ``print`` writes its text and its newline apart, so two workers
    leaving together could interleave their lines."""
    import json
    from .ops import cd_pallas, cd_sched
    launched = {k: v for counts in (cd_sched.LAUNCHES, cd_pallas.LAUNCHES)
                for k, v in counts.items() if v}
    sys.stdout.write(f"bluesky_tpu_torch worker {node.node_id.hex()}: "
                     f"kernel launches {json.dumps(launched, sort_keys=True)}"
                     "\n")
    sys.stdout.flush()


def run_detached(args):
    from .simulation.simnode import DetachedSimNode
    return _serve(DetachedSimNode(), args)


def run_web(args):
    """Live browser radar (ui/web.py): an embedded sim on
    ``settings.device`` by default, or — with --attach — a GuiClient
    mirror of a running server (the same split as the reference's
    embedded pygame vs networked Qt radar)."""
    if args.attach:
        why = _need_zmq("--web --attach")
        if why:
            print(why, file=sys.stderr)
            return 2
        import time
        from .network.guiclient import GuiClient
        from .ui.web import ClientBackend, WebUI
        client = GuiClient()
        client.connect(host=args.host,
                       event_port=args.event_port or settings.event_port,
                       stream_port=args.stream_port
                       or settings.stream_port)
        backend = ClientBackend(client, pumped=True)
        backend.pump()           # seed the frame cache pre-serving
        ui = WebUI(backend, host="127.0.0.1",
                   port=args.web_port).start()
        print(f"bluesky_tpu_torch web UI (attached to {args.host}) on "
              f"http://{ui.host}:{ui.port}/", flush=True)
        try:
            while True:
                backend.pump()               # drain streams/events
                time.sleep(0.02)
        except KeyboardInterrupt:
            pass
        finally:
            ui.stop()
            client.close()
        return 0
    from .simulation.sim import Simulation
    from .ui.web import serve_sim
    sim = Simulation(device=settings.device)
    _start_telnet(sim)
    try:
        if args.scenfile:
            sim.stack.ic(args.scenfile)
        serve_sim(sim, host=args.host, port=args.web_port)
    finally:
        if sim.telnet is not None:
            sim.telnet.stop()
            sim.telnet = None
    return 0


def run_client(args):
    """Minimal text console: lines -> STACKCMD, ECHO/SIMINFO printed."""
    why = _need_zmq("--client")
    if why:
        print(why, file=sys.stderr)
        return 2
    from .network.client import Client
    client = Client()
    client.connect(host=args.host,
                   event_port=args.event_port or settings.event_port,
                   stream_port=args.stream_port or settings.stream_port)
    client.subscribe(b"SIMINFO")

    def on_event(name, data, sender):
        if name in (b"ECHO", b"HEALTH", b"HA"):
            print(data.get("text", data) if isinstance(data, dict)
                  else data)
        elif name == b"BATCHREJECTED":
            d = data or {}
            print(f"BATCH rejected: queue {d.get('queue_depth', '?')}/"
                  f"{d.get('limit', '?')} full — retry in "
                  f"{d.get('retry_after', '?')} s")
    client.event_received.connect(on_event)
    print(f"connected to {client.host_id.hex()}; "
          f"{len(client.nodes)} node(s). Ctrl-D to quit.")
    try:
        while True:
            client.receive(10)
            line = input("> ").strip()
            if not line:
                continue
            if line.upper() in ("QUIT", "EXIT", "BYE"):
                break
            if line.upper() == "HEALTH":
                # fabric-level introspection is answered by the SERVER,
                # not the active sim node
                client.request_health()
            else:
                client.stack(line)
            # give the reply a moment to arrive
            for _ in range(20):
                if client.receive(25):
                    break
    except (EOFError, KeyboardInterrupt):
        pass
    client.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
