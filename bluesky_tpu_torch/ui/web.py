"""Live browser frontend: the reference's radar-view UX, headlessly.

The reference's flagship user experience is a live Qt-OpenGL radar
window (``bluesky/ui/qtgl/radarwidget.py:115-1031``) with a command line
(``mainwindow.py:93-399``).  This module serves the same picture to a
web browser instead of a GL context: a tiny stdlib HTTP server streams
the existing SVG radar frames (``ui/radar.py`` — the same renderer the
SCREENSHOT command uses) over Server-Sent Events at a few Hz, and a
command box posts stack commands back, so a user can *watch* moving
traffic and fly the sim from any browser with zero dependencies.

Two backends plug in behind one ``WebUI`` facade:
  * an embedded :class:`~bluesky_tpu_torch.simulation.sim.Simulation`
    (``python -m bluesky_tpu_torch --web``), rendered from live state;
  * a connected :class:`~bluesky_tpu_torch.network.guiclient.GuiClient`,
    rendered from its ACDATA/ROUTEDATA nodeData mirror — the same
    client path the reference GUI consumes (screenio.py:18-21 streams).

Threading: the HTTP server runs daemon threads, but host-side Traffic
state (the ids list, routes, array replacement between chunks) is only
consistent on the sim thread.  ``SimBackend.pump()`` therefore renders
the frame *on the sim thread* between chunks and caches it; server
threads serve the cached frame, so they never read sim state mid-
mutation and N connected viewers cost one render, not N.  Stack
commands are queued to the owner loop the same way.  When no loop is
pumping (tests, ad-hoc embedding) ``frame()`` falls back to rendering
directly, which is safe only because nothing else is stepping the sim.

Port of ``bluesky_tpu/ui/web.py``.  The sim thread alone touches the
card: a frame is one device-to-host copy of the state's columns
(``radar.render_sim``), taken in ``pump()`` between chunks, where it
waits for the chunk in flight; a command first retires that chunk's
edge (``Simulation.drain_pipeline``), as the sim's own stack processing
does, and is answered after the refresh, so its reply comes with the
frame that shows it.  ``frame()`` renders in place only before the
first ``pump()`` (an idle sim); once a loop pumps, a server thread
serves the cache, or a placeholder while none is rendered yet, and
never copies from the card while a chunk is in flight.
"""
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

log = logging.getLogger(__name__)

_PAGE = """<!DOCTYPE html>
<html><head><title>bluesky_tpu_torch radar</title><style>
 body { background:#10141c; color:#9fd49f; font-family:monospace;
        margin:0; display:flex; flex-direction:column; height:100vh; }
 #radar { flex:1; display:flex; align-items:center;
          justify-content:center; overflow:hidden; cursor:crosshair; }
 #radar svg { max-width:100%; max-height:100%; }
 #bar { display:flex; padding:6px; background:#181e2a; }
 #cmd { flex:1; background:#0c0f16; color:#d0e8d0; border:1px solid
        #334; font-family:monospace; padding:4px 8px; }
 #echo { height:9em; overflow-y:auto; background:#0c0f16;
         padding:4px 8px; font-size:12px; white-space:pre-wrap; }
 #info { padding:2px 8px; color:#678; font-size:12px; }
 #nd { position:fixed; top:8px; right:8px; width:280px; height:280px;
       display:none; border:1px solid #334; background:#000; }
 #nd svg { width:100%; height:100%; }
</style></head><body>
 <div id="radar">connecting&hellip;</div>
 <div id="nd"></div>
 <div id="info"></div>
 <div id="bar"><input id="cmd" autofocus placeholder="stack command
 (CRE KL204 B744 52 4 90 FL200 250 / OP / FF 60 ...) &mdash; click the
 map to fill position/aircraft args, drag to pan, wheel to zoom"/></div>
 <div id="echo"></div>
<script>
 const radar = document.getElementById('radar');
 const info = document.getElementById('info');
 const echo = document.getElementById('echo');
 const cmd = document.getElementById('cmd');
 const nd = document.getElementById('nd');
 const es = new EventSource('/events');
 es.onmessage = ev => {
   const d = JSON.parse(ev.data);
   if (d.svg) radar.innerHTML = d.svg;
   if (d.info) info.textContent = d.info;
   if (d.nd) { nd.innerHTML = d.nd; nd.style.display = 'block'; }
   else nd.style.display = 'none';
 };
 function pushEcho(line, t) {
   echo.textContent = '> ' + line + '\\n' + (t || '') + '\\n'
     + echo.textContent;
 }
 async function sendCmd(line) {
   const r = await fetch('/cmd', {method:'POST', body: line});
   pushEcho(line, await r.text());
 }
 const hist = []; let hidx = -1;
 cmd.addEventListener('keydown', async ev => {
   if (ev.key === 'Enter' && cmd.value.trim()) {
     const line = cmd.value.trim(); hist.unshift(line); hidx = -1;
     cmd.value = '';
     await sendCmd(line);
   } else if (ev.key === 'ArrowUp') {
     hidx = Math.min(hidx + 1, hist.length - 1);
     if (hidx >= 0) cmd.value = hist[hidx];
   } else if (ev.key === 'ArrowDown') {
     hidx = Math.max(hidx - 1, -1);
     cmd.value = hidx >= 0 ? hist[hidx] : '';
   } else if (ev.key === 'Tab') {
     ev.preventDefault();              // command/filename completion
     const r = await fetch('/complete', {method:'POST', body: cmd.value});
     const out = await r.json();
     if (out.line) cmd.value = out.line;
     if (out.hint) pushEcho('?', out.hint);
   }
 });

 // ---- radar interaction: click-to-command, drag-pan, wheel-zoom ----
 function svgEl() { return radar.querySelector('svg'); }
 function extent() {
   const s = svgEl(); if (!s) return null;
   const e = (s.dataset.extent || '').split(',').map(Number);
   return e.length === 4 && e.every(isFinite) ? e : null;
 }
 function toLatLon(ev) {
   const s = svgEl(); const e = extent();
   if (!s || !e) return null;
   const r = s.getBoundingClientRect();
   const fx = (ev.clientX - r.left) / r.width;
   const fy = (ev.clientY - r.top) / r.height;
   return [e[1] - fy * (e[1] - e[0]), e[2] + fx * (e[3] - e[2])];
 }
 let drag = null;
 radar.addEventListener('mousedown', ev => {
   drag = {x: ev.clientX, y: ev.clientY, moved: false};
 });
 radar.addEventListener('mousemove', ev => {
   if (drag && Math.abs(ev.clientX - drag.x)
             + Math.abs(ev.clientY - drag.y) > 6) drag.moved = true;
 });
 radar.addEventListener('mouseup', async ev => {
   const d = drag; drag = null;
   const s = svgEl(); const e = extent();
   if (!s || !e) return;
   const r = s.getBoundingClientRect();
   if (d && d.moved) {           // drag -> PAN the view center
     const clat = (e[0] + e[1]) / 2
       + (ev.clientY - d.y) / r.height * (e[1] - e[0]);
     const clon = (e[2] + e[3]) / 2
       - (ev.clientX - d.x) / r.width * (e[3] - e[2]);
     await sendCmd('PAN ' + clat.toFixed(4) + ',' + clon.toFixed(4));
     return;
   }
   const ll = toLatLon(ev); if (!ll) return;
   const resp = await fetch('/click', {method:'POST',
     body: JSON.stringify({line: cmd.value, lat: ll[0], lon: ll[1]})});
   const out = await resp.json();
   if (out.tostack) pushEcho(out.tostack, out.echo);
   const td = out.todisplay || '';
   // a trailing newline means the command completed (it already ran
   // server-side): clear the line instead of leaving stale text
   if (td.endsWith('\\n')) cmd.value = '';
   else cmd.value += td;
   cmd.focus();
 });
 let wheelTimer = null, wheelDir = 0;
 radar.addEventListener('wheel', ev => {
   ev.preventDefault();
   wheelDir = ev.deltaY < 0 ? 1 : -1;   // one ZOOM per gesture window
   if (wheelTimer) return;
   wheelTimer = setTimeout(() => {
     wheelTimer = null;
     sendCmd(wheelDir > 0 ? 'ZOOM IN' : 'ZOOM OUT');
   }, 200);
 }, {passive: false});
</script></body></html>
"""


def _complete_line(line, stack=None, fileac=None):
    """Shared Tab-completion: {"line": completed, "hint": candidates}.

    First word incomplete -> command-name completion against the stack
    dictionary (when available); IC/BATCH -> scenario filename cycling
    via ui/console.Autocomplete.  ``fileac`` carries the caller's
    Autocomplete instance so repeated Tab presses CYCLE (its _previous
    glob state must survive between requests — a fresh instance per
    request would re-complete the same common prefix forever)."""
    from . import console
    words = line.split()
    # filename completion only while the filename is being typed; a
    # line that already has a filename + further args passes through
    if words and words[0].upper() in ("IC", "BATCH") and len(words) <= 2:
        from .. import settings
        ac = fileac if fileac is not None \
            else console.Autocomplete(settings.scenario_path)
        newline, hint = ac.complete(line)
        return {"line": newline, "hint": hint}
    if stack is not None and line and " " not in line:
        frag = line.upper()
        # snapshot: the sim thread may register/remove plugin commands
        # concurrently (stack.append_commands/remove_commands)
        names = sorted(n for n in list(stack.cmddict)
                       if n.startswith(frag))
        if not names:
            return {"line": line, "hint": ""}
        if len(names) == 1:
            return {"line": names[0] + " ", "hint": ""}
        import os
        prefix = os.path.commonprefix(names)
        return {"line": prefix, "hint": ", ".join(names[:20])}
    return {"line": line, "hint": ""}


_FILEAC_INIT_LOCK = threading.Lock()

#: what a pumped backend serves before its first render
_NO_FRAME = ('<svg xmlns="http://www.w3.org/2000/svg" width="1000" '
             'height="800"><text x="10" y="20" fill="#ccc">no frame '
             'yet</text></svg>', "waiting for the sim loop")


def _backend_complete(backend, line, stack=None):
    """Per-backend completion holding ONE Autocomplete across requests
    (reset when the typed line is not the one we last emitted, so a
    fresh user edit restarts the cycle — reference autocomplete.py
    semantics).  complete() runs on ThreadingHTTPServer handler
    threads, so the shared cycling state is lock-guarded; like the
    reference console there is ONE completion context per backend —
    two browsers Tab-completing different lines at once take turns
    resetting it, which is harmless (each reset just restarts that
    line's cycle)."""
    from . import console
    from .. import settings
    with _FILEAC_INIT_LOCK:
        lock = getattr(backend, "_fileac_lock", None)
        if lock is None:
            lock = backend._fileac_lock = threading.Lock()
    with lock:
        ac = getattr(backend, "_fileac", None)
        if ac is None:
            ac = console.Autocomplete(settings.scenario_path)
            backend._fileac = ac
            backend._fileac_last = None
        if line != backend._fileac_last:
            ac.reset()
        res = _complete_line(line, stack, fileac=ac)
        backend._fileac_last = res["line"]
        return res


class SimBackend:
    """Frame/command adapter over an embedded Simulation."""

    def __init__(self, sim):
        self.sim = sim
        self._pending = queue.Queue()
        self._frame = None               # (svg, info) cached by pump()
        self._nd = None                  # ND svg when SHOWND active
        self._plots = None               # plot sheet when PLOTs exist
        self.render_period = 0.25        # sim-thread time between
        #                                  renders, at least (s)
        self._last_render = 0.0
        self._last_request = 0.0         # last frame() call (viewer pull)
        self._pumped = False             # a loop pumps: serve the cache

    def _render(self):
        from . import radar
        svg = radar.render_sim(self.sim)
        # per-aircraft navigation display when SHOWND selected one
        self._nd = radar.render_nd(self.sim) \
            if getattr(self.sim.scr, "nd_acid", None) else None
        # live plot sheet (the InfoWindow analogue), only when plots run
        self._plots = radar.render_plots(self.sim) \
            if getattr(self.sim.plotter, "plots", None) else None
        return svg, (f"simt {float(self.sim.simt):8.1f} s   "
                     f"ntraf {self.sim.traf.ntraf}   "
                     f"state {self.sim.state_flag}")

    def nd_frame(self):
        return self._nd

    def frame(self):
        """Latest frame; served from the sim-thread cache once a loop
        pumps (a placeholder until its first render), rendered in place
        before that (idle sim only)."""
        self._last_request = time.monotonic()
        cached = self._frame
        if cached is not None:
            return cached
        if self._pumped:
            return _NO_FRAME
        return self._render()

    def command(self, line):
        """Queue a stack command; executed by the sim loop via pump()."""
        return self._submit("cmd", line, "(queued)")

    def click(self, line, lat, lon):
        """Radar click -> command completion (ui/radarclick.py), run on
        the sim thread like any command (it reads live traffic state)."""
        return self._submit("click", (line, lat, lon),
                            {"tostack": "", "todisplay": "", "echo": ""})

    def _submit(self, kind, payload, timeout_result):
        done = queue.Queue()
        self._pending.put((kind, payload, done))
        try:
            return done.get(timeout=5.0)
        except queue.Empty:
            return timeout_result

    def _run_cmd(self, line):
        # a command reads and writes the post-chunk state: retire the
        # chunk in flight first, as Simulation._plan_chunk does for the
        # stack (the pipelined loop's synchronous fallback)
        self.sim.drain_pipeline()
        self.sim.scr.echobuf.clear()
        self.sim.stack.stack(line)
        self.sim.stack.process()
        return "\n".join(self.sim.scr.echobuf)

    def complete(self, line):
        """Tab completion: command names from the live dictionary,
        IC/BATCH scenario filenames through the console's Autocomplete
        engine (ui/console.py — the reference console's Tab behavior).
        Reads stable dicts/the filesystem plus the lock-guarded
        completion-cycle state, so it is safe off the sim thread."""
        return _backend_complete(self, line, self.sim.stack)

    def pump(self):
        """Run queued commands and refresh the frame cache — called on
        the sim thread between chunks, the only place state is stable."""
        from . import radarclick
        self._pumped = True
        answers = []        # given after the refresh: the reply to a
        while True:         # command comes with the frame that shows it
            try:
                kind, payload, done = self._pending.get_nowait()
            except queue.Empty:
                break
            if kind == "cmd":
                answers.append((done, self._run_cmd(payload)))
            else:                           # radar click
                line, lat, lon = payload
                tostack, todisplay = radarclick.radarclick(
                    line, lat, lon, self.sim)
                out = {"tostack": tostack, "todisplay": todisplay,
                       "echo": ""}
                if tostack:
                    out["echo"] = self._run_cmd(tostack)
                answers.append((done, out))
        ran_cmd = bool(answers)
        now = time.monotonic()
        # Refresh at most at render_period and only while a viewer is
        # actually pulling frames (no browser connected -> the sim
        # thread pays nothing); always refresh right after a command —
        # the user who just typed CRE expects to see it.
        wanted = self._frame is None \
            or now - self._last_request < 3.0 * max(self.render_period, 1.0)
        if ran_cmd or (wanted
                       and now - self._last_render >= self.render_period):
            try:
                self._frame = self._render()
            except RuntimeError:
                raise    # torch's and CUDA's faults (the state's copy
                #          is where a fault of the chunk in flight shows)
            except Exception:
                # a drawing bug keeps the last good frame and the sim
                # loop it rides on, but is logged and counted
                log.exception("radar render failed")
                self.sim.pipe_stats["render_errors"] += 1
            # the period runs from the END of a render: a render that
            # takes longer than the period (10k aircraft on the card's
            # host: ~0.3 s) would otherwise run at every pump and leave
            # the sim one chunk between renders
            self._last_render = time.monotonic()
        for done, out in answers:
            done.put(out)


class ClientBackend:
    """Frame/command adapter over a connected GuiClient.

    Threading: ZMQ sockets are not thread-safe, so ONLY the thread
    calling ``pump()`` may touch the client socket.  HTTP threads queue
    commands here exactly like SimBackend; ``pump()`` (the attach
    loop's thread) executes them and drains the streams.  When nothing
    is pumping (ad-hoc embedding/tests) ``command()`` falls back to
    running inline, which is safe only single-threaded."""

    #: gesture/flow commands that succeed silently — don't hold the
    #: pump thread waiting for an ECHO that never comes
    _SILENT = {"PAN", "ZOOM", "OP", "HOLD", "PAUSE", "FF", "DTMULT"}

    def __init__(self, client, pumped=False):
        """``pumped=True`` declares up front that a pump loop will own
        the socket (run_web --attach), closing the startup window where
        an early HTTP command could race the loop on the ZMQ socket."""
        self.client = client
        self._pending = queue.Queue()
        self._pumping = pumped
        self._frame = None               # cached by pump()
        self._nd = None                  # ND cache (when SHOWND active)
        self.render_period = 0.25
        self._last_render = 0.0

    def _render(self):
        svg = self.client.render_svg()
        nd = self.client.get_nodedata()
        n = len(nd.acdata.get("id", [])) if nd.acdata else 0
        return svg, f"ntraf {n}   node {self.client.act or '-'}"

    def frame(self):
        """Serve the pump-thread frame cache (nodeData mutates on the
        pump thread mid-receive; rendering there keeps reads
        consistent).  Inline render only when nothing is pumping."""
        cached = self._frame
        if cached is not None:
            return cached
        return self._render()

    def command(self, line):
        if not self._pumping:
            return self._run_cmd(line)
        done = queue.Queue()
        self._pending.put((line, done))
        try:
            return done.get(timeout=8.0)
        except queue.Empty:
            return "(queued)"

    def _run_cmd(self, line):
        """Execute on the socket-owning thread only."""
        nd = self.client.get_nodedata()
        n0 = len(nd.echo_text)
        self.client.stack(line)
        # ECHO rides the event socket; the node replies between scan
        # chunks, which can lag while a chunk computes/compiles.  Known
        # no-echo gestures only get a token wait so drag-pan/zoom stay
        # snappy; anything else waits long enough to catch its reply.
        word = line.split()[0].upper() if line.split() else ""
        wait = 0.2 if word in self._SILENT else 2.5
        deadline = time.monotonic() + wait
        while time.monotonic() < deadline and len(nd.echo_text) == n0:
            self.client.receive(20)
        return "\n".join(nd.echo_text[n0:])

    def click(self, line, lat, lon):
        """Client mode has no live Simulation for the full radarclick
        logic; insert the clicked position (the most common argument)."""
        return {"tostack": "", "echo": "",
                "todisplay": f"{lat:.4f},{lon:.4f} "}

    def complete(self, line):
        return _backend_complete(self, line)   # filename completion only

    def nd_frame(self):
        """Client-side ND: served from the pump-thread cache like
        frame() (nodeData mutates on the pump thread); inline render
        only when nothing is pumping."""
        if self._pumping:
            return self._nd
        return self._render_nd()

    def _render_nd(self):
        from . import radar
        nd = self.client.get_nodedata()
        if not getattr(nd, "nd_acid", None):
            return None
        return radar.render_nd_acdata(nd)

    def pump(self):
        self._pumping = True
        ran = False
        while True:
            try:
                line, done = self._pending.get_nowait()
            except queue.Empty:
                break
            try:
                done.put(self._run_cmd(line))
            except Exception as exc:  # surface, don't kill the loop
                done.put(f"command failed: {exc}")
            ran = True
        self.client.receive()
        now = time.monotonic()
        if ran or self._frame is None \
                or now - self._last_render >= self.render_period:
            self._last_render = now
            try:
                self._frame = self._render()
            except Exception:        # keep the last good frame
                log.exception("mirror render failed")
            try:
                self._nd = self._render_nd()
            except Exception:        # never show a silently-stale ND
                log.exception("mirror ND render failed")
                self._nd = None


class WebUI:
    """The HTTP/SSE server; ``start()`` returns immediately (daemon)."""

    def __init__(self, backend, host="127.0.0.1", port=8080, fps=4.0):
        self.backend = backend
        self.host, self.port = host, port
        self.period = 1.0 / max(fps, 0.1)
        self.httpd = None
        ui = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):       # silence request spam
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    self._send(200, "text/html; charset=utf-8",
                               _PAGE.encode())
                elif self.path == "/frame.svg":
                    svg, _ = ui.backend.frame()
                    self._send(200, "image/svg+xml", svg.encode())
                elif self.path == "/nd.svg":
                    nd = ui.backend.nd_frame()
                    if nd:
                        self._send(200, "image/svg+xml", nd.encode())
                    else:
                        self._send(404, "text/plain",
                                   b"no ND selected (SHOWND acid)")
                elif self.path == "/plots.svg":
                    pl = getattr(ui.backend, "_plots", None)
                    if pl:
                        self._send(200, "image/svg+xml", pl.encode())
                    else:
                        self._send(404, "text/plain",
                                   b"no plots (PLOT x,y,dt)")
                elif self.path == "/events":
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.end_headers()
                    try:
                        while True:
                            svg, inf = ui.backend.frame()
                            d = {"svg": svg, "info": inf}
                            nd = ui.backend.nd_frame()
                            if nd:
                                d["nd"] = nd
                            payload = json.dumps(d)
                            self.wfile.write(
                                f"data: {payload}\n\n".encode())
                            self.wfile.flush()
                            time.sleep(ui.period)
                    except (BrokenPipeError, ConnectionResetError,
                            OSError):
                        return               # browser went away
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                if self.path == "/cmd":
                    n = int(self.headers.get("Content-Length", 0))
                    line = self.rfile.read(n).decode().strip()
                    out = ui.backend.command(line)
                    self._send(200, "text/plain; charset=utf-8",
                               (out or "").encode())
                elif self.path == "/complete":
                    n = int(self.headers.get("Content-Length", 0))
                    line = self.rfile.read(n).decode()
                    try:
                        out = ui.backend.complete(line)
                    except Exception as exc:  # completion must not 500
                        out = {"line": line, "hint": f"error: {exc}"}
                    self._send(200, "application/json",
                               json.dumps(out).encode())
                elif self.path == "/click":
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        req = json.loads(self.rfile.read(n).decode())
                        out = ui.backend.click(
                            str(req.get("line", "")),
                            float(req["lat"]), float(req["lon"]))
                    except (ValueError, KeyError, TypeError,
                            AttributeError) as exc:
                        out = {"tostack": "", "todisplay": "",
                               "echo": f"click error: {exc}"}
                    self._send(200, "application/json",
                               json.dumps(out).encode())
                else:
                    self._send(404, "text/plain", b"not found")

        self._handler = Handler

    def start(self):
        self.httpd = ThreadingHTTPServer((self.host, self.port),
                                         self._handler)
        self.port = self.httpd.server_address[1]      # resolve port 0
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return self

    def stop(self):
        if self.httpd:
            self.httpd.shutdown()
            self.httpd.server_close()
            self.httpd = None


def serve_sim(sim, host="127.0.0.1", port=8080, fps=4.0, run=True):
    """Serve an embedded sim and (optionally) drive its loop forever.

    The loop advances the sim (wall-clock paced unless the stack said
    FF/DTMULT) and pumps queued browser commands between chunks — the
    web equivalent of the reference's Qt event loop around the sim
    timer (``ui/qtgl/mainwindow.py``)."""
    backend = SimBackend(sim)
    backend.pump()       # seed the frame cache before any server thread
    ui = WebUI(backend, host=host, port=port, fps=fps).start()
    print(f"bluesky_tpu_torch web UI on http://{ui.host}:{ui.port}/",
          flush=True)
    if not run:
        return ui
    from ..simulation.sim import OP
    try:
        while True:
            backend.pump()
            if not sim.step():               # END
                break
            if sim.state_flag != OP:         # INIT/HOLD: idle politely
                time.sleep(0.05)
    except KeyboardInterrupt:
        pass
    finally:
        ui.stop()
    return ui
