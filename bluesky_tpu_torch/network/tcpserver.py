"""Raw-TCP line bridge into the command stack (telnet-style).

Port of ``bluesky_tpu/network/tcpserver.py``; parity with the reference
``tools/network.py:151-184``
(TcpServer/StackTelnetServer): external programs (the reference's TCP
end-to-end tests, BlueBird-style REST adapters) connect a plain socket,
send stack command lines, and receive the echo output back on the same
connection.

Threading model: socket accept/read happens on daemon threads that only
ENQUEUE (line, connection) pairs; the simulation loop drains the queue at
its own cadence via ``pump()`` (wired into ``Simulation.step``), so all
stack/state access stays on the sim thread — the same discipline the
reference gets from its Qt event loop.  ``stop`` shuts the listening
socket down (which wakes a blocked ``accept``) and joins the accept
thread, so a finished worker leaves no thread behind.
"""
import queue
import socket
import threading


class StackTelnetServer:
    def __init__(self, sim, host="127.0.0.1", port=8888):
        self.sim = sim
        self.host = host
        self.port = port
        self._sock = None
        self._conns = {}
        self._nextid = 0
        self._queue = queue.Queue()
        self._accept_thread = None
        self.running = False

    # ------------------------------------------------------------ control
    def start(self):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        self.port = self._sock.getsockname()[1]   # resolve port 0
        self._sock.listen(5)
        self.running = True
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()
        return self.port

    def stop(self):
        self.running = False
        if self._sock is not None:
            # close() alone does not wake an accept() blocked in another
            # thread on Linux; shutdown() does
            for fn in (lambda: self._sock.shutdown(socket.SHUT_RDWR),
                       self._sock.close):
                try:
                    fn()
                except OSError:
                    pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
        for conn in list(self._conns.values()):
            try:
                conn.close()
            except OSError:
                pass
        self._conns.clear()

    def numConnections(self):
        return len(self._conns)

    # ------------------------------------------------------- socket side
    def _accept_loop(self):
        while self.running:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                break
            cid = self._nextid
            self._nextid += 1
            # Bounded sends: a stalled client must not block the sim
            # thread in pump() (socket.timeout is an OSError there)
            conn.settimeout(2.0)
            self._conns[cid] = conn
            threading.Thread(target=self._read_loop, args=(cid, conn),
                             daemon=True).start()

    def _read_loop(self, cid, conn):
        buf = b""
        while self.running:
            try:
                data = conn.recv(4096)
            except socket.timeout:
                continue           # idle connection; keep listening
            except OSError:
                break
            if not data:
                break
            buf += data
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                msg = line.decode("ascii", errors="ignore").strip()
                if msg:
                    self._queue.put((cid, msg))
        self._conns.pop(cid, None)
        try:
            conn.close()
        except OSError:
            pass

    # ---------------------------------------------------------- sim side
    def pump(self):
        """Drain pending lines on the SIM thread: stack, process, and
        send the echo output back to the issuing connection."""
        if self._queue.empty():
            return
        scr = self.sim.scr
        # Drain commands other clients queued first so their echoes
        # don't leak into a TCP reply.
        self.sim.stack.process()
        while True:
            try:
                cid, msg = self._queue.get_nowait()
            except queue.Empty:
                break
            # Capture echoes via a temporary tee (no echobuf indexing,
            # so the buffer stays boundable)
            collected = []
            orig_echo = scr.echo

            def tee(text="", flags=0, _c=collected, _o=orig_echo):
                _c.append(text)
                return _o(text, flags)

            scr.echo = tee
            try:
                self.sim.stack.stack(msg, sender=f"tcp{cid}")
                self.sim.stack.process()
            finally:
                scr.echo = orig_echo
            reply = "\n".join(collected)
            conn = self._conns.get(cid)
            if conn is not None and reply:
                try:
                    conn.sendall(reply.encode("ascii", errors="ignore")
                                 + b"\n")
                except OSError:
                    pass
