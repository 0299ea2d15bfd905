"""Non-blocking event-loop HTTP transport (``selectors``-based).

The original front end was ``ThreadingHTTPServer``: one OS thread per
connection, each parked in a blocking ``readline``. That model capped the
serving layer at ~130 qps on this hardware — thread creation, stack
memory, and GIL-contended wakeups per connection dominated long before the
engine (2.9 ms single-row, 1.4 M rows/s batched) broke a sweat. This
module replaces it with the standard single-threaded readiness loop
(``selectors.DefaultSelector`` — epoll on Linux):

  * **One loop thread** owns every socket (the contract is annotated
    ``@loop_only`` / ``@cross_thread`` — ``contracts.py`` — and
    statically enforced by graftcheck rule ``loop-discipline``,
    docs/ANALYSIS.md). Reads feed the connection's
    ``protocol.RequestParser``; complete requests are dispatched to the
    application; response bytes queue on a per-connection write buffer
    flushed as the socket accepts them.
  * **Keep-alive pipelining.** A connection's buffered bytes may hold
    several requests; they are served strictly in order, one in flight at
    a time per connection.
  * **Explicit backpressure.** While a connection has a request in flight
    (or unflushed response bytes) the loop STOPS READING its socket: a
    client that floods pipelined requests is throttled by TCP flow
    control instead of ballooning server memory. Read buffers are bounded
    by the protocol caps on top.
  * **Idle reaping.** Connections idle past ``idle_timeout_s`` — including
    slow-loris partials that never complete a request — are swept and
    closed on a periodic tick, so each parked socket costs one fd and a
    small buffer, never a thread.
  * **Thread-safe completion.** Handlers may finish a request from any
    thread (the batcher's flush thread completes ``/predict`` futures):
    ``Responder.send`` marshals the response onto the loop via a wake
    pipe. ``call_later`` schedules deadline callbacks on the loop clock.
  * **Pre-fork sharding.** ``reuse_port=True`` binds with ``SO_REUSEPORT``
    so N worker processes each run their own loop on the same address and
    the kernel load-balances accepted connections across them
    (``cli serve --workers N``).

The application interface is two callbacks (see ``serve.server._App``):
``handle_request(req, responder)`` and
``handle_protocol_error(exc, responder)``. Handlers run ON the loop
thread and must not block — anything slow (device compute, profiler
captures) is handed to another thread and completed through the
responder.

**The outbound leg** (``UpstreamPool``): the fleet router proxies every
``/predict`` to a replica, and for three PRs that upstream hop ran on a
small pool of forwarder threads holding blocking ``http.client``
connections — the same thread-per-request architecture whose removal on
the listener side bought 10.1×. ``UpstreamPool`` moves the upstream leg
onto the SAME loop: non-blocking connect, request bytes written with
explicit backpressure (partial sends re-arm write interest), replies
parsed incrementally by ``protocol.ResponseParser``, and per-replica
keep-alive connection reuse with the strict poisoning rules a proxy
needs (a truncated or over-long reply closes the connection rather than
desyncing the next attempt; an idle pooled connection that receives
unsolicited bytes, or EOF, is dropped on the spot). One loop thread owns
every socket end to end — client side and replica side — with no thread
hand-off per request. A reused connection that dies before yielding a
single response byte gets ONE transparent resend on a fresh connection
(the idle-reap race every keep-alive client has); everything else
surfaces as an ``UpstreamError`` for the application's retry policy.

The listener binds in the constructor and is released by
``server_close()`` on every exit path — including a warmup failure before
the loop ever ran — so a crashed worker never wedges its port
(EADDRINUSE) for the replacement that rebinds it.
"""

from __future__ import annotations

import errno
import heapq
import selectors
import socket
import threading
import time
from collections import deque

from machine_learning_replications_tpu_torch.serve import protocol
from machine_learning_replications_tpu_torch.contracts import (
    cross_thread,
    loop_only,
)

_READ_CHUNK = 65536


class _Timer:
    __slots__ = ("deadline", "fn", "cancelled")

    def __init__(self, deadline: float, fn) -> None:
        self.deadline = deadline
        self.fn = fn
        self.cancelled = False

    def cancel(self) -> None:
        # Lazy deletion: the heap entry stays until its deadline pops, but
        # a cancelled timer's callback never runs and the entry is
        # discarded cheaply at pop time.
        self.cancelled = True


class _Conn:
    __slots__ = (
        "sock", "parser", "out_buf", "in_flight", "close_after_write",
        "last_activity", "partial_since", "mask", "closed", "advancing",
    )

    def __init__(self, sock: socket.socket, parser) -> None:
        self.sock = sock
        self.parser = parser
        self.out_buf = bytearray()
        self.in_flight = False
        self.close_after_write = False
        self.last_activity = time.monotonic()
        self.partial_since: float | None = None
        self.mask = 0  # currently registered selector interest
        self.closed = False
        self.advancing = False


class Responder:
    """Exactly-once reply channel for one dispatched request.

    ``send`` may be called from any thread; the transport marshals the
    bytes onto the loop. ``abort`` closes the connection with NOTHING
    written — the explicit-transport-error reply (a partial or garbled
    body would be the one unforgivable failure mode; a dead socket is
    not). The effective keep-alive of the reply is the request's
    keep-alive AND ``close=False``.
    """

    __slots__ = ("_server", "_conn", "_keep_alive", "_done", "_lock")

    def __init__(self, server: "EventLoopHttpServer", conn: _Conn,
                 keep_alive: bool) -> None:
        self._server = server
        self._conn = conn
        self._keep_alive = keep_alive
        self._done = False
        self._lock = threading.Lock()

    def _claim(self) -> bool:
        with self._lock:
            if self._done:
                return False
            self._done = True
            return True

    @cross_thread
    def send(
        self,
        code: int,
        body: bytes,
        content_type: str,
        headers: dict[str, str] | None = None,
        request_id: str | None = None,
        close: bool = False,
    ) -> None:
        if not self._claim():
            return
        keep = self._keep_alive and not close
        data = protocol.build_response(
            code, body, content_type, headers=headers,
            request_id=request_id, keep_alive=keep,
        )
        self._server._complete(self._conn, data, close=not keep)

    @cross_thread
    def send_json(self, code: int, obj, **kw) -> None:
        import json

        self.send(code, json.dumps(obj).encode(), "application/json", **kw)

    @cross_thread
    def abort(self) -> None:
        """Drop the connection without writing a byte."""
        if not self._claim():
            return
        self._server._post(lambda: self._server._close_conn(self._conn))


class EventLoopHttpServer:
    """Single-threaded non-blocking HTTP server over ``selectors``.

    ``app`` provides ``handle_request(req, responder)`` and
    ``handle_protocol_error(exc, responder)``. The listener binds here;
    run the loop with ``serve_forever()`` (blocking) — stop it with
    ``shutdown()`` from another thread, then ``server_close()``.
    """

    def __init__(
        self,
        address: tuple[str, int],
        app,
        backlog: int = 128,
        idle_timeout_s: float = 5.0,
        max_header_bytes: int = protocol.MAX_HEADER_BYTES,
        max_body_bytes: int = protocol.MAX_BODY_BYTES,
        max_connections: int = 8192,
        reuse_port: bool = False,
    ) -> None:
        self.app = app
        self.idle_timeout_s = float(idle_timeout_s)
        self.max_header_bytes = int(max_header_bytes)
        self.max_body_bytes = int(max_body_bytes)
        self.max_connections = int(max_connections)
        self._sel = selectors.DefaultSelector()
        self._conns: dict[socket.socket, _Conn] = {}
        self._timers: list[tuple[float, int, _Timer]] = []
        self._timer_seq = 0
        self._pending: deque = deque()  # cross-thread posted callables
        self._pending_lock = threading.Lock()
        self._running = False
        self._stop_requested = False
        self._drain_deadline: float | None = None
        self._stopped = threading.Event()
        self._stopped.set()  # not running yet
        self._loop_tid: int | None = None
        self._closed = False
        self._pools: list["UpstreamPool"] = []

        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            if reuse_port:
                # Pre-fork multi-worker mode: every worker binds the same
                # concrete port; the kernel spreads new connections across
                # the listeners.
                lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            lsock.bind(address)
            # Kernel accept backlog stays at 128 (the r6 lesson): bursts
            # must reach the application-level admission decision, not die
            # as silent SYN drops.
            lsock.listen(backlog)
            lsock.setblocking(False)
        except BaseException:
            lsock.close()
            raise
        self._listener: socket.socket | None = lsock
        self.server_address = lsock.getsockname()
        # Wake pipe: cross-thread posts (flush-thread completions) nudge a
        # sleeping select.
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        self._sel.register(lsock, selectors.EVENT_READ, "accept")

    # -- cross-thread entry points -----------------------------------------

    @cross_thread
    def _post(self, fn) -> None:
        """Run ``fn`` on the loop thread (soon). Safe from any thread;
        silently dropped once the loop has exited (late completions after
        shutdown must not deadlock their caller)."""
        with self._pending_lock:
            self._pending.append(fn)
            first = len(self._pending) == 1
        if first and threading.get_ident() != self._loop_tid:
            try:
                self._wake_w.send(b"\0")
            except OSError:
                pass

    @loop_only
    def call_later(self, delay_s: float, fn) -> _Timer:
        """Schedule ``fn`` on the loop thread after ``delay_s``. Loop
        thread only (the request handlers run there); returns a handle
        whose ``cancel()`` is safe from any thread."""
        t = _Timer(time.monotonic() + delay_s, fn)
        self._timer_seq += 1
        heapq.heappush(self._timers, (t.deadline, self._timer_seq, t))
        return t

    # -- loop --------------------------------------------------------------

    @loop_only
    def serve_forever(self) -> None:
        self._running = True
        self._stopped.clear()
        self._loop_tid = threading.get_ident()
        next_sweep = time.monotonic() + min(1.0, self.idle_timeout_s / 2)
        try:
            while True:
                now = time.monotonic()
                if self._stop_requested and self._drained(now):
                    break
                timeout = 0.5
                if self._timers:
                    timeout = min(timeout, max(
                        0.0, self._timers[0][0] - now
                    ))
                timeout = min(timeout, max(0.0, next_sweep - now))
                if self._stop_requested:
                    timeout = min(timeout, 0.05)
                for key, mask in self._sel.select(timeout):
                    kind = key.data
                    if kind == "accept":
                        self._accept()
                    elif kind == "wake":
                        try:
                            self._wake_r.recv(4096)
                        except OSError:
                            pass
                    elif type(kind) is _Conn:  # an inbound connection
                        conn = kind
                        if mask & selectors.EVENT_READ:
                            self._readable(conn)
                        if mask & selectors.EVENT_WRITE and not conn.closed:
                            self._writable(conn)
                    else:  # an upstream connection (UpstreamPool)
                        kind.pool._on_io(kind, mask)
                self._run_pending()
                now = time.monotonic()
                self._run_timers(now)
                if now >= next_sweep:
                    self._sweep_idle(now)
                    next_sweep = now + min(1.0, self.idle_timeout_s / 2)
        finally:
            self._running = False
            self._loop_tid = None
            self._teardown()
            self._stopped.set()

    @loop_only
    def _drained(self, now: float) -> bool:
        """Shutdown gate: every enqueued response flushed (or the drain
        deadline passed) — an admitted request's reply must not be cut off
        by shutdown racing the write."""
        if self._drain_deadline is not None and now >= self._drain_deadline:
            return True
        return not any(
            c.in_flight or c.out_buf for c in self._conns.values()
        )

    @loop_only
    def _run_pending(self) -> None:
        while True:
            with self._pending_lock:
                if not self._pending:
                    return
                fn = self._pending.popleft()
            try:
                fn()
            except Exception:
                pass  # a posted completion must never kill the loop

    @loop_only
    def _run_timers(self, now: float) -> None:
        while self._timers and self._timers[0][0] <= now:
            _, _, t = heapq.heappop(self._timers)
            if t.cancelled:
                continue
            try:
                t.fn()
            except Exception:
                pass  # a deadline callback must never kill the loop

    @loop_only
    def _sweep_idle(self, now: float) -> None:
        # In-flight requests are exempt: their lifetime is bounded by the
        # application's own request deadline, and reaping them would cut
        # off an admitted request's reply. Everything else — idle
        # keep-alives, drip-fed partials (stamped at first byte), AND
        # clients that stopped reading their response (out_buf making no
        # progress; _flush_writes refreshes last_activity per successful
        # send) — is bounded by idle_timeout_s.
        stale = [
            c for c in self._conns.values()
            if not c.in_flight
            and (
                now - c.last_activity > self.idle_timeout_s
                or (
                    c.partial_since is not None
                    and now - c.partial_since > self.idle_timeout_s
                )
            )
        ]
        for c in stale:
            self._close_conn(c)

    # -- connection lifecycle ----------------------------------------------

    @loop_only
    def _accept(self) -> None:
        while True:
            try:
                sock, _ = self._listener.accept()
            except BlockingIOError:
                return
            except OSError as exc:
                if exc.errno in (errno.EMFILE, errno.ENFILE):
                    # Fd exhaustion: the pending connection stays in the
                    # kernel queue, so the listener would read as ready
                    # on every select and busy-spin the loop. Pause
                    # accepting briefly instead; existing connections
                    # keep being served and closes free fds.
                    lsock = self._listener
                    try:
                        self._sel.unregister(lsock)
                    except (KeyError, ValueError):
                        pass

                    def resume():
                        if self._listener is lsock:
                            try:
                                self._sel.register(
                                    lsock, selectors.EVENT_READ, "accept"
                                )
                            except KeyError:
                                pass
                    self.call_later(0.2, resume)
                return
            if len(self._conns) >= self.max_connections:
                # Fd protection, not admission control (that is the
                # batcher's bounded queue): past the cap the connection is
                # refused at the door.
                sock.close()
                continue
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _Conn(sock, protocol.RequestParser(
                self.max_header_bytes, self.max_body_bytes
            ))
            self._conns[sock] = conn
            self._sel.register(sock, selectors.EVENT_READ, conn)
            conn.mask = selectors.EVENT_READ

    @loop_only
    def _close_conn(self, conn: _Conn) -> None:
        if conn.closed:
            return
        conn.closed = True
        if conn.mask:
            try:
                self._sel.unregister(conn.sock)
            except (KeyError, ValueError):
                pass
            conn.mask = 0
        self._conns.pop(conn.sock, None)
        try:
            conn.sock.close()
        except OSError:
            pass

    @loop_only
    def _set_interest(self, conn: _Conn, read: bool, write: bool) -> None:
        """Reconcile the selector mask with the wanted one — a no-op when
        unchanged, so the steady keep-alive path (read interest on for
        the whole connection lifetime) costs zero epoll_ctl calls per
        request."""
        mask = (selectors.EVENT_READ if read else 0) | \
            (selectors.EVENT_WRITE if write else 0)
        if mask == conn.mask:
            return
        if conn.mask == 0:
            self._sel.register(conn.sock, mask, conn)
        elif mask == 0:
            self._sel.unregister(conn.sock)
        else:
            self._sel.modify(conn.sock, mask, conn)
        conn.mask = mask

    @loop_only
    def _backpressured(self, conn: _Conn) -> bool:
        """A connection that keeps streaming pipelined bytes while a
        request is in flight gets its read interest dropped once it has
        buffered one full request's worth — TCP flow control then
        throttles the client; reading resumes when the response drains."""
        return conn.parser.buffered >= \
            self.max_header_bytes + self.max_body_bytes

    @loop_only
    def _readable(self, conn: _Conn) -> None:
        try:
            data = conn.sock.recv(_READ_CHUNK)
        except BlockingIOError:
            return
        except OSError:
            self._close_conn(conn)
            return
        if not data:
            self._close_conn(conn)
            return
        conn.last_activity = time.monotonic()
        conn.parser.feed(data)
        if conn.partial_since is None:
            # Stamped AFTER the feed and only when unset: a drip-fed
            # partial keeps its ORIGINAL arrival stamp (refreshing it per
            # recv would let one byte per second park the connection
            # forever), and leftover bytes behind a completed pipelined
            # request get their own stamp on the recv that brought them.
            conn.partial_since = conn.last_activity
        if (conn.in_flight or conn.out_buf) and self._backpressured(conn):
            self._set_interest(conn, read=False, write=bool(conn.out_buf))
            return
        self._advance(conn)

    @loop_only
    def _advance(self, conn: _Conn) -> None:
        """Dispatch buffered requests while the connection is free. One
        request in flight per connection: while it is, the socket is not
        read (backpressure) and buffered pipelined requests wait. The
        ``advancing`` guard makes this iterative: a handler that responds
        synchronously re-enters via the write path, and the outer loop —
        not recursion — picks up the next pipelined request (a hostile
        client packing hundreds of requests into one segment must not
        grow the Python stack)."""
        if conn.advancing:
            return
        conn.advancing = True
        try:
            while not (conn.closed or conn.in_flight or conn.out_buf):
                try:
                    req = conn.parser.next_request()
                except protocol.ProtocolError as exc:
                    conn.in_flight = True
                    conn.partial_since = None
                    responder = Responder(self, conn, keep_alive=False)
                    try:
                        self.app.handle_protocol_error(exc, responder)
                    except Exception:
                        responder.abort()
                    continue
                if req is None:
                    if not conn.parser.has_partial():
                        conn.partial_since = None
                    self._set_interest(
                        conn, read=True, write=bool(conn.out_buf)
                    )
                    return
                conn.in_flight = True
                conn.partial_since = None
                # Read interest deliberately stays ON while the request
                # is in flight: a well-behaved keep-alive client sends
                # nothing until the reply, so the common path costs zero
                # epoll reconfiguration; a pipelining flooder is caught
                # by the _backpressured check in _readable.
                responder = Responder(self, conn, keep_alive=req.keep_alive)
                try:
                    self.app.handle_request(req, responder)
                except Exception as exc:  # the loop survives handler bugs
                    import json

                    responder.send(
                        500, json.dumps(
                            {"error": f"{type(exc).__name__}: {exc}"}
                        ).encode(), "application/json", close=True,
                    )
        finally:
            conn.advancing = False

    def _complete(self, conn: _Conn, data: bytes, close: bool) -> None:
        """Queue response bytes for a dispatched request. Called via the
        responder — possibly from another thread, in which case it is
        posted onto the loop."""
        if threading.get_ident() != self._loop_tid and self._loop_tid \
                is not None:
            self._post(lambda: self._complete_on_loop(conn, data, close))
        else:
            self._complete_on_loop(conn, data, close)

    @loop_only
    def _complete_on_loop(self, conn: _Conn, data: bytes,
                          close: bool) -> None:
        if conn.closed:
            return
        conn.out_buf += data
        conn.close_after_write = conn.close_after_write or close
        conn.in_flight = False
        conn.last_activity = time.monotonic()
        self._flush_writes(conn)

    @loop_only
    def _writable(self, conn: _Conn) -> None:
        self._flush_writes(conn)

    @loop_only
    def _flush_writes(self, conn: _Conn) -> None:
        while conn.out_buf:
            try:
                n = conn.sock.send(conn.out_buf)
            except BlockingIOError:
                self._set_interest(
                    conn, read=not self._backpressured(conn), write=True
                )
                return
            except OSError:
                # Client hung up mid-reply: the request was already
                # accounted (trace/SLO finished before the bytes queued) —
                # just drop the connection.
                self._close_conn(conn)
                return
            if n <= 0:
                self._set_interest(
                    conn, read=not self._backpressured(conn), write=True
                )
                return
            del conn.out_buf[:n]
            # Write progress counts as activity: the idle sweep reaps a
            # client that STOPPED reading, not one draining slowly.
            conn.last_activity = time.monotonic()
        conn.last_activity = time.monotonic()
        if conn.close_after_write:
            self._close_conn(conn)
            return
        # Response fully written: serve the next pipelined request, or go
        # back to reading.
        self._set_interest(conn, read=True, write=False)
        self._advance(conn)

    # -- shutdown ----------------------------------------------------------

    def close_listener(self) -> None:
        """Stop accepting; existing connections keep being served."""
        if self._listener is None:
            return
        try:
            self._sel.unregister(self._listener)
        except (KeyError, ValueError):
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        self._listener = None

    @cross_thread
    def shutdown(self, flush_timeout_s: float = 10.0) -> None:
        """Stop the loop: close the listener, flush every queued response
        (bounded by ``flush_timeout_s``), then exit ``serve_forever``.
        Safe to call from any thread, more than once."""
        def _request_stop():
            self.close_listener()
            self._stop_requested = True
            self._drain_deadline = time.monotonic() + flush_timeout_s
        if not self._running:
            _request_stop()
            return
        self._post(_request_stop)
        if threading.get_ident() != self._loop_tid:
            self._stopped.wait(flush_timeout_s + 5.0)

    def _teardown(self) -> None:
        for conn in list(self._conns.values()):
            self._close_conn(conn)
        for pool in self._pools:
            pool.close_all()
        self.close_listener()

    def server_close(self) -> None:
        """Release every socket (idempotent). The listener is closed even
        when the loop never ran — the warmup-failure path — so the port is
        immediately rebindable."""
        if self._closed:
            return
        self.shutdown(flush_timeout_s=2.0)
        self._teardown()
        self._closed = True
        try:
            self._sel.close()
        except Exception:
            pass
        try:
            self._wake_r.close()
            self._wake_w.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# the outbound leg: loop-owned upstream connections (the router's data plane)
# ---------------------------------------------------------------------------


class UpstreamError(OSError):
    """Transport-level upstream failure: connect refused, reset, reply
    truncated mid-stream, or unparseable. The application's retry policy
    classifies these; none of them carry a usable response."""


class UpstreamTimeout(UpstreamError):
    """The attempt's own deadline expired before a complete reply."""


#: Upstream connection states.
_CONNECTING, _BUSY, _IDLE = "connecting", "busy", "idle"


class _UpstreamConn:
    __slots__ = (
        "pool", "sock", "key", "parser", "out_buf", "state", "attempt",
        "last_activity", "mask", "served", "closed",
    )

    def __init__(self, pool: "UpstreamPool", sock: socket.socket,
                 key) -> None:
        self.pool = pool
        self.sock = sock
        self.key = key
        self.parser = protocol.ResponseParser(
            pool.max_header_bytes, pool.max_body_bytes
        )
        self.out_buf = bytearray()
        self.state = _CONNECTING
        self.attempt: "UpstreamAttempt | None" = None
        self.last_activity = time.monotonic()
        self.mask = 0
        self.served = 0  # responses completed on this connection
        self.closed = False


class UpstreamAttempt:
    """Handle for one in-flight upstream request. ``cancel()`` (loop
    thread) abandons it: the connection closes (a half-spoken exchange
    can never be pooled) and ``on_done`` is not called. ``reused`` says
    whether the attempt rode a pooled keep-alive connection —
    bench/tests assert reuse across retries and hedges with it."""

    __slots__ = ("pool", "key", "addr", "data", "on_done", "timer", "conn",
                 "done", "reused", "resent")

    def __init__(self, pool, key, addr, data, on_done) -> None:
        self.pool = pool
        self.key = key
        self.addr = addr
        self.data = data
        self.on_done = on_done
        self.timer: _Timer | None = None
        self.conn: _UpstreamConn | None = None
        self.done = False
        self.reused = False
        self.resent = False

    @loop_only
    def cancel(self) -> bool:
        """True when this call actually cancelled the attempt — False
        when it had already completed/failed (its ``on_done`` fired or
        is about to). Callers that track per-attempt state (the
        router's per-replica outstanding counts) settle it exactly once
        based on this."""
        if self.done:
            return False
        self.done = True
        if self.timer is not None:
            self.timer.cancel()
        if self.conn is not None:
            self.pool._close_conn(self.conn)
        return True


class UpstreamPool:
    """Per-key keep-alive upstream connections on the server's event
    loop (see the module docstring's "outbound leg"). All entry points
    are loop-thread-only — the application dispatches requests from its
    handlers and receives ``on_done(result)`` back on the loop, where
    ``result`` is a ``protocol.HttpResponse`` or an ``UpstreamError``.

    Pooling contract: a connection returns to the idle pool only when
    the reply said keep-alive, the request was fully written, AND the
    parser is empty (no trailing bytes — a reply that overran its
    ``Content-Length`` has poisoned the framing and the connection
    closes instead). Idle connections keep read interest so a peer
    close is seen immediately, and are reaped past ``idle_timeout_s``.

    ``configure_sock`` (tests) runs on each fresh socket before connect
    — e.g. shrinking ``SO_SNDBUF`` to force the write-backpressure path
    at loopback speeds.
    """

    def __init__(
        self,
        server: EventLoopHttpServer,
        idle_timeout_s: float = 5.0,
        max_header_bytes: int = protocol.MAX_HEADER_BYTES,
        max_body_bytes: int = protocol.MAX_BODY_BYTES,
        max_idle_per_key: int = 4096,
        configure_sock=None,
    ) -> None:
        # max_idle_per_key sizes with the listener's own connection cap,
        # not against memory: at N concurrent proxied requests the pool
        # legitimately holds ~N upstream connections, and a small cap
        # CHURNS under load — completions overflow it, close pooled
        # connections, and the next dispatch burst pays fresh connects
        # (measured: a 128 cap cost ~1.9k reconnects over a 5k-request
        # 500-connection run). An idle fd is cheap; the reaper shrinks
        # the pool when load actually drops.
        self.server = server
        self.idle_timeout_s = float(idle_timeout_s)
        self.max_header_bytes = int(max_header_bytes)
        self.max_body_bytes = int(max_body_bytes)
        self.max_idle_per_key = int(max_idle_per_key)
        self.configure_sock = configure_sock
        self._idle: dict = {}  # key -> deque[_UpstreamConn]
        self._conns: set[_UpstreamConn] = set()
        self.opened_total = 0
        self.reused_total = 0
        self._closed = False
        self._sweep_timer: _Timer | None = None
        server._pools.append(self)

    # -- public API (loop thread) -------------------------------------------

    @loop_only
    def request(self, key, addr: tuple[str, int], data: bytes,
                timeout_s: float, on_done) -> UpstreamAttempt:
        """Send ``data`` (a fully rendered HTTP request) to ``addr``,
        reusing a pooled connection for ``key`` when one is alive.
        ``on_done`` fires exactly once on the loop thread with the
        parsed response or an ``UpstreamError`` — unless the attempt is
        cancelled first."""
        att = UpstreamAttempt(self, key, addr, data, on_done)
        att.timer = self.server.call_later(
            max(0.0, timeout_s), lambda: self._on_timeout(att)
        )
        self._ensure_sweep()
        conn = self._pop_idle(key)
        if conn is not None:
            att.reused = True
            self.reused_total += 1
            self._bind(att, conn)
        else:
            self._open(att)
        return att

    def stats(self) -> dict:
        return {
            "opened_total": self.opened_total,
            "reused_total": self.reused_total,
            "connections": len(self._conns),
            "idle": sum(len(d) for d in self._idle.values()),
        }

    @loop_only
    def close_all(self) -> None:
        """Drop every connection (loop teardown)."""
        self._closed = True
        if self._sweep_timer is not None:
            self._sweep_timer.cancel()
            self._sweep_timer = None
        for conn in list(self._conns):
            self._close_conn(conn)
        self._idle.clear()

    # -- connection management ----------------------------------------------

    @loop_only
    def _pop_idle(self, key) -> _UpstreamConn | None:
        dq = self._idle.get(key)
        while dq:
            conn = dq.pop()  # LIFO: the most recently used is the most
            if not conn.closed:  # likely to still be alive server-side
                return conn
        return None

    @loop_only
    def _open(self, att: UpstreamAttempt) -> None:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setblocking(False)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self.configure_sock is not None:
                self.configure_sock(sock)
            rc = sock.connect_ex(att.addr)
        except OSError as exc:
            sock.close()
            self._fail(att, UpstreamError(f"upstream connect: {exc}"))
            return
        if rc not in (0, errno.EINPROGRESS, errno.EWOULDBLOCK):
            sock.close()
            self._fail(att, UpstreamError(
                f"upstream connect: {errno.errorcode.get(rc, rc)}"
            ))
            return
        self.opened_total += 1
        conn = _UpstreamConn(self, sock, att.key)
        self._conns.add(conn)
        att.conn = conn
        conn.attempt = att
        conn.out_buf += att.data
        if rc == 0:
            conn.state = _BUSY
            self._flush(conn)
        else:
            self._set_interest(conn, selectors.EVENT_WRITE)

    @loop_only
    def _bind(self, att: UpstreamAttempt, conn: _UpstreamConn) -> None:
        """Ride a pooled idle connection: the parser is empty by the
        pooling contract, so the next bytes read are this reply's."""
        att.conn = conn
        conn.attempt = att
        conn.state = _BUSY
        conn.out_buf += att.data
        conn.last_activity = time.monotonic()
        self._flush(conn)

    @loop_only
    def _close_conn(self, conn: _UpstreamConn) -> None:
        if conn.closed:
            return
        conn.closed = True
        if conn.mask:
            try:
                self.server._sel.unregister(conn.sock)
            except (KeyError, ValueError):
                pass
            conn.mask = 0
        self._conns.discard(conn)
        try:
            conn.sock.close()
        except OSError:
            pass

    @loop_only
    def _set_interest(self, conn: _UpstreamConn, mask: int) -> None:
        if mask == conn.mask:
            return
        sel = self.server._sel
        if conn.mask == 0:
            sel.register(conn.sock, mask, conn)
        elif mask == 0:
            sel.unregister(conn.sock)
        else:
            sel.modify(conn.sock, mask, conn)
        conn.mask = mask

    # -- I/O (loop thread, dispatched by serve_forever) ----------------------

    @loop_only
    def _on_io(self, conn: _UpstreamConn, mask: int) -> None:
        if conn.closed:
            return
        if mask & selectors.EVENT_WRITE:
            if conn.state == _CONNECTING:
                err = conn.sock.getsockopt(
                    socket.SOL_SOCKET, socket.SO_ERROR
                )
                if err:
                    att = conn.attempt
                    self._close_conn(conn)
                    if att is not None:
                        self._fail(att, UpstreamError(
                            "upstream connect: "
                            f"{errno.errorcode.get(err, err)}"
                        ))
                    return
                conn.state = _BUSY
            self._flush(conn)
            if conn.closed:
                return
        if mask & selectors.EVENT_READ:
            self._readable(conn)

    @loop_only
    def _flush(self, conn: _UpstreamConn) -> None:
        """Write pending request bytes with explicit backpressure: a
        partial send re-arms write interest and the loop resumes when
        the replica's socket drains — no thread ever blocks in send.
        Read interest stays on throughout: a server may reply (413, 400)
        from the headers alone, before the body is fully written."""
        while conn.out_buf:
            try:
                n = conn.sock.send(conn.out_buf)
            except BlockingIOError:
                self._set_interest(
                    conn, selectors.EVENT_READ | selectors.EVENT_WRITE
                )
                return
            except OSError as exc:
                self._conn_died(conn, exc)
                return
            if n <= 0:
                self._set_interest(
                    conn, selectors.EVENT_READ | selectors.EVENT_WRITE
                )
                return
            del conn.out_buf[:n]
            conn.last_activity = time.monotonic()
        self._set_interest(conn, selectors.EVENT_READ)

    @loop_only
    def _readable(self, conn: _UpstreamConn) -> None:
        try:
            data = conn.sock.recv(_READ_CHUNK)
        except BlockingIOError:
            return
        except OSError as exc:
            self._conn_died(conn, exc)
            return
        att = conn.attempt
        if not data:  # EOF
            self._conn_died(conn, None)
            return
        conn.last_activity = time.monotonic()
        if att is None:
            # Unsolicited bytes on an idle pooled connection: the peer
            # is desynced or not speaking our framing — never reuse it.
            self._close_conn(conn)
            return
        conn.parser.feed(data)
        try:
            resp = conn.parser.next_response()
        except protocol.ProtocolError as exc:
            self._close_conn(conn)
            self._fail(att, UpstreamError(f"upstream protocol: {exc}"))
            return
        if resp is None:
            return  # reply still in flight
        self._complete_attempt(conn, att, resp)

    @loop_only
    def _complete_attempt(self, conn: _UpstreamConn, att: UpstreamAttempt,
                  resp) -> None:
        conn.served += 1
        conn.attempt = None
        # Pooling contract: keep-alive reply, request fully written,
        # parser empty. Trailing bytes past the declared Content-Length
        # mean the framing is poisoned — close, never desync the next
        # attempt riding this connection.
        if resp.keep_alive and not conn.out_buf \
                and conn.parser.at_start() and not self._closed:
            conn.state = _IDLE
            conn.last_activity = time.monotonic()
            dq = self._idle.setdefault(conn.key, deque())
            dq.append(conn)
            while len(dq) > self.max_idle_per_key:
                self._close_conn(dq.popleft())
            self._set_interest(conn, selectors.EVENT_READ)
        else:
            self._close_conn(conn)
        if att.done:
            return  # cancelled while the reply was in flight
        att.done = True
        if att.timer is not None:
            att.timer.cancel()
        try:
            att.on_done(resp)
        except Exception:
            pass  # a completion callback must never kill the loop

    # -- failure / retry / timeout -------------------------------------------

    @loop_only
    def _conn_died(self, conn: _UpstreamConn, exc) -> None:
        """EOF or a transport error (reset, EPIPE) on an upstream
        connection — the ONE classification point, so the send path and
        the read path agree: with reply bytes already buffered the
        response is truncated and the attempt FAILS (a transparent
        resend would silently execute the request twice after the
        replica already started answering it); with no reply bytes the
        attempt gets its one transparent fresh-connection resend (the
        stale keep-alive race); an idle pooled connection just closes."""
        att = conn.attempt
        mid_reply = not conn.parser.at_start()
        self._close_conn(conn)
        if att is None:
            return  # idle pooled connection reaped by the peer: fine
        if mid_reply:
            self._fail(att, UpstreamError(
                "upstream closed mid-response (truncated reply)"
                + (f": {exc}" if exc is not None else "")
            ))
        elif not att.resent:
            self._resend(att)
        else:
            self._fail(att, UpstreamError(
                "upstream connection closed before reply"
                + (f": {exc}" if exc is not None else "")
            ))

    @loop_only
    def _resend(self, att: UpstreamAttempt) -> None:
        if att.done:
            return
        att.resent = True
        att.conn = None
        self._open(att)

    @loop_only
    def _fail(self, att: UpstreamAttempt, exc: Exception) -> None:
        if att.done:
            return
        att.done = True
        att.conn = None
        if att.timer is not None:
            att.timer.cancel()

        def deliver():
            try:
                att.on_done(exc)
            except Exception:
                pass

        # Posted, not called: a connect that fails synchronously inside
        # ``request()`` must still complete asynchronously — callers
        # capture the returned attempt handle in their completion
        # closure, and an ``on_done`` firing before ``request`` returns
        # would see a half-constructed caller state.
        self.server._post(deliver)

    @loop_only
    def _on_timeout(self, att: UpstreamAttempt) -> None:
        if att.done:
            return
        if att.conn is not None:
            self._close_conn(att.conn)
        att.conn = None
        att.done = True
        try:
            att.on_done(UpstreamTimeout("upstream attempt timed out"))
        except Exception:
            pass

    # -- idle reaping ---------------------------------------------------------

    @loop_only
    def _ensure_sweep(self) -> None:
        if self._sweep_timer is not None or self._closed:
            return
        self._sweep_timer = self.server.call_later(
            min(1.0, self.idle_timeout_s / 2), self._sweep
        )

    @loop_only
    def _sweep(self) -> None:
        self._sweep_timer = None
        now = time.monotonic()
        for dq in self._idle.values():
            stale = [
                c for c in dq
                if c.closed or now - c.last_activity > self.idle_timeout_s
            ]
            for c in stale:
                try:
                    dq.remove(c)
                except ValueError:
                    pass
                self._close_conn(c)
        if self._conns and not self._closed:
            self._ensure_sweep()
