"""HTTP/1.1 protocol layer — pure, transport-agnostic parse/respond logic.

Extracted from the original fused ``http.server`` front end so the wire
rules the serving contract depends on are testable as plain functions, with
no sockets anywhere:

  * **Incremental parsing.** ``RequestParser`` is fed raw bytes in whatever
    fragments the transport happens to read — a request split across many
    reads, or several pipelined requests in one TCP segment — and yields
    complete ``HttpRequest`` objects one at a time. Between requests the
    remainder stays buffered, so HTTP/1.1 keep-alive pipelining works by
    construction.
  * **Bounded buffering.** Header bytes are capped (431 past
    ``max_header_bytes``) and bodies are rejected from the
    ``Content-Length`` header alone (413 past ``max_body_bytes``, never
    buffered) — one connection cannot allocate past the caps no matter how
    it drips or floods bytes.
  * **Framing guards.** A body-carrying request with a missing, unparseable,
    or negative ``Content-Length`` is unframeable: the connection cannot be
    resynced (the next request line would be read out of the unconsumed
    body), so the parser raises and the reply must close. These are the
    same desync rules the threaded server enforced, now in one place.
  * **Response building.** ``build_response`` renders a full HTTP/1.1
    response (status line, ``Content-Length`` always, ``Connection: close``
    when the connection will not be reused) as bytes for any transport to
    write.
  * **The outbound leg.** The fleet router speaks HTTP in the other
    direction too: ``build_request`` renders a request for an upstream
    replica, and ``ResponseParser`` incrementally parses the reply the
    same way ``RequestParser`` parses requests — fed raw fragments,
    yielding one complete ``HttpResponse`` at a time, with the identical
    framing discipline (``Content-Length`` required, caps enforced,
    unframeable streams raise and the connection must close). A reused
    upstream connection is only safe while both sides agree on byte
    positions; the parser is where that agreement is checked.

Every parse failure is a ``ProtocolError`` carrying the HTTP status to
reply with and whatever request context (target, headers) was parsed before
the failure, so the application layer can still echo an ``X-Request-Id``
and trace the failure. A ``ProtocolError`` always closes the connection:
by definition the parser no longer knows where the next request starts.
"""

from __future__ import annotations

from urllib.parse import parse_qs, urlparse

#: Default caps — a patient JSON is ~600 bytes; anything near these bounds
#: is not a legitimate request for this API.
MAX_HEADER_BYTES = 16 * 1024
MAX_BODY_BYTES = 64 * 1024

#: Reason phrases for the status codes this server emits.
REASONS = {
    200: "OK",
    400: "Bad Request",
    403: "Forbidden",
    404: "Not Found",
    405: "Method Not Allowed",
    409: "Conflict",
    413: "Payload Too Large",
    431: "Request Header Fields Too Large",
    500: "Internal Server Error",
    501: "Not Implemented",
    502: "Bad Gateway",
    503: "Service Unavailable",
    504: "Gateway Timeout",
}

#: Methods that carry a body and therefore require Content-Length framing.
_BODY_METHODS = frozenset({"POST", "PUT", "PATCH"})


class ProtocolError(Exception):
    """A request that cannot be parsed or framed.

    ``code``/``message`` are the HTTP reply to send; ``target`` and
    ``headers`` are whatever was parsed before the failure (``None`` /
    empty when the failure happened earlier than that), so the reply can
    still echo request identity. The connection must close after the
    reply — an unframeable request means the byte stream position of the
    next request is unknown.
    """

    def __init__(
        self,
        code: int,
        message: str,
        target: str | None = None,
        headers: dict[str, str] | None = None,
    ) -> None:
        super().__init__(message)
        self.code = code
        self.message = message
        self.target = target
        self.headers = headers or {}

    @property
    def path(self) -> str | None:
        return urlparse(self.target).path if self.target else None


class HttpRequest:
    """One complete, framed request: method, target, headers, body.

    ``headers`` keys are lower-cased (HTTP header names are
    case-insensitive); ``path``/``query`` are the parsed target.
    ``keep_alive`` is the connection's post-reply reusability under the
    HTTP/1.1 defaults (1.1: persistent unless ``Connection: close``; 1.0:
    close unless ``Connection: keep-alive``) — the response builder and the
    transport both honor it.
    """

    __slots__ = ("method", "target", "path", "headers", "body",
                 "keep_alive", "_qs", "_query")

    def __init__(
        self,
        method: str,
        target: str,
        headers: dict[str, str],
        body: bytes,
        keep_alive: bool,
    ) -> None:
        self.method = method
        self.target = target
        # Fast split — the hot /predict path has no query string, and a
        # full urlparse per request is measurable on the event loop.
        self.path, _, self._qs = target.partition("?")
        self._query: dict[str, list[str]] | None = None
        self.headers = headers
        self.body = body
        self.keep_alive = keep_alive

    @property
    def query(self) -> dict[str, list[str]]:
        if self._query is None:
            self._query = parse_qs(self._qs)
        return self._query

    def get_header(self, name: str, default: str | None = None) -> str | None:
        return self.headers.get(name.lower(), default)

    def query_param(self, name: str, default: str) -> str:
        return self.query.get(name, [default])[0]


def _parse_head(
    head: bytes,
) -> tuple[str, str, str, dict[str, str]]:
    """Request line + header block → (method, target, version, headers).
    Raises ``ProtocolError`` on a malformed line."""
    lines = head.split(b"\r\n")
    try:
        parts = lines[0].decode("latin-1").split()
    except Exception:
        raise ProtocolError(400, "malformed request line")
    if len(parts) != 3:
        raise ProtocolError(
            400, f"malformed request line: {lines[0][:80].decode('latin-1')!r}"
        )
    method, target, version = parts
    if not version.startswith("HTTP/1."):
        raise ProtocolError(400, f"unsupported protocol version {version}",
                            target=target)
    headers: dict[str, str] = {}
    for raw in lines[1:]:
        if not raw:
            continue
        name, sep, value = raw.partition(b":")
        if not sep:
            raise ProtocolError(
                400, f"malformed header line: {raw[:80].decode('latin-1')!r}",
                target=target, headers=headers,
            )
        headers[name.decode("latin-1").strip().lower()] = \
            value.decode("latin-1").strip()
    return method, target, version, headers


class RequestParser:
    """Incremental HTTP/1.1 request parser over a bounded byte buffer.

    ``feed`` raw bytes as they arrive; ``next_request`` returns one
    complete ``HttpRequest``, ``None`` while more bytes are needed, and
    raises ``ProtocolError`` when the stream is unparseable or exceeds a
    cap. Bytes past a complete request stay buffered for the next call —
    pipelined requests drain one per call, in order.
    """

    def __init__(
        self,
        max_header_bytes: int = MAX_HEADER_BYTES,
        max_body_bytes: int = MAX_BODY_BYTES,
    ) -> None:
        self.max_header_bytes = int(max_header_bytes)
        self.max_body_bytes = int(max_body_bytes)
        self._buf = bytearray()

    def feed(self, data: bytes) -> None:
        self._buf += data

    @property
    def buffered(self) -> int:
        return len(self._buf)

    def has_partial(self) -> bool:
        """Bytes buffered that do not yet form a complete request — the
        state a slow-loris client parks a connection in; the transport's
        idle reaper uses this to bound how long it may persist."""
        return len(self._buf) > 0

    def next_request(self) -> HttpRequest | None:
        buf = self._buf
        if not buf:
            return None
        end = buf.find(b"\r\n\r\n")
        if end < 0:
            if len(buf) > self.max_header_bytes:
                # The header block never terminated within the cap: an
                # attacker (or a broken client) streaming unbounded header
                # bytes. 431 is the specific status for it.
                raise ProtocolError(
                    431, f"headers exceed {self.max_header_bytes} bytes"
                )
            return None
        if end > self.max_header_bytes:
            raise ProtocolError(
                431, f"headers exceed {self.max_header_bytes} bytes"
            )
        method, target, version, headers = _parse_head(bytes(buf[:end]))
        if "transfer-encoding" in headers:
            # Chunked framing is not part of this API's contract; accepting
            # the header while ignoring it would desync the connection.
            raise ProtocolError(
                400, "Transfer-Encoding is not supported",
                target=target, headers=headers,
            )
        length = 0
        raw_length = headers.get("content-length")
        if method in _BODY_METHODS:
            try:
                length = int(raw_length)  # type: ignore[arg-type]
            except (TypeError, ValueError):
                length = -1
            if length < 0:
                # Missing, unparseable, or negative Content-Length: the
                # body length is unknowable, so the connection cannot be
                # resynced either — the reply must close it.
                raise ProtocolError(
                    400, "missing or invalid Content-Length",
                    target=target, headers=headers,
                )
        elif raw_length is not None:
            # A GET/HEAD with a declared body: frame (and deliver) it so
            # the connection stays in sync instead of parsing the stale
            # body bytes as the next request line.
            try:
                length = max(0, int(raw_length))
            except ValueError:
                raise ProtocolError(
                    400, "missing or invalid Content-Length",
                    target=target, headers=headers,
                )
        if length > self.max_body_bytes:
            # Reject from the header alone — the body is never buffered.
            raise ProtocolError(
                413, f"body exceeds {self.max_body_bytes} bytes",
                target=target, headers=headers,
            )
        body_start = end + 4
        if len(buf) - body_start < length:
            return None  # body still in flight
        body = bytes(buf[body_start:body_start + length])
        del buf[:body_start + length]
        keep_alive = _keep_alive(version, headers)
        return HttpRequest(method, target, headers, body, keep_alive)


def _keep_alive(version: str, headers: dict[str, str]) -> bool:
    conn = headers.get("connection", "").lower()
    if version == "HTTP/1.0":
        return conn == "keep-alive"
    return conn != "close"


class HttpResponse:
    """One complete, framed upstream response: status code, headers,
    body. ``headers`` keys are lower-cased; ``keep_alive`` is whether the
    CONNECTION may carry another request after this reply (HTTP/1.1
    defaults — the pooling decision also requires the parser to be empty,
    which the transport checks)."""

    __slots__ = ("code", "reason", "headers", "body", "keep_alive")

    def __init__(
        self,
        code: int,
        reason: str,
        headers: dict[str, str],
        body: bytes,
        keep_alive: bool,
    ) -> None:
        self.code = code
        self.reason = reason
        self.headers = headers
        self.body = body
        self.keep_alive = keep_alive

    def get_header(self, name: str, default: str | None = None) -> str | None:
        return self.headers.get(name.lower(), default)


class ResponseParser:
    """Incremental HTTP/1.1 *response* parser — the outbound mirror of
    ``RequestParser``, for the transport's upstream leg.

    ``feed`` raw bytes as they arrive; ``next_response`` returns one
    complete ``HttpResponse``, ``None`` while more bytes are needed, and
    raises ``ProtocolError`` when the stream is garbled or exceeds a cap.
    The framing rules are deliberately strict: every response this stack
    emits carries a ``Content-Length`` (``build_response`` guarantees it),
    so a missing/invalid one on the upstream leg means the peer is not one
    of ours or the stream is desynced — unframeable either way, and the
    connection must close. ``Transfer-Encoding`` is rejected for the same
    reason as inbound. A ``ProtocolError`` here never reaches a client
    as-is; the router classifies it as an upstream failure (retryable).

    ``at_start`` distinguishes a clean EOF between responses (an idle
    keep-alive connection the peer reaped — retryable on a fresh socket)
    from an EOF mid-response (a truncated reply — the bytes received so
    far are unusable and must never be taken for a complete answer).
    """

    def __init__(
        self,
        max_header_bytes: int = MAX_HEADER_BYTES,
        max_body_bytes: int = MAX_BODY_BYTES,
    ) -> None:
        self.max_header_bytes = int(max_header_bytes)
        self.max_body_bytes = int(max_body_bytes)
        self._buf = bytearray()

    def feed(self, data: bytes) -> None:
        self._buf += data

    @property
    def buffered(self) -> int:
        return len(self._buf)

    def at_start(self) -> bool:
        """True when no response bytes are pending — the only state in
        which a connection EOF is a clean close rather than truncation."""
        return not self._buf

    def next_response(self) -> HttpResponse | None:
        buf = self._buf
        if not buf:
            return None
        end = buf.find(b"\r\n\r\n")
        if end < 0:
            if len(buf) > self.max_header_bytes:
                raise ProtocolError(
                    502, f"upstream headers exceed {self.max_header_bytes} "
                    "bytes"
                )
            return None
        if end > self.max_header_bytes:
            raise ProtocolError(
                502, f"upstream headers exceed {self.max_header_bytes} bytes"
            )
        lines = bytes(buf[:end]).split(b"\r\n")
        try:
            parts = lines[0].decode("latin-1").split(None, 2)
            version, code = parts[0], int(parts[1])
            reason = parts[2] if len(parts) > 2 else ""
        except (ValueError, IndexError):
            raise ProtocolError(
                502, "malformed upstream status line: "
                f"{lines[0][:80].decode('latin-1')!r}"
            )
        if not version.startswith("HTTP/1."):
            raise ProtocolError(
                502, f"unsupported upstream protocol version {version}"
            )
        headers: dict[str, str] = {}
        for raw in lines[1:]:
            if not raw:
                continue
            name, sep, value = raw.partition(b":")
            if not sep:
                raise ProtocolError(
                    502, "malformed upstream header line: "
                    f"{raw[:80].decode('latin-1')!r}"
                )
            headers[name.decode("latin-1").strip().lower()] = \
                value.decode("latin-1").strip()
        if "transfer-encoding" in headers:
            raise ProtocolError(
                502, "upstream Transfer-Encoding is not supported"
            )
        try:
            length = int(headers.get("content-length"))  # type: ignore[arg-type]
        except (TypeError, ValueError):
            length = -1
        if length < 0:
            # Every server in this stack stamps Content-Length on every
            # reply; its absence means close-delimited framing (not part
            # of this contract) or a desynced stream.
            raise ProtocolError(
                502, "upstream response missing or invalid Content-Length"
            )
        if length > self.max_body_bytes:
            raise ProtocolError(
                502, f"upstream body exceeds {self.max_body_bytes} bytes"
            )
        body_start = end + 4
        if len(buf) - body_start < length:
            return None  # body still in flight
        body = bytes(buf[body_start:body_start + length])
        del buf[:body_start + length]
        keep_alive = _keep_alive(version, headers)
        return HttpResponse(code, reason, headers, body, keep_alive)


def build_request(
    method: str,
    target: str,
    headers: dict[str, str] | None = None,
    body: bytes = b"",
    host: str = "",
) -> bytes:
    """Render a complete HTTP/1.1 request as bytes — the outbound leg's
    counterpart of ``build_response``. ``Content-Length`` is always
    present on body-carrying methods (the framing contract both parsers
    enforce); connections default to keep-alive."""
    lines = [f"{method} {target} HTTP/1.1", f"Host: {host or 'localhost'}"]
    if method in _BODY_METHODS or body:
        lines.append(f"Content-Length: {len(body)}")
    if headers:
        lines.extend(f"{k}: {v}" for k, v in headers.items())
    head = "\r\n".join(lines).encode("latin-1") + b"\r\n\r\n"
    return head + body


def build_response(
    code: int,
    body: bytes,
    content_type: str,
    headers: dict[str, str] | None = None,
    request_id: str | None = None,
    keep_alive: bool = True,
) -> bytes:
    """Render a complete HTTP/1.1 response as bytes.

    ``Content-Length`` is always present (the keep-alive framing
    contract); ``Connection: close`` is added when the connection will not
    be reused, so clients stop waiting for a next response the moment the
    socket closes.
    """
    reason = REASONS.get(code, "Unknown")
    lines = [
        f"HTTP/1.1 {code} {reason}",
        f"Content-Type: {content_type}",
        f"Content-Length: {len(body)}",
    ]
    if request_id is not None:
        # Echoed (or assigned) correlation id: the client can join its own
        # latency record against /debug/requests samples.
        lines.append(f"X-Request-Id: {request_id}")
    if headers:
        lines.extend(f"{k}: {v}" for k, v in headers.items())
    if not keep_alive:
        lines.append("Connection: close")
    head = "\r\n".join(lines).encode("latin-1") + b"\r\n\r\n"
    return head + body
