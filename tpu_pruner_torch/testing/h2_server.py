"""Minimal HTTP/2 server shim for the hermetic fakes.

The daemon's shared transport (native/src/h2.cpp) multiplexes every
request to an endpoint over one connection as concurrent h2 streams. For
the python test tiers to exercise that path — and for tests to assert
multiplexing actually happened — the fakes themselves must speak h2.
There is no `h2` package in the image, and the client's wire usage is
deliberately narrow (HPACK literal-without-indexing with raw strings,
one HEADERS frame per request, DATA for bodies, no server push), so this
module implements exactly that subset by hand:

  - `maybe_serve_h2(handler, stats)` peeks the connection's first bytes
    from inside a BaseHTTPRequestHandler: an `PRI * HTTP/2.0` preface
    hands the socket to an `_H2Connection`, anything else falls through
    to the normal HTTP/1.1 path. One request-handling implementation
    (the fake's do_GET/do_PATCH/...) serves both protocols.
  - Each h2 stream synthesizes an HTTP/1.1 request and runs it through a
    fresh instance of the fake's handler class on a worker thread; the
    handler's response bytes are re-framed as HEADERS + DATA on the fly
    (chunked watch streams become incremental DATA frames), so streaming
    semantics — including server-initiated drops — survive translation.
  - `TransportStats` counts accepted connections, h2 connections, total
    and peak-concurrent streams, so tests can assert e.g. that a warm
    mega cycle opened ≤ 1 connection to the endpoint.

Flow control is deliberately ignored on the server side: the native
client advertises 8 MiB windows and returns credit on every DATA frame,
so TCP backpressure is the only throttle this shim needs.
"""

from __future__ import annotations

import io
import threading
from concurrent.futures import ThreadPoolExecutor

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

FRAME_DATA = 0x0
FRAME_HEADERS = 0x1
FRAME_RST = 0x3
FRAME_SETTINGS = 0x4
FRAME_PING = 0x6
FRAME_GOAWAY = 0x7
FRAME_WINDOW_UPDATE = 0x8
FRAME_CONTINUATION = 0x9

FLAG_END_STREAM = 0x1
FLAG_ACK = 0x1
FLAG_END_HEADERS = 0x4
FLAG_PADDED = 0x8
FLAG_PRIORITY = 0x20

MAX_FRAME = 16384  # the client's (default) SETTINGS_MAX_FRAME_SIZE

# HPACK static table (RFC 7541 appendix A): index → (name, value). The
# client only emits literal-without-indexing fields, but tolerate indexed
# references for robustness.
STATIC_TABLE = [
    (None, None),
    (":authority", ""), (":method", "GET"), (":method", "POST"), (":path", "/"),
    (":path", "/index.html"), (":scheme", "http"), (":scheme", "https"),
    (":status", "200"), (":status", "204"), (":status", "206"), (":status", "304"),
    (":status", "400"), (":status", "404"), (":status", "500"),
    ("accept-charset", ""), ("accept-encoding", "gzip, deflate"),
    ("accept-language", ""), ("accept-ranges", ""), ("accept", ""),
    ("access-control-allow-origin", ""), ("age", ""), ("allow", ""),
    ("authorization", ""), ("cache-control", ""), ("content-disposition", ""),
    ("content-encoding", ""), ("content-language", ""), ("content-length", ""),
    ("content-location", ""), ("content-range", ""), ("content-type", ""),
    ("cookie", ""), ("date", ""), ("etag", ""), ("expect", ""), ("expires", ""),
    ("from", ""), ("host", ""), ("if-match", ""), ("if-modified-since", ""),
    ("if-none-match", ""), ("if-range", ""), ("if-unmodified-since", ""),
    ("last-modified", ""), ("link", ""), ("location", ""), ("max-forwards", ""),
    ("proxy-authenticate", ""), ("proxy-authorization", ""), ("range", ""),
    ("referer", ""), ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""),
    ("transfer-encoding", ""), ("user-agent", ""), ("vary", ""), ("via", ""),
    ("www-authenticate", ""),
]


class TransportStats:
    """Per-fake transport accounting, safe to read from test threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self.connections = 0        # TCP connections accepted (h1 + h2)
        self.h2_connections = 0     # connections that spoke the h2 preface
        self.h2_streams = 0         # request streams served over h2
        self.max_concurrent_streams = 0  # high-water concurrent h2 streams
        self._active = 0

    def connection_opened(self):
        with self._lock:
            self.connections += 1

    def h2_connection_opened(self):
        with self._lock:
            self.h2_connections += 1

    def stream_opened(self):
        with self._lock:
            self.h2_streams += 1
            self._active += 1
            self.max_concurrent_streams = max(self.max_concurrent_streams, self._active)

    def stream_closed(self):
        with self._lock:
            self._active = max(0, self._active - 1)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "connections": self.connections,
                "h2_connections": self.h2_connections,
                "h2_streams": self.h2_streams,
                "max_concurrent_streams": self.max_concurrent_streams,
            }


# ── HPACK (the literal-heavy subset the native client emits) ────────────


def _read_prefix_int(block: bytes, pos: int, bits: int) -> tuple[int, int]:
    mask = (1 << bits) - 1
    v = block[pos] & mask
    pos += 1
    if v < mask:
        return v, pos
    shift = 0
    while True:
        b = block[pos]
        pos += 1
        v += (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7


def _read_string(block: bytes, pos: int) -> tuple[str, int]:
    huffman = bool(block[pos] & 0x80)
    length, pos = _read_prefix_int(block, pos, 7)
    raw = block[pos:pos + length]
    pos += length
    if huffman:
        # The native client never huffman-codes; any other client is out of
        # this shim's scope.
        raise ValueError("h2 fake: huffman-coded HPACK string unsupported")
    return raw.decode("utf-8", "surrogateescape"), pos


def hpack_decode(block: bytes) -> list[tuple[str, str]]:
    out: list[tuple[str, str]] = []
    pos = 0
    while pos < len(block):
        b = block[pos]
        if b & 0x80:  # indexed
            idx, pos = _read_prefix_int(block, pos, 7)
            if not 1 <= idx < len(STATIC_TABLE):
                raise ValueError(f"h2 fake: dynamic-table index {idx}")
            name, value = STATIC_TABLE[idx]
            out.append((name, value))
        elif b & 0xE0 == 0x20:  # dynamic table size update
            _, pos = _read_prefix_int(block, pos, 5)
        else:  # literal (with/without/never indexing)
            bits = 6 if b & 0xC0 == 0x40 else 4
            idx, pos = _read_prefix_int(block, pos, bits)
            if idx == 0:
                name, pos = _read_string(block, pos)
            elif idx < len(STATIC_TABLE):
                name = STATIC_TABLE[idx][0]
            else:
                raise ValueError(f"h2 fake: dynamic-table name index {idx}")
            value, pos = _read_string(block, pos)
            out.append((name, value))
    return out


def _hpack_len(n: int) -> bytes:
    # 7-bit prefix integer, H bit 0
    if n < 127:
        return bytes([n])
    out = bytearray([0x7F])
    n -= 127
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def hpack_literal(name: str, value: str) -> bytes:
    nb = name.encode()
    vb = value.encode("utf-8", "surrogateescape")
    return b"\x00" + _hpack_len(len(nb)) + nb + _hpack_len(len(vb)) + vb


def frame_header(length: int, ftype: int, flags: int, stream: int) -> bytes:
    return bytes([
        (length >> 16) & 0xFF, (length >> 8) & 0xFF, length & 0xFF,
        ftype, flags,
        (stream >> 24) & 0x7F, (stream >> 16) & 0xFF, (stream >> 8) & 0xFF, stream & 0xFF,
    ])


# ── per-stream response translation ─────────────────────────────────────


class _StreamWriter(io.RawIOBase):
    """The synthesized handler's wfile: parses the HTTP/1.1 response bytes
    it writes — status line, headers, then chunked/content-length/
    close-delimited body — and re-frames them as h2 HEADERS + DATA on the
    parent connection as they arrive (a flushed watch event becomes a DATA
    frame immediately)."""

    def __init__(self, conn: "_H2Connection", stream_id: int):
        self.conn = conn
        self.sid = stream_id
        self.buf = bytearray()
        self.state = "headers"
        self.chunked = False
        self.remaining = None  # content-length countdown
        self.headers_sent = False
        self.ended = False
        self.cancelled = threading.Event()
        # Content-length responses accumulate ALL their frames here and
        # leave in ONE locked write at _end(): an actuation burst is
        # dozens of small responses, and 3 lock+write+flush rounds per
        # response (headers, body, end) made the shim the latency floor.
        # Chunked / close-delimited bodies (watch streams) still flush
        # per event — streaming semantics survive translation.
        self.pending = bytearray()

    def writable(self):
        return True

    def write(self, data):
        if self.cancelled.is_set() or self.conn.dead.is_set():
            raise BrokenPipeError("h2 stream cancelled")
        self.buf += bytes(data)
        self._pump()
        return len(data)

    def flush(self):
        pass

    def _pump(self):
        if self.state == "headers":
            end = self.buf.find(b"\r\n\r\n")
            if end < 0:
                return
            head = bytes(self.buf[:end]).decode("latin-1").split("\r\n")
            del self.buf[:end + 4]
            status = head[0].split(" ", 2)[1] if " " in head[0] else "200"
            headers = []
            for line in head[1:]:
                if ":" not in line:
                    continue
                k, v = line.split(":", 1)
                k = k.strip().lower()
                v = v.strip()
                if k in ("connection", "keep-alive", "transfer-encoding", "upgrade"):
                    if k == "transfer-encoding" and "chunked" in v.lower():
                        self.chunked = True
                    continue
                if k == "content-length":
                    self.remaining = int(v)
                headers.append((k, v))
            block = hpack_literal(":status", status)
            for k, v in headers:
                block += hpack_literal(k, v)
            # A content-length: 0 response (or 204-style no-body) could end
            # here, but the handler may still be mid-write; END_STREAM is
            # decided by the body state machine / finalize().
            frame = frame_header(len(block), FRAME_HEADERS, FLAG_END_HEADERS,
                                 self.sid) + block
            if self.remaining is not None:
                self.pending += frame  # batched with the body at _end()
            else:
                self.conn.send_raw(bytes(frame))
            self.headers_sent = True
            self.state = "body"
            if self.remaining == 0 and not self.chunked:
                self._end()
                return
        if self.state == "body":
            self._pump_body()

    def _pump_body(self):
        if self.chunked:
            while True:
                nl = self.buf.find(b"\r\n")
                if nl < 0:
                    return
                try:
                    size = int(bytes(self.buf[:nl]).split(b";")[0], 16)
                except ValueError:
                    raise BrokenPipeError("h2 fake: bad chunk size") from None
                if len(self.buf) < nl + 2 + size + 2:
                    return
                data = bytes(self.buf[nl + 2:nl + 2 + size])
                del self.buf[:nl + 2 + size + 2]
                if size == 0:
                    self._end()
                    return
                self._data(data)
        elif self.remaining is not None:
            take = min(self.remaining, len(self.buf))
            if take:
                self._data(bytes(self.buf[:take]))
                del self.buf[:take]
                self.remaining -= take
            if self.remaining == 0:
                self._end()
        else:
            # close-delimited: forward whatever arrives; finalize() ends.
            if self.buf:
                self._data(bytes(self.buf))
                self.buf.clear()

    def _data(self, data: bytes):
        # One buffered write for the whole payload: a multi-megabyte
        # Prometheus matrix is hundreds of 16 KiB frames, and paying a
        # lock + write + flush per frame made the Python shim (not the
        # client) the measured transport floor.
        out = bytearray()
        for off in range(0, len(data), MAX_FRAME):
            piece = data[off:off + MAX_FRAME]
            out += frame_header(len(piece), FRAME_DATA, 0, self.sid)
            out += piece
        if self.remaining is not None:
            self.pending += out  # content-length: batched until _end()
        else:
            self.conn.send_raw(bytes(out))

    def _end(self):
        if not self.ended:
            self.ended = True
            self.pending += frame_header(0, FRAME_DATA, FLAG_END_STREAM,
                                         self.sid)
            self.conn.send_raw(bytes(self.pending))
            self.pending.clear()

    def finalize(self):
        """Handler finished (or died): close out the stream."""
        if self.ended:
            return
        if not self.headers_sent:
            # Handler produced nothing (e.g. it raised before responding):
            # surface a 500 so the client's stream doesn't hang.
            block = hpack_literal(":status", "500")
            try:
                self.conn.send_frame(FRAME_HEADERS, FLAG_END_HEADERS, self.sid, block)
            except OSError:
                return
            self.headers_sent = True
        try:
            incomplete = (self.chunked  # terminal 0-chunk never arrived
                          or (self.remaining is not None and self.remaining > 0))
            if self.pending and incomplete:
                # flush what the handler DID produce before the reset, so
                # the client sees headers + partial body + RST — the same
                # torn-connection shape the HTTP/1.1 path presents
                self.conn.send_raw(bytes(self.pending))
                self.pending.clear()
            if incomplete:
                # The HTTP/1.1 handler dropped the connection mid-body
                # (kill_watches-style abrupt drop): the h2 translation is a
                # stream RESET, not a clean end — the client must see a
                # transport error exactly like a torn TCP connection.
                self.ended = True
                self.conn.send_frame(FRAME_RST, 0, self.sid,
                                     (0x2).to_bytes(4, "big"))  # INTERNAL_ERROR
            else:
                self._end()
        except OSError:
            pass


# ── the connection ──────────────────────────────────────────────────────


class _H2Connection:
    def __init__(self, handler, stats: TransportStats | None):
        self.handler = handler
        self.stats = stats
        self.wlock = threading.Lock()
        self.dead = threading.Event()
        self.writers: dict[int, _StreamWriter] = {}
        self.writers_lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=256,
                                        thread_name_prefix="h2-stream")

    def send_frame(self, ftype: int, flags: int, stream: int, payload: bytes):
        self.send_raw(frame_header(len(payload), ftype, flags, stream) + payload)

    def send_raw(self, frames: bytes):
        """Write pre-framed bytes (one or many whole frames) in one locked
        write+flush — bulk DATA goes through here as a single syscall."""
        if self.dead.is_set():
            raise BrokenPipeError("h2 connection closed")
        try:
            with self.wlock:
                self.handler.wfile.write(frames)
                self.handler.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError, ValueError):
            # ValueError: "I/O operation on closed file" — the connection
            # thread already tore the socket down.
            self.dead.set()
            raise BrokenPipeError("h2 connection closed") from None

    def serve(self):
        if self.stats:
            self.stats.h2_connection_opened()
        rfile = self.handler.rfile
        # Server preface: our SETTINGS (all defaults) must be the first
        # frame — the client's prior-knowledge probe waits for it.
        self.send_frame(FRAME_SETTINGS, 0, 0, b"")
        pending: dict[int, dict] = {}  # open request streams awaiting DATA
        collecting = None  # (stream_id, end_stream, block) across CONTINUATION
        try:
            while not self.dead.is_set():
                head = rfile.read(9)
                if not head or len(head) < 9:
                    break
                length = (head[0] << 16) | (head[1] << 8) | head[2]
                ftype, flags = head[3], head[4]
                stream = ((head[5] & 0x7F) << 24) | (head[6] << 16) | (head[7] << 8) | head[8]
                payload = rfile.read(length) if length else b""
                if length and len(payload) < length:
                    break
                if ftype == FRAME_SETTINGS:
                    if not flags & FLAG_ACK:
                        self.send_frame(FRAME_SETTINGS, FLAG_ACK, 0, b"")
                elif ftype == FRAME_PING:
                    if not flags & FLAG_ACK:
                        self.send_frame(FRAME_PING, FLAG_ACK, 0, payload)
                elif ftype == FRAME_WINDOW_UPDATE:
                    pass  # flow control ignored server-side (see module doc)
                elif ftype == FRAME_GOAWAY:
                    break
                elif ftype == FRAME_RST:
                    pending.pop(stream, None)
                    with self.writers_lock:
                        w = self.writers.get(stream)
                    if w:
                        w.cancelled.set()
                elif ftype in (FRAME_HEADERS, FRAME_CONTINUATION):
                    block = payload
                    if ftype == FRAME_HEADERS:
                        if flags & FLAG_PADDED:
                            pad = block[0]
                            block = block[1:len(block) - pad]
                        if flags & FLAG_PRIORITY:
                            block = block[5:]
                        collecting = [stream, bool(flags & FLAG_END_STREAM), bytearray(block)]
                    elif collecting is not None:
                        collecting[2] += block
                    if collecting is not None and flags & FLAG_END_HEADERS:
                        sid, end_stream, blk = collecting
                        collecting = None
                        headers = hpack_decode(bytes(blk))
                        if end_stream:
                            self._dispatch(sid, headers, b"")
                        else:
                            pending[sid] = {"headers": headers, "body": bytearray()}
                elif ftype == FRAME_DATA:
                    st = pending.get(stream)
                    data = payload
                    if flags & FLAG_PADDED:
                        pad = data[0]
                        data = data[1:len(data) - pad]
                    # Return flow-control credit like a real server: without
                    # this the client's 65535-byte connection send window
                    # drains across request bodies and every later POST
                    # stalls ("send window stalled past the stream
                    # deadline") — we ignore OUR send windows, not theirs.
                    if length:
                        inc = length.to_bytes(4, "big")
                        credit = frame_header(4, FRAME_WINDOW_UPDATE, 0, 0) + inc
                        if not flags & FLAG_END_STREAM:
                            credit += frame_header(4, FRAME_WINDOW_UPDATE, 0,
                                                   stream) + inc
                        self.send_raw(credit)
                    if st is not None:
                        st["body"] += data
                        if flags & FLAG_END_STREAM:
                            pending.pop(stream, None)
                            self._dispatch(stream, st["headers"], bytes(st["body"]))
                # PRIORITY / PUSH_PROMISE / unknown frames: skip
        except (ValueError, OSError):
            pass
        finally:
            self.dead.set()
            with self.writers_lock:
                for w in self.writers.values():
                    w.cancelled.set()

    def _dispatch(self, stream_id: int, headers: list[tuple[str, str]], body: bytes):
        if self.stats:
            self.stats.stream_opened()
        writer = _StreamWriter(self, stream_id)
        with self.writers_lock:
            self.writers[stream_id] = writer
        # Pool, not Thread(): a scale-actuation burst opens dozens of
        # short streams back to back, and per-stream thread spawn (~1 ms
        # under load) serialized their responses behind the reader loop.
        # Unbounded workers: long-lived watch streams must never starve a
        # queued request stream behind them.
        self._pool.submit(self._run_stream, stream_id, headers, body, writer)

    def _run_stream(self, stream_id: int, headers: list[tuple[str, str]], body: bytes,
                    writer: _StreamWriter):
        try:
            pseudo = {k: v for k, v in headers if k.startswith(":")}
            method = pseudo.get(":method", "GET")
            path = pseudo.get(":path", "/")
            lines = [f"{method} {path} HTTP/1.1"]
            if ":authority" in pseudo:
                lines.append(f"Host: {pseudo[':authority']}")
            for k, v in headers:
                if k.startswith(":") or k == "content-length":
                    continue
                lines.append(f"{k}: {v}")
            if body:
                lines.append(f"Content-Length: {len(body)}")
            raw = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body

            handler_cls = type(self.handler)
            sub = object.__new__(handler_cls)
            sub.rfile = io.BufferedReader(io.BytesIO(raw))
            sub.wfile = writer
            sub.server = self.handler.server
            sub.client_address = self.handler.client_address
            sub.connection = self.handler.connection
            sub.close_connection = True
            try:
                sub.handle_one_request()
            except (BrokenPipeError, ConnectionResetError, OSError):
                pass  # stream cancelled / connection died mid-response
        finally:
            writer.finalize()
            with self.writers_lock:
                self.writers.pop(stream_id, None)
            if self.stats:
                self.stats.stream_closed()


def maybe_serve_h2(handler, stats: TransportStats | None = None) -> bool:
    """Call at the top of handle_one_request(): returns True after serving
    an entire h2 connection (the caller must close), False to proceed with
    normal HTTP/1.1 handling."""
    rfile = handler.rfile
    peek = getattr(rfile, "peek", None)
    if peek is None:
        return False
    try:
        head = peek(3)[:3]
    except (OSError, ValueError):
        return False
    if head != b"PRI":  # no HTTP/1.x method starts with PRI (RFC 7540 §3.5)
        return False
    preface = rfile.read(len(PREFACE))
    if preface != PREFACE:
        return True  # garbage that started like a preface: drop the conn
    _H2Connection(handler, stats).serve()
    return True
