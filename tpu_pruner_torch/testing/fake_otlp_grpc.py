"""Fake OTLP/gRPC collector: a minimal plaintext HTTP/2 (h2c) server.

Speaks just enough of RFC 7540 + gRPC framing to receive the daemon's
unary Export calls (native/src/otlp_grpc.cpp) hermetically: connection
preface, SETTINGS exchange, HEADERS decoded from the client's
literal-without-indexing HPACK, DATA reassembled into the gRPC message,
and a 200 + empty Export*ServiceResponse + grpc-status trailers reply —
all literal, non-huffman, so the client's HPACK-subset decoder reads it
deterministically. A generic protobuf walker (`pb_fields`) lets tests
assert on the received request bytes without a protobuf dependency.
"""

from __future__ import annotations

import socket
import struct
import threading

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

FRAME_DATA, FRAME_HEADERS, FRAME_SETTINGS, FRAME_PING = 0x0, 0x1, 0x4, 0x6
FRAME_WINDOW_UPDATE = 0x8
FLAG_END_STREAM, FLAG_ACK, FLAG_END_HEADERS = 0x1, 0x1, 0x4


def pb_fields(buf: bytes):
    """Generic protobuf decode: list of (field_number, wire_type, value).

    wire 0 -> int, wire 1 -> int (little-endian fixed64), wire 2 -> bytes.
    """
    out, i = [], 0

    def varint():
        nonlocal i
        v = shift = 0
        while True:
            b = buf[i]
            i += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7

    while i < len(buf):
        tag = varint()
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            out.append((field, 0, varint()))
        elif wire == 1:
            out.append((field, 1, struct.unpack("<Q", buf[i:i + 8])[0]))
            i += 8
        elif wire == 2:
            ln = varint()
            out.append((field, 2, bytes(buf[i:i + ln])))
            i += ln
        else:
            raise ValueError(f"unsupported wire type {wire}")
    return out


def pb_find(fields, number):
    return [v for f, _, v in fields if f == number]


def _hpack_literal(name: bytes, value: bytes) -> bytes:
    """Literal without indexing, new name, raw strings (RFC 7541 §6.2.2)."""
    assert len(name) < 127 and len(value) < 127
    return b"\x00" + bytes([len(name)]) + name + bytes([len(value)]) + value


# RFC 7541 appendix B huffman codes, (code, bits) per symbol 0..255 + EOS.
# grpc-go huffman-codes literal trailer names ("grpc-status" is 8 coded
# bytes vs 11 raw), so a collector mode that does the same is needed to
# exercise the client's huffman decoder — an all-raw fake can never catch
# a decoder that treats huffman strings as opaque.
HUFFMAN_TABLE = [
    (0x1ff8, 13), (0x7fffd8, 23), (0xfffffe2, 28), (0xfffffe3, 28),
    (0xfffffe4, 28), (0xfffffe5, 28), (0xfffffe6, 28), (0xfffffe7, 28),
    (0xfffffe8, 28), (0xffffea, 24), (0x3ffffffc, 30), (0xfffffe9, 28),
    (0xfffffea, 28), (0x3ffffffd, 30), (0xfffffeb, 28), (0xfffffec, 28),
    (0xfffffed, 28), (0xfffffee, 28), (0xfffffef, 28), (0xffffff0, 28),
    (0xffffff1, 28), (0xffffff2, 28), (0x3ffffffe, 30), (0xffffff3, 28),
    (0xffffff4, 28), (0xffffff5, 28), (0xffffff6, 28), (0xffffff7, 28),
    (0xffffff8, 28), (0xffffff9, 28), (0xffffffa, 28), (0xffffffb, 28),
    (0x14, 6), (0x3f8, 10), (0x3f9, 10), (0xffa, 12), (0x1ff9, 13),
    (0x15, 6), (0xf8, 8), (0x7fa, 11), (0x3fa, 10), (0x3fb, 10),
    (0xf9, 8), (0x7fb, 11), (0xfa, 8), (0x16, 6), (0x17, 6), (0x18, 6),
    (0x0, 5), (0x1, 5), (0x2, 5), (0x19, 6), (0x1a, 6), (0x1b, 6),
    (0x1c, 6), (0x1d, 6), (0x1e, 6), (0x1f, 6), (0x5c, 7), (0xfb, 8),
    (0x7ffc, 15), (0x20, 6), (0xffb, 12), (0x3fc, 10), (0x1ffa, 13),
    (0x21, 6), (0x5d, 7), (0x5e, 7), (0x5f, 7), (0x60, 7), (0x61, 7),
    (0x62, 7), (0x63, 7), (0x64, 7), (0x65, 7), (0x66, 7), (0x67, 7),
    (0x68, 7), (0x69, 7), (0x6a, 7), (0x6b, 7), (0x6c, 7), (0x6d, 7),
    (0x6e, 7), (0x6f, 7), (0x70, 7), (0x71, 7), (0x72, 7), (0xfc, 8),
    (0x73, 7), (0xfd, 8), (0x1ffb, 13), (0x7fff0, 19), (0x1ffc, 13),
    (0x3ffc, 14), (0x22, 6), (0x7ffd, 15), (0x3, 5), (0x23, 6), (0x4, 5),
    (0x24, 6), (0x5, 5), (0x25, 6), (0x26, 6), (0x27, 6), (0x6, 5),
    (0x74, 7), (0x75, 7), (0x28, 6), (0x29, 6), (0x2a, 6), (0x7, 5),
    (0x2b, 6), (0x76, 7), (0x2c, 6), (0x8, 5), (0x9, 5), (0x2d, 6),
    (0x77, 7), (0x78, 7), (0x79, 7), (0x7a, 7), (0x7b, 7), (0x7ffe, 15),
    (0x7fc, 11), (0x3ffd, 14), (0x1ffd, 13), (0xffffffc, 28), (0xfffe6, 20),
    (0x3fffd2, 22), (0xfffe7, 20), (0xfffe8, 20), (0x3fffd3, 22),
    (0x3fffd4, 22), (0x3fffd5, 22), (0x7fffd9, 23), (0x3fffd6, 22),
    (0x7fffda, 23), (0x7fffdb, 23), (0x7fffdc, 23), (0x7fffdd, 23),
    (0x7fffde, 23), (0xffffeb, 24), (0x7fffdf, 23), (0xffffec, 24),
    (0xffffed, 24), (0x3fffd7, 22), (0x7fffe0, 23), (0xffffee, 24),
    (0x7fffe1, 23), (0x7fffe2, 23), (0x7fffe3, 23), (0x7fffe4, 23),
    (0x1fffdc, 21), (0x3fffd8, 22), (0x7fffe5, 23), (0x3fffd9, 22),
    (0x7fffe6, 23), (0x7fffe7, 23), (0xffffef, 24), (0x3fffda, 22),
    (0x1fffdd, 21), (0xfffe9, 20), (0x3fffdb, 22), (0x3fffdc, 22),
    (0x7fffe8, 23), (0x7fffe9, 23), (0x1fffde, 21), (0x7fffea, 23),
    (0x3fffdd, 22), (0x3fffde, 22), (0xfffff0, 24), (0x1fffdf, 21),
    (0x3fffdf, 22), (0x7fffeb, 23), (0x7fffec, 23), (0x1fffe0, 21),
    (0x1fffe1, 21), (0x3fffe0, 22), (0x1fffe2, 21), (0x7fffed, 23),
    (0x3fffe1, 22), (0x7fffee, 23), (0x7fffef, 23), (0xfffea, 20),
    (0x3fffe2, 22), (0x3fffe3, 22), (0x3fffe4, 22), (0x7ffff0, 23),
    (0x3fffe5, 22), (0x3fffe6, 22), (0x7ffff1, 23), (0x3ffffe0, 26),
    (0x3ffffe1, 26), (0xfffeb, 20), (0x7fff1, 19), (0x3fffe7, 22),
    (0x7ffff2, 23), (0x3fffe8, 22), (0x1ffffec, 25), (0x3ffffe2, 26),
    (0x3ffffe3, 26), (0x3ffffe4, 26), (0x7ffffde, 27), (0x7ffffdf, 27),
    (0x3ffffe5, 26), (0xfffff1, 24), (0x1ffffed, 25), (0x7fff2, 19),
    (0x1fffe3, 21), (0x3ffffe6, 26), (0x7ffffe0, 27), (0x7ffffe1, 27),
    (0x3ffffe7, 26), (0x7ffffe2, 27), (0xfffff2, 24), (0x1fffe4, 21),
    (0x1fffe5, 21), (0x3ffffe8, 26), (0x3ffffe9, 26), (0xffffffd, 28),
    (0x7ffffe3, 27), (0x7ffffe4, 27), (0x7ffffe5, 27), (0xfffec, 20),
    (0xfffff3, 24), (0xfffed, 20), (0x1fffe6, 21), (0x3fffe9, 22),
    (0x1fffe7, 21), (0x1fffe8, 21), (0x7ffff3, 23), (0x3fffea, 22),
    (0x3fffeb, 22), (0x1ffffee, 25), (0x1ffffef, 25), (0xfffff4, 24),
    (0xfffff5, 24), (0x3ffffea, 26), (0x7ffff4, 23), (0x3ffffeb, 26),
    (0x7ffffe6, 27), (0x3ffffec, 26), (0x3ffffed, 26), (0x7ffffe7, 27),
    (0x7ffffe8, 27), (0x7ffffe9, 27), (0x7ffffea, 27), (0x7ffffeb, 27),
    (0xffffffe, 28), (0x7ffffec, 27), (0x7ffffed, 27), (0x7ffffee, 27),
    (0x7ffffef, 27), (0x7fffff0, 27), (0x3ffffee, 26), (0x3fffffff, 30),
]


def huffman_encode(data: bytes) -> bytes:
    """RFC 7541 §5.2 string encoding (pad with EOS-prefix one-bits)."""
    acc = nbits = 0
    out = bytearray()
    for b in data:
        code, length = HUFFMAN_TABLE[b]
        acc = (acc << length) | code
        nbits += length
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)
    if nbits:
        pad = 8 - nbits
        out.append(((acc << pad) | ((1 << pad) - 1)) & 0xFF)
    return bytes(out)


def _hpack_literal_huffman(name: bytes, value: bytes) -> bytes:
    """Literal without indexing, huffman NAME + shorter-of-raw/huffman
    VALUE — the encoding shape grpc-go produces for unknown trailer names
    (huffman flag = high bit of the length octet)."""
    hname = huffman_encode(name)
    assert len(hname) < 127
    out = b"\x00" + bytes([0x80 | len(hname)]) + hname
    hvalue = huffman_encode(value)
    if len(hvalue) < len(value):
        assert len(hvalue) < 127
        out += bytes([0x80 | len(hvalue)]) + hvalue
    else:
        assert len(value) < 127
        out += bytes([len(value)]) + value
    return out


def _hpack_decode_literals(block: bytes):
    """Decode the client's own header encoding (all literal, non-huffman)."""
    headers, i = [], 0
    while i < len(block):
        b = block[i]
        if b & 0x80 or (b & 0xE0) == 0x20:  # indexed / table-size update
            i += 1
            continue
        i += 1  # literal marker (name index 0 assumed — our client's shape)
        nlen = block[i] & 0x7F
        i += 1
        name = block[i:i + nlen]
        i += nlen
        vlen = block[i] & 0x7F
        i += 1
        value = block[i:i + vlen]
        i += vlen
        headers.append((name.decode(), value.decode()))
    return headers


def _frame(ftype: int, flags: int, stream: int, payload: bytes) -> bytes:
    return struct.pack("!I", len(payload))[1:] + bytes([ftype, flags]) + \
        struct.pack("!I", stream & 0x7FFFFFFF) + payload


class FakeGrpcCollector:
    """One request per connection (matching the client's dial-per-export)."""

    def __init__(self, grpc_status: int = 0, grpc_message: str = "",
                 split_trailers: bool = False, pad_headers: bool = False,
                 ping_before_response: bool = False,
                 huffman_trailers: bool = False,
                 initial_window_size: int | None = None,
                 bogus_stream_window_update: bool = False,
                 reject_before_body: bool = False,
                 corrupt_huffman_names: bool = False):
        self.grpc_status = grpc_status
        self.grpc_message = grpc_message
        # Encode trailer NAMES (and shorter-than-raw values) with RFC 7541
        # huffman — what grpc-go/otel-collector actually sends. The
        # all-raw default can never catch a client that treats huffman
        # strings as opaque.
        self.huffman_trailers = huffman_trailers
        # Send trailers as HEADERS(END_STREAM) + CONTINUATION(END_HEADERS)
        # (RFC 7540 §4.3) — exercises the client's split-block path.
        self.split_trailers = split_trailers
        # Send the response HEADERS with the PADDED flag (pad length +
        # trailing padding octets) — exercises the client's pad stripping.
        self.pad_headers = pad_headers
        # Send a PING before the response — the client must ACK it and
        # keep reading.
        self.ping_before_response = ping_before_response
        # Advertise SETTINGS_INITIAL_WINDOW_SIZE (0x4): legal per RFC 7540
        # §6.5.2, shrinks the client's per-stream send window mid-flight
        # (§6.9.2 delta, possibly negative) — the client must cap its DATA
        # frames to the reduced credit once the SETTINGS arrive.
        self.initial_window_size = initial_window_size
        # Send a WINDOW_UPDATE for a stream id the client never opened: a
        # client crediting it to stream 1 would burst past the reduced
        # window.
        self.bogus_stream_window_update = bogus_stream_window_update
        # Respond (200 + trailers + END_STREAM, no RST) right after the
        # request HEADERS, before any DATA — the legal gRPC early-reject
        # shape; combined with initial_window_size=0 the client stalls
        # mid-upload and must surface the decoded status, not its send
        # deadline.
        self.reject_before_body = reject_before_body
        # Trailer names sent huffman-FLAGGED but with invalid bytes (EOS):
        # the undecodable-name path — the client must fall back to
        # inferred success on a clean 200 close, with a warning.
        self.corrupt_huffman_names = corrupt_huffman_names
        self.ping_acks = []  # payloads of PING ACK frames the client sent
        self.requests = []  # (path, message_bytes, headers list)
        self.data_frame_sizes = []  # DATA payload lengths in arrival order
        self._sock: socket.socket | None = None
        self._stop = threading.Event()

    def start(self, certfile: str | None = None, keyfile: str | None = None,
              alpn: list[str] | None = ("h2",)) -> int:
        """certfile/keyfile switch the listener to TLS (gRPC-over-TLS
        testing); `alpn` is what the server offers — pass None to model a
        TLS server without ALPN, which a gRPC client must reject."""
        self._tls_ctx = None
        if certfile:
            import ssl
            self._tls_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            self._tls_ctx.load_cert_chain(certfile, keyfile)
            if alpn:
                self._tls_ctx.set_alpn_protocols(list(alpn))
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(16)
        threading.Thread(target=self._accept_loop, daemon=True).start()
        return self._sock.getsockname()[1]

    @property
    def url(self) -> str:
        assert self._sock is not None
        scheme = "https" if self._tls_ctx else "http"
        return f"{scheme}://127.0.0.1:{self._sock.getsockname()[1]}"

    def stop(self) -> None:
        self._stop.set()
        if self._sock:
            self._sock.close()
            self._sock = None

    # ── internals ──────────────────────────────────────────────────────
    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket):
        conn.settimeout(10)
        # Without NODELAY, Nagle + delayed ACK turns every WINDOW_UPDATE
        # exchange into ~40ms (the shrunk-window test does ~200 of them).
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if self._tls_ctx is not None:
            try:
                conn = self._tls_ctx.wrap_socket(conn, server_side=True)
            except Exception:
                conn.close()  # handshake refused (e.g. client bailed on ALPN)
                return
        try:
            buf = b""
            while len(buf) < len(PREFACE):
                buf += conn.recv(4096)
            assert buf.startswith(PREFACE), "missing h2 preface"
            buf = buf[len(PREFACE):]

            # Server SETTINGS first (RFC 7540 §3.5), defaults are fine.
            settings = b""
            if self.initial_window_size is not None:
                settings += struct.pack("!HI", 0x4, self.initial_window_size)
            conn.sendall(_frame(FRAME_SETTINGS, 0, 0, settings))
            if self.bogus_stream_window_update:
                conn.sendall(_frame(FRAME_WINDOW_UPDATE, 0, 3,
                                    struct.pack("!I", 10 * 1024 * 1024)))

            headers, data, path = [], b"", ""
            while True:
                while len(buf) < 9:
                    chunk = conn.recv(65536)
                    if not chunk:
                        return
                    buf += chunk
                length = int.from_bytes(buf[:3], "big")
                ftype, flags = buf[3], buf[4]
                stream = int.from_bytes(buf[5:9], "big") & 0x7FFFFFFF
                while len(buf) < 9 + length:
                    chunk = conn.recv(65536)
                    if not chunk:
                        return
                    buf += chunk
                payload = buf[9:9 + length]
                buf = buf[9 + length:]

                if ftype == FRAME_SETTINGS and not flags & FLAG_ACK:
                    conn.sendall(_frame(FRAME_SETTINGS, FLAG_ACK, 0, b""))
                elif ftype == FRAME_PING and not flags & FLAG_ACK:
                    conn.sendall(_frame(FRAME_PING, FLAG_ACK, 0, payload))
                elif ftype == FRAME_HEADERS:
                    headers = _hpack_decode_literals(payload)
                    path = dict(headers).get(":path", "")
                    if self.reject_before_body:
                        break  # respond now; the drain loop eats in-flight DATA
                elif ftype == FRAME_DATA:
                    data += payload
                    self.data_frame_sizes.append(len(payload))
                    # Replenish flow-control windows as a real server does
                    # when it consumes DATA — without this, requests larger
                    # than the 65535-byte initial window would stall the
                    # client forever (the >64 KB flow-control test path).
                    if payload:
                        inc = struct.pack("!I", len(payload))
                        conn.sendall(_frame(FRAME_WINDOW_UPDATE, 0, 0, inc))
                        conn.sendall(_frame(FRAME_WINDOW_UPDATE, 0, stream, inc))
                    if flags & FLAG_END_STREAM:
                        break
                if ftype == FRAME_HEADERS and flags & FLAG_END_STREAM:
                    break  # request without body (not our client, but legal)

            # gRPC frame: flag byte + BE32 length + protobuf message.
            message = b""
            if len(data) >= 5:
                (mlen,) = struct.unpack("!I", data[1:5])
                message = data[5:5 + mlen]
            self.requests.append((path, message, headers))

            if self.ping_before_response:
                conn.sendall(_frame(FRAME_PING, 0, 0, b"\x01\x02\x03\x04\x05\x06\x07\x08"))
            resp_headers = _hpack_literal(b":status", b"200") + \
                _hpack_literal(b"content-type", b"application/grpc")
            if self.pad_headers:
                FLAG_PADDED = 0x8
                padded = bytes([4]) + resp_headers + b"\x00" * 4
                conn.sendall(_frame(FRAME_HEADERS, FLAG_END_HEADERS | FLAG_PADDED,
                                    stream, padded))
            else:
                conn.sendall(_frame(FRAME_HEADERS, FLAG_END_HEADERS, stream,
                                    resp_headers))
            # Empty Export*ServiceResponse message.
            conn.sendall(_frame(FRAME_DATA, 0, stream, b"\x00\x00\x00\x00\x00"))
            if self.corrupt_huffman_names:
                # huffman flag + 4 bytes of ones = EOS in-string: undecodable
                def literal(name, value):
                    return (b"\x00" + bytes([0x80 | 4]) + b"\xff\xff\xff\xff"
                            + bytes([len(value)]) + value)
            elif self.huffman_trailers:
                literal = _hpack_literal_huffman
            else:
                literal = _hpack_literal
            trailers = literal(b"grpc-status", str(self.grpc_status).encode())
            if self.grpc_message:
                trailers += literal(b"grpc-message", self.grpc_message.encode())
            if self.split_trailers:
                FRAME_CONTINUATION = 0x9
                conn.sendall(_frame(FRAME_HEADERS, FLAG_END_STREAM, stream, b""))
                conn.sendall(_frame(FRAME_CONTINUATION, FLAG_END_HEADERS,
                                    stream, trailers))
            else:
                conn.sendall(_frame(FRAME_HEADERS,
                                    FLAG_END_HEADERS | FLAG_END_STREAM, stream,
                                    trailers))
            # Half-close and drain: a bare close() while the client's late
            # SETTINGS ACK is in flight RSTs the connection and discards
            # the buffered trailers on the client side. FIN + read-to-EOF
            # lets the client consume everything first. The drained bytes
            # are parsed as frames so tests can assert the client's PING
            # ACK actually went out (not just that it kept reading).
            conn.shutdown(socket.SHUT_WR)
            conn.settimeout(2)
            drained = buf
            try:
                while True:
                    chunk = conn.recv(4096)
                    if not chunk:
                        break
                    drained += chunk
            finally:
                # Parse whatever arrived even if the final recv timed out
                # (a slow client close must not discard an ACK already in
                # hand — that would flake the PING-ACK assertion).
                while len(drained) >= 9:
                    flen = int.from_bytes(drained[:3], "big")
                    ftype, fflags = drained[3], drained[4]
                    if len(drained) < 9 + flen:
                        break
                    if ftype == FRAME_PING and fflags & FLAG_ACK:
                        self.ping_acks.append(bytes(drained[9:9 + flen]))
                    drained = drained[9 + flen:]
        except Exception:
            pass  # connection-level failures surface as client errors
        finally:
            conn.close()
