"""In-process fake HTTP forward proxy.

Supports the two mechanisms the native client uses behind egress proxies
(HTTPS_PROXY/HTTP_PROXY/NO_PROXY, the env contract the reference inherits
from reqwest, gpu-pruner/src/lib.rs:240-282): CONNECT tunneling for https
targets and absolute-form forwarding for plain http. Records CONNECT
targets, absolute-form request lines, and per-request headers (so tests
can assert Proxy-Authorization); can demand Basic credentials (407
otherwise).
"""

from __future__ import annotations

import socket
import socketserver
import threading


class FakeProxy:
    def __init__(self):
        self.connects: list[str] = []  # CONNECT authority targets
        self.requests: list[str] = []  # absolute-form request lines
        self.headers: list[dict] = []  # lowercased header dict per request
        self.require_auth: str | None = None  # e.g. "Basic dXNlcjpwdw=="
        self._server: socketserver.ThreadingTCPServer | None = None
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()

    def start(self) -> int:
        proxy = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                sock.settimeout(10)
                data = b""
                try:
                    while b"\r\n\r\n" not in data:
                        chunk = sock.recv(65536)
                        if not chunk:
                            return
                        data += chunk
                except OSError:
                    return
                head, _, rest = data.partition(b"\r\n\r\n")
                lines = head.decode("latin-1").split("\r\n")
                reqline = lines[0]
                hdrs = {}
                for line in lines[1:]:
                    if ":" in line:
                        k, v = line.split(":", 1)
                        hdrs[k.strip().lower()] = v.strip()
                with proxy._lock:
                    proxy.headers.append(hdrs)
                if proxy.require_auth and hdrs.get("proxy-authorization") != proxy.require_auth:
                    sock.sendall(b"HTTP/1.1 407 Proxy Authentication Required\r\n"
                                 b"Content-Length: 0\r\nConnection: close\r\n\r\n")
                    return
                if reqline.startswith("CONNECT "):
                    self._tunnel(sock, reqline, rest)
                else:
                    self._forward(sock, reqline, lines[1:], hdrs, rest)

            def _tunnel(self, sock, reqline, early_bytes):
                target = reqline.split()[1]
                with proxy._lock:
                    proxy.connects.append(target)
                host, _, port = target.rpartition(":")
                try:
                    up = socket.create_connection((host, int(port)), timeout=10)
                except OSError:
                    sock.sendall(b"HTTP/1.1 502 Bad Gateway\r\nContent-Length: 0\r\n\r\n")
                    return
                sock.sendall(b"HTTP/1.1 200 Connection Established\r\n\r\n")
                if early_bytes:
                    up.sendall(early_bytes)

                def pump(a, b):
                    try:
                        while True:
                            d = a.recv(65536)
                            if not d:
                                break
                            b.sendall(d)
                    except OSError:
                        pass
                    finally:
                        try:
                            b.shutdown(socket.SHUT_WR)
                        except OSError:
                            pass

                t = threading.Thread(target=pump, args=(up, sock), daemon=True)
                t.start()
                pump(sock, up)
                t.join(timeout=10)
                up.close()

            def _forward(self, sock, reqline, header_lines, hdrs, rest):
                # absolute-form: METHOD http://host[:port]/path HTTP/1.1
                with proxy._lock:
                    proxy.requests.append(reqline)
                method, absurl, ver = reqline.split()
                if not absurl.startswith("http://"):
                    sock.sendall(b"HTTP/1.1 400 Bad Request\r\nContent-Length: 0\r\n\r\n")
                    return
                hostport, slash, path = absurl[7:].partition("/")
                host, _, port = hostport.partition(":")
                body = rest
                want = int(hdrs.get("content-length", "0"))
                while len(body) < want:
                    chunk = sock.recv(65536)
                    if not chunk:  # client died mid-body; don't spin
                        return
                    body += chunk
                up = socket.create_connection((host, int(port or "80")), timeout=10)
                out = [f"{method} {slash}{path} {ver}"]
                for line in header_lines:
                    low = line.lower()
                    if low.startswith(("proxy-", "connection:")):
                        continue
                    out.append(line)
                out.append("Connection: close")
                up.sendall(("\r\n".join(out) + "\r\n\r\n").encode("latin-1") + body)
                try:
                    while True:
                        d = up.recv(65536)
                        if not d:
                            break
                        sock.sendall(d)
                finally:
                    up.close()

        socketserver.ThreadingTCPServer.allow_reuse_address = True
        self._server = socketserver.ThreadingTCPServer(("127.0.0.1", 0), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        assert self._server is not None
        return f"http://127.0.0.1:{self._server.server_address[1]}"

    def stop(self) -> None:
        if self._server:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
