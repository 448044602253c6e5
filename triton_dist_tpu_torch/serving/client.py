"""Client of the JSON-lines ``ModelServer`` protocol (the port of
``triton_dist_tpu.serving.client``, single-endpoint subset).

:class:`ChatClient` keeps one persistent connection; :func:`request_once`
is the one-shot framing primitive. ``timeout`` bounds every round trip
(``None`` blocks). Multi-endpoint round-robin and ``fanout`` are not
ported yet (ROADMAP.md Queue A item 17).
"""

from __future__ import annotations

import json
import socket
import threading


def _roundtrip(file, req: dict) -> dict:
    file.write((json.dumps(req) + "\n").encode())
    file.flush()
    line = file.readline()
    if not line:
        raise ConnectionError("server closed the connection")
    return json.loads(line)


class ChatClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 8777,
                 timeout: float | None = None):
        self.addr = (host, int(port))
        self.timeout = timeout
        self._sock = socket.create_connection(self.addr, timeout=timeout)
        self._file = self._sock.makefile("rwb")
        self._lock = threading.Lock()  # one round trip at a time

    def request(self, req: dict) -> dict:
        """One protocol round trip with any request object."""
        with self._lock:
            return _roundtrip(self._file, req)

    def generate_ids(self, prompt_ids, gen_len: int = 16,
                     stop_tokens=None) -> dict:
        """Generate from token-id prompts (a list of lists). The reply's
        ``gen_len`` is the server's effective (possibly clamped) value."""
        req = {"prompt_ids": prompt_ids, "gen_len": gen_len}
        if stop_tokens is not None:
            req["stop_tokens"] = list(stop_tokens)
        return self.request(req)

    def close(self):
        with self._lock:
            try:
                self._file.close()
                self._sock.close()
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def request_once(endpoint, req: dict, timeout: float | None = None) -> dict:
    """One fresh-connection round trip to ``"host:port"`` or
    ``(host, port)``. Raises ``OSError`` on transport failure,
    ``ConnectionError`` when the server closes without a reply and
    ``ValueError`` on a garbled reply."""
    if isinstance(endpoint, str):
        host, _, port = endpoint.rpartition(":")
        endpoint = (host, int(port))
    with socket.create_connection(tuple(endpoint), timeout=timeout) as s:
        s.settimeout(timeout)
        with s.makefile("rwb") as f:
            return _roundtrip(f, req)
