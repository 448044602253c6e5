"""Flight recorder: dump the last N seconds of trace events on failure
(the port of ``triton_dist_tpu.obs.flight``; the device-profile capture a
dump arms there, ``obs.devprof``, comes with the captured decode step).

The resilience layer records *that* a config hung (known-bad cache,
breaker opens) but not *what the process was doing* when it did. The
flight recorder closes that gap: tracing's per-thread ring buffers
(``obs.trace``) already hold the most recent event window at all times
— bounded, overwrite-oldest — and this module dumps that window to
disk as a Chrome trace-event / Perfetto JSON file whenever something
goes wrong:

- a compile-watchdog trip (``resilience.router``),
- a circuit breaker opening (``resilience.breaker``),
- an unhandled serve-loop exception (``serving.server``),
- ``SIGTERM`` (:func:`install_signal_handlers`),
- an explicit ``{"cmd": "dump_trace"}`` server request.

Knobs (docs/observability.md): ``TDT_FLIGHT_SECONDS`` — the window
length (default 30 s); ``TDT_TRACE_DIR`` — where dumps land (default
``<tmp>/tdt_trace``). Each dump increments the
``resilience.flight_dumps`` counter and records its path for
``obs.trace.stats()`` / ``tools/report.py``'s Tracing section.

Dumps are best-effort by construction: every trigger sits on a failure
path, so :func:`maybe_dump` never raises and rate-limits per reason
(a breaker flapping open must not write a dump per request).
"""

from __future__ import annotations

import json
import os
import signal
import tempfile
import threading
import time

from triton_dist_tpu_torch.obs import registry as _registry
from triton_dist_tpu_torch.obs import trace as _trace

__all__ = ["dump", "flight_seconds", "install_signal_handlers",
           "last_record", "maybe_dump", "replica_id", "reset",
           "set_replica_id", "trace_dir"]

DEFAULT_FLIGHT_SECONDS = 30.0

#: Minimum spacing between dumps of the SAME reason (maybe_dump).
MIN_INTERVAL_S = 1.0

_LOCK = threading.Lock()
_LAST: dict | None = None           # {"path", "reason", "ts", "count"}
_COUNT = 0
_SEQ = 0                            # filename uniquifier (same-ms dumps)
_LAST_BY_REASON: dict[str, float] = {}
_SIGTERM_INSTALLED = False
_REPLICA_ID: str | None = None


def set_replica_id(rid: str | None) -> None:
    """Stamp a replica identity into every later dump: the filename
    gains a ``_r<id>`` segment and the trace metadata a
    ``replica_id`` key, so flight records from two same-host replicas
    can never alias in a merged Perfetto view (the
    ``ModelServer`` calls this at construction — in a multi-server
    process the LAST server wins, which matches the shared tracer
    those servers also share)."""
    global _REPLICA_ID
    _REPLICA_ID = str(rid) if rid else None


def replica_id() -> str | None:
    return _REPLICA_ID


def flight_seconds() -> float:
    """The recorder window in seconds (``TDT_FLIGHT_SECONDS``)."""
    v = os.environ.get("TDT_FLIGHT_SECONDS", "").strip()
    if not v:
        return DEFAULT_FLIGHT_SECONDS
    try:
        return float(v)
    except ValueError:
        raise ValueError(
            f"TDT_FLIGHT_SECONDS must be a number: {v!r}") from None


def trace_dir() -> str:
    """Directory flight records land in (``TDT_TRACE_DIR``)."""
    return (os.environ.get("TDT_TRACE_DIR", "").strip()
            or os.path.join(tempfile.gettempdir(), "tdt_trace"))


def last_record() -> dict | None:
    """``{"path", "reason", "ts", "count"}`` of the newest dump, or
    None. ``count`` is the total dumps this process has written."""
    with _LOCK:
        return dict(_LAST) if _LAST else None


def dump(reason: str, last_s: float | None = None) -> str | None:
    """Write the trailing event window as a Perfetto-loadable JSON
    file; returns its path, or None when tracing is disabled.

    The filename carries the reason, host index, and a millisecond
    timestamp so repeated dumps never clobber each other."""
    global _LAST, _COUNT, _SEQ
    if not _trace.enabled():
        return None
    from triton_dist_tpu_torch.tools import trace_export as _texp
    window = last_s if last_s is not None else flight_seconds()
    meta = {"reason": reason, "window_s": window,
            "unix_time": time.time()}
    if _REPLICA_ID:
        meta["replica_id"] = _REPLICA_ID
    chrome = _texp.to_chrome(_trace.collect(last_s=window),
                             metadata=meta)
    d = trace_dir()
    os.makedirs(d, exist_ok=True)

    def _safe(s, n=64):
        return "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in s)[:n]

    safe = _safe(reason)
    # The replica segment keeps two same-host replicas' dumps
    # filename-distinct even at identical millisecond timestamps.
    rep = f"_r{_safe(_REPLICA_ID, 48)}" if _REPLICA_ID else ""
    with _LOCK:
        # Per-process sequence number: two dumps inside the SAME
        # millisecond (fast hosts, back-to-back triggers) must not
        # share a path — the second would silently overwrite the
        # first postmortem.
        _SEQ += 1
        seq = _SEQ
    path = os.path.join(
        d, f"flight_{safe}{rep}_h{_texp._host_index()}"
           f"_{int(time.time() * 1e3)}_{os.getpid()}_{seq}.trace.json")
    with open(path, "w") as f:
        json.dump(chrome, f)
    with _LOCK:
        _COUNT += 1
        _LAST = {"path": path, "reason": reason, "ts": time.time(),
                 "count": _COUNT}
    _registry.counter("resilience.flight_dumps").inc()
    _registry.counter(f"resilience.flight_dump.{safe}").inc()
    return path


def maybe_dump(reason: str, last_s: float | None = None) -> str | None:
    """Best-effort :func:`dump` for failure paths: never raises, and
    skips when the same reason dumped less than :data:`MIN_INTERVAL_S`
    ago (a flapping breaker must not write a dump per request)."""
    if not _trace.enabled():
        return None
    now = time.monotonic()
    with _LOCK:
        prev = _LAST_BY_REASON.get(reason)
        if prev is not None and now - prev < MIN_INTERVAL_S:
            return None
        _LAST_BY_REASON[reason] = now
    try:
        return dump(reason, last_s)
    except Exception:  # noqa: BLE001 — the dump must never worsen a failure
        return None


def install_signal_handlers() -> bool:
    """Dump a flight record on ``SIGTERM`` before the previous handler
    (or the default die-now behavior) runs. Idempotent; only works
    from the main thread (``signal.signal``'s constraint) — returns
    False and does nothing elsewhere."""
    global _SIGTERM_INSTALLED
    if _SIGTERM_INSTALLED:
        return True
    if threading.current_thread() is not threading.main_thread():
        return False
    prev = signal.getsignal(signal.SIGTERM)

    def _on_term(signum, frame):
        maybe_dump("sigterm")
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_DFL:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            signal.raise_signal(signal.SIGTERM)

    try:
        signal.signal(signal.SIGTERM, _on_term)
    except ValueError:  # not the main thread after all
        return False
    _SIGTERM_INSTALLED = True
    return True


def reset() -> None:
    """Drop process-local recorder state (tests). The SIGTERM handler
    is left installed — it re-checks tracing at fire time."""
    global _LAST, _COUNT, _REPLICA_ID
    with _LOCK:
        _LAST = None
        _COUNT = 0
        _LAST_BY_REASON.clear()
        _REPLICA_ID = None
