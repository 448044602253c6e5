"""Structured event tracing: per-thread ring buffers → Perfetto timelines.

The reference treats the timeline as its primary observability artifact:
``group_profile`` writes per-rank chrome traces and merges them on
rank 0 via ``gather_object`` (python/triton_dist/utils.py:505-592), and
``launch_metadata`` annotates every kernel launch onto it. ``obs``'s
metrics layer aggregates *numbers*; this module restores the
*order* — who ran what, when, on which thread — as structured events
that export to Chrome trace-event / Perfetto JSON
(``tools/trace_export.py``) without attaching a profiler.

Design:

- **Events** are compact tuples ``(ph, ts_us, dur_us, name, cat,
  trace_id, args)`` with the Chrome trace-event phases ``B``/``E``
  (begin/end), ``X`` (complete), ``i`` (instant). Categories are the
  fixed set :data:`CATEGORIES` — ``op`` (kernel/op entries), ``comms``
  (per-chunk ring-schedule events), ``engine``, ``serving``,
  ``resilience``.
- **Per-thread ring buffers.** Each thread appends to its own
  fixed-capacity ring (``TDT_TRACE_RING`` events, default 32768) with
  no lock on the append path — the owning thread is the only writer,
  so the hot path is a list store + integer bump under the GIL.
  When the ring is full the OLDEST event is overwritten and
  ``dropped`` increments: the buffer always holds the most recent
  window, which is exactly what a flight recorder wants
  (``obs.flight``). Named side tracks (the ring-schedule comm/compute
  timelines) may have several writers and append under a per-ring
  lock — they are cold paths. Finished threads' rings are kept as a
  bounded tail (:data:`Tracer.MAX_DEAD_RINGS`) so a
  thread-per-connection server cannot leak one ring per request.
- **Trace IDs** propagate through a thread-local: the server binds one
  per request (:func:`bind`), and every event emitted on that thread —
  engine spans, op instants, resilience fallbacks — carries it, so one
  request's prefill→decode→reply path filters to a single story in
  the exported timeline.
- **Disabled by default at zero cost.** The module-level tracer starts
  as ``None``; every emit helper begins with an ``is None`` check.
  :func:`enable` switches it on (``TDT_TRACE=1`` makes ``obs.enable``
  do so; the ``ModelServer`` enables it by default — the flight
  recorder posture — unless ``TDT_TRACE=0``).

Timestamps are wall-clock microseconds with ``perf_counter``
precision (an epoch anchor is taken once at tracer creation), so
per-host traces from the same boot epoch line up when merged rank-0
side (``tools/trace_export.gather_to_chrome``).

See docs/observability.md for the event schema and knob catalog.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import uuid

__all__ = [
    "CATEGORIES", "Tracer", "bind", "begin", "collect", "complete",
    "current_trace_id", "disable", "emit", "enable", "enabled", "end",
    "env_enabled", "get_tracer", "instant", "new_trace_id", "now_us",
    "perf_to_us", "reset", "ring_schedule_events", "span", "stats",
]

#: The recognized event categories (docs/observability.md "Tracing").
CATEGORIES = ("op", "comms", "engine", "serving", "resilience")

#: Default per-ring capacity (events). At ~100 B/event the default
#: bounds each thread's recorder at a few MB.
DEFAULT_RING_CAPACITY = 32768


def _env_int(name: str, default: int) -> int:
    # Lazy: registry imports this module at load, so the shared parser
    # is reached at call time, when both modules exist.
    from triton_dist_tpu_torch.obs.registry import env_int
    return env_int(name, default)


def env_enabled(default: bool = False) -> bool:
    """``TDT_TRACE`` as a boolean; unset → ``default``."""
    v = os.environ.get("TDT_TRACE")
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


class _Ring:
    """Fixed-capacity overwrite-oldest event buffer.

    Per-thread rings have exactly ONE writer (the owning thread) and
    append with no lock — a list store plus integer bumps under the
    GIL. Named side tracks can be written from several threads (an
    abandoned watchdog worker unwedging mid-``record_overlap`` races
    the current case's thread), so they carry a ``lock`` and append
    under it — they are cold paths.

    Snapshots from other threads read the list without a lock: a read
    racing the owner on a WRAPPED ring can observe freshly-overwritten
    (newest) events in the oldest slots, i.e. out of timestamp order —
    :meth:`Tracer.collect` re-sorts each track by timestamp, restoring
    the true order (per-writer timestamps are monotonic). The backing
    list grows lazily up to ``cap`` so a thread that emits three
    events does not pay for 32768 slots.
    """

    __slots__ = ("name", "buf", "cap", "total", "dropped", "owner",
                 "lock")

    def __init__(self, name: str, cap: int, owner=None,
                 lock: threading.Lock | None = None):
        self.name = name
        self.buf: list = []
        self.cap = cap
        self.total = 0          # events ever appended
        self.dropped = 0        # oldest events overwritten
        self.owner = owner      # weakref to the owning thread, if any
        self.lock = lock        # multi-writer (named-track) rings only

    def append(self, ev) -> None:
        if self.lock is not None:
            with self.lock:
                self._append(ev)
        else:
            self._append(ev)

    def _append(self, ev) -> None:
        i = self.total
        if i < self.cap:
            self.buf.append(ev)
        else:
            self.dropped += 1
            self.buf[i % self.cap] = ev
        self.total = i + 1

    def events(self) -> list:
        """Buffered events, oldest-slot first (see class docstring for
        the torn-read caveat the caller's ts-sort absorbs)."""
        n, cap = self.total, self.cap
        if n <= cap:
            return [e for e in self.buf[:n] if e is not None]
        h = n % cap
        return [e for e in self.buf[h:] + self.buf[:h] if e is not None]

    def owner_dead(self) -> bool:
        return self.owner is not None and self.owner() is None


class Tracer:
    """Registry of per-thread (and named) event rings."""

    def __init__(self, capacity: int | None = None):
        self.capacity = capacity if capacity is not None else _env_int(
            "TDT_TRACE_RING", DEFAULT_RING_CAPACITY)
        if self.capacity <= 0:
            raise ValueError(
                f"trace ring capacity must be positive: {self.capacity}")
        self._lock = threading.Lock()
        self._rings: dict[str, _Ring] = {}
        self._tls = threading.local()
        # Wall-clock anchor for perf_counter: epoch micros with
        # monotonic precision (merged per-host traces line up).
        self._epoch = time.time() - time.perf_counter()

    # -- clocks ------------------------------------------------------------
    def now_us(self) -> float:
        return (time.perf_counter() + self._epoch) * 1e6

    def perf_to_us(self, t_perf: float) -> float:
        """Convert a ``time.perf_counter()`` reading to trace micros."""
        return (t_perf + self._epoch) * 1e6

    # -- rings -------------------------------------------------------------

    #: Dead-thread rings retained beyond this many are evicted
    #: (oldest-registered first). A server handling each connection on
    #: a fresh thread (ThreadingTCPServer) would otherwise leak one
    #: ring per connection forever; keeping a bounded tail of finished
    #: threads' rings preserves the flight-recorder window without
    #: unbounded growth.
    MAX_DEAD_RINGS = 64

    def ring(self, name: str, owner=None) -> _Ring:
        """Named track ring (cold paths: ring-schedule timelines).
        Ownerless rings may be written from several threads and get a
        per-ring append lock; per-thread rings stay lock-free."""
        with self._lock:
            r = self._rings.get(name)
            if r is None:
                r = self._rings[name] = _Ring(
                    name, self.capacity, owner,
                    lock=None if owner is not None
                    else threading.Lock())
                if owner is not None:
                    self._prune_dead_rings()
            elif owner is not None and r.owner_dead():
                # A new thread landed on a finished thread's key (the
                # OS reuses thread idents): adopt the ring so pruning
                # cannot drop a buffer that is being written to.
                r.owner = owner
            return r

    def _prune_dead_rings(self) -> None:
        # Caller holds the lock. Dict order = registration order, so
        # the oldest finished threads' rings go first.
        dead = [n for n, r in self._rings.items() if r.owner_dead()]
        for n in dead[:max(len(dead) - self.MAX_DEAD_RINGS, 0)]:
            del self._rings[n]

    def thread_ring(self) -> _Ring:
        r = getattr(self._tls, "ring", None)
        if r is None:
            import weakref
            t = threading.current_thread()
            r = self.ring(f"{t.name}-{t.ident}", owner=weakref.ref(t))
            self._tls.ring = r
        return r

    # -- emit --------------------------------------------------------------
    def emit(self, ph: str, name: str, cat: str = "op", *,
             ts_us: float | None = None, dur_us: float | None = None,
             args: dict | None = None, track: str | None = None,
             trace_id: str | None = None) -> None:
        if trace_id is None:
            trace_id = current_trace_id()
        ev = (ph, self.now_us() if ts_us is None else ts_us, dur_us,
              name, cat, trace_id, args)
        (self.ring(track) if track else self.thread_ring()).append(ev)

    # -- snapshots ---------------------------------------------------------
    def collect(self, last_s: float | None = None) -> dict:
        """All buffered events as ``{"tracks": {name: [event, ...]},
        "dropped_total": int, "events_total": int}`` — ordered by
        timestamp per track, optionally trimmed to the trailing
        ``last_s`` seconds (the flight-recorder window).

        The per-track ts sort restores true order when a snapshot
        races the owning thread on a wrapped ring (the torn read can
        surface freshly-overwritten newest events in the oldest
        slots); per-writer clocks are monotonic so the sort is a no-op
        on quiescent rings."""
        with self._lock:
            rings = list(self._rings.values())
        cutoff = self.now_us() - last_s * 1e6 if last_s else None
        tracks = {}
        for r in rings:
            evs = r.events()
            if cutoff is not None:
                evs = [e for e in evs if e[1] >= cutoff]
            if evs:
                evs.sort(key=lambda e: e[1])
                tracks[r.name] = evs
        return {"tracks": tracks,
                "events_total": sum(r.total for r in rings),
                "dropped_total": sum(r.dropped for r in rings),
                "ring_capacity": self.capacity}


_TRACER: Tracer | None = None
_TLS = threading.local()


def enabled() -> bool:
    return _TRACER is not None


def get_tracer() -> Tracer | None:
    return _TRACER


def enable(capacity: int | None = None) -> Tracer:
    """Switch tracing on. Idempotent: an active tracer (and its
    buffered events) is kept; pass ``capacity`` only on first enable."""
    global _TRACER
    if _TRACER is None:
        _TRACER = Tracer(capacity)
    return _TRACER


def disable() -> None:
    """Back to the zero-cost disabled state (buffered events dropped)."""
    global _TRACER
    _TRACER = None


def reset() -> None:
    """Full reset for tests: tracer AND thread-local trace IDs."""
    disable()
    if getattr(_TLS, "trace_id", None) is not None:
        _TLS.trace_id = None


# ---------------------------------------------------------------------------
# Trace-ID propagation (thread-local).
# ---------------------------------------------------------------------------

def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def current_trace_id() -> str | None:
    return getattr(_TLS, "trace_id", None)


class bind:
    """Context manager binding ``trace_id`` to the current thread:
    every event emitted inside carries it (the server wraps each
    request in one so the whole prefill→decode→reply path is a single
    filterable story in the exported timeline)."""

    __slots__ = ("trace_id", "_prev")

    def __init__(self, trace_id: str):
        self.trace_id = trace_id

    def __enter__(self):
        self._prev = getattr(_TLS, "trace_id", None)
        _TLS.trace_id = self.trace_id
        return self

    def __exit__(self, *exc):
        _TLS.trace_id = self._prev
        return False


# ---------------------------------------------------------------------------
# Module-level emit helpers (every one starts with the is-None gate).
# ---------------------------------------------------------------------------

def now_us() -> float:
    t = _TRACER
    return t.now_us() if t is not None else time.time() * 1e6


def perf_to_us(t_perf: float) -> float:
    t = _TRACER
    return t.perf_to_us(t_perf) if t is not None else t_perf * 1e6


def emit(ph: str, name: str, cat: str = "op", **kw) -> None:
    t = _TRACER
    if t is not None:
        t.emit(ph, name, cat, **kw)


def begin(name: str, cat: str = "op", args: dict | None = None,
          track: str | None = None) -> None:
    t = _TRACER
    if t is not None:
        t.emit("B", name, cat, args=args, track=track)


def end(name: str, cat: str = "op", track: str | None = None) -> None:
    t = _TRACER
    if t is not None:
        t.emit("E", name, cat, track=track)


def instant(name: str, cat: str = "op", args: dict | None = None,
            track: str | None = None) -> None:
    t = _TRACER
    if t is not None:
        t.emit("i", name, cat, args=args, track=track)


def complete(name: str, cat: str, ts_us: float, dur_us: float,
             args: dict | None = None, track: str | None = None) -> None:
    t = _TRACER
    if t is not None:
        t.emit("X", name, cat, ts_us=ts_us, dur_us=dur_us, args=args,
               track=track)


@contextlib.contextmanager
def span(name: str, cat: str = "op", args: dict | None = None):
    """Begin/end pair around a region. B/E (not one X) on purpose: a
    hang inside leaves the un-ended B in the flight record — the
    postmortem then SHOWS what was in flight when the watchdog tripped
    (``tools/trace_export.py --validate`` reports unclosed begins as
    warnings, not errors, for exactly this reason)."""
    t = _TRACER
    if t is None:
        yield
        return
    t.emit("B", name, cat, args=args)
    try:
        yield
    finally:
        # Re-read: disable() while the region ran must not crash it.
        t2 = _TRACER
        if t2 is not None:
            t2.emit("E", name, cat)


def collect(last_s: float | None = None) -> dict:
    t = _TRACER
    if t is None:
        return {"tracks": {}, "events_total": 0, "dropped_total": 0,
                "ring_capacity": 0}
    return t.collect(last_s)


def stats() -> dict:
    """Counts for dashboards/reports: events captured, dropped (ring
    overwrites), buffer capacity, plus the last flight record if one
    was dumped. Mirrors the counts into ``trace.*`` gauges so plain
    metric snapshots carry them too."""
    t = _TRACER
    out = {"enabled": t is not None}
    if t is not None:
        with t._lock:
            rings = list(t._rings.values())
        out["events_total"] = sum(r.total for r in rings)
        out["dropped_total"] = sum(r.dropped for r in rings)
        out["tracks"] = len(rings)
        out["ring_capacity"] = t.capacity
        # Per-ring high-water mark: the fullest any single ring ever
        # got (capped at capacity — a wrapped ring IS full). Together
        # with dropped_total this is the TDT_TRACE_RING sizing signal:
        # high water at capacity + nonzero drops = undersized ring
        # (tools/report.py warns on it).
        out["ring_high_water"] = max(
            (min(r.total, r.cap) for r in rings), default=0)
        from triton_dist_tpu_torch.obs import registry as _registry
        _registry.gauge("trace.events_total").set(out["events_total"])
        _registry.gauge("trace.dropped_total").set(out["dropped_total"])
        _registry.gauge("trace.ring_high_water").set(
            out["ring_high_water"])
    from triton_dist_tpu_torch.obs import flight as _flight
    last = _flight.last_record()
    if last is not None:
        out["last_flight_record"] = last["path"]
        out["flight_dumps"] = last["count"]
    return out


# ---------------------------------------------------------------------------
# Ring-schedule chunk events (the fused comm-GEMM timelines).
# ---------------------------------------------------------------------------

def ring_schedule_events(op: str, *, world: int, dirs: int,
                         compute_ms: float, comm_ms: float,
                         n_hops: int | None = None) -> None:
    """Per-chunk begin/end events for a fused ring schedule, emitted
    host-side at dispatch onto two named tracks —
    ``comms.<op>.compute`` (one slice per consumed chunk, in the
    kernel's rank-rotated order) and ``comms.<op>.comm`` (one slice
    per travelling hop, each overlapping the previous chunk's tile
    loop, per the schedule contract in docs/perf.md).

    The slice GEOMETRY (who overlaps whom) is the kernel's real
    schedule; the durations are the dispatch-time cost-model terms —
    so ``tools/trace_export.py --overlap`` reconstructs overlap from
    the trace's interval arithmetic rather than trusting the
    ``comms.<op>.overlap_pct`` gauge, and an on-chip profile overlaid
    in Perfetto shows model-vs-measured skew per chunk."""
    t = _TRACER
    if t is None or world <= 1:
        return
    from triton_dist_tpu_torch.ops.common import (ring_chunk_schedule,
                                            ring_hop_counts)
    if n_hops is None:
        n_hops = sum(ring_hop_counts(world, dirs))
    t0 = t.now_us()
    dc = compute_ms / world * 1e3                    # us per chunk
    dh = comm_ms / max(n_hops, 1) * 1e3              # us per hop
    tid = current_trace_id()
    for s in range(world):
        chunk, is_bwd, off = ring_chunk_schedule(0, s, world, dirs)
        args = {"op": op, "step": s, "chunk": int(chunk),
                "dir": "bwd" if bool(is_bwd) else "fwd",
                "hop": int(off)}
        t.emit("X", f"chunk{int(chunk)}", "comms", ts_us=t0 + s * dc,
               dur_us=dc, args=args, track=f"comms.{op}.compute",
               trace_id=tid)
        if s + 1 < world:
            # The hop delivering the chunk consumed at step s+1 runs
            # under step s's tile loop — the overlap the schedule buys.
            t.emit("X", f"hop{s}", "comms", ts_us=t0 + s * dc,
                   dur_us=dh, args={"op": op, "step": s},
                   track=f"comms.{op}.comm", trace_id=tid)
