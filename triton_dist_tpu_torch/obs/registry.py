"""Process-local metrics registry: counters, gauges, histograms, spans
(the port of ``triton_dist_tpu.obs.registry``: the same names,
environment settings and snapshot format).

A process-local registry of counters / gauges / fixed-bucket latency
histograms that the engine and server record into, snapshot-able to a
plain JSON-able dict (``snapshot``) and mergeable across processes
(``obs.exposition.merge_snapshots``).

Zero overhead by default: the module-level registry starts as the
:class:`NullRegistry`, whose metrics are shared no-op singletons and
whose spans skip the clock entirely — instrumented hot paths (the
engine decode loop) pay a couple of attribute lookups per *serve call*,
not per token, until :func:`enable` swaps in a real :class:`Registry`.

The port runs eagerly, so every count is a real event: the engine's
loop drives each step from Python and counts it there. Spans also open
a ``torch.profiler.record_function`` region of the same name, so a
profiler session shows them.
"""

from __future__ import annotations

import bisect
import os
import threading
import time
import warnings

from triton_dist_tpu_torch.obs import trace as _trace

__all__ = [
    "DEFAULT_MS_BUCKETS", "Counter", "Gauge", "Histogram", "Registry",
    "NullRegistry", "enable", "disable", "enabled", "env_int",
    "get_registry", "set_registry", "counter", "gauge", "histogram",
    "scoped_registry", "snapshot", "reset", "span", "record_comm",
]

def env_int(name: str, default: int, minimum: int | None = None) -> int:
    """Validated integer env knob — the one parser the obs modules
    share."""
    v = os.environ.get(name, "").strip()
    if not v:
        return default
    try:
        n = int(v)
    except ValueError:
        raise ValueError(f"{name} must be an integer: {v!r}") from None
    if minimum is not None and n < minimum:
        raise ValueError(f"{name} must be >= {minimum}: {n}")
    return n


#: Default latency buckets (milliseconds): sub-ms jit dispatch up to
#: multi-second prefills. Upper bounds; an implicit +Inf bucket catches
#: the tail.
DEFAULT_MS_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                      100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
                      10000.0)


class Counter:
    """Monotonically increasing count (Prometheus counter semantics)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: inc({amount}) < 0")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Point-in-time value (can go up and down)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram with sum/count/min/max.

    ``buckets`` are inclusive upper bounds; observations above the last
    bound land in the implicit +Inf bucket (``counts`` has
    ``len(buckets) + 1`` entries). Bucket *layout is fixed at creation*
    so per-host snapshots merge by plain elementwise addition.
    """

    __slots__ = ("name", "buckets", "_counts", "_sum", "_count", "_min",
                 "_max", "_lock")

    def __init__(self, name: str, lock: threading.Lock,
                 buckets=DEFAULT_MS_BUCKETS):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(
                f"histogram {name}: buckets must be ascending, non-empty")
        self.name = name
        self.buckets = tuple(float(b) for b in buckets)
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0
        self._min = None
        self._max = None
        self._lock = lock

    def observe(self, value: float) -> None:
        value = float(value)
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            if self._min is None or value < self._min:
                self._min = value
            if self._max is None or value > self._max:
                self._max = value

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def to_dict(self) -> dict:
        return {"buckets": list(self.buckets),
                "counts": list(self._counts),
                "sum": self._sum, "count": self._count,
                "min": self._min, "max": self._max}


class Registry:
    """Thread-safe store of named metrics.

    One lock serves both metric creation and updates: telemetry is
    opt-in and its hot operations (a float add under the GIL + lock)
    cost tens of nanoseconds — far below the jit-dispatch floor of the
    paths it instruments.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def _check_free(self, name: str, kind: dict) -> None:
        for store in (self._counters, self._gauges, self._histograms):
            if store is not kind and name in store:
                raise ValueError(
                    f"metric {name!r} already registered as a different "
                    f"type")

    def counter(self, name: str) -> Counter:
        with self._lock:
            m = self._counters.get(name)
            if m is None:
                self._check_free(name, self._counters)
                m = self._counters[name] = Counter(name, self._lock)
        return m

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            m = self._gauges.get(name)
            if m is None:
                self._check_free(name, self._gauges)
                m = self._gauges[name] = Gauge(name, self._lock)
        return m

    def histogram(self, name: str,
                  buckets=DEFAULT_MS_BUCKETS) -> Histogram:
        with self._lock:
            m = self._histograms.get(name)
            if m is None:
                self._check_free(name, self._histograms)
                m = self._histograms[name] = Histogram(
                    name, self._lock, buckets)
        return m

    def snapshot(self) -> dict:
        """Plain JSON-able dict of every metric's current value."""
        with self._lock:
            return {
                "counters": {k: c._value
                             for k, c in self._counters.items()},
                "gauges": {k: g._value for k, g in self._gauges.items()},
                "histograms": {k: h.to_dict()
                               for k, h in self._histograms.items()},
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


class _NullMetric:
    """Shared no-op stand-in for every metric type."""

    __slots__ = ()
    name = "<null>"
    value = 0.0
    count = 0
    sum = 0.0

    def inc(self, amount: float = 1.0) -> None:
        pass

    def dec(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    def to_dict(self) -> dict:
        return {}


_NULL_METRIC = _NullMetric()


class NullRegistry:
    """The disabled-telemetry registry: every lookup returns the shared
    no-op metric, snapshots are empty. This is the DEFAULT — hot paths
    instrumented against it pay attribute lookups only."""

    def counter(self, name: str) -> _NullMetric:
        return _NULL_METRIC

    def gauge(self, name: str) -> _NullMetric:
        return _NULL_METRIC

    def histogram(self, name: str, buckets=None) -> _NullMetric:
        return _NULL_METRIC

    def snapshot(self) -> dict:
        return {"counters": {}, "gauges": {}, "histograms": {}}

    def reset(self) -> None:
        pass


_NULL_REGISTRY = NullRegistry()
_REGISTRY = _NULL_REGISTRY

#: Thread-scoped registry overrides (``scoped_registry``). ``_SCOPED``
#: is a monotonic fast-path guard: until the FIRST scope is installed
#: anywhere in the process, every emission resolves the registry with
#: one module-global read — the zero-overhead-when-unused contract.
#: Once a process runs replica-scoped servers each emission
#: additionally pays one ``threading.local`` attribute lookup.
_TLS = threading.local()
_SCOPED = False


def _current():
    if _SCOPED:
        reg = getattr(_TLS, "registry", None)
        if reg is not None:
            return reg
    return _REGISTRY


class scoped_registry:
    """Route THIS thread's module-level metric emissions
    (``obs.counter``/``gauge``/``histogram``/``span``/``snapshot``)
    into ``registry`` for the duration of the ``with`` block.

    This is how several ``ModelServer`` replicas coexist in one
    process without aliasing each other's serving metrics
    (docs/observability.md "Fleet view"): each replica's handler
    threads and scheduler pump wrap their work in its private
    registry, so per-replica snapshots stay distinct and the fleet
    merge's counter sums are correct. ``registry=None`` is a no-op
    (the global registry keeps receiving), so call sites need no
    branching. Re-entrant per thread (the previous scope is restored
    on exit); scopes never leak across threads."""

    __slots__ = ("_registry", "_prev", "_installed")

    def __init__(self, registry):
        self._registry = registry
        self._installed = False

    def __enter__(self):
        global _SCOPED
        if self._registry is not None:
            self._prev = getattr(_TLS, "registry", None)
            _TLS.registry = self._registry
            _SCOPED = True
            self._installed = True
        return self._registry

    def __exit__(self, *exc):
        if self._installed:
            _TLS.registry = self._prev
            self._installed = False
        return False


def get_registry():
    return _REGISTRY


def set_registry(registry) -> None:
    global _REGISTRY
    _REGISTRY = registry


def enable(registry: Registry | None = None) -> Registry:
    """Switch telemetry on. Idempotent: an already-active real registry
    is kept (so a second subsystem enabling telemetry does not wipe the
    first's counts); pass ``registry`` to replace it explicitly.

    ``TDT_TRACE=1`` makes this also switch event tracing on
    (``obs.trace``), so bench/smoke runs that enable metrics get the
    timeline for free."""
    global _REGISTRY
    if registry is not None:
        _REGISTRY = registry
    elif _REGISTRY is _NULL_REGISTRY:
        _REGISTRY = Registry()
    if _trace.env_enabled() and not _trace.enabled():
        _trace.enable()
    return _REGISTRY


def disable() -> None:
    """Back to the zero-overhead no-op registry (counts are dropped)."""
    global _REGISTRY
    _REGISTRY = _NULL_REGISTRY


def enabled() -> bool:
    return _REGISTRY is not _NULL_REGISTRY


def counter(name: str):
    return _current().counter(name)


def gauge(name: str):
    return _current().gauge(name)


def histogram(name: str, buckets=DEFAULT_MS_BUCKETS):
    return _current().histogram(name, buckets)


def snapshot() -> dict:
    return _current().snapshot()


def reset() -> None:
    _current().reset()


# ---------------------------------------------------------------------------
# Spans: wall-clock regions that land in a histogram AND in the profiler.
# ---------------------------------------------------------------------------

class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


#: Category a span's trace events land under, by name prefix
#: (docs/observability.md "Tracing"): the part before the first dot.
_CAT_BY_PREFIX = {"engine": "engine", "server": "serving",
                  "serving": "serving", "comms": "comms",
                  "resilience": "resilience"}

_ANNOTATE_WARNED = False


def _enter_annotate(name: str):
    """Entered ``torch.profiler.record_function(name)`` context, or None
    when the profiler side is unavailable. The span docstring promises
    composition with the profiler — an import/construction failure must
    not be pure silence, so the first one warns and every one counts
    into ``obs.span.annotate_unavailable``; histograms (and trace
    events) keep recording either way."""
    global _ANNOTATE_WARNED
    try:
        from torch.profiler import record_function
        cm = record_function(name)
        cm.__enter__()
        return cm
    except Exception as e:  # noqa: BLE001 — degrade, never break the span
        _current().counter("obs.span.annotate_unavailable").inc()
        if not _ANNOTATE_WARNED:
            _ANNOTATE_WARNED = True
            warnings.warn(
                f"obs.span: profiler annotation unavailable "
                f"({type(e).__name__}: {e}) — spans record histograms "
                f"and trace events only", RuntimeWarning, stacklevel=4)
        return None


class _Span:
    """Times the enclosed region into ``<name>_ms``, wraps it in
    ``torch.profiler.record_function(name)`` so the SAME label shows up
    as a named region in a profiler trace when one is being collected,
    and —
    when event tracing is on (``obs.trace``) — emits a begin/end pair
    so the region lands on the Perfetto timeline under the thread's
    current trace ID. B/E (not one complete event) on purpose: a hang
    inside the span leaves the un-ended begin in the flight record."""

    __slots__ = ("_hist", "_name", "_cat", "_args", "_t0", "_ann",
                 "_traced")

    def __init__(self, hist, name: str, cat: str | None = None,
                 args: dict | None = None):
        self._hist = hist
        self._name = name
        self._cat = cat or _CAT_BY_PREFIX.get(
            name.split(".", 1)[0], "op")
        self._args = args
        self._ann = None

    def __enter__(self):
        self._ann = _enter_annotate(self._name)
        self._traced = _trace.enabled()
        if self._traced:
            _trace.begin(self._name, self._cat, args=self._args)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt_ms = (time.perf_counter() - self._t0) * 1e3
        if self._traced:
            _trace.end(self._name, self._cat)
        ann, self._ann = self._ann, None
        try:
            return ann.__exit__(*exc) if ann is not None else False
        finally:
            self._hist.observe(dt_ms)


def span(name: str, buckets=DEFAULT_MS_BUCKETS, cat: str | None = None,
         args: dict | None = None):
    """Context manager timing a region into histogram ``<name>_ms``
    (and onto the event timeline when tracing is enabled; ``cat``
    overrides the prefix-derived category, ``args`` attach to the
    begin event).

    Disabled telemetry AND disabled tracing return a shared no-op (no
    clock read, no annotation) — the form the engine decode loop
    relies on for its zero-overhead-when-disabled contract. With only
    tracing on, the histogram side records into the no-op registry."""
    reg = _current()
    if reg is _NULL_REGISTRY and not _trace.enabled():
        return _NULL_SPAN
    return _Span(reg.histogram(name + "_ms", buckets), name, cat, args)


def record_comm(op: str, *arrays) -> None:
    """Count one collective-wrapper invocation: ``comms.<op>.calls`` +=
    1 and ``comms.<op>.bytes`` += the summed byte size of ``arrays``
    (the global payload handed to the op).

    Counts per call, as the port runs eagerly. Tensors give their
    bytes by ``numel() * element_size()``; arrays with ``size`` and
    ``dtype.itemsize`` (numpy) by those.

    With event tracing on, the dispatch also lands on the timeline as
    an instant event (category ``op``) carrying the op name and byte
    count — the hook that puts every op entry a request touches onto
    that request's trace-ID track."""
    reg = _current()
    tracing = _trace.enabled()
    if reg is _NULL_REGISTRY and not tracing:
        return
    nbytes = 0
    for a in arrays:
        if hasattr(a, "element_size"):
            nbytes += a.numel() * a.element_size()
            continue
        size = getattr(a, "size", None)
        dtype = getattr(a, "dtype", None)
        if size is not None and dtype is not None:
            try:
                nbytes += int(size) * dtype.itemsize
            except (TypeError, AttributeError):
                pass
    reg.counter(f"comms.{op}.calls").inc()
    reg.counter(f"comms.{op}.bytes").inc(nbytes)
    if tracing:
        _trace.instant(f"comms.{op}", "op",
                       args={"op": op, "bytes": nbytes})
