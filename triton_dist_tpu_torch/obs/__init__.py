"""Telemetry: metrics, spans, event tracing, exposition (the port of
``triton_dist_tpu.obs``: the same metric names, environment settings and
wire formats — JSON snapshots, Prometheus text, Chrome trace events).

Process-local counters / gauges / fixed-bucket histograms
(``obs.registry``), wall-clock spans that land in a histogram, a
``torch.profiler.record_function`` region AND the structured event
timeline (``obs.span``), snapshot merge and a Prometheus text exposition
(``obs.exposition``).

The timeline side (``obs.trace``) records begin/end + instant events
into per-thread ring buffers, exports Chrome trace-event / Perfetto JSON
through ``tools/trace_export.py``, and doubles as a flight recorder
(``obs.flight``): the most recent event window dumps to disk on
failures, SIGTERM, or an explicit dump.

``obs.slo`` keeps rolling-window percentiles + multi-window burn rates
that arm the flight recorder on a latency-SLO breach, and ``obs.attrib``
keeps per-request latency waterfalls (queue → prefill → decode).

The modules' docstrings name the consumers they have in the JAX package
(the serving scheduler, the server's control verbs, ``bench.py``,
``tools/report.py``). In the port the engine records into them; the
scheduler and the server's verbs come with ROADMAP.md Queue A item A9b.

Not ported yet: ``perfwatch`` (it feeds the resilience router's
routing, which the port does not carry), ``devprof`` (with the captured
decode step), ``fleet`` and ``history`` (with fleet and disaggregated
serving); ROADMAP.md Queue A.

Disabled by default at zero hot-path cost; flip metrics on with
``obs.enable()`` (``TDT_TRACE=1`` makes that enable tracing too).
"""

from triton_dist_tpu_torch.obs.registry import (  # noqa: F401
    DEFAULT_MS_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    NullRegistry,
    Registry,
    counter,
    disable,
    enable,
    enabled,
    env_int,
    gauge,
    get_registry,
    histogram,
    record_comm,
    reset,
    scoped_registry,
    set_registry,
    snapshot,
    span,
)
from triton_dist_tpu_torch.obs.exposition import (  # noqa: F401
    aggregate_across_hosts,
    histogram_quantile,
    merge_snapshots,
    render_prometheus,
)
from triton_dist_tpu_torch.obs import (  # noqa: F401
    attrib, flight, slo, trace)
from triton_dist_tpu_torch.obs.slo import (  # noqa: F401
    SLOTarget,
    SLOTracker,
    WindowedHistogram,
)
from triton_dist_tpu_torch.obs.trace import (  # noqa: F401
    enabled as trace_enabled,
)
