"""Chrome trace-event / Perfetto export of ``obs.trace``'s events (the
part of ``triton_dist_tpu.tools.trace_export`` the port's flight recorder
uses; the same JSON).

:func:`to_chrome` turns a tracer snapshot into a Chrome trace-event JSON
dict (the ``{"traceEvents": [...]}`` object format Perfetto loads).

Load any output at https://ui.perfetto.dev (or chrome://tracing).
"""

from __future__ import annotations

__all__ = ["to_chrome"]


def to_chrome(collected: dict, pid: int | None = None,
              process_name: str = "tdt",
              metadata: dict | None = None) -> dict:
    """Convert an ``obs.trace.collect()`` snapshot into a Chrome
    trace-event object. Tracks become tids (named via ``M`` metadata
    events); event args carry the trace ID under ``args.trace_id`` so
    Perfetto's query/filter box isolates one request's story."""
    if pid is None:
        pid = _host_index()
    events: list[dict] = [
        {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
         "args": {"name": f"{process_name} host{pid}"}},
    ]
    for tid, track in enumerate(sorted(collected.get("tracks", {})),
                                start=1):
        events.append({"ph": "M", "pid": pid, "tid": tid,
                       "name": "thread_name", "args": {"name": track}})
        for ph, ts_us, dur_us, name, cat, trace_id, args in \
                collected["tracks"][track]:
            ev: dict = {"ph": ph, "ts": ts_us, "pid": pid, "tid": tid,
                        "name": name, "cat": cat}
            if ph == "X":
                ev["dur"] = 0.0 if dur_us is None else dur_us
            elif ph == "i":
                ev["s"] = "t"   # thread-scoped instant
            if args or trace_id:
                a = dict(args or {})
                if trace_id:
                    a["trace_id"] = trace_id
                ev["args"] = a
            events.append(ev)
    meta = {"events_total": collected.get("events_total", 0),
            "dropped_total": collected.get("dropped_total", 0),
            "ring_capacity": collected.get("ring_capacity", 0)}
    if metadata:
        meta.update(metadata)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "metadata": meta}


def _host_index() -> int:
    """This process's index among the hosts: the port runs in one."""
    return 0

