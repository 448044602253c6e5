"""Snapshot merging and metrics exposition (the port of
``triton_dist_tpu.obs.exposition``: the same JSON and Prometheus text).

``merge_snapshots`` is the cross-host aggregation primitive: the
reference gathers per-rank chrome traces with ``gather_object`` and
merges JSON on rank 0 (utils.py:505-592); here the artifact is a plain
metrics dict, so the merge is arithmetic — counters and histogram
buckets sum, gauges take the max (they are point-in-time readings; max
answers the capacity questions gauges exist for, e.g. peak in-flight).

``render_prometheus`` turns a snapshot into Prometheus text exposition
format (v0.0.4) so any scraper pointed at the serving host — via the
server's ``{"cmd": "metrics", "format": "prometheus"}`` request — can
ingest the numbers without a client library.
"""

from __future__ import annotations

import json
import re

from triton_dist_tpu_torch.obs import registry as _registry

__all__ = ["allgather_json", "histogram_quantile", "merge_snapshots",
           "render_prometheus", "aggregate_across_hosts"]


def histogram_quantile(h: dict, q: float, detail: bool = False):
    """Estimate the ``q``-quantile of a snapshot histogram dict
    (fixed upper-bound ``buckets`` + per-bucket ``counts`` — the shape
    :meth:`Histogram.to_dict` emits) by linear interpolation inside
    the containing bucket. A quantile landing in the +Inf overflow
    bucket reports the recorded ``max`` when the snapshot carries one,
    and otherwise CLIPS to the top finite bucket edge — windowed
    histogram deltas (bench.py) and rolling windows (``obs.slo``)
    cannot know their extrema, and "at least the top edge" is a usable
    lower bound where ``None`` used to hide the whole percentile.
    ``detail=True`` returns ``(value, clipped)`` so callers can flag
    the clip. ``None`` (or ``(None, False)``) only on an empty or
    malformed histogram. This is how bench.py turns the server's
    ``serving.ttft_ms`` histogram into p50/p99 without shipping raw
    samples."""
    value, clipped = None, False
    counts = h.get("counts") or []
    buckets = h.get("buckets") or []
    total = h.get("count", 0)
    if total and counts:
        target = q * total
        cum = 0
        lo = 0.0
        in_overflow = True
        for i, c in enumerate(counts):
            cum += c
            if cum >= target and c:
                if i < len(buckets):
                    hi = buckets[i]
                    frac = (target - (cum - c)) / c
                    value = lo + (hi - lo) * frac
                    in_overflow = False
                break
            if i < len(buckets):
                lo = buckets[i]
        if in_overflow and buckets:
            if h.get("max") is not None:
                value = float(h["max"])
            else:
                value, clipped = float(buckets[-1]), True
    return (value, clipped) if detail else value


def allgather_json(obj) -> list:
    """Every process's ``obj`` (any JSON-able value), as a list indexed
    by process — the ``gather_object`` analog. The port always runs in
    one process (its ranks are slices of one card), so this is
    ``[obj]``. Shared by the metrics merge below and the chrome-trace
    merge."""
    return [obj]


def merge_snapshots(snaps) -> dict:
    """Merge per-host snapshot dicts into one (rank-0 aggregation).

    Counters and histogram (counts, sum, count) add; gauges take the
    max across hosts; histogram min/max combine. Histograms must share
    bucket layouts (they do by construction — layouts are fixed at
    metric creation); a mismatch raises ``ValueError``.
    """
    snaps = [s for s in snaps if s]
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    for s in snaps:
        for k, v in s.get("counters", {}).items():
            out["counters"][k] = out["counters"].get(k, 0.0) + v
        for k, v in s.get("gauges", {}).items():
            out["gauges"][k] = (v if k not in out["gauges"]
                                else max(out["gauges"][k], v))
        for k, h in s.get("histograms", {}).items():
            if k not in out["histograms"]:
                out["histograms"][k] = {
                    "buckets": list(h["buckets"]),
                    "counts": list(h["counts"]),
                    "sum": h["sum"], "count": h["count"],
                    "min": h.get("min"), "max": h.get("max")}
                continue
            acc = out["histograms"][k]
            if list(h["buckets"]) != acc["buckets"]:
                raise ValueError(
                    f"histogram {k!r}: bucket layouts differ across "
                    f"hosts — {acc['buckets']} vs {list(h['buckets'])}")
            acc["counts"] = [a + b
                             for a, b in zip(acc["counts"], h["counts"])]
            acc["sum"] += h["sum"]
            acc["count"] += h["count"]
            for key, pick in (("min", min), ("max", max)):
                vals = [v for v in (acc.get(key), h.get(key))
                        if v is not None]
                acc[key] = pick(vals) if vals else None
    return out


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str, prefix: str) -> str:
    n = _NAME_RE.sub("_", name)
    if prefix:
        n = f"{prefix}_{n}"
    if n[:1].isdigit():
        n = "_" + n
    return n


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def render_prometheus(snap: dict | None = None,
                      prefix: str = "tdt") -> str:
    """Render a snapshot (default: the active registry's) as Prometheus
    text exposition. Counters get the ``_total`` suffix; histogram
    buckets are emitted CUMULATIVE with ``le`` labels plus the
    ``_sum`` / ``_count`` series, per the format spec."""
    if snap is None:
        snap = _registry.snapshot()
    lines = []
    for name in sorted(snap.get("counters", {})):
        pn = _prom_name(name, prefix) + "_total"
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn} {_fmt(snap['counters'][name])}")
    for name in sorted(snap.get("gauges", {})):
        pn = _prom_name(name, prefix)
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {_fmt(snap['gauges'][name])}")
    for name in sorted(snap.get("histograms", {})):
        h = snap["histograms"][name]
        pn = _prom_name(name, prefix)
        lines.append(f"# TYPE {pn} histogram")
        cum = 0
        for ub, c in zip(h["buckets"], h["counts"]):
            cum += c
            lines.append(f'{pn}_bucket{{le="{_fmt(ub)}"}} {cum}')
        cum += h["counts"][len(h["buckets"])]
        lines.append(f'{pn}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{pn}_sum {_fmt(h['sum'])}")
        lines.append(f"{pn}_count {h['count']}")
    return "\n".join(lines) + ("\n" if lines else "")


def aggregate_across_hosts(snap: dict | None = None) -> dict:
    """Gather every host's snapshot and return the merged dict
    (meaningful on rank 0; every rank returns the same merge).

    The multi-host transport mirrors the reference's ``gather_object``:
    each host contributes its JSON-encoded snapshot as a padded uint8
    array through ``process_allgather``, rank 0's merge being plain
    ``merge_snapshots``. Single-process (the CPU tier-1 mesh) returns
    the local snapshot unchanged.
    """
    if snap is None:
        snap = _registry.snapshot()
    return merge_snapshots(allgather_json(snap))
