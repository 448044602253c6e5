"""Sliding-window SLO engine: rolling percentiles + burn-rate alerts.

The metrics registry keeps cumulative-since-boot histograms:
after an hour of good samples a p99 regression is arithmetically
invisible — the bad minute drowns in the good hour. This module adds
the *rolling* view serving health lives on: a ring of subwindow bucket
arrays (:class:`WindowedHistogram`) whose trailing-window merge yields
p50/p99 over the last ``TDT_SLO_WINDOW_S`` seconds (default 60 s, 12
subwindows of 5 s), for the four serving signals the scheduler feeds —
TTFT, per-output-token time (TPOT), queue wait, and pump-iteration
time.

On top sit declarative targets (:class:`SLOTarget`) evaluated
Google-SRE style with **multi-window burn rates**: the burn rate of a
window is the fraction of that window's requests violating the
threshold divided by the error budget ``1 - p`` (burn 1.0 = budget
consumed exactly at the sustainable rate). A target *breaches* when
BOTH the fast window (``window_s``, 1 min) and the slow window
(``window_s × TDT_SLO_SLOW_MULT``, 10 min) exceed the target's burn
threshold — the fast window gives detection latency, the slow window
vetoes one-off blips (a single slow request cannot page anyone).

The payoff: a breach **arms the flight recorder** — the same
``obs.flight`` dump a watchdog trip produces — so a latency regression
leaves a Perfetto postmortem of what the process was doing *before*
anything crashes. Dumps fire on the not-breached → breached
transition only (plus ``obs.flight``'s own per-reason rate limit), so
a sustained breach writes one record, not one per evaluation.

Every clock is injectable (``clock=``) so window rotation, expiry, and
burn math are testable without sleeping (tests/test_slo.py).

Metric surface (docs/observability.md "SLOs and burn rates"):
``serving.rolling.<metric>_{p50,p99}_ms`` + ``serving.rolling.<metric>_n``
gauges, ``serving.slo_burn.<name>`` / ``serving.slo_burn.<name>_slow``
/ ``serving.slo_breached.<name>`` gauges, ``serving.slo_breaches`` /
``serving.slo_breach.<name>`` counters.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import os
import threading
import time

from triton_dist_tpu_torch.obs import flight as _flight
from triton_dist_tpu_torch.obs import registry as _registry
from triton_dist_tpu_torch.obs import trace as _trace
from triton_dist_tpu_torch.obs.exposition import histogram_quantile

__all__ = [
    "DEFAULT_BURN_THRESHOLD", "DEFAULT_SLOW_MULT", "DEFAULT_SUBWINDOWS",
    "DEFAULT_WINDOW_S", "METRICS", "SLO_MS_BUCKETS", "SLOTarget",
    "SLOTracker", "WindowedHistogram", "default_targets", "enabled",
    "gauge_catalog", "violating_fraction",
]

#: The serving signals the scheduler feeds into the tracker.
METRICS = ("ttft", "tpot", "queue_wait", "pump")

#: Default rolling window (seconds) — the FAST burn window.
DEFAULT_WINDOW_S = 60.0

#: Subwindows per window: granularity of rotation/expiry.
DEFAULT_SUBWINDOWS = 12

#: Slow burn window = ``window_s * slow_mult`` (Google-SRE multiwindow:
#: the fast window detects, the slow window vetoes blips).
DEFAULT_SLOW_MULT = 10

#: Burn rate both windows must exceed for a breach. 1.0 = the error
#: budget is being consumed exactly at the sustainable rate.
DEFAULT_BURN_THRESHOLD = 1.0

#: The SLOW window must hold at least this many samples before a
#: target can breach (``TDT_SLO_MIN_SAMPLES``). Under sparse traffic
#: the slow window may contain only the blip itself — with no good
#: traffic to dilute it, fast and slow agree trivially and the
#: multiwindow veto is void; requiring a floor of slow-window data
#: restores "a single slow request cannot page anyone".
DEFAULT_MIN_SAMPLES = 10

#: SLO histograms extend the default ms buckets past 10 s: thresholds
#: only *provably* fire on samples inside a finite bucket (the
#: overflow tail cannot be compared against a larger threshold), so
#: the buckets must reach the generous default thresholds below.
SLO_MS_BUCKETS = _registry.DEFAULT_MS_BUCKETS + (
    25_000.0, 60_000.0, 120_000.0, 300_000.0)

#: Default targets: (metric, env override, p, threshold_ms). Deliberately
#: generous — on the CPU quick tier nothing healthy ever breaches them
#: (the acceptance bar: no false positive across the suite) — and
#: per-deployment env overrides tighten them to real latency goals.
_DEFAULT_TARGET_SPECS = (
    ("ttft", "TDT_SLO_TTFT_P99_MS", 0.99, 60_000.0),
    ("tpot", "TDT_SLO_TPOT_P99_MS", 0.99, 60_000.0),
    ("queue_wait", "TDT_SLO_QUEUE_P99_MS", 0.99, 120_000.0),
)

#: Evaluations closer together than this are skipped (pump loops tick
#: every few ms; quantile merges need not run that often).
EVAL_INTERVAL_S = 1.0


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name, "").strip()
    if not v:
        return default
    try:
        return float(v)
    except ValueError:
        raise ValueError(f"{name} must be a number: {v!r}") from None


def enabled() -> bool:
    """``TDT_SLO=0`` switches the whole SLO engine off."""
    return os.environ.get("TDT_SLO", "").strip() != "0"


def window_s() -> float:
    return _env_float("TDT_SLO_WINDOW_S", DEFAULT_WINDOW_S)


def subwindows() -> int:
    return _registry.env_int("TDT_SLO_SUBWINDOWS", DEFAULT_SUBWINDOWS,
                             minimum=1)


def slow_mult() -> int:
    return _registry.env_int("TDT_SLO_SLOW_MULT", DEFAULT_SLOW_MULT,
                             minimum=1)


def burn_threshold() -> float:
    return _env_float("TDT_SLO_BURN_RATE", DEFAULT_BURN_THRESHOLD)


def min_breach_samples() -> int:
    return _registry.env_int("TDT_SLO_MIN_SAMPLES",
                             DEFAULT_MIN_SAMPLES, minimum=0)


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """Declarative target: "the ``p`` quantile of ``metric`` stays
    under ``threshold_ms``" — i.e. at most ``1 - p`` of requests may
    exceed the threshold (the error budget the burn rate is measured
    against)."""

    metric: str
    p: float
    threshold_ms: float
    burn_threshold: float = DEFAULT_BURN_THRESHOLD

    def __post_init__(self):
        if self.metric not in METRICS:
            raise ValueError(
                f"SLOTarget metric {self.metric!r} not in {METRICS}")
        if not 0.0 < self.p < 1.0:
            raise ValueError(f"SLOTarget p must be in (0, 1): {self.p}")
        if self.threshold_ms <= 0:
            raise ValueError(
                f"SLOTarget threshold_ms must be positive: "
                f"{self.threshold_ms}")

    @property
    def name(self) -> str:
        return f"{self.metric}_p{self.p * 100:g}".replace(".", "_")

    @property
    def budget(self) -> float:
        return 1.0 - self.p


def default_targets() -> list[SLOTarget]:
    """The default target set, with per-metric env overrides
    (``TDT_SLO_TTFT_P99_MS`` etc.; ``0`` or negative disables that
    target)."""
    bt = burn_threshold()
    out = []
    for metric, env, p, dflt in _DEFAULT_TARGET_SPECS:
        thr = _env_float(env, dflt)
        if thr > 0:
            out.append(SLOTarget(metric, p, thr, burn_threshold=bt))
    return out


class WindowedHistogram:
    """Ring of subwindow bucket arrays: rolling-window histograms.

    Each subwindow covers ``window_s / subwindows`` seconds and is a
    plain ``(counts, sum, count)`` triple keyed by its absolute
    subwindow index (``clock() // sub_s``); subwindows older than the
    retained span (``window_s × retain_windows`` — sized to cover the
    SLOW burn window) expire on the next observe/snapshot.
    :meth:`snapshot` merges the trailing subwindows covering a
    requested window into a registry-shaped histogram dict, so
    ``obs.histogram_quantile`` works on it unchanged. ``min``/``max``
    are reported as None — window extrema are not tracked, and the
    quantile's overflow handling clips to the top finite edge instead
    of needing them.
    """

    __slots__ = ("buckets", "window_s", "sub_s", "n_keep", "_slots",
                 "_lock", "_clock")

    def __init__(self, buckets=SLO_MS_BUCKETS, window_s_: float | None = None,
                 subwindows_: int | None = None,
                 retain_windows: int | None = None, clock=time.monotonic):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError("buckets must be ascending, non-empty")
        self.buckets = tuple(float(b) for b in buckets)
        self.window_s = window_s_ if window_s_ is not None else window_s()
        n_sub = subwindows_ if subwindows_ is not None else subwindows()
        if self.window_s <= 0 or n_sub <= 0:
            raise ValueError(
                f"window_s/subwindows must be positive: "
                f"{self.window_s}/{n_sub}")
        retain = retain_windows if retain_windows is not None else slow_mult()
        self.sub_s = self.window_s / n_sub
        self.n_keep = n_sub * max(int(retain), 1)
        self._slots: collections.OrderedDict[int, list] = (
            collections.OrderedDict())
        self._lock = threading.Lock()
        self._clock = clock

    def _expire(self, now_idx: int) -> None:
        # Caller holds the lock. Insertion order == index order (the
        # clock is monotonic), so expiry pops from the front.
        oldest_keep = now_idx - self.n_keep + 1
        while self._slots and next(iter(self._slots)) < oldest_keep:
            self._slots.popitem(last=False)

    def observe(self, value: float) -> None:
        value = float(value)
        i = bisect.bisect_left(self.buckets, value)
        now_idx = int(self._clock() // self.sub_s)
        with self._lock:
            self._expire(now_idx)
            slot = self._slots.get(now_idx)
            if slot is None:
                slot = self._slots[now_idx] = [
                    [0] * (len(self.buckets) + 1), 0.0, 0]
            slot[0][i] += 1
            slot[1] += value
            slot[2] += 1

    def snapshot(self, over_s: float | None = None) -> dict:
        """Merged histogram dict over the trailing ``over_s`` seconds
        (default: one fast window): the current — possibly partial —
        subwindow plus enough whole ones to cover the span."""
        over_s = self.window_s if over_s is None else float(over_s)
        n = min(max(-(-over_s // self.sub_s), 1), self.n_keep)
        now_idx = int(self._clock() // self.sub_s)
        counts = [0] * (len(self.buckets) + 1)
        total, s = 0, 0.0
        with self._lock:
            self._expire(now_idx)
            for idx, (c, sm, n_obs) in self._slots.items():
                if idx > now_idx - n:
                    for i, v in enumerate(c):
                        counts[i] += v
                    s += sm
                    total += n_obs
        return {"buckets": list(self.buckets), "counts": counts,
                "sum": s, "count": total, "min": None, "max": None}

    def quantile(self, q: float, over_s: float | None = None):
        return histogram_quantile(self.snapshot(over_s), q)

    def clear(self) -> None:
        """Drop every retained subwindow (a fresh measurement epoch)."""
        with self._lock:
            self._slots.clear()


def violating_fraction(h: dict, threshold_ms: float) -> float:
    """Estimated fraction of a histogram dict's samples above
    ``threshold_ms``: whole buckets above the threshold count fully,
    the containing bucket contributes linearly, and overflow-bucket
    samples count only when the threshold sits at or under the top
    finite edge (they are provably above it there; beyond the top edge
    their position is unknowable and assuming violation would
    manufacture false positives)."""
    counts = h.get("counts") or []
    buckets = h.get("buckets") or []
    total = h.get("count", 0)
    if not total or not counts:
        return 0.0
    threshold_ms = float(threshold_ms)
    viol = 0.0
    lo = 0.0
    for i, c in enumerate(counts):
        if i >= len(buckets):
            if buckets and threshold_ms <= buckets[-1]:
                viol += c
            break
        hi = buckets[i]
        if threshold_ms <= lo:
            viol += c
        elif threshold_ms < hi:
            viol += c * (hi - threshold_ms) / (hi - lo)
        lo = hi
    return viol / total


class SLOTracker:
    """Rolling-window observatory over the serving signals + the
    burn-rate evaluator that arms the flight recorder.

    One per serving scheduler (``serving/scheduler.py``); the
    pump thread observes and ticks :meth:`evaluate` (rate-limited to
    :data:`EVAL_INTERVAL_S`), the server's ``{"cmd": "metrics"}``
    forces a fresh evaluation before snapshotting. Gauges land in the
    process registry, so multiple trackers in one process (tests) last
    write wins — exactly the point-in-time semantics gauges carry."""

    def __init__(self, targets=None, window_s_: float | None = None,
                 subwindows_: int | None = None,
                 slow_mult_: int | None = None, clock=time.monotonic,
                 buckets=SLO_MS_BUCKETS):
        self.window_s = window_s_ if window_s_ is not None else window_s()
        mult = slow_mult_ if slow_mult_ is not None else slow_mult()
        self.slow_s = self.window_s * max(int(mult), 1)
        self.clock = clock
        self.targets = tuple(default_targets() if targets is None
                             else targets)
        for t in self.targets:
            if not isinstance(t, SLOTarget):
                raise TypeError(
                    f"slo targets must be SLOTarget, got {t!r}")
        self.hists = {m: WindowedHistogram(
            buckets, self.window_s, subwindows_, max(int(mult), 1),
            clock) for m in METRICS}
        self._lock = threading.Lock()
        self._breached: dict[str, bool] = {}
        self._last_eval: float | None = None

    def observe(self, metric: str, ms: float) -> None:
        self.hists[metric].observe(ms)

    def reset_windows(self) -> None:
        """Drop every rolling window (breach state stays): the start
        of a fresh measurement epoch. bench.py calls this between its
        warmup and timed passes so the windowed percentiles it reports
        cannot contain the warmup's cold-compile latencies."""
        for h in self.hists.values():
            h.clear()

    def quantile(self, metric: str, q: float,
                 over_s: float | None = None):
        return self.hists[metric].quantile(q, over_s)

    def burn_rate(self, target: SLOTarget, over_s: float) -> float:
        """Violating fraction over the window, divided by the error
        budget. 0.0 on an empty window (no data is not a breach)."""
        h = self.hists[target.metric].snapshot(over_s)
        if not h["count"]:
            return 0.0
        return (violating_fraction(h, target.threshold_ms)
                / max(target.budget, 1e-9))

    @staticmethod
    def _burn_of(snap: dict, target: SLOTarget) -> float:
        if not snap["count"]:
            return 0.0
        return (violating_fraction(snap, target.threshold_ms)
                / max(target.budget, 1e-9))

    def evaluate(self, force: bool = False) -> dict | None:
        """One evaluation pass: refresh the rolling-percentile and
        burn-rate gauges, detect breach transitions, arm the flight
        recorder on each new breach. Returns the evaluation dict, or
        None when rate-limited (``force=True`` bypasses)."""
        new_breaches: list[str] = []
        with self._lock:
            now = self.clock()
            if (not force and self._last_eval is not None
                    and now - self._last_eval < EVAL_INTERVAL_S):
                return None
            self._last_eval = now
            rolling: dict = {}
            # One window merge per (metric, span): the fast snapshots
            # serve the rolling gauges AND every target's fast burn,
            # the slow ones each target's slow burn + sample floor.
            fast_snaps = {m: self.hists[m].snapshot() for m in METRICS}
            slow_snaps: dict = {}
            for m in METRICS:
                snap = fast_snaps[m]
                _registry.gauge(f"serving.rolling.{m}_n").set(
                    snap["count"])
                for q, tag in ((0.50, "p50"), (0.99, "p99")):
                    # A drained window zeroes its gauges (with _n=0
                    # alongside): a dashboard must never read a
                    # minutes-old percentile as current.
                    v = (histogram_quantile(snap, q)
                         if snap["count"] else None)
                    _registry.gauge(
                        f"serving.rolling.{m}_{tag}_ms").set(
                        round(v, 3) if v is not None else 0.0)
                    if v is not None:
                        rolling[f"{m}_{tag}_ms"] = round(v, 3)
            burn: dict = {}
            min_n = min_breach_samples()
            for t in self.targets:
                if t.metric not in slow_snaps:
                    slow_snaps[t.metric] = self.hists[
                        t.metric].snapshot(self.slow_s)
                fast = self._burn_of(fast_snaps[t.metric], t)
                slow = self._burn_of(slow_snaps[t.metric], t)
                _registry.gauge(f"serving.slo_burn.{t.name}").set(
                    round(fast, 4))
                _registry.gauge(f"serving.slo_burn.{t.name}_slow").set(
                    round(slow, 4))
                # The slow-window sample floor keeps the multiwindow
                # veto meaningful under sparse traffic: one slow
                # request alone in both windows must not page anyone.
                breached = (fast > t.burn_threshold
                            and slow > t.burn_threshold
                            and slow_snaps[t.metric]["count"] >= min_n)
                _registry.gauge(f"serving.slo_breached.{t.name}").set(
                    1.0 if breached else 0.0)
                if breached and not self._breached.get(t.name):
                    # Transition, not level: a sustained breach arms
                    # the recorder ONCE (obs.flight's per-reason rate
                    # limit backstops a flapping target).
                    new_breaches.append(t.name)
                    _registry.counter("serving.slo_breaches").inc()
                    _registry.counter(
                        f"serving.slo_breach.{t.name}").inc()
                    _trace.instant(
                        f"serving.slo_breach.{t.name}", "serving",
                        args={"target": t.name,
                              "threshold_ms": t.threshold_ms,
                              "burn_fast": round(fast, 4),
                              "burn_slow": round(slow, 4)})
                self._breached[t.name] = breached
                burn[t.name] = {"fast": round(fast, 4),
                                "slow": round(slow, 4),
                                "breached": breached}
        # The dump serializes the whole trace ring to disk — OUTSIDE
        # the tracker lock, or a concurrent metrics scrape (and the
        # pump itself) would stall behind file I/O exactly while the
        # regression being reported is in progress.
        for name in new_breaches:
            _flight.maybe_dump(f"slo_{name}")
        return {"rolling": rolling, "burn": burn,
                "new_breaches": new_breaches}


def gauge_catalog(targets=None) -> list[str]:
    """Every gauge name the tracker maintains (the wellformedness
    contract a live ``{"cmd": "metrics"}`` snapshot is tested
    against). Percentile gauges require at least one sample in the
    window; ``_n`` gauges and the per-target burn/breach gauges exist
    after any evaluation."""
    targets = default_targets() if targets is None else targets
    names = [f"serving.rolling.{m}_n" for m in METRICS]
    names += [f"serving.rolling.{m}_{tag}_ms" for m in METRICS
              for tag in ("p50", "p99")]
    for t in targets:
        names += [f"serving.slo_burn.{t.name}",
                  f"serving.slo_burn.{t.name}_slow",
                  f"serving.slo_breached.{t.name}"]
    return names
