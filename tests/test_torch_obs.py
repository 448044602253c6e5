"""The port's telemetry (``triton_dist_tpu_torch.obs``) against the JAX
package's (``triton_dist_tpu.obs``) on the CPU: the same event sequences
run through both, and the outputs must be equal — JSON snapshots,
Prometheus text, quantiles, merges, SLO verdicts and gauges, attribution
waterfalls, trace events (names, phases, categories, trace IDs, args and
nesting; timestamps masked) and their Chrome export, flight-recorder
dumps. Then a tiny f32 ``Engine.serve`` / ``serve_stream`` on both
packages leaves the same engine counters and histogram counts under the
same names, and the same engine trace events.

Clocks are injected where the modules take one (the SLO windows);
elsewhere span durations and timestamps are masked, since two runs never
take the same time. Modelled on the JAX package's tests/test_obs.py,
test_trace.py and test_slo.py."""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import triton_dist_tpu.obs as jax_obs
import triton_dist_tpu_torch.obs as port_obs
from triton_dist_tpu.tools import trace_export as jax_texp
from triton_dist_tpu_torch.tools import trace_export as port_texp

PKGS = {
    "jax": types.SimpleNamespace(obs=jax_obs, trace=jax_obs.trace,
                                 flight=jax_obs.flight, slo=jax_obs.slo,
                                 attrib=jax_obs.attrib, texp=jax_texp),
    "port": types.SimpleNamespace(obs=port_obs, trace=port_obs.trace,
                                  flight=port_obs.flight, slo=port_obs.slo,
                                  attrib=port_obs.attrib, texp=port_texp),
}


def _reset(p):
    p.obs.disable()
    p.trace.disable()
    p.trace.reset()
    p.flight.reset()
    p.attrib.reset()


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    """Both packages' telemetry is process-global: every test starts and
    ends disabled, dumps land in a test directory."""
    monkeypatch.setenv("TDT_TRACE_DIR", str(tmp_path / "dumps"))
    for name in ("TDT_TRACE", "TDT_SLO", "TDT_FLIGHT_SECONDS"):
        monkeypatch.delenv(name, raising=False)
    for p in PKGS.values():
        _reset(p)
    yield
    for p in PKGS.values():
        _reset(p)


def _both(fn):
    """``fn(pkg)`` on the JAX package then the port, each from a clean
    state; returns (jax result, port result)."""
    out = []
    for p in PKGS.values():
        _reset(p)
        out.append(fn(p))
        _reset(p)
    return tuple(out)


def _masked_snapshot(snap):
    """A snapshot with span histograms' sum / min / max masked (wall
    time), counts kept."""
    snap = json.loads(json.dumps(snap))
    for name, h in snap["histograms"].items():
        if name.endswith("_ms"):
            h.update(sum=None, min=None, max=None)
    return snap


def _events(collected):
    """A trace collection without timestamps: per track, (phase, name,
    category, trace id, args) in order."""
    return {track: [(ph, name, cat, tid, args)
                    for ph, _ts, _dur, name, cat, tid, args in evs]
            for track, evs in collected["tracks"].items()}


def _chrome(obj):
    """A Chrome trace object with ts / dur masked."""
    obj = json.loads(json.dumps(obj))
    for e in obj["traceEvents"]:
        e.pop("ts", None)
        e.pop("dur", None)
    return obj


def _nesting(events):
    """The B/E nesting of one track's events as (depth, name) pairs."""
    depth, out = 0, []
    for ph, name, *_ in events:
        if ph == "E":
            depth -= 1
        out.append((depth, ph, name))
        if ph == "B":
            depth += 1
    return out


# -- registry, exposition ------------------------------------------------

def _registry_program(p):
    o = p.obs
    out = {}
    assert not o.enabled()
    o.counter("n").inc()
    o.histogram("h").observe(1.0)
    out["noop"] = (o.snapshot(), o.span("a") is o.span("b"))
    reg = o.Registry()
    c = reg.counter("engine.serve_calls")
    c.inc()
    c.inc(2.5)
    errors = []
    for bad in (lambda: c.inc(-1), lambda: reg.gauge("engine.serve_calls"),
                lambda: reg.histogram("bad", buckets=(5.0, 1.0))):
        try:
            bad()
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    g = reg.gauge("server.inflight")
    g.set(4)
    g.inc()
    g.dec(2)
    h = reg.histogram("engine.decode_step_ms", buckets=(1.0, 5.0, 100.0))
    for v in (0.5, 2.0, 9.0, 1.0, 500.0):
        h.observe(v)
    out["snapshot"] = reg.snapshot()
    out["prometheus"] = o.render_prometheus(reg.snapshot())
    hs = out["snapshot"]["histograms"]["engine.decode_step_ms"]
    out["quantiles"] = [o.histogram_quantile(hs, q, detail=True)
                        for q in (0.05, 0.5, 0.9, 0.99)]
    clipped = {"buckets": [1.0, 2.0, 4.0], "counts": [1, 0, 0, 9],
               "count": 10, "sum": 100.0, "min": None, "max": None}
    out["clipped"] = o.histogram_quantile(clipped, 0.99, detail=True)
    r0, r1 = o.Registry(), o.Registry()
    for i, r in enumerate((r0, r1)):
        r.counter("c").inc(1 + i)
        r.gauge("g").set(10 * (i + 1))
        r.histogram("h", buckets=(1.0, 2.0)).observe(0.5 + i)
    out["merge"] = o.merge_snapshots([r0.snapshot(), r1.snapshot()])
    o.enable(r0)
    out["aggregate"] = o.aggregate_across_hosts()
    with o.span("engine.step"):
        pass
    o.enable()                                  # idempotent: keeps counts
    with o.span("engine.step"):
        pass
    scoped = o.Registry()
    with o.scoped_registry(scoped):
        o.counter("replica.calls").inc(3)
    o.record_comm("allgather", np.zeros((4, 8), np.float32),
                  np.zeros(3, np.int8))
    out["scoped"] = scoped.snapshot()
    out["global"] = _masked_snapshot(o.snapshot())
    return out


def test_registry_and_exposition_match_jax():
    want, got = _both(_registry_program)
    assert got == want
    assert want["snapshot"]["counters"] == {"engine.serve_calls": 3.5}
    assert want["global"]["counters"]["comms.allgather.bytes"] == 131.0


def test_record_comm_counts_tensor_bytes():
    o = port_obs
    o.enable()
    o.record_comm("allgather", torch.zeros((4, 8)),
                  torch.zeros(3, dtype=torch.int8))
    assert o.snapshot()["counters"] == {"comms.allgather.calls": 1.0,
                                        "comms.allgather.bytes": 131.0}


# -- tracing, Chrome export, flight recorder ------------------------------

def _trace_program(p):
    o, trace = p.obs, p.trace
    out = {}
    reg = o.Registry()
    o.enable(reg)
    trace.enable(capacity=4)
    for i in range(10):                         # 6 overwrites
        trace.instant(f"e{i}", "op", args={"i": i})
    st = trace.stats()
    out["stats"] = {k: st[k] for k in ("enabled", "events_total",
                                       "dropped_total", "ring_capacity",
                                       "ring_high_water")}
    out["drop_gauges"] = reg.snapshot()["gauges"]
    out["ring"] = _events(trace.collect())
    trace.disable()
    trace.reset()
    trace.enable()
    with trace.bind("rt-1"):
        with o.span("serving.request", args={"n": 1}):
            with o.span("engine.decode_step"):
                trace.instant("comms.ag_gemm", "op", args={"bytes": 64})
            trace.complete("engine.prefill", "engine", trace.now_us(), 5.0,
                           args={"batch": 2})
        o.record_comm("gemm_ar", np.zeros(16, np.float32))
    trace.ring_schedule_events("ag_gemm", world=4, dirs=2, compute_ms=1.0,
                               comm_ms=0.5)
    col = trace.collect()
    out["events"] = _events(col)
    out["nesting"] = {t: _nesting(e) for t, e in out["events"].items()}
    out["chrome"] = _chrome(p.texp.to_chrome(col, pid=0))
    out["counters"] = reg.snapshot()["counters"]
    return out


def test_trace_events_and_chrome_export_match_jax():
    want, got = _both(_trace_program)
    assert got == want
    assert want["stats"]["dropped_total"] == 6
    tracks = want["nesting"]
    main = next(v for v in tracks.values()
                if any(n == "serving.request" for _, _, n in v))
    assert main[:2] == [(0, "B", "serving.request"),
                        (1, "B", "engine.decode_step")]


def _flight_program(p):
    trace, flight = p.trace, p.flight
    reg = p.obs.Registry()
    p.obs.enable(reg)
    out = {"disabled": flight.dump("off")}
    trace.enable()
    with trace.bind("fl-1"):
        trace.instant("serving.admit", "serving", args={"row": 0})
        with trace.span("engine.stream_step", "engine"):
            pass
    flight.set_replica_id("r-7")
    path = flight.dump("watchdog trip!")
    with open(path) as f:
        dumped = json.load(f)
    dumped["metadata"].pop("unix_time")
    out["dump"] = _chrome(dumped)
    out["file"] = path.rsplit("/", 1)[1].split("_h0_")[0]
    out["again"] = flight.maybe_dump("watchdog trip!") is not None
    out["rate_limited"] = flight.maybe_dump("watchdog trip!")
    out["last"] = {k: v for k, v in flight.last_record().items()
                   if k in ("reason", "count")}
    out["counters"] = reg.snapshot()["counters"]
    out["seconds"] = flight.flight_seconds()
    return out


def test_flight_dump_matches_jax(monkeypatch):
    monkeypatch.setenv("TDT_FLIGHT_SECONDS", "12.5")
    want, got = _both(_flight_program)
    assert got == want
    assert want["disabled"] is None and want["seconds"] == 12.5
    assert want["counters"]["resilience.flight_dumps"] == 2.0


# -- SLO windows, burn rates, verdicts ------------------------------------

class Clock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _slo_program(p):
    slo, o = p.slo, p.obs
    out = {}
    reg = o.Registry()
    o.enable(reg)
    p.trace.enable()
    ck = Clock(1000.0)
    w = slo.WindowedHistogram(window_s_=60.0, subwindows_=12,
                              retain_windows=10, clock=ck)
    for _ in range(10):
        w.observe(4.0)
    ck.advance(30.0)
    out["window"] = [w.snapshot()["count"]]
    ck.advance(40.0)
    out["window"] += [w.snapshot()["count"],
                      w.snapshot(over_s=600.0)["count"]]
    out["vf"] = slo.violating_fraction(w.snapshot(over_s=600.0), 3.0)
    targets = [slo.SLOTarget("ttft", 0.99, 50.0),
               slo.SLOTarget("tpot", 0.9, 20.0, burn_threshold=2.0)]
    tr = slo.SLOTracker(targets=targets, window_s_=60.0, subwindows_=12,
                        slow_mult_=5, clock=ck)
    for i in range(40):
        tr.observe("ttft", 10.0 + i)
        tr.observe("tpot", 5.0)
        ck.advance(1.0)
    out["calm"] = tr.evaluate(force=True)
    for i in range(40):
        tr.observe("ttft", 400.0)              # a latency spike
        tr.observe("tpot", 90.0 if i % 2 else 5.0)
        ck.advance(0.5)
    out["breach"] = tr.evaluate(force=True)
    out["rate_limited"] = tr.evaluate()
    ck.advance(600.0)
    out["drained"] = tr.evaluate(force=True)
    out["quantile"] = tr.quantile("ttft", 0.5, over_s=6000.0)
    out["gauges"] = reg.snapshot()["gauges"]
    out["counters"] = reg.snapshot()["counters"]
    out["catalog"] = slo.gauge_catalog(targets)
    out["breach_events"] = [
        (ph, name, args) for evs in _events(p.trace.collect()).values()
        for ph, name, _cat, _tid, args in evs if "slo_breach" in name]
    errors = []
    for bad in (lambda: slo.SLOTarget("nope", 0.9, 1.0),
                lambda: slo.SLOTarget("ttft", 1.5, 1.0),
                lambda: slo.SLOTarget("ttft", 0.9, 0.0)):
        try:
            bad()
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    return out


def test_slo_verdicts_match_jax():
    want, got = _both(_slo_program)
    assert got == want
    assert want["window"] == [10, 0, 10]
    assert want["breach"]["new_breaches"] and not want["calm"]["new_breaches"]
    assert want["rate_limited"] is None


def _attrib_program(p):
    a = p.attrib
    recs = [a.build(rid=i, trace_id=f"t{i}", t_submit=10.0 + i,
                    t_admit=10.25 + i, t_first=10.5 + i, t_done=11.5 + i,
                    prompt_tokens=13, tokens=1 + i, cached_tokens=4 * i,
                    prefill_chunks=i) for i in range(3)]
    recs.append(a.build(rid=9, trace_id=None, t_submit=0.0, t_admit=0.0,
                        t_first=0.1, t_done=0.3, prompt_tokens=2, tokens=5,
                        draft_ms=1.25, verify_ms=2.5))
    for r in recs:
        a.push(r)
    return {"records": recs, "last": a.last(), "last2": a.last(2),
            "ring": a.ring_size()}


def test_attribution_waterfalls_match_jax(monkeypatch):
    monkeypatch.setenv("TDT_ATTRIB_RING", "3")
    want, got = _both(_attrib_program)
    assert got == want
    assert [r["rid"] for r in want["last"]] == [9, 2, 1]


# -- the engines' telemetry -----------------------------------------------

TINY = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
            num_attention_heads=4, num_key_value_heads=2, head_dim=8,
            vocab_size=64, max_position_embeddings=32)
SQUARE = [[1, 2, 3, 4], [5, 6, 7, 8]]
STREAM = [[1, 2, 3], [4, 5, 6, 7, 8], [9], [10, 11]]
GEN = 4


@pytest.fixture(scope="module")
def engines():
    from triton_dist_tpu.models import DenseLLM as JaxDense
    from triton_dist_tpu.models import Engine as JaxEngine
    from triton_dist_tpu.models import ModelConfig as JaxConfig
    from triton_dist_tpu_torch.models import (
        DenseLLM, Engine, ModelConfig, params_from_jax)
    mesh = Mesh(np.array(jax.devices()[:1]), ("tp",))
    jmodel = JaxDense(JaxConfig(dtype=jnp.float32, **TINY), mesh=mesh,
                      axis="tp", impl="xla")
    jparams = jmodel.init(jax.random.PRNGKey(2))
    model = DenseLLM(ModelConfig(dtype=torch.float32, **TINY), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             model.config, "cpu")
    return {"jax": (JaxEngine(jmodel, batch=2, max_seq=32), jparams,
                    lambda x: jnp.asarray(x, jnp.int32)),
            "port": (Engine(model, batch=2, max_seq=32), params,
                     lambda x: x)}


def _engine_program(engines, name):
    eng, params, ids = engines[name]
    p = PKGS[name]
    reg = p.obs.Registry()
    p.obs.enable(reg)
    p.trace.enable()
    with p.trace.bind("req-1"):
        served = eng.serve(params, ids(SQUARE), GEN)
        stream = eng.serve_stream(params, STREAM, GEN)
    snap = reg.snapshot()
    keep = ("engine.", "serving.")
    engine_events = [
        (ph, name, cat, tid) for evs in _events(p.trace.collect()).values()
        for ph, name, cat, tid, _args in evs if cat == "engine"]
    return {
        "tokens": (np.asarray(served).tolist(), stream),
        "counters": {k: v for k, v in snap["counters"].items()
                     if k.startswith(keep)},
        "histograms": {k: h["count"] for k, h in snap["histograms"].items()
                       if k.startswith(keep)},
        "gauges": sorted(k for k in snap["gauges"] if k.startswith(keep)),
        "events": engine_events,
    }


def test_engine_telemetry_matches_jax(engines):
    want, got = _both(lambda p: _engine_program(
        engines, "jax" if p is PKGS["jax"] else "port"))
    assert got == want
    c = want["counters"]
    assert c["engine.serve_calls"] == 1 and c["engine.serve_stream_calls"] == 1
    assert c["engine.stream_admissions"] == len(STREAM)
    assert c["engine.tokens_generated"] == len(SQUARE) * GEN
    assert want["histograms"]["engine.decode_step_ms"] == GEN - 1
    assert "engine.tokens_per_s" in want["gauges"]


def test_engine_telemetry_off_records_nothing(engines):
    eng, params, _ = engines["port"]
    assert not port_obs.enabled() and not port_obs.trace.enabled()
    eng.serve(params, SQUARE, GEN)
    eng.serve_stream(params, STREAM, GEN)
    assert port_obs.snapshot() == {"counters": {}, "gauges": {},
                                   "histograms": {}}
    assert port_obs.trace.collect()["tracks"] == {}
