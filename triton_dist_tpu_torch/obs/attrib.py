"""Per-request latency attribution: where did this request's time go?

The trace timeline already carries every request's story —
``serving.admit`` / ``serving.retire`` instants, admission prefill
events, prefix-hit instants — under its trace ID, but reading it
means exporting a dump and opening Perfetto. This module folds the
same per-request timestamps into a *waterfall* the serving path can
hand back inline:

    queue_wait → prefill (admission, chunked or one-shot, minus any
    prefix-cache hit) → decode (per-token share)

Segments are computed from one monotonic clock's readings
(``t_submit`` → ``t_admit`` → ``t_first`` → ``t_done``), so they sum
to the request's measured wall time *by construction* — the
acceptance contract (segments ≈ wall time within 5 ms on CPU) is
arithmetic, not sampling.

Consumers (docs/observability.md "Request attribution"):

- the scheduler attaches each finished request's waterfall to its
  future, and the server returns it in the response under
  ``"timing"``;
- the last ``TDT_ATTRIB_RING`` (default 256) waterfalls sit in a
  process-local ring, queryable via ``{"cmd": "request_stats"}``;
- ``tools/top.py`` renders the freshest entries in its refresh loop,
  and bench.py embeds one sampled waterfall per serving part so
  BENCH_*.json shows where TTFT went.
"""

from __future__ import annotations

import collections
import threading

from triton_dist_tpu_torch.obs import registry as _registry

__all__ = ["DEFAULT_RING", "build", "last", "push", "reset",
           "ring_size"]

DEFAULT_RING = 256

_LOCK = threading.Lock()
_RING: collections.deque | None = None


def ring_size() -> int:
    return _registry.env_int("TDT_ATTRIB_RING", DEFAULT_RING,
                             minimum=1)


def build(*, rid: int, trace_id: str | None, t_submit: float,
          t_admit: float, t_first: float, t_done: float,
          prompt_tokens: int, tokens: int, cached_tokens: int = 0,
          prefill_chunks: int = 0, draft_ms: float = 0.0,
          verify_ms: float = 0.0) -> dict:
    """Waterfall dict from one request's monotonic-clock milestones
    (``time.perf_counter`` readings). The three segments partition
    ``[t_submit, t_done]`` exactly:

    - ``queue_wait_ms`` — submit → admission start;
    - ``prefill_ms`` — admission start → first token sampled (covers
      every chunked-prefill slice, including pump iterations it shared
      with decode steps);
    - ``decode_ms`` — first token → retirement.

    ``draft_ms``/``verify_ms``: speculative-decoding
    sub-attribution of the decode segment — the draft and widened-
    verify wall time of every shared burst this request rode. They
    ride under ``"spec"`` and are NOT part of the exact partition
    (shared-step time is booked to every rider, like ``decode_ms``
    itself); present only when the engine speculated.
    """
    queue_wait = (t_admit - t_submit) * 1e3
    prefill = (t_first - t_admit) * 1e3
    decode = (t_done - t_first) * 1e3
    tpot = decode / (tokens - 1) if tokens > 1 else None
    out = {
        "rid": rid,
        "trace_id": trace_id,
        "total_ms": round((t_done - t_submit) * 1e3, 3),
        "segments": {
            "queue_wait_ms": round(queue_wait, 3),
            "prefill_ms": round(prefill, 3),
            "decode_ms": round(decode, 3),
        },
        "prompt_tokens": int(prompt_tokens),
        "cached_tokens": int(cached_tokens),
        "prefill_chunks": int(prefill_chunks),
        "tokens": int(tokens),
        "tpot_ms": round(tpot, 3) if tpot is not None else None,
    }
    if draft_ms or verify_ms:
        out["spec"] = {"draft_ms": round(draft_ms, 3),
                       "verify_ms": round(verify_ms, 3)}
    return out


def push(record: dict) -> None:
    """Keep ``record`` in the last-K ring (newest last)."""
    global _RING
    with _LOCK:
        if _RING is None:
            _RING = collections.deque(maxlen=ring_size())
        _RING.append(record)


def last(k: int | None = None) -> list[dict]:
    """The newest ``k`` (default: all retained) waterfalls,
    newest first."""
    with _LOCK:
        items = list(_RING) if _RING else []
    items.reverse()
    if k is not None:
        items = items[:max(int(k), 0)]
    return items


def reset() -> None:
    global _RING
    with _LOCK:
        _RING = None
