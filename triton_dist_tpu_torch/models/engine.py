"""Inference engine: prefill + eager decode loop (the port of
``triton_dist_tpu.models.engine``).

The JAX engine compiles each step with ``jax.jit``; the port runs each
step eagerly (a CUDA graph of the step is later work, ROADMAP.md Queue A
item 10). The engine families served:

* the default modes, ``prefill_mode="xla_ar"`` (plain products) and
  ``decode_mode="gemm_ar"`` (o_proj and down projection through the
  hand-written ``gemm_ar`` kernel), over contiguous caches;
* the fused TP mode ``"ag_rs"`` (QKV through AG-GEMM, gate/up through
  AG-SwiGLU, o_proj and down through GEMM-RS) and its golden ``"xla"``,
  in either phase beside any other non-sp mode: prefill ``"ag_rs"`` with
  decode ``"gemm_ar"`` is the JAX reference engine, decode ``"ag_rs"``
  fuses the decode too;
* mode ``"sp"`` for both phases (a model built with ``sp_axis=...``,
  its sequence split over the model's ``sp_world`` ranks): prefill
  attention of ``ops.sp_attention`` and decode through the hand-written
  flash-decode kernels, over contiguous caches (optionally prefilled in
  ``prefill_chunk`` slices) or, with ``paged=True``, over a
  ``PagedKVCacheManager`` block pool of one pool per rank with the
  cross-request prefix cache (on by default) and block-granular stream
  admission.

Served: ``serve``, ``serve_ragged`` (not in mode "sp", which is
non-ragged), ``serve_stream`` and :class:`StreamSession`, with chunked
stream admission (:meth:`StreamSession.prefill_step`). The mega and auto
decode paths and speculative decoding raise ``NotImplementedError``
naming their ROADMAP.md item.

Telemetry (``obs``): the JAX engine's counters, histograms, gauges and
spans under its names (``engine.serve_calls``, ``engine.prefill_ms``,
``engine.ttft_ms``, the ``engine.decode_step`` span,
``engine.tokens_generated``, ``engine.tokens_per_s``,
``engine.serve_stream_calls``, ``engine.stream_admissions``, the
``engine.stream_step`` span, the prefix-cache counters). The clocks read
completed device work: with telemetry or tracing on, the engine waits for
its device (``torch.cuda.synchronize``) where JAX blocks until ready;
with both off the decode loop adds no wait and no host work beyond the
counters' no-op calls.

Sampling: greedy is ``argmax``. Temperature sampling draws from a
``torch.Generator`` seeded with ``seed``; its draws differ from
``jax.random`` by design, so the two engines agree on greedy output only.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from triton_dist_tpu_torch import obs
from triton_dist_tpu_torch.models.kv_cache import (
    KVCacheManager, PagedKVCacheManager)
from triton_dist_tpu_torch.obs import trace as _trace


def sample_token(logits: torch.Tensor,
                 generator: torch.Generator | None = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0) -> torch.Tensor:
    """Greedy / temperature / top-k / nucleus sampling.
    logits: (B, V) -> (B,) int64."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    if generator is None:
        raise ValueError("temperature sampling needs a torch.Generator")
    logits = logits / temperature
    if top_k > 0 or top_p < 1.0:
        # ONE descending sort serves both filters.
        v = logits.shape[-1]
        s = torch.sort(logits, dim=-1, descending=True).values
        neg_inf = torch.tensor(-float("inf"), device=logits.device)
        if top_k > 0:
            logits = torch.where(logits < s[:, top_k - 1:top_k], neg_inf,
                                 logits)
            s = torch.where(torch.arange(v, device=s.device)[None, :] < top_k,
                            s, neg_inf)
        if top_p < 1.0:
            # Nucleus over the (top-k-filtered) distribution: keep the
            # smallest sorted prefix whose mass reaches top_p. `<=` keeps
            # the top token even at top_p == 0.
            probs = torch.softmax(s, dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            keep = cum - probs <= top_p
            kept_min = torch.where(keep, s, -neg_inf).min(
                dim=-1, keepdim=True).values
            logits = torch.where(logits >= kept_min, logits, neg_inf)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, {item})")


class Engine:
    """Serve loop around a port ``DenseLLM`` or ``Qwen3MoE``.

    The model's device is the engine's device. Options of the JAX engine
    that the port does not have yet are refused with
    ``NotImplementedError`` rather than ignored."""

    def __init__(self, model, batch: int, max_seq: int,
                 prefill_mode: str = "xla_ar", decode_mode: str = "gemm_ar",
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: int = 0,
                 paged: bool = False, page_size: int = 16,
                 prefill_chunk: int | None = None,
                 use_mega: bool = False, decode_path: str | None = None,
                 prefix_cache: bool | None = None,
                 kv_slots_per_dev: int | None = None, spec=None):
        if use_mega or decode_path not in (None, "plain"):
            raise _unported(f"decode_path={decode_path or 'mega'!r}",
                            "Queue A item 10")
        if spec is not None:
            raise _unported("speculative decoding", "Queue A item 11")
        sp = "sp" in (prefill_mode, decode_mode)
        if sp and not prefill_mode == decode_mode == "sp":
            raise ValueError("mode 'sp' applies to prefill and decode "
                             "together")
        if sp and getattr(model, "sp_axis", None) is None:
            raise ValueError("build the model with sp_axis=... for sp "
                             "serving")
        if paged and not sp:
            raise ValueError("paged serving requires the sp modes")
        if prefill_chunk is not None and (not sp or paged):
            raise ValueError("prefill_chunk applies to the (non-paged) sp "
                             "engine")
        self.model = model
        c = model.config
        self.device = model.device
        self.paged = paged
        # The cross-request prefix cache serves paged stream sessions;
        # on by default there (greedy outputs are identical either way).
        self.prefix_cache = paged and (prefix_cache is None
                                      or bool(prefix_cache))
        self.prefill_chunk = prefill_chunk
        #: Ranks of the sequence axis (sp engines) the caches split over.
        self.sp_world = getattr(model, "sp_world", 1) if sp else 1
        if paged:
            if max_seq % (self.sp_world * page_size):
                raise ValueError(f"max_seq {max_seq} must divide into "
                                 f"{self.sp_world} devices x {page_size}"
                                 f"-token pages")
            # kv_slots_per_dev sizes each device's allocatable pool
            # (default: whole-batch capacity; the sentinel page rides
            # outside it). Smaller pools stream through block-granular
            # admission; serve() still needs whole rows.
            self.kv = PagedKVCacheManager(
                c.num_hidden_layers, batch, page_size,
                max_seq // (self.sp_world * page_size),
                c.num_key_value_heads, c.head_dim, dtype=c.dtype,
                device=self.device, slots_per_dev=kv_slots_per_dev,
                world=self.sp_world)
        else:
            self.kv = KVCacheManager(c.num_hidden_layers, batch, max_seq,
                                     c.num_key_value_heads, c.head_dim,
                                     dtype=c.dtype, device=self.device,
                                     seq_shard=sp,
                                     world=(self.sp_world if sp else
                                            getattr(model, "world", 1)))
        self.prefill_mode = prefill_mode
        self.decode_mode = decode_mode
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return sample_token(logits, self.generator, self.temperature,
                            self.top_k, self.top_p)

    def _wait(self) -> None:
        """Wait for the work queued on the engine's device (telemetry's
        clocks read completed work, not the enqueue)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _stop_set(self, stop_tokens) -> tuple:
        if stop_tokens is None:
            eos = getattr(self.model.config, "eos_token_id", -1)
            return (eos,) if eos >= 0 else ()
        return tuple(int(t) for t in stop_tokens)

    @torch.no_grad()
    def serve(self, params, input_ids, gen_len: int, stop_tokens=None,
              kv_start=None) -> torch.Tensor:
        """Prefill ``input_ids`` (B, S) then generate up to ``gen_len``
        tokens, B <= the engine's batch. Returns (B, S + gen_len) on the
        engine's device.

        ``stop_tokens``: token ids ending a row's generation (default:
        the config's ``eos_token_id`` if set). Stopped rows keep emitting
        their stop token (the output stays a rectangle); the loop exits
        early once every row has stopped."""
        input_ids = torch.as_tensor(input_ids, dtype=torch.int64,
                                    device=self.device)
        b, s = input_ids.shape
        if gen_len <= 0:
            return input_ids
        # Telemetry: ``timed`` gates every clock read and device wait.
        # With telemetry and tracing off the loop's span is a shared
        # no-op and nothing waits.
        tel = obs.enabled()
        tr = _trace.enabled()
        timed = tel or tr
        t_serve0 = time.perf_counter() if timed else 0.0
        obs.counter("engine.serve_calls").inc()
        obs.counter("engine.decode_path.plain").inc()
        stop_tokens = self._stop_set(stop_tokens)
        has_stop = bool(stop_tokens)
        stop = torch.tensor(list(stop_tokens) or [-1], dtype=torch.int64,
                            device=self.device)
        sp = self.prefill_mode == "sp"
        if sp and kv_start is not None and bool(
                torch.as_tensor(kv_start).any()):
            raise ValueError("sp serving is non-ragged")
        kv_start = (torch.zeros((b,), dtype=torch.int64, device=self.device)
                    if kv_start is None else
                    torch.as_tensor(kv_start, dtype=torch.int64,
                                    device=self.device))
        self.kv.reset()
        table = None
        if self.paged:
            # Admission per serve() call: reset the pool (a stream session
            # may have left it block-granular), then reserve this
            # request's whole rows at once (rolled back on exhaustion).
            self.kv.reset_pool()
            self.kv.alloc_many(range(b))
            table = self.kv.block_table()[:, :b]
            caches = self.kv.init()
        else:
            # A request of fewer rows than the engine's batch gets caches
            # of its own row count (the JAX engine raises on such a
            # request).
            caches = self.kv.init(rows=b)
        fwd = dict(block_table=table) if sp else dict(kv_start=kv_start)
        t_pre0 = time.perf_counter() if timed else 0.0
        chunk = self.prefill_chunk
        if chunk and s > chunk:
            # Chunked sp prefill: each slice writes its K/V and attends
            # over the cache filled so far.
            for start in range(0, s, chunk):
                logits, caches = self.model.forward(
                    params, input_ids[:, start:start + chunk], caches,
                    start, mode="sp")
        else:
            logits, caches = self.model.forward(params, input_ids, caches, 0,
                                                mode=self.prefill_mode, **fwd)
        self.kv.inc_offset(s)
        token = self._sample(logits[:, -1])
        if timed:
            self._wait()
            now = time.perf_counter()
            obs.histogram("engine.prefill_ms").observe((now - t_pre0) * 1e3)
            obs.histogram("engine.ttft_ms").observe((now - t_serve0) * 1e3)
            if tr:
                _trace.complete(
                    "engine.prefill", "engine", _trace.perf_to_us(t_pre0),
                    (now - t_pre0) * 1e6,
                    args={"batch": b, "prompt_len": s,
                          "chunked": bool(chunk and s > chunk)})
        done = torch.isin(token, stop) if has_stop else None
        stopped = has_stop and bool(done.all())  # prefill may already stop
        out = [input_ids, token[:, None]]
        n_total = gen_len - 1
        steps_run = 0
        t_dec0 = time.perf_counter() if timed else 0.0
        for i in range(n_total):
            if stopped:
                out.append(token[:, None].expand(b, n_total - i))
                break
            with obs.span("engine.decode_step"):
                logits, caches = self.model.forward(
                    params, token[:, None], caches, self.kv.offset,
                    mode=self.decode_mode, **fwd)
                nxt = self._sample(logits[:, -1])
                if has_stop:
                    nxt = torch.where(done, token, nxt)
                    done = done | torch.isin(nxt, stop)
                token = nxt
                if timed:
                    self._wait()
            steps_run += 1
            self.kv.inc_offset(1)
            out.append(token[:, None])
            # the all-done check is a host sync; amortize it
            if has_stop and i % 8 == 7 and bool(done.all()):
                stopped = True
        if timed:
            self._wait()
            dt = time.perf_counter() - t_dec0
            # Computed tokens only: the first and one a decode step a row.
            obs.counter("engine.tokens_generated").inc(b * (steps_run + 1))
            if steps_run > 0 and dt > 0:
                obs.gauge("engine.tokens_per_s").set(b * steps_run / dt)
            if tr:
                now = time.perf_counter()
                _trace.complete(
                    "engine.serve", "engine", _trace.perf_to_us(t_serve0),
                    (now - t_serve0) * 1e6,
                    args={"batch": b, "prompt_len": s, "gen_len": gen_len,
                          "steps_run": steps_run, "mega": False})
        return torch.cat(out, dim=1)

    def serve_ragged(self, params, prompts, gen_len: int, stop_tokens=None,
                     pad_token: int = 0) -> list:
        """Serve prompts of DIFFERENT lengths in one batch.

        Left-pads to a rectangle; the pad prefix is invisible to attention
        (per-row ``kv_start`` mask) and rope positions count from each
        row's first real token, so under greedy decoding each row equals
        serving its prompt alone. Returns a list of 1-D CPU tensors
        (prompt + generated, pads stripped)."""
        b = len(prompts)
        lens = [len(p) for p in prompts]
        if not b or not all(lens):
            raise ValueError("serve_ragged needs non-empty prompts")
        s = max(lens)
        ids = np.full((b, s), pad_token, np.int64)
        for i, pr in enumerate(prompts):
            ids[i, s - lens[i]:] = np.asarray(pr, np.int64)
        kv_start = [s - n for n in lens]
        out = self.serve(params, ids, gen_len, stop_tokens=stop_tokens,
                         kv_start=kv_start).cpu()
        return [out[i, s - lens[i]:] for i in range(b)]

    # -- continuous batching ----------------------------------------------
    @staticmethod
    def _bucket_len(n: int) -> int:
        b = 8
        while b < n:
            b *= 2
        return b

    def stream_session(self, params) -> "StreamSession":
        """Open an incremental continuous-batching session over this
        engine's decode window (resets the KV cache)."""
        return StreamSession(self, params)

    def serve_stream(self, params, prompts, gen_len: int,
                     stop_tokens=None) -> list:
        """Continuous batching: pump a stream of prompts through the
        fixed ``batch``-row decode window, admitting the next prompt into
        a row the moment its occupant finishes.

        Every row runs at its own cache position: admission resets the
        row's lane (batch-1 prefill written at slot 0, rope and mask from
        the per-row offset), so a freed row is reusable at once. Paged
        engines admit by blocks: the next prompt waits (FIFO) until the
        pool holds its worst-case block demand, and a prompt that could
        never fit the pool is refused up front. Greedy results equal
        serving each prompt alone. Returns prompt + generated token lists
        in input order."""
        obs.counter("engine.serve_stream_calls").inc()
        b = self.kv.batch
        stop_set = set(self._stop_set(stop_tokens))
        if gen_len <= 0:
            return [list(p) for p in prompts]
        n_req = len(prompts)
        if not all(len(p) for p in prompts):
            raise ValueError("prompts must be non-empty")
        if not all(len(p) + gen_len <= self.kv.max_seq for p in prompts):
            raise ValueError("prompt + gen_len must fit max_seq")
        if self.paged:
            bad = [i for i, p in enumerate(prompts)
                   if not self.kv.fits_pool(len(p), gen_len)]
            if bad:
                raise ValueError(f"prompts {bad} can never fit the block "
                                 f"pool ({self.kv.slots_per_dev} slots)")

        sess = self.stream_session(params)
        row_req = [None] * b                 # request id occupying a row
        row_budget = [0] * b                 # tokens left to generate
        results: list = [None] * n_req
        generated: dict = {}
        next_req = 0

        def record(r, tok: int) -> bool:
            """Book one generated token for row r; retire the row when its
            budget is spent or a stop token lands. True if freed."""
            rid = row_req[r]
            generated[rid].append(tok)
            row_budget[r] -= 1
            if row_budget[r] <= 0 or tok in stop_set:
                results[rid] = list(prompts[rid]) + generated.pop(rid)
                row_req[r] = None
                sess.retire_row(r)
                return True
            return False

        def admit_free_rows():
            nonlocal next_req
            for r in range(b):
                while row_req[r] is None and next_req < n_req:
                    if not sess.can_admit(len(prompts[next_req]), gen_len):
                        # Not enough blocks yet: FIFO order holds, the
                        # head re-checks after the next retirement.
                        return
                    rid = next_req
                    next_req += 1
                    first = sess.prefill_into_row(r, prompts[rid],
                                                  gen_budget=gen_len)
                    row_req[r] = rid
                    row_budget[r] = gen_len
                    generated[rid] = []
                    # gen_len == 1 or an immediate stop frees the row
                    # again; the loop then admits the next request.
                    record(r, first)

        admit_free_rows()
        while any(rid is not None for rid in row_req):
            bursts = sess.decode_burst()
            for r in range(b):
                for tok in bursts.get(r, ()):
                    if row_req[r] is None or record(r, int(tok)):
                        break
            admit_free_rows()
        if any(r is None for r in results):
            raise RuntimeError("stream ended with unserved prompts: "
                               "admission stalled with no live rows")
        return results


class StreamSession:
    """Incremental row-level API over an Engine's fixed decode window.

    * :meth:`prefill_into_row` admits a prompt into a free row: the whole
      prompt in one prefill, returning its first token, or (``chunk=N``)
      the first N tokens, the rest advanced by :meth:`prefill_step`
      between decode steps until it returns the first token;
    * :meth:`decode_step` runs ONE shared decode step for every live row
      (frozen rows re-emit their token and do not advance);
    * :meth:`retire_row` frees a finished row for the next admission.

    Paged engines run the pool block-granular: the session starts with
    every row's table lanes on the sentinel page, admission maps cached
    prefix blocks and allocates the rest of the prompt's blocks
    (:meth:`can_admit` says whether the pool can take a request), each
    decode step first grows rows whose next write crosses into a new
    page, and retirement hands the row's blocks back at once. After
    every table change the session re-reads the device table.

    Exactly one thread may drive a session."""

    def __init__(self, engine: Engine, params):
        self.engine = engine
        self.params = params
        b = engine.kv.batch
        dev = engine.device
        engine.kv.reset()
        self.cur_table = None
        if engine.paged:
            engine.kv.stream_setup(prefix_cache=engine.prefix_cache)
            self.cur_table = engine.kv.block_table()
        self.caches = engine.kv.init()
        self.token = torch.zeros((b,), dtype=torch.int64, device=dev)
        self.offsets = torch.zeros((b,), dtype=torch.int64, device=dev)
        self.live = [False] * b
        self._host_off = [0] * b     # host shadow of the per-row offsets
        self._pending: dict = {}     # row -> chunked admission state
        #: Facts about the last admission: the prompt tokens served from
        #: the prefix cache.
        self.admit_info: dict | None = None

    @property
    def batch(self) -> int:
        return self.engine.kv.batch

    def free_rows(self) -> list:
        """Rows with no occupant (neither live nor mid-prefill)."""
        return [r for r in range(self.batch)
                if not self.live[r] and r not in self._pending]

    def can_admit(self, prompt_len: int, gen_len: int,
                  extra=None) -> bool:
        """Block-granular admission control (paged engines): enough free
        or evictable blocks for this request's worst-case demand, net of
        live rows' commitments and of ``extra`` (summed
        :meth:`admission_need` of admissions not yet run). Contiguous
        sessions always admit."""
        if not self.engine.paged:
            return True
        return self.engine.kv.can_admit(prompt_len, gen_len, extra=extra)

    def admission_need(self, prompt_len: int, gen_len: int):
        """Per-device worst-case block demand (the ``extra`` operand of
        :meth:`can_admit`); ``None`` for contiguous sessions."""
        if not self.engine.paged:
            return None
        return self.engine.kv.need_per_dev(prompt_len, gen_len)

    # -- admission ---------------------------------------------------------
    def prefill_into_row(self, row: int, prompt, chunk: int | None = None,
                         gen_budget: int | None = None):
        """Admit ``prompt`` into free row ``row``.

        Whole prompt (``chunk=None``): runs the admission prefill now and
        returns the first sampled token (int). Chunked: runs only the
        first ``chunk``-token slice and returns ``None``; call
        :meth:`prefill_step` (between decode steps) until it returns the
        first token. Chunking applies where the JAX package applies it:
        contiguous caches, a prefill mode other than "sp", a prompt
        longer than the chunk and its padded length (whole chunks)
        within ``max_seq``; other engines admit in one prefill.

        ``gen_budget`` (paged engines): the tokens this request may still
        generate; admission commits that many future blocks so a later
        admission cannot starve the row mid-decode."""
        eng = self.engine
        if self.live[row] or row in self._pending:
            raise ValueError(f"row {row} is occupied")
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("prompts must be non-empty")
        if eng.paged:
            return self._admit_paged(row, prompt, gen_budget)
        if (chunk and eng.prefill_mode != "sp" and len(prompt) > chunk
                and -(-len(prompt) // chunk) * chunk <= eng.kv.max_seq):
            return self._start_chunked(row, prompt, int(chunk))
        return self._admit_whole(row, prompt)

    def _bucket(self, n: int) -> int:
        """The power-of-two prompt bucket rounded up to a multiple of the
        sequence world (the sp prefill splits S over its ranks)."""
        w = self.engine.sp_world
        return -(-self.engine._bucket_len(n) // w) * w

    def _prefill_ids(self, tokens: list, lb: int) -> torch.Tensor:
        """``tokens`` right-padded with 0 to the bucket length ``lb``."""
        return torch.tensor([tokens + [0] * (lb - len(tokens))],
                            dtype=torch.int64, device=self.engine.device)

    @torch.no_grad()
    def _admit_whole(self, row: int, prompt: list) -> int:
        """Prefill the prompt, right-padded to a power-of-two bucket, at
        slot 0 of row ``row``'s lane and sample its first token.

        The JAX engine prefills a zeroed batch-1 scratch cache of the
        bucket's length and copies it into the lane; here the forward
        writes straight into views of the lane's first ``lb`` positions,
        which gives the same K/V and the same attention window. The pad
        suffix is causally invisible to the first token, and its K/V
        slots are overwritten by the row's own decode steps before the
        per-row mask ever exposes them."""
        eng = self.engine
        lb = min(self._bucket(len(prompt)), eng.kv.max_seq)
        lanes = [(ck[row:row + 1, :lb], cv[row:row + 1, :lb])
                 for ck, cv in self.caches]
        logits, _ = eng.model.forward(self.params,
                                      self._prefill_ids(prompt, lb), lanes,
                                      0, mode=eng.prefill_mode)
        first = int(eng._sample(logits[:, len(prompt) - 1])[0])
        self.admit_info = {"cached": 0}
        self._mark_admitted(row, len(prompt), first)
        return first

    def _start_chunked(self, row: int, prompt: list, chunk: int):
        """Start a chunked admission: the prompt right-padded to whole
        chunks, batch-1 scratch caches of that length (zeroed, so the
        decode steps that run between chunks never touch them: a frozen
        row still writes its own lane), then the first chunk."""
        eng = self.engine
        lb = -(-len(prompt) // chunk) * chunk
        self._pending[row] = {
            "ids": self._prefill_ids(prompt, lb), "len": len(prompt),
            "chunk": chunk, "pos": 0,
            "small": [(torch.zeros((1, lb) + ck.shape[2:], dtype=ck.dtype,
                                   device=eng.device),
                       torch.zeros((1, lb) + cv.shape[2:], dtype=cv.dtype,
                                   device=eng.device))
                      for ck, cv in self.caches]}
        return self.prefill_step(row)

    @torch.no_grad()
    def prefill_step(self, row: int):
        """Advance row ``row``'s chunked admission by one slice; returns
        the first sampled token (int) once the last slice lands, else
        ``None``."""
        eng = self.engine
        st = self._pending[row]
        c = st["chunk"]
        logits, _ = eng.model.forward(
            self.params, st["ids"][:, st["pos"]:st["pos"] + c], st["small"],
            st["pos"], mode=eng.prefill_mode)
        st["pos"] += c
        if st["pos"] < st["ids"].shape[1]:
            return None
        # The last slice: sample the first token at the prompt's last
        # position, then copy the scratch prefix into the row's lane at
        # slot 0 (JAX ``_build_admit_finish``). The pad positions' K/V are
        # causally invisible and overwritten by the row's decode steps
        # before any mask exposes them.
        del self._pending[row]
        idx = st["len"] - 1 - (st["pos"] - c)   # last real token's index
        first = int(eng._sample(logits[:, idx])[0])
        lb = st["ids"].shape[1]
        for (ck, cv), (sk, sv) in zip(self.caches, st["small"]):
            ck[row:row + 1, :lb].copy_(sk)
            cv[row:row + 1, :lb].copy_(sv)
        self.admit_info = {"cached": 0}
        self._mark_admitted(row, st["len"], first)
        return first

    def cancel_prefill(self, row: int) -> None:
        """Drop a mid-chunk admission (its scratch caches were never
        copied into the batch, so the session stays consistent)."""
        self._pending.pop(row, None)

    @torch.no_grad()
    def _admit_paged(self, row: int, prompt: list,
                     gen_budget: int | None) -> int:
        """Block-granular paged admission with cross-request prefix
        reuse: map cached prefix blocks into the row's lanes, then run
        only the SUFFIX through the prefill (the whole prompt when the
        cache misses). The cached blocks hold exactly the K/V a cold
        prefill of the same tokens writes; the suffix's attention over
        them rounds differently from a whole-prompt prefill only in
        bf16 (the f32 greedy tokens are the JAX engine's)."""
        eng, kv = self.engine, self.engine.kv
        L = len(prompt)
        # Size the suffix against the pool BEFORE claiming hits: the
        # padded suffix is written at cached + [0, lb) and must not run
        # off max_seq. Fewer hits give a longer suffix but more room;
        # k = 0 (cold, lb clamped to max_seq) always fits.
        hashes = kv.prefix_hashes(prompt)
        k = kv.prefix_probe(prompt, hashes=hashes)
        while k > 0 and (k * kv.page_size
                         + self._bucket(L - k * kv.page_size)
                         > kv.max_seq):
            k -= 1
        cached = kv.admit_row(row, prompt, gen_budget=int(gen_budget or 0),
                              use_hits=k, hashes=hashes)
        suffix = prompt[cached:]
        lb = min(self._bucket(len(suffix)), kv.max_seq - cached)
        try:
            self.cur_table = kv.block_table()
            # Offset 0 is the whole-prompt prefill; a hit's suffix starts
            # at `cached`, the paged chunked-prefill path of forward_sp.
            logits, _ = eng.model.forward(
                self.params, self._prefill_ids(suffix, lb), self.caches,
                cached, mode="sp", block_table=self.cur_table[:, row:row + 1])
            first = int(eng._sample(logits[:, len(suffix) - 1])[0])
        except Exception:
            # The prefill never finished: hand the row's blocks straight
            # back (a stranded allocation is a slow leak).
            kv.release_row(row)
            self.cur_table = kv.block_table()
            raise
        kv.register_prefix(row, prompt, hashes=hashes)
        self._note_prefix(row, L, cached)
        self.admit_info = {"cached": cached}
        self._mark_admitted(row, L, first)
        return first

    def _note_prefix(self, row: int, prompt_len: int, cached: int) -> None:
        """Prefix-cache telemetry for one admission: tokens saved, the
        block-weighted hit rate (from the lifetime counters), and a trace
        instant on the request's timeline."""
        kv = self.engine.kv
        if kv.prefix is None:
            return
        obs.counter("serving.prefill_tokens_saved").inc(cached)
        hits = obs.counter("serving.prefix_hit_blocks")
        hits.inc(cached // kv.page_size)
        lookups = obs.counter("serving.prefix_lookup_blocks")
        lookups.inc(kv.prefix_lookup_blocks(prompt_len))
        if lookups.value > 0:
            obs.gauge("serving.prefix_hit_rate").set(
                round(hits.value / lookups.value, 4))
        if cached:
            _trace.instant("serving.prefix_hit", "serving",
                           args={"row": row, "prompt_len": prompt_len,
                                 "cached_tokens": cached})

    def _mark_admitted(self, row: int, prompt_len: int, first: int) -> None:
        obs.counter("engine.stream_admissions").inc()
        _trace.instant("engine.stream_admission", "engine",
                       args={"row": row, "prompt_len": prompt_len})
        self.offsets[row] = prompt_len
        self._host_off[row] = prompt_len
        self.live[row] = True
        self.token[row] = first

    # -- decode / retire ---------------------------------------------------
    def decode_burst(self) -> dict:
        """One shared decode iteration: ``{row: [tok]}`` for every live
        row (exactly one token each on the plain path)."""
        toks = self.decode_step()
        return {r: [int(toks[r])] for r in range(self.batch)
                if self.live[r]}

    @torch.no_grad()
    def decode_step(self) -> np.ndarray:
        """One shared decode step: every live row decodes at its own
        cache position, frozen rows re-emit their token. Returns the
        (batch,) token vector as numpy."""
        eng = self.engine
        if eng.paged:
            # Grow every live row whose next write position crosses into
            # an unallocated page; its admission committed the block.
            grew = False
            for r in range(self.batch):
                if self.live[r]:
                    grew |= eng.kv.ensure_position(r, self._host_off[r])
            if grew:
                self.cur_table = eng.kv.block_table()
        done = torch.tensor([not alive for alive in self.live],
                            device=eng.device)
        fwd = ({"block_table": self.cur_table} if eng.paged else {})
        with obs.span("engine.stream_step"):
            logits, self.caches = eng.model.forward(
                self.params, self.token[:, None], self.caches, self.offsets,
                mode=eng.decode_mode, **fwd)
            nxt = eng._sample(logits[:, -1])
            self.token = torch.where(done, self.token, nxt)
            self.offsets = torch.where(done, self.offsets, self.offsets + 1)
            if obs.enabled() or _trace.enabled():
                eng._wait()
        for r in range(self.batch):
            if self.live[r]:
                self._host_off[r] += 1
        return self.token.cpu().numpy()

    def retire_row(self, row: int) -> None:
        """Free a finished row; the next admission may reuse its lane.
        Paged engines release its blocks at once: shared prefix blocks
        drop a reference (cached ones stay, evictable), private blocks
        return to the free stack, and the lanes point back at the
        sentinel so the row's frozen writes stay harmless."""
        self.live[row] = False
        if self.engine.paged:
            self.engine.kv.release_row(row)
            self.cur_table = self.engine.kv.block_table()

    def close(self) -> None:
        """Retire every live row, returning its blocks to the pool."""
        for r in range(self.batch):
            if self.live[r]:
                self.retire_row(r)
