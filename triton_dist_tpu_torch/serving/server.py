"""Generation server (the port of ``triton_dist_tpu.serving.server``,
serialized path).

Protocol: newline-delimited JSON over TCP, the same wire format as the
JAX server, so either package's client drives either server::

    -> {"prompt_ids": [[...]], "gen_len": 16, "stop_tokens": [151645]}
    <- {"tokens": [[...]], "gen_len": 16, "latency_ms": 12.3}

``stop_tokens`` is optional (default: the model config's eos). The
reply's ``gen_len`` echoes the EFFECTIVE value: requests past the
protocol cap (4096) or the engine's room (max_seq - longest prompt) are
clamped. Each row's tokens end at, and include, the first stop token.

Whole generations run one at a time under a lock (the JAX server's
``scheduler=False`` path). The continuous-batching scheduler and the
control verbs (metrics, health, drain, ...) are not ported yet
(ROADMAP.md Queue A item 9): a request carrying ``"cmd"`` gets the JAX
server's structured error reply for an unknown command.
"""

from __future__ import annotations

import json
import socketserver
import threading
import time


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        try:
            self._serve_lines()
        except OSError:
            # The peer vanished mid-read: connection-scoped, the server
            # keeps serving every other client.
            return

    def _serve_lines(self):
        for line in self.rfile:
            line = line.strip()
            if not line:
                continue
            # A per-request failure answers THIS request with a
            # structured error and keeps the connection and the server
            # alive.
            try:
                req = json.loads(line)
            except ValueError as e:
                resp = {"error": f"malformed request: {e}",
                        "type": type(e).__name__}
            else:
                try:
                    resp = self.server.model_server._serve_request(req)
                except Exception as e:  # report, keep serving
                    resp = {"error": str(e) or repr(e),
                            "type": type(e).__name__}
            try:
                self.wfile.write((json.dumps(resp) + "\n").encode())
                self.wfile.flush()
            except OSError:
                break


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class ModelServer:
    """Wraps an :class:`~triton_dist_tpu_torch.models.engine.Engine`
    behind the TCP JSON-lines protocol. ``port=0`` binds a free port
    (read it from ``.port``)."""

    def __init__(self, engine, params, host: str = "127.0.0.1",
                 port: int = 0):
        self.engine = engine
        self.params = params
        self._lock = threading.Lock()
        self._srv = _TCPServer((host, port), _Handler)
        self._srv.model_server = self
        self.host, self.port = self._srv.server_address
        self._thread: threading.Thread | None = None

    def _serve_request(self, req: dict) -> dict:
        if not isinstance(req, dict):
            raise ValueError("a request is a JSON object")
        if "cmd" in req:
            return {"error": f"unknown cmd {req['cmd']!r} (this server "
                             f"answers generate requests only; the control "
                             f"verbs are not ported yet)"}
        return self._serve_generate(req)

    def _effective_gen_len(self, req: dict, prompts) -> int:
        """Clamp the requested gen_len to the protocol cap (4096) and the
        engine's room (max_seq - longest prompt)."""
        requested = int(req.get("gen_len", 16))
        room = self.engine.kv.max_seq - max(
            (len(p) for p in prompts), default=0)
        return max(0, min(requested, 4096, room))

    def _serve_generate(self, req: dict) -> dict:
        prompts = req["prompt_ids"]
        gen_len = self._effective_gen_len(req, prompts)
        stop = req.get("stop_tokens")  # None -> engine default (eos)
        lens = [len(p) for p in prompts]
        ragged = len(set(lens)) > 1
        batch = self.engine.kv.batch
        stop_set = set(self.engine._stop_set(stop))

        def trim(row):
            row = list(row)
            for i, t in enumerate(row):
                if t in stop_set:
                    return row[:i + 1]
            return row

        with self._lock:
            t0 = time.perf_counter()
            if len(prompts) > batch:
                # More prompts than decode rows: continuous batching pumps
                # them through the fixed window.
                rows = self.engine.serve_stream(self.params, prompts,
                                                gen_len, stop_tokens=stop)
                tokens = [r[n:] for r, n in zip(rows, lens)]
            elif ragged:
                rows = self.engine.serve_ragged(self.params, prompts,
                                                gen_len, stop_tokens=stop)
                tokens = [r[n:].tolist() for r, n in zip(rows, lens)]
            else:
                out = self.engine.serve(self.params, prompts, gen_len,
                                        stop_tokens=stop)
                tokens = out[:, lens[0] if lens else 0:].tolist()
            ms = (time.perf_counter() - t0) * 1e3
        return {"tokens": [trim(r) for r in tokens], "gen_len": gen_len,
                "latency_ms": round(ms, 3)}

    def start(self):
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)


def preset_config(args, **overrides):
    """The config of ``--preset`` (a tiny dense model when unset), with
    ``overrides`` applied to its fields."""
    from triton_dist_tpu_torch.models import ModelConfig
    from triton_dist_tpu_torch.models import presets

    if args.preset:
        return presets.PRESETS[args.preset](**overrides)
    tiny = dict(num_hidden_layers=2, hidden_size=256, intermediate_size=512,
                num_attention_heads=8, num_key_value_heads=8, head_dim=32,
                vocab_size=1024)
    return ModelConfig(**dict(tiny, **overrides))


def build_model(args, **overrides):
    """(model, params) of the command line: a local HF checkpoint
    (``--model-dir``) or :func:`preset_config` with random weights.
    ``AutoLLM`` builds a ``Qwen3MoE`` for an MoE config and a ``DenseLLM``
    otherwise, over ``--world`` tensor-parallel ranks on the one device
    (JAX's server puts every device on its "tp" axis)."""
    from triton_dist_tpu_torch.models import AutoLLM

    if args.model_dir:
        return AutoLLM.from_pretrained(args.model_dir, device=args.device,
                                       world=args.world)
    model = AutoLLM.build(preset_config(args, **overrides),
                          device=args.device, world=args.world)
    return model, model.init(args.seed)


def parse_args(argv=None):
    import argparse
    from triton_dist_tpu_torch.models import presets

    ap = argparse.ArgumentParser()
    ap.add_argument("--model-dir", default=None,
                    help="HF checkpoint dir (config.json + *.safetensors)")
    ap.add_argument("--preset", default=None, choices=sorted(presets.PRESETS),
                    help="model preset with random weights (a tiny random "
                         "model if neither this nor --model-dir is set)")
    ap.add_argument("--port", type=int, default=8777)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--max-seq", type=int, default=1024)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--world", type=int, default=1,
                    help="tensor-parallel ranks on the one device")
    return ap.parse_args(argv)


def main():  # pragma: no cover - manual demo
    from triton_dist_tpu_torch.models import Engine

    args = parse_args()
    model, params = build_model(args)
    eng = Engine(model, batch=args.batch, max_seq=args.max_seq)
    srv = ModelServer(eng, params, port=args.port).start()
    print(f"serving on {srv.host}:{srv.port}")
    threading.Event().wait()


if __name__ == "__main__":  # pragma: no cover
    main()
