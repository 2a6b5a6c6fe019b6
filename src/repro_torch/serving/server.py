"""Stdlib-only HTTP frontend over the port's incremental serving engines,
a copy of the JAX package's ``serving/server.py`` over
``repro_torch.serving.api`` (the port imports nothing of that package).

Endpoints (OpenAI-completions-shaped, token ids in place of text — this
repo has no tokenizer):

- ``POST /v1/completions`` — body::

      {"prompt": [int, ...],          # exactly engine prompt_len ids
       "max_tokens": int | null,
       "temperature": float | null,   # null -> ServeConfig default
       "conf_threshold": float | null,
       "seed": int | null,
       "eos_token_id": int | null,
       "stream": bool}

  Non-streaming responses carry the generated span (trimmed to
  ``gen_length``) in ``choices[0].token_ids``. With ``"stream": true``
  the response is Server-Sent Events: one ``data: {...}`` chunk per
  finalized *block* — CDLM's block-causal finalization commits a block
  exactly once, so each SSE chunk is final the moment it is sent — and a
  terminating ``data: [DONE]``. Streamed chunks concatenate to the exact
  non-streamed ``token_ids``.

- ``GET /healthz`` — liveness (``{"status": "ok"}``).

- ``GET /metrics`` — Prometheus text exposition surfacing the engine's
  ``page_pool_stats()`` / ``concurrency_stats()`` plus request counters,
  and, for the continuous engine, ``phase_stats()``: the host's seconds
  and entries in each phase of ``step()`` since the engine's last reset,
  as ``cdlm_engine_phase_seconds_total{phase="engine.sync"}`` and
  ``cdlm_engine_phase_total{phase="engine.sync"}`` (the phases are
  ``ContinuousEngine.phase_stats``'s). These need no profiler: a rate of
  ``engine.sync`` seconds near that of ``engine.step`` says the host
  mostly waits for the device, a low one that the host sets the pace.
  A continuous engine serving a "grouped" MoE config adds
  ``cdlm_moe_pairs_total`` and ``cdlm_moe_rows_padded_total``
  (``ContinuousEngine.moe_stats``: the routed pairs and the rows the expert
  products computed for them; a read of the device-side tally, which waits
  for the step in flight).

A single scheduler thread owns the engine (the engines are not
thread-safe): HTTP handlers enqueue requests through
``engine.add_request`` under a lock and block on a per-request event
queue; the scheduler drains ``engine.step()`` and routes each
:class:`BlockEvent` to its request's queue. Mid-stream client
disconnects abort the request (``engine.abort``), freeing its lane/pages
without perturbing other lanes (non-streamed disconnects are only
detectable at response-write time, after the decode finished). If
``step()`` ever raises, the driver fails every pending request, stops,
and ``/healthz`` turns 500 with the error — requests never hang on a
silently dead scheduler.
"""
from __future__ import annotations

import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict

import numpy as np

from repro_torch.serving.api import GenerationRequest, SamplingParams


class EngineDriver:
    """Single-threaded owner of an engine, fed by HTTP handler threads.

    ``submit``/``abort`` serialize with ``step()`` under ``cond`` (the
    engines are not thread-safe); a submission arriving mid-step therefore
    waits for the step to finish — which costs it nothing, since a request
    can only be admitted at the next block boundary anyway. ``metrics()``
    and ``/healthz`` read lock-free snapshots so observability stays
    responsive during long decode steps."""

    def __init__(self, engine):
        self.engine = engine
        self.cond = threading.Condition()
        self._queues: Dict[int, "queue.Queue"] = {}
        self._stop = False
        self.last_error: str = ""
        self.requests_total = 0
        self.completed_total = 0
        self.aborted_total = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="engine-driver")
        self._thread.start()

    @property
    def healthy(self) -> bool:
        return not self._stop and self._thread.is_alive()

    def submit(self, prompt, params: SamplingParams):
        """Enqueue one request; returns ``(request_id, event_queue)``. The
        queue yields :class:`BlockEvent` items and a final ``None``."""
        with self.cond:
            if self._stop:
                raise RuntimeError(
                    f"engine driver stopped: {self.last_error or 'shutdown'}")
            rid = self.engine.add_request(
                GenerationRequest(prompt=prompt, params=params))
            q: "queue.Queue" = queue.Queue()
            self._queues[rid] = q
            self.requests_total += 1
            self.cond.notify()
        return rid, q

    def abort(self, request_id: int) -> bool:
        with self.cond:
            found = self.engine.abort(request_id)
            # only detach the event queue when the engine really dropped
            # the request; a static-scheduler request already inside the
            # running chunk will still finish and must reach
            # completed_total (nobody reads its events — that's fine)
            q = self._queues.pop(request_id, None) if found else None
            if found:
                self.aborted_total += 1
        if q is not None:
            q.put(None)
        return found

    def metrics(self) -> str:
        # lock-free snapshot: counters are GIL-atomic int reads and the
        # stats methods read host-side counters (moe_stats the device-side
        # tally, which waits for the work queued before it), so /metrics
        # never takes the scheduler lock a decode step holds
        eng = self.engine
        lines = [
            "# TYPE cdlm_requests_total counter",
            f"cdlm_requests_total {self.requests_total}",
            "# TYPE cdlm_requests_completed_total counter",
            f"cdlm_requests_completed_total {self.completed_total}",
            "# TYPE cdlm_requests_aborted_total counter",
            f"cdlm_requests_aborted_total {self.aborted_total}",
            "# TYPE cdlm_requests_active gauge",
            f"cdlm_requests_active {len(self._queues)}",
        ]
        for src, prefix in ((getattr(eng, "page_pool_stats", None),
                             "cdlm_page_pool"),
                            (getattr(eng, "concurrency_stats", None),
                             "cdlm_lanes")):
            if src is None:
                continue
            for k, v in src().items():
                lines.append(f"# TYPE {prefix}_{k} gauge")
                lines.append(f"{prefix}_{k} {v}")
        phases = getattr(eng, "phase_stats", None)
        if phases is not None:
            stats = phases()
            for metric, key in (("cdlm_engine_phase_seconds_total",
                                 "seconds"),
                                ("cdlm_engine_phase_total", "count")):
                lines.append(f"# TYPE {metric} counter")
                lines += [f'{metric}{{phase="{name}"}} {s[key]}'
                          for name, s in stats.items()]
        moe = getattr(eng, "moe_stats", lambda: {})()
        for key in ("pairs_total", "rows_padded_total"):
            if key in moe:
                lines.append(f"# TYPE cdlm_moe_{key} counter")
                lines.append(f"cdlm_moe_{key} {moe[key]}")
        return "\n".join(lines) + "\n"

    def shutdown(self):
        with self.cond:
            self._stop = True
            self.cond.notify()
        self._thread.join(timeout=5)

    def _loop(self):
        while True:
            with self.cond:
                while not self._stop and not self.engine.has_unfinished():
                    self.cond.wait(timeout=0.5)
                if self._stop:
                    return
                try:
                    events = self.engine.step()
                except Exception as e:  # noqa: BLE001 — fail pending
                    # requests loudly instead of hanging them on a dead
                    # scheduler thread; /healthz turns 500
                    self.last_error = f"{type(e).__name__}: {e}"
                    self._stop = True
                    dead = list(self._queues.values())
                    self._queues.clear()
                    for q in dead:
                        q.put(None)
                    return
                routes = []
                for ev in events:
                    q = self._queues.get(ev.request_id)
                    if q is None:
                        continue  # aborted between steps
                    routes.append((q, ev))
                    if ev.finished:
                        self._queues.pop(ev.request_id, None)
                        self.completed_total += 1
            for q, ev in routes:
                q.put(ev)
                if ev.finished:
                    q.put(None)


def _params_from_body(body: dict) -> SamplingParams:
    def opt(key, cast):
        v = body.get(key)
        return None if v is None else cast(v)

    return SamplingParams(
        temperature=opt("temperature", float),
        conf_threshold=opt("conf_threshold", float),
        max_tokens=opt("max_tokens", int),
        seed=opt("seed", int),
        eos_token_id=opt("eos_token_id", int))


class CompletionsHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    # quiet the default per-request stderr logging
    def log_message(self, fmt, *args):
        pass

    @property
    def driver(self) -> EngineDriver:
        return self.server.driver

    def _json(self, code: int, payload: dict):
        data = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path == "/healthz":
            if self.driver.healthy:
                self._json(200, {"status": "ok"})
            else:
                self._json(500, {"status": "error",
                                 "error": self.driver.last_error})
        elif self.path == "/metrics":
            data = self.driver.metrics().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        else:
            self._json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        if self.path != "/v1/completions":
            self._json(404, {"error": f"unknown path {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            prompt = np.asarray(body["prompt"], np.int32)
            if prompt.ndim != 1:
                raise ValueError("prompt must be a flat list of token ids")
            params = _params_from_body(body)
        except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
            self._json(400, {"error": str(e)})
            return
        try:
            rid, events = self.driver.submit(prompt, params)
        except ValueError as e:  # e.g. wrong prompt length
            self._json(400, {"error": str(e)})
            return
        except RuntimeError as e:  # driver stopped after a step() failure
            self._json(503, {"error": str(e)})
            return
        if body.get("stream"):
            self._stream_response(rid, events)
        else:
            self._full_response(rid, events)

    # -- response bodies ----------------------------------------------------
    def _drain(self, events):
        """Wait out this request's block events; returns its final output
        (None if the request was aborted server-side)."""
        output = None
        while True:
            ev = events.get()
            if ev is None:
                return output
            if ev.finished:
                output = ev.output

    def _choice(self, output, token_ids):
        return {"index": 0, "token_ids": token_ids,
                "finish_reason": output.finish_reason if output else None}

    def _full_response(self, rid, events):
        output = self._drain(events)
        try:
            if output is None:  # aborted / driver failed server-side
                self._json(503, {"error": "request aborted"})
                return
            ids = np.asarray(output.tokens)[:output.gen_length].tolist()
            self._json(200, {
                "id": f"cmpl-{rid}",
                "object": "text_completion",
                "choices": [self._choice(output, ids)],
                "usage": {"prompt_tokens": self.server.prompt_len,
                          "completion_tokens": output.gen_length,
                          "steps": output.steps},
            })
        except (BrokenPipeError, ConnectionResetError):
            pass  # client left; the decode already completed

    def _stream_response(self, rid, events):
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        sent = 0
        completed = False
        try:
            while True:
                ev = events.get()
                if ev is None:
                    break
                if ev.finished:
                    completed = True
                if ev.finished and ev.output is not None:
                    # trim the final block to gen_length; earlier blocks
                    # are always fully inside the generated span
                    take = max(0, ev.output.gen_length - sent)
                else:
                    take = len(ev.tokens)
                chunk = np.asarray(ev.tokens)[:take].tolist()
                sent += len(chunk)
                payload = {
                    "id": f"cmpl-{rid}",
                    "object": "text_completion.chunk",
                    "choices": [{
                        "index": 0, "token_ids": chunk, "block": ev.index,
                        "finish_reason": (ev.output.finish_reason
                                          if ev.finished and ev.output
                                          else None)}],
                }
                self.wfile.write(
                    f"data: {json.dumps(payload)}\n\n".encode())
                self.wfile.flush()
            if completed:
                self.wfile.write(b"data: [DONE]\n\n")
            else:
                # aborted server-side / driver died: make the truncation
                # visible instead of ending the stream like a success
                self.wfile.write(
                    b'data: {"error": "request aborted"}\n\n')
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            # client went away mid-stream: free the lane/pages
            self.driver.abort(rid)


class CompletionsServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 8000):
        self.driver = EngineDriver(engine)
        self.prompt_len = engine.spec.prompt_len
        super().__init__((host, port), CompletionsHandler)

    def shutdown(self):
        super().shutdown()
        self.driver.shutdown()


def serve_http(engine, host: str = "127.0.0.1", port: int = 8000,
               *, block: bool = True) -> CompletionsServer:
    """Boot the HTTP frontend over ``engine``. ``port=0`` binds an
    ephemeral port (read it back from ``server.server_address``). With
    ``block=False`` the server runs on a daemon thread and is returned
    immediately (tests / smoke drivers)."""
    server = CompletionsServer(engine, host, port)
    if block:
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.shutdown()
        return server
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="http-server").start()
    return server
