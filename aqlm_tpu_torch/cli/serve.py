"""HTTP serving daemon over the continuous-batching engine (PyTorch
counterpart of ``aqlm_tpu.cli.serve``), and ``--device`` (default ``cuda``;
``cpu`` runs the plain versions).

    python -m aqlm_tpu_torch.cli.serve MODEL_DIR --port 8900 --mode int8 --kv_int8

    POST /generate {"prompt_ids": [1, 2, 3], "max_new_tokens": 64, "temperature": 0.7}
      or {"prompt": "...", ...} with a tokenizer in the model directory
    POST /v1/completions  (OpenAI-compatible: "stream": true for SSE, "logprobs")
    GET  /v1/models
    GET  /health

One background thread drives ``Engine.step()`` and is the only one that
touches the model and the card; the HTTP handler threads queue requests
and wait. ``--draft_model`` (``--draft_mode`` defaults to ``--mode``) serves
with speculative decoding: each engine step is one batched draft-and-verify
round of ``--spec_k`` proposals. Not ported: ``--tp > 1`` (ROADMAP A14, with
or without a draft); ``--no_compile_cache`` is accepted and does nothing.
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from aqlm_tpu_torch.cli.common import dtype_from_str, load_tokenizer, resolve_model
from aqlm_tpu_torch.device import resolve_device
from aqlm_tpu_torch.ops.runtime import not_ported
from aqlm_tpu_torch.serve import Engine, SamplingParams, ServeConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model_path")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8900, help="0 picks a free port")
    p.add_argument("--max_batch", type=int, default=4)
    p.add_argument("--max_len", type=int, default=2048)
    p.add_argument("--prefill_buckets", nargs="+", type=int, default=[64, 256, 1024])
    p.add_argument("--kv_int8", action="store_true")
    p.add_argument("--mode", choices=["reference", "codes", "int8", "int4"], default="int8")
    p.add_argument("--dtype", choices=["auto", "float32", "bfloat16"], default="bfloat16")
    p.add_argument("--draft_model", type=str, default=None,
                   help="draft model for speculative decoding (same formats as model_path)")
    p.add_argument("--draft_mode", choices=["reference", "codes", "int8", "int4"], default=None,
                   help="runtime mode of the draft model (defaults to --mode)")
    p.add_argument("--spec_k", type=int, default=4, help="draft tokens proposed per verify")
    p.add_argument("--tp", type=int, default=1, help="tensor parallelism: not ported")
    p.add_argument("--decode_chunk", type=int, default=1,
                   help=">1: up to this many tokens per engine step, one host sync per chunk")
    p.add_argument("--no_compile_cache", action="store_true", help="accepted; nothing to cache")
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    return p


class _Server:
    """One background loop drives ``Engine.step()``; requests queue and wait.

    The loop's thread is the only one that calls the engine, so it alone
    touches the card; ``torch.inference_mode`` is thread-local and is
    entered there."""

    def __init__(self, engine: Engine, tokenizer, model_id: str = "aqlm-tpu"):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_id = model_id
        self._submissions: queue.Queue = queue.Queue()
        self._done: dict[int, dict] = {}
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        with torch.inference_mode():
            while self._running:
                try:
                    while True:
                        prompt, sampling, box = self._submissions.get_nowait()
                        try:
                            rid = self.engine.submit(prompt, sampling)
                        except Exception as e:  # a bad request fails alone
                            box["error"] = e
                            box["finished"].set()
                            if box.get("stream_q") is not None:
                                box["stream_q"].put(None)
                            continue
                        self._done[rid] = box
                except queue.Empty:
                    pass
                if self.engine._active or self.engine._pending:
                    self.engine.step()
                    self._publish()
                else:
                    time.sleep(0.005)

    def _publish(self):
        """Push each request's new tokens to its stream and wake the finished."""
        for rid, box in list(self._done.items()):
            req = self.engine.get_request(rid)
            stream_q = box.get("stream_q")
            if stream_q is not None:
                for t in req.generated[box["pushed"]:]:
                    stream_q.put(int(t))
                box["pushed"] = len(req.generated)
            if req.done:
                box["tokens"] = req.generated
                box["logprobs"] = req.logprobs
                if stream_q is not None:
                    stream_q.put(None)  # end of stream
                box["finished"].set()
                del self._done[rid]

    def generate(self, prompt_ids, sampling: SamplingParams, timeout: float = 600.0):
        box = {"finished": threading.Event()}
        self._submissions.put((prompt_ids, sampling, box))
        if not box["finished"].wait(timeout):
            raise TimeoutError("generation timed out")
        if "error" in box:
            raise box["error"]
        return box["tokens"], box["logprobs"]

    def generate_stream(self, prompt_ids, sampling: SamplingParams, timeout: float = 600.0):
        """Submit and yield tokens as the engine produces them."""
        box = {"finished": threading.Event(), "stream_q": queue.Queue(), "pushed": 0}
        self._submissions.put((prompt_ids, sampling, box))
        while True:
            tok = box["stream_q"].get(timeout=timeout)
            if tok is None:
                if "error" in box:
                    raise box["error"]
                return
            yield tok

    def stop(self, timeout: float = 60.0):
        self._running = False
        self._thread.join(timeout)


def make_handler(server: _Server):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._reply(200, {"status": "ok"})
            elif self.path == "/v1/models":
                self._reply(200, {
                    "object": "list",
                    "data": [{"id": server.model_id, "object": "model", "owned_by": "aqlm_tpu"}],
                })
            else:
                self._reply(404, {"error": "unknown path"})

        def _parse_request(self, req, openai: bool):
            if "prompt_ids" in req:
                ids = np.asarray(req["prompt_ids"], np.int64)
            else:
                if server.tokenizer is None:
                    raise ValueError("text prompts need a tokenizer")
                ids = np.asarray(server.tokenizer(req["prompt"]).input_ids, np.int64)
            max_new = req.get("max_tokens" if openai else "max_new_tokens", 128)
            sampling = SamplingParams(
                temperature=float(req.get("temperature", 0.0)),
                top_p=float(req.get("top_p", 1.0)),
                max_new_tokens=int(max_new),
                eos_token_id=getattr(server.tokenizer, "eos_token_id", None)
                if server.tokenizer else None,
            )
            return ids, sampling

        def _completion_payload(self, tokens, text, logprobs=None, finish="stop"):
            choice = {"index": 0, "text": text, "finish_reason": finish,
                      "token_ids": [int(t) for t in tokens]}
            if logprobs is not None:
                choice["logprobs"] = {"token_logprobs": [round(float(l), 6) for l in logprobs]}
            return {
                "id": "cmpl-aqlm",
                "object": "text_completion",
                "model": server.model_id,
                "choices": [choice],
                "usage": {"completion_tokens": len(tokens)},
            }

        def _stream_completion(self, ids, sampling):
            """OpenAI-style SSE: one chunk per new token, then [DONE]."""
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            sent_text = ""
            tokens = []
            for tok in server.generate_stream(ids, sampling):
                tokens.append(tok)
                if server.tokenizer is not None:
                    full = server.tokenizer.decode(tokens)
                    delta, sent_text = full[len(sent_text):], full
                else:
                    delta = ""
                chunk = {
                    "id": "cmpl-aqlm", "object": "text_completion", "model": server.model_id,
                    "choices": [{"index": 0, "text": delta, "finish_reason": None,
                                 "token_ids": [tok]}],
                }
                self.wfile.write(f"data: {json.dumps(chunk)}\n\n".encode())
                self.wfile.flush()
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()

        def do_POST(self):
            openai = self.path == "/v1/completions"
            if self.path != "/generate" and not openai:
                self._reply(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                ids, sampling = self._parse_request(req, openai)
                if openai and req.get("stream"):
                    self._stream_completion(ids, sampling)
                    return
                tokens, logprobs = server.generate(ids, sampling)
                text = server.tokenizer.decode(tokens) if server.tokenizer is not None else ""
                if openai:
                    self._reply(200, self._completion_payload(
                        tokens, text, logprobs=logprobs if req.get("logprobs") else None))
                else:
                    out = {"tokens": [int(t) for t in tokens]}
                    if server.tokenizer is not None:
                        out["text"] = text
                    self._reply(200, out)
            except Exception as e:  # surface errors to the client
                self._reply(500, {"error": repr(e)})

    return Handler


def make_server(args) -> tuple[ThreadingHTTPServer, _Server]:
    """Load the model, build the engine and its loop, and bind the HTTP
    server (``args.port`` 0 picks a free port: ``httpd.server_address``);
    the caller runs ``httpd.serve_forever()``."""
    if args.tp > 1:
        raise not_ported("tensor-parallel serving (--tp)", "A14")
    dev = resolve_device(args.device)
    params, cfg, _ = resolve_model(args.model_path, dtype=dtype_from_str(args.dtype),
                                   mode=args.mode, device=dev)
    spec_kw = {}
    if args.draft_model is not None:
        dparams, dcfg, _ = resolve_model(args.draft_model, dtype=dtype_from_str(args.dtype),
                                         mode=args.draft_mode or args.mode, device=dev)
        spec_kw = dict(draft_params=dparams, draft_cfg=dcfg, spec_k=args.spec_k)
    engine = Engine(params, cfg, ServeConfig(
        max_batch=args.max_batch, max_len=args.max_len,
        prefill_buckets=tuple(args.prefill_buckets), kv_quantized=args.kv_int8,
        decode_chunk=args.decode_chunk), device=dev, **spec_kw)
    del params, spec_kw
    server = _Server(engine, load_tokenizer(args.model_path),
                     model_id=args.model_path.rstrip("/").split("/")[-1])
    return ThreadingHTTPServer((args.host, args.port), make_handler(server)), server


def main(argv=None):
    args = build_parser().parse_args(argv)
    httpd, server = make_server(args)
    host, port = httpd.server_address[:2]
    print(f"serving on http://{host}:{port} "
          f"(POST /generate, POST /v1/completions, GET /v1/models, GET /health)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.stop()


if __name__ == "__main__":
    main()
