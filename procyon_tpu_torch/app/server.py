"""Dependency-free HTTP serving (stdlib http.server; counterpart of
procyon_tpu/app/server.py).

The endpoint contract of app/main.py's FastAPI variant: POST /retrieve with
{task_desc, disease_desc, instruction_source_dataset, k}; GET /healthz;
plus POST /generate: generation requests from concurrent HTTP clients are
admitted into one inference/serving.ContinuousBatcher (paged pool,
continuous batching) by a single batcher thread, so simultaneous requests
share decode rounds instead of queueing behind each other.

POST /generate {"tokens": [...], "max_new": 32, "eos_id": null}
             -> {"tokens": [...]}   (token-level; tokenize client-side)

/generate answers 503 only when `serve` was given no GenerationService; as
in the reference, `main()` builds none: a caller passes one
(`serve(service, port, gen=GenerationService(batcher))`).

Handler threads share one model on one device; a lock lets one /retrieve
request at a time into the forward pass, and the batcher is touched only by
its batcher thread.

Run: python -m procyon_tpu_torch.app.server [--port 8000] [--synthetic]
"""

import argparse
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from procyon_tpu_torch.inference.retrieval_service import RetrievalService


class GenerationService:
    """Thread-safe facade over ContinuousBatcher for HTTP handlers: each
    request thread submits and blocks on its own event; one thread ticks
    the batcher whenever work exists (requests arriving between ticks join
    the next round)."""

    def __init__(self, batcher):
        self.batcher = batcher
        self._cv = threading.Condition()
        self._events = {}
        self._results = {}
        self._error = None
        self._thread = threading.Thread(target=self._drive, daemon=True)
        self._thread.start()

    def generate(self, prompt, max_new=32, eos_id=None, timeout=300.0):
        # the batcher refuses such a request at admission, inside its
        # thread's tick; refused here, it costs the other requests nothing
        need, most = len(prompt) + max_new, self.batcher.pcfg.max_ctx
        if need > most:
            raise ValueError(f"the request needs {need} tokens > max_ctx "
                             f"{most}")
        with self._cv:
            if self._error is not None:
                raise RuntimeError(f"the batcher thread stopped: "
                                   f"{self._error!r}")
            rid = self.batcher.submit(list(prompt), max_new=max_new,
                                      eos_id=eos_id)
            ev = self._events[rid] = threading.Event()
            self._cv.notify()
        if not ev.wait(timeout):
            raise TimeoutError(f"request {rid} timed out")
        with self._cv:
            if rid not in self._results:
                raise RuntimeError(f"the batcher thread stopped: "
                                   f"{self._error!r}")
            return self._results.pop(rid)

    def _drive(self):
        try:
            while True:
                with self._cv:
                    while not (self.batcher.queue or self.batcher.live
                               or self.batcher._inflight):
                        self._cv.wait()
                    self.batcher.tick()
                    for rid in list(self.batcher.done):
                        ev = self._events.pop(rid, None)
                        if ev is not None:
                            self._results[rid] = self.batcher.done.pop(rid)
                            ev.set()
        except Exception as e:
            # a batcher that raised cannot be driven on: wake every waiter
            # with the error instead of letting it run into its timeout
            with self._cv:
                self._error = e
                for ev in self._events.values():
                    ev.set()
                self._events.clear()
            raise


def make_handler(service: Optional[RetrievalService],
                 gen: Optional[GenerationService] = None):
    model_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path == "/generate":
                self._generate()
                return
            if self.path != "/retrieve":
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError):
                self._json(400, {"error": "invalid JSON body"})
                return
            if not isinstance(req, dict):
                self._json(400, {"error": "the body must be a JSON object"})
                return
            disease_desc = req.get("disease_desc")
            if not disease_desc or not isinstance(disease_desc, str):
                self._json(422, {"error": "disease_desc is required"})
                return
            source = req.get("instruction_source_dataset", "disgenet")
            if source not in ("disgenet", "omim"):
                self._json(422, {"error": "instruction_source_dataset must "
                                          "be disgenet or omim"})
                return
            try:
                k = int(req.get("k", 10))
            except (TypeError, ValueError):
                self._json(422, {"error": "k must be an integer"})
                return
            try:
                with model_lock:
                    results = service.retrieve(
                        task_id=f"{source}_all_retrieval",
                        disease_desc=disease_desc, k=k)
            except Exception as e:  # surface model errors as 500s
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._json(200, {"results": results})

        def _generate(self):
            if gen is None:
                self._json(503, {"error": "no generation service was "
                                          "passed to serve() "
                                          "(retrieval-only)"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError):
                self._json(400, {"error": "invalid JSON body"})
                return
            if not isinstance(req, dict):
                self._json(400, {"error": "the body must be a JSON object"})
                return
            tokens = req.get("tokens")
            if not isinstance(tokens, list) or not tokens:
                self._json(422, {"error": "tokens (non-empty int list) "
                                          "is required"})
                return
            try:
                prompt = [int(t) for t in tokens]
                max_new = int(req.get("max_new", 32))
                eos_id = (None if req.get("eos_id") is None
                          else int(req["eos_id"]))
            except (TypeError, ValueError):
                self._json(422, {"error": "tokens, max_new and eos_id must "
                                          "be integers"})
                return
            try:
                out = gen.generate(prompt, max_new=max_new, eos_id=eos_id)
            except Exception as e:  # surface model errors as 500s
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._json(200, {"tokens": [int(t) for t in out]})

        def log_message(self, fmt, *args):
            pass

    return Handler


def serve(service: Optional[RetrievalService], port: int = 8000, *,
          gen: Optional[GenerationService] = None, host: str = "0.0.0.0",
          background: bool = False) -> Optional[ThreadingHTTPServer]:
    """Serve until interrupted, or with background=True start a daemon
    thread and return the server (stop it with shutdown() and
    server_close()). port 0 takes a free port (server_address[1]). `gen`
    answers POST /generate; without it that path answers 503."""
    httpd = ThreadingHTTPServer((host, port), make_handler(service, gen))
    if background:
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        return httpd
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
    return None


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="the device the model runs on; there is no "
                        "fallback to the CPU")
    args = p.parse_args(argv)
    if args.synthetic:
        os.environ["PROCYON_SYNTHETIC"] = "1"
    from procyon_tpu_torch.app.main import _build_service

    service = _build_service(device=args.device)
    print(f"serving on :{args.port} ({service.device})")
    serve(service, args.port)


if __name__ == "__main__":
    main()
