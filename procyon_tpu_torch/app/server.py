"""Dependency-free HTTP serving (stdlib http.server; counterpart of
procyon_tpu/app/server.py).

The endpoint contract of app/main.py's FastAPI variant: POST /retrieve with
{task_desc, disease_desc, instruction_source_dataset, k}; GET /healthz.
POST /generate answers 503: the continuous batcher behind it is not ported
yet (ROADMAP.md, queue 1, the serving slice), and the reference answers the
same without a batcher.

Handler threads share one model on one device; a lock lets one request at a
time into the forward pass.

Run: python -m procyon_tpu_torch.app.server [--port 8000] [--synthetic]
"""

import argparse
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from procyon_tpu_torch.inference.retrieval_service import RetrievalService


def make_handler(service: RetrievalService):
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
                self._json(503, {"error": "generation service not "
                                          "configured (retrieval-only)"})
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

        def log_message(self, fmt, *args):
            pass

    return Handler


def serve(service: RetrievalService, port: int = 8000, *,
          host: str = "0.0.0.0",
          background: bool = False) -> Optional[ThreadingHTTPServer]:
    """Serve until interrupted, or with background=True start a daemon
    thread and return the server (stop it with shutdown() and
    server_close()). port 0 takes a free port (server_address[1])."""
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
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
