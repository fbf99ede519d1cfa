"""HTTP serving frontend (counterpart of multimodal_concept_learning_tpu/serve/server.py).

POST /generate   {"prompt": str, "image_b64": <base64 image file>} or
                 {"prompt": str, "image_path": <server-local path>}
                 optional: "max_tokens": N, "stop": str|[str],
                 "stream": true (NDJSON tokens)   -> {"text": str}
GET  /healthz    -> {"ok": true, "draining": false, "requests": N, ...}
GET  /metrics    -> stats + queue depth + sliding-window latency percentiles
                    + http_inflight / draining

SIGTERM drains gracefully: new /generate requests get 503, in-flight ones
finish (up to --drain_grace_s), then the accept loop stops.

The port serves the paged continuous front (serve/paged.py): prefill
attention runs the K1 forward kernel and every decode step the K3 paged
attention kernel on the card.  The other fronts and options of the JAX
server are not ported yet and raise NotImplementedError.

Usage:
  python -m multimodal_concept_learning_tpu_torch.serve.server \
      --results_dir RESULTS --paged [--device cuda] [--port 8077]
      [--batch_size 8] [--max_new_tokens 8] [--page_size 16]
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

_NOT_PORTED = "is not ported to the PyTorch package yet (ROADMAP.md, queue A)"


def build_app(batcher, drain_state=None):
    """A BaseHTTPRequestHandler subclass bound to ``batcher``; ``drain_state``
    ({"draining", "inflight", "lock"}) is shared with :func:`drain`."""
    if drain_state is None:
        drain_state = {"draining": False, "inflight": 0, "lock": threading.Lock()}

    class Handler(BaseHTTPRequestHandler):
        state = drain_state

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": not drain_state["draining"],
                                  "draining": drain_state["draining"], **batcher.stats})
            elif self.path == "/metrics":
                self._reply(200, {**batcher.metrics(),
                                  "http_inflight": drain_state["inflight"],
                                  "draining": drain_state["draining"]})
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._reply(404, {"error": "not found"})
                return
            if drain_state["draining"]:
                self._reply(503, {"error": "server draining (SIGTERM): "
                                           "not accepting new requests"})
                return
            with drain_state["lock"]:
                drain_state["inflight"] += 1
            try:
                self._generate()
            finally:
                with drain_state["lock"]:
                    drain_state["inflight"] -= 1

        def _generate(self):
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                prompt = req["prompt"]
                from PIL import Image  # only the image-decode path needs Pillow

                if "image_b64" in req:
                    img = Image.open(io.BytesIO(base64.b64decode(req["image_b64"])))
                elif "image_path" in req:
                    img = Image.open(req["image_path"])
                else:
                    raise KeyError("image_b64 or image_path required")
                image = batcher.engine.preprocess_image(img)
                if int(req.get("adapter", 0)):
                    raise ValueError("adapter banks " + _NOT_PORTED)
                max_tokens = req.get("max_tokens")
                if max_tokens is not None and int(max_tokens) < 1:
                    raise ValueError("max_tokens must be >= 1")
                stop = req.get("stop")
                if isinstance(stop, str):
                    stop = [stop]
            except Exception as e:  # noqa: BLE001 — malformed request
                self._reply(400, {"error": str(e)})
                return
            if req.get("stream"):
                self._stream(image, prompt, max_tokens, stop)
                return
            try:
                text = batcher.submit(image, prompt, max_tokens=max_tokens, stop=stop)
            except Exception as e:  # noqa: BLE001 — generation failure
                self._reply(500, {"error": str(e)})
                return
            self._reply(200, {"text": text})

        def _stream(self, image, prompt, max_tokens=None, stop=None):
            """NDJSON: one {"token_id": N} line per generated token, then
            {"done": true, "text": ...}; the connection closes at the end."""
            import queue as _queue

            tq: "_queue.Queue" = _queue.Queue()
            holder = {}

            def run():
                try:
                    holder["text"] = batcher.submit(image, prompt, on_token=tq.put,
                                                    max_tokens=max_tokens, stop=stop)
                except Exception as e:  # noqa: BLE001
                    holder["error"] = str(e)
                tq.put(None)

            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.end_headers()
            threading.Thread(target=run, daemon=True).start()
            while True:
                tok = tq.get()
                if tok is None:
                    break
                self.wfile.write((json.dumps({"token_id": int(tok)}) + "\n").encode())
                self.wfile.flush()
            if "error" in holder:
                tail = {"done": True, "error": holder["error"]}
            else:
                tail = {"done": True, "text": holder.get("text", "")}
            self.wfile.write((json.dumps(tail) + "\n").encode())
            self.wfile.flush()

    return Handler


def make_server(results_dir: str, port: int = 8077, host: str = "127.0.0.1",
                checkpoint: str = "best_model.pt", int8: bool = False,
                int8_vision: bool = False, int4: bool = False,
                batch_size: int = 8, max_wait_ms: float = 20.0,
                max_new_tokens: int = 8, max_prompt_len: int = 64,
                temperature: float = 0.0, top_k=None, top_p=None, seed: int = 0,
                continuous: bool = False, steps_per_call: int = 4,
                paged: bool = False, page_size: int = 16,
                num_pages=None, adapters=None, chunked_prefill: int = 0,
                int8_kv: bool = False, num_beams: int = 1,
                length_penalty: float = 0.0, draft_layers: int = 0,
                draft_len: int = 4, device="cuda", dtype: torch.dtype = torch.bfloat16):
    """Build (ThreadingHTTPServer, batcher) for the paged front on
    ``device``; the caller runs serve_forever().  Same signature as the JAX
    ``make_server`` plus ``device``/``dtype``; every mode but ``paged=True``
    raises NotImplementedError.  ``max_wait_ms`` and ``length_penalty``
    belong to unported fronts and are ignored."""
    from multimodal_concept_learning_tpu_torch.serve.continuous import ContinuousBatcher
    from multimodal_concept_learning_tpu_torch.serve.loader import load_trained_mllm
    from multimodal_concept_learning_tpu_torch.serve.paged import PagedContinuousEngine

    unported = {
        "--int8": int8, "--int8_vision": int8_vision, "--int4": int4,
        "--adapters": adapters, "--chunked_prefill": chunked_prefill,
        "--int8_kv": int8_kv, "--num_beams > 1": num_beams > 1,
        "--draft_layers": draft_layers > 0,
    }
    for flag, on in unported.items():
        if on:
            raise NotImplementedError(f"{flag} {_NOT_PORTED}")
    if not paged:
        front = "the dense continuous front" if continuous else "the whole-batch front"
        raise NotImplementedError(f"{front} {_NOT_PORTED}; serve with paged=True (--paged)")

    loaded = load_trained_mllm(results_dir, checkpoint=checkpoint, device=device, dtype=dtype)
    engine = PagedContinuousEngine(
        loaded, num_slots=batch_size, max_new_tokens=max_new_tokens,
        max_prompt_len=max_prompt_len, page_size=page_size, num_pages=num_pages,
        temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
        steps_per_call=steps_per_call)
    batcher = ContinuousBatcher(engine)
    drain_state = {"draining": False, "inflight": 0, "lock": threading.Lock()}
    httpd = ThreadingHTTPServer((host, port), build_app(batcher, drain_state))
    httpd.drain_state = drain_state
    return httpd, batcher


def drain(httpd, grace_s: float = 30.0, poll_s: float = 0.05):
    """Graceful shutdown: flip to draining (new /generate -> 503), wait for
    in-flight requests (``grace_s`` cap), stop the accept loop, then wait
    out handlers accepted just before the flag flipped.  Not callable from
    the thread running ``serve_forever``."""
    state = httpd.drain_state
    state["draining"] = True
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline and state["inflight"] > 0:
        time.sleep(poll_s)
    httpd.shutdown()
    time.sleep(3 * poll_s)
    while time.monotonic() < deadline and state["inflight"] > 0:
        time.sleep(poll_s)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--results_dir", type=str, required=True)
    parser.add_argument("--checkpoint", type=str, default="best_model.pt")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8077)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--max_wait_ms", type=float, default=20.0)
    parser.add_argument("--max_new_tokens", type=int, default=8)
    parser.add_argument("--max_prompt_len", type=int, default=64)
    parser.add_argument("--int8", action="store_true")
    parser.add_argument("--int8_vision", action="store_true")
    parser.add_argument("--int4", action="store_true")
    parser.add_argument("--continuous", action="store_true")
    parser.add_argument("--steps_per_call", type=int, default=4,
                        help="tokens decoded per engine step")
    parser.add_argument("--paged", action="store_true",
                        help="continuous batching over a shared KV page pool "
                             "(the only front the port serves)")
    parser.add_argument("--page_size", type=int, default=16)
    parser.add_argument("--num_pages", type=int, default=None)
    parser.add_argument("--chunked_prefill", type=int, default=0)
    parser.add_argument("--adapters", type=str, default=None)
    parser.add_argument("--int8_kv", action="store_true")
    parser.add_argument("--num_beams", type=int, default=1)
    parser.add_argument("--length_penalty", type=float, default=0.0)
    parser.add_argument("--draft_layers", type=int, default=0)
    parser.add_argument("--draft_len", type=int, default=4)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--top_k", type=int, default=None)
    parser.add_argument("--top_p", type=float, default=None)
    parser.add_argument("--sample_seed", type=int, default=0)
    parser.add_argument("--drain_grace_s", type=float, default=30.0)
    args = parser.parse_args(argv)

    httpd, batcher = make_server(
        args.results_dir, port=args.port, host=args.host, checkpoint=args.checkpoint,
        int8=args.int8, int8_vision=args.int8_vision, int4=args.int4,
        batch_size=args.batch_size, max_wait_ms=args.max_wait_ms,
        max_new_tokens=args.max_new_tokens, max_prompt_len=args.max_prompt_len,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        seed=args.sample_seed, continuous=args.continuous,
        steps_per_call=args.steps_per_call, paged=args.paged, page_size=args.page_size,
        num_pages=args.num_pages,
        adapters=args.adapters.split(",") if args.adapters else None,
        chunked_prefill=args.chunked_prefill, int8_kv=args.int8_kv,
        num_beams=args.num_beams, length_penalty=args.length_penalty,
        draft_layers=args.draft_layers, draft_len=args.draft_len,
        device=args.device, dtype=getattr(torch, args.dtype))
    print(f"Serving on http://{args.host}:{args.port} (paged, batch_size={args.batch_size}, "
          f"device={args.device})")

    import signal

    def on_sigterm(signum, frame):
        print(f"SIGTERM: draining (grace {args.drain_grace_s:.0f}s) ...", flush=True)
        threading.Thread(target=drain, args=(httpd, args.drain_grace_s), daemon=True).start()

    signal.signal(signal.SIGTERM, on_sigterm)
    try:
        httpd.serve_forever()
        if httpd.drain_state["draining"]:
            print("Drained; shutting down.", flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        batcher.shutdown()


if __name__ == "__main__":
    main()
