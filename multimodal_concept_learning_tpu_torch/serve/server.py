"""HTTP serving frontend (counterpart of multimodal_concept_learning_tpu/serve/server.py).

POST /generate   {"prompt": str, "image_b64": <base64 image file>} or
                 {"prompt": str, "image_path": <server-local path>}
                 optional: "max_tokens": N, "stop": str|[str],
                 "adapter": i (multi-LoRA banks: 0 = raw base),
                 "stream": true (NDJSON tokens)   -> {"text": str}
GET  /healthz    -> {"ok": true, "draining": false, "requests": N, ...}
GET  /metrics    -> stats + queue depth + sliding-window latency percentiles
                    + http_inflight / draining

SIGTERM drains gracefully: new /generate requests get 503, in-flight ones
finish (up to --drain_grace_s), then the accept loop stops.

Fronts, chosen as the JAX server chooses them:

- no flag: the whole-batch front (serve/engine.py ``ServingEngine`` +
  ``Batcher``): requests coalesce for up to ``--max_wait_ms`` into one
  fixed-shape batch, generated over dense KV caches; ``--num_beams K``
  runs beam search and ``--draft_layers N`` self-speculative decoding
  there (and only there);
- ``--continuous``: the dense continuous front (serve/continuous.py):
  requests admit into slots and retire one by one, each engine step
  advances every live slot ``--steps_per_call`` tokens;
  ``--chunked_prefill N`` admits prompts in N-token chunks between steps
  (serve/chunked.py);
- ``--paged``: the paged continuous front (serve/paged.py), K3 in every
  decode attention (K4 under ``MCL_PAGED_KERNEL=2``); ``--int8_kv`` stores
  its pool as int8, read through a gather, a dequantize and K1.

Prefill attention runs K1 on the card everywhere, and so does every decode
attention over dense caches.  ``--int4`` serves the LM with int4 weights
(every decode-step projection runs K5), ``--int8`` with int8 weights,
``--int8_vision`` the ViT with int8 weights (combines with either).
A ``language_lora`` results dir is served with its adapter merged into the
base weights.  ``--adapters DIR1,DIR2`` serves a multi-LoRA bank on the
``language_lora`` run of ``--results_dir`` (``serve/loader.load_adapter_bank``:
adapter 0 the raw base, i the i-th dir) through the whole-batch or the
dense continuous front; each request picks its adapter with ``"adapter"``.
Banks take ``--int8`` (the shared base) but not ``--int4`` or ``--paged``.

Usage:
  python -m multimodal_concept_learning_tpu_torch.serve.server \
      --results_dir RESULTS [--device cuda] [--port 8077] [--batch_size 8]
      [--max_new_tokens 8] [--int4 | --int8] [--int8_vision]
      [--num_beams K [--length_penalty A] | --draft_layers N [--draft_len G]]
      [--continuous [--steps_per_call 4] [--chunked_prefill N]]
      [--paged [--page_size 16] [--int8_kv]] [--adapters DIR1,DIR2]
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
                adapter = int(req.get("adapter", 0))
                n_bank = getattr(batcher.engine, "num_adapters", 0)
                if adapter and not 0 <= adapter < max(n_bank, 1):
                    raise ValueError(f"adapter {adapter} out of range (bank size {n_bank})")
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
                self._stream(image, prompt, adapter, max_tokens, stop)
                return
            try:
                text = batcher.submit(image, prompt, adapter=adapter, max_tokens=max_tokens,
                                      stop=stop)
            except Exception as e:  # noqa: BLE001 — generation failure
                self._reply(500, {"error": str(e)})
                return
            self._reply(200, {"text": text})

        def _stream(self, image, prompt, adapter=0, max_tokens=None, stop=None):
            """NDJSON: one {"token_id": N} line per generated token, then
            {"done": true, "text": ...}; the connection closes at the end."""
            import queue as _queue

            tq: "_queue.Queue" = _queue.Queue()
            holder = {}

            def run():
                try:
                    holder["text"] = batcher.submit(image, prompt, on_token=tq.put,
                                                    adapter=adapter, max_tokens=max_tokens,
                                                    stop=stop)
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
    """Build (ThreadingHTTPServer, batcher) on ``device``; the caller runs
    serve_forever().  The JAX ``make_server``'s signature, front selection
    and ValueErrors, plus ``device``/``dtype``.  ``adapters``: results dirs
    of a multi-LoRA bank on ``results_dir``'s base (requests pick one with
    {"adapter": i}, 0 = raw base, i = the i-th dir)."""
    from multimodal_concept_learning_tpu_torch.serve.loader import (
        load_adapter_bank,
        load_trained_mllm,
    )

    if chunked_prefill and (paged or not continuous):
        raise ValueError("--chunked_prefill requires --continuous (and "
                         "excludes --paged: the paged front keeps one-shot "
                         "admission bounded by pool backpressure)")
    if int8_kv and not paged:
        raise ValueError("--int8_kv requires --paged (the dense fronts "
                         "keep full-precision caches)")
    if num_beams > 1 and (continuous or paged):
        raise ValueError("--num_beams > 1 runs on the whole-batch front only "
                         "(beam reorders B*K cache rows each step, which the "
                         "slot-level engines' in-place row ownership excludes)")
    if draft_layers > 0 and (continuous or paged):
        raise ValueError("--draft_layers runs on the whole-batch front only "
                         "(the draft/verify chunk cadence assumes the whole "
                         "batch advances together; slot-level engines admit "
                         "and retire rows mid-chunk)")
    if adapters:
        if paged:
            raise ValueError("multi-LoRA banks exclude --paged "
                             "(serve a merged checkpoint there instead)")
        if int4:
            raise ValueError("multi-LoRA banks support --int8, not --int4 "
                             "(the vmapped bank transform quantizes the "
                             "shared base via ops/quant only)")
        loaded = load_adapter_bank(results_dir, adapters, checkpoint=checkpoint, int8=int8,
                                   int8_vision=int8_vision, device=device, dtype=dtype)
    else:
        loaded = load_trained_mllm(results_dir, checkpoint=checkpoint, int8=int8,
                                   int8_vision=int8_vision, int4=int4, device=device,
                                   dtype=dtype)
    sampler = dict(temperature=temperature, top_k=top_k, top_p=top_p, seed=seed)
    if paged:
        from multimodal_concept_learning_tpu_torch.serve.continuous import ContinuousBatcher
        from multimodal_concept_learning_tpu_torch.serve.paged import PagedContinuousEngine

        engine = PagedContinuousEngine(
            loaded, num_slots=batch_size, max_new_tokens=max_new_tokens,
            max_prompt_len=max_prompt_len, page_size=page_size, num_pages=num_pages,
            steps_per_call=steps_per_call, quant_kv=int8_kv, **sampler)
        batcher = ContinuousBatcher(engine)
    elif continuous:
        from multimodal_concept_learning_tpu_torch.serve.continuous import (
            ContinuousBatcher,
            ContinuousEngine,
        )

        kw = dict(num_slots=batch_size, max_new_tokens=max_new_tokens,
                  max_prompt_len=max_prompt_len, steps_per_call=steps_per_call, **sampler)
        if chunked_prefill:
            from multimodal_concept_learning_tpu_torch.serve.chunked import (
                ChunkedContinuousEngine,
            )

            engine = ChunkedContinuousEngine(loaded, chunk_size=chunked_prefill, **kw)
        else:
            engine = ContinuousEngine(loaded, **kw)
        batcher = ContinuousBatcher(engine)
    else:
        from multimodal_concept_learning_tpu_torch.serve.engine import Batcher, ServingEngine

        engine = ServingEngine(
            loaded, batch_size=batch_size, max_new_tokens=max_new_tokens,
            max_prompt_len=max_prompt_len, num_beams=num_beams,
            length_penalty=length_penalty, draft_layers=draft_layers, draft_len=draft_len,
            **sampler)
        batcher = Batcher(engine, max_wait_ms=max_wait_ms)
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


def front_name(args) -> str:
    """The front ``make_server`` builds for these arguments."""
    if args.paged:
        return "paged"
    if args.continuous:
        return f"chunked prefill {args.chunked_prefill}" if args.chunked_prefill else "continuous"
    if args.num_beams > 1:
        return f"whole-batch, beam search of width {args.num_beams}"
    if args.draft_layers > 0:
        return f"whole-batch, self-speculative with {args.draft_layers} draft layers"
    return "whole-batch"


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
    parser.add_argument("--continuous", action="store_true",
                        help="slot-level continuous batching over dense caches instead of "
                             "whole-batch coalescing")
    parser.add_argument("--steps_per_call", type=int, default=4,
                        help="continuous and paged fronts: tokens decoded per engine step")
    parser.add_argument("--paged", action="store_true",
                        help="continuous batching over a shared KV page pool")
    parser.add_argument("--page_size", type=int, default=16)
    parser.add_argument("--num_pages", type=int, default=None)
    parser.add_argument("--chunked_prefill", type=int, default=0,
                        help="continuous front: admit prompts in N-token chunks between "
                             "decode steps (0 = one-shot admission)")
    parser.add_argument("--adapters", type=str, default=None,
                        help="comma-separated results dirs of a multi-LoRA bank on the "
                             "language_lora base of --results_dir (whole-batch and "
                             "continuous fronts; requests pick {\"adapter\": i}, 0 = base)")
    parser.add_argument("--int8_kv", action="store_true",
                        help="paged front: int8 page pool with per-token scales")
    parser.add_argument("--num_beams", type=int, default=1,
                        help="beam-search width (whole-batch front only)")
    parser.add_argument("--length_penalty", type=float, default=0.0)
    parser.add_argument("--draft_layers", type=int, default=0,
                        help="self-speculative decoding: the draft's depth (whole-batch "
                             "front only; greedy)")
    parser.add_argument("--draft_len", type=int, default=4,
                        help="speculative chunk size g (g-1 proposals a verify)")
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
    quant = "".join(f", {f}" for f, on in (("int8", args.int8), ("int4", args.int4),
                                           ("int8_vision", args.int8_vision),
                                           ("int8_kv", args.int8_kv)) if on)
    if args.adapters:
        quant += f", {batcher.engine.num_adapters} adapters"
    print(f"Serving on http://{args.host}:{args.port} ({front_name(args)}, batch_size="
          f"{args.batch_size}, max_wait_ms={args.max_wait_ms}, device={args.device}{quant})")

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
