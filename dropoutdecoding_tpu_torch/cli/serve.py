"""HTTP captioning service over the continuous-batching ``DecodeServer``;
port of ``dropoutdecoding_tpu/cli/serve.py``.

POST an image path, get a Dropout Decoding caption; concurrent requests
share decode steps through ``engine/serving.DecodeServer``.

  python -m dropoutdecoding_tpu_torch.cli.serve \\
      --model-path /ckpts/llava-1.5-7b-hf --port 8000 [--fused-step True]

  curl -X POST localhost:8000/caption -d '{"image_path": "/data/img.jpg"}'

``/caption`` answers {"caption": ...}; ``/caption_stream`` sends the
caption as server-sent events, one ``data:`` line of {"delta": ...} a step
chunk, then ``data: [DONE]``; ``GET /stats`` gives the counters.  Standard
library only (``http.server`` and threads): handlers queue requests, and
one worker thread owns the card, submitting into free slots and stepping
the server until requests finish.

The engine comes from the CHAIR CLI's ``make_engine`` (its
``build_engine``); the parser is the JAX CLI's, flag for flag.  LLaVA-1.5
and LLaVA-NeXT serve; InstructBLIP exits with the JAX CLI's message.  As in
the JAX CLI, the server runs the engine's decode step whatever the arm
flags say: ``--vcd``, ``--opera`` and ``--num-beams`` parse, and decode as
``--original`` does.
"""
from __future__ import annotations

import argparse
import json
import queue
import threading
import time
import uuid
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

NO_INSTRUCTBLIP = (  # the JAX CLI's exit, word for word
    "serving supports llava-1.5 and llava-next (InstructBLIP's "
    "question-dependent visual tokens make per-request prompts "
    "incompatible with the shared caption template)"
)


class CaptionService:
    def __init__(self, engine, processor, model: str, n_slots: int = 8,
                 step_chunk: int = 8, chunked_prefill: int | None = None,
                 batched_submit: bool = False):
        from ..engine.serving import DecodeServer

        self.engine = engine
        self.processor = processor
        self.model = model
        self.step_chunk = max(int(step_chunk), 1)
        # chunked_prefill = C: joining requests prefill in C-token pieces with
        # decode steps pumped between them (DecodeServer.submit_chunked)
        self.chunked_prefill = chunked_prefill
        # batched_submit: plain same-budget LLaVA-1.5 groups take one batched
        # prefill (DecodeServer.submit_many); opt-in, as in the JAX CLI
        self.batched_submit = batched_submit
        self.server = DecodeServer(engine=engine, n_slots=n_slots)
        self.inbox: "queue.Queue" = queue.Queue()
        self.events: dict = {}
        self.results: dict = {}
        self.streams: dict = {}  # rid -> queue of text deltas (SSE)
        self._sent: dict = {}  # rid -> tokens already streamed
        self._t0 = time.time()
        self._done = 0
        self._tokens_out = 0
        self._starts: dict = {}  # rid -> when the worker took it
        self._lat = deque(maxlen=512)  # recent request latencies (s)
        self._stop = threading.Event()
        self.worker = threading.Thread(target=self._loop, daemon=True)
        self.worker.start()

    def close(self, timeout: float = 10.0) -> None:
        """Stop the worker thread (it ends within its 0.5 s poll)."""
        self._stop.set()
        self.worker.join(timeout)

    def caption(self, image, prompt: str, timeout: float = 300.0,
                max_new_tokens: int | None = None) -> str:
        rid = uuid.uuid4().hex
        ev = threading.Event()
        self.events[rid] = ev
        self.inbox.put((rid, image, prompt, max_new_tokens))
        if not ev.wait(timeout):
            raise TimeoutError(rid)
        tokens = self.results.pop(rid)
        self.events.pop(rid, None)
        if isinstance(tokens, Exception):
            raise tokens
        return self.processor.decode(tokens).strip()

    def caption_stream(self, image, prompt: str, timeout: float = 300.0,
                       max_new_tokens: int | None = None):
        """Generator of text deltas as the request decodes (one a step
        chunk): the worker publishes new tokens after every ``step``."""
        rid = uuid.uuid4().hex
        q: "queue.Queue" = queue.Queue()
        self.streams[rid] = q
        self.inbox.put((rid, image, prompt, max_new_tokens))
        try:
            while True:
                item = q.get(timeout=timeout)
                if item is None:  # request finished
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            self.streams.pop(rid, None)
            self._sent.pop(rid, None)

    def stats(self) -> dict:
        el = max(time.time() - self._t0, 1e-9)
        lat = sorted(self._lat)

        def pct(p):
            return round(lat[int(p * (len(lat) - 1))], 3) if lat else None

        return {
            "active_slots": self.server.active(),
            "n_slots": self.server.n_slots,
            "pending": self.inbox.qsize(),
            "requests_done": self._done,
            "tokens_generated": self._tokens_out,
            "uptime_s": round(el, 1),
            "requests_per_s": round(self._done / el, 3),
            "tokens_per_s": round(self._tokens_out / el, 2),
            "latency_p50_s": pct(0.5),
            "latency_p95_s": pct(0.95),
        }

    def _publish_stream_deltas(self):
        """Push the newly decoded tokens of streaming requests (one host
        read of the slots' steps and buffers a loop iteration), up to each
        request's budget: a row goes on decoding past it until its harvest,
        and the JAX service streams those tokens too."""
        live = [(slot, rid) for slot, rid in enumerate(self.server._requests)
                if rid in self.streams]
        if not live:
            return
        steps = self.server._carry["steps"].tolist()
        bufs = self.server._carry["tokens_buf"].cpu().numpy()
        for slot, rid in live:
            q = self.streams.get(rid)
            if q is None:
                continue
            n, sent = min(steps[slot], self.server._budgets[slot]), self._sent.get(rid, 0)
            if n > sent:
                text = self.processor.decode(bufs[slot][sent:n])
                self._sent[rid] = n
                if text:
                    q.put(text)

    def _prefill_args(self, image, prompt):
        if self.model == "llava-next":
            from .chair_test import next_image_prep

            tiles, orig = next_image_prep(self.engine)(image)
            return self.processor(prompt)["input_ids"], tiles, orig
        inputs = self.processor(prompt, image)
        return inputs["input_ids"], inputs["pixel_values"]

    def _submit(self, rid, args, max_new):
        if self.chunked_prefill and self.model in ("llava-1.5", "llava-next"):
            self.server.submit_chunked(
                rid, *args, chunk=self.chunked_prefill,
                pump_steps=self.step_chunk, max_new_tokens=max_new,
            )
        else:
            self.server.submit(rid, *args, max_new_tokens=max_new)

    def _deliver(self, rid, result) -> None:
        """``result`` (the tokens, or a submit's error) to the caller of
        ``rid``: ``caption``'s event or ``caption_stream``'s queue."""
        if rid in self.events:
            self.results[rid] = result
            self.events[rid].set()
        sq = self.streams.get(rid)
        if sq is None:
            return
        if isinstance(result, Exception):
            sq.put(result)
            return
        sent = self._sent.get(rid, 0)  # the tail the last publish missed
        if len(result) > sent:
            sq.put(self.processor.decode(result[sent:]))
        sq.put(None)

    def _finish(self, rid, tokens) -> None:
        self._done += 1
        self._tokens_out += len(tokens)
        t0 = self._starts.pop(rid, None)
        if t0 is not None:
            self._lat.append(time.time() - t0)
        self._deliver(rid, tokens)

    def _loop(self):
        pending = []
        while not self._stop.is_set():
            # pick up new requests (block only when idle)
            block = not pending and self.server.active() == 0
            try:
                while True:
                    pending.append(self.inbox.get(block=block, timeout=0.5))
                    block = False
            except queue.Empty:
                pass
            free = self.server.free_slots()
            if pending and free:
                # the waiting requests join decode on step_chunk boundaries
                take = [pending.pop(0) for _ in range(min(len(free), len(pending)))]
                items = []
                for rid, image, prompt, max_new in take:
                    self._starts[rid] = time.time()
                    items.append((rid, self._prefill_args(image, prompt), max_new))
                plain = (
                    self.batched_submit
                    and self.model == "llava-1.5"
                    and not self.chunked_prefill
                    and all(m is None for _, _, m in items)
                )
                if plain:
                    self.server.submit_many([(r, a) for r, a, _ in items])
                else:
                    for rid, args, max_new in items:
                        try:
                            self._submit(rid, args, max_new)
                        except ValueError as err:  # a budget or the capacity guard
                            self._starts.pop(rid, None)
                            self._deliver(rid, err)
            if self.server.active():
                # one host round trip every step_chunk decode steps
                self.server.step(self.step_chunk)
                self._publish_stream_deltas()
                for rid, tokens in self.server.harvest().items():
                    self._finish(rid, tokens)


def make_handler(service: CaptionService, default_prompt: str):
    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path != "/stats":
                self.send_error(404)
                return
            payload = json.dumps(service.stats()).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(payload)

        def do_POST(self):
            if self.path not in ("/caption", "/caption_stream"):
                self.send_error(404)
                return
            try:
                body = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))))
                from PIL import Image

                image = Image.open(body["image_path"]).convert("RGB")
                prompt = body.get("prompt_template") or default_prompt
                max_new = body.get("max_new_tokens")
                if self.path == "/caption_stream":
                    # server-sent events: one `data:` line a step chunk
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.end_headers()
                    for delta in service.caption_stream(image, prompt, max_new_tokens=max_new):
                        self.wfile.write(f"data: {json.dumps({'delta': delta})}\n\n".encode())
                        self.wfile.flush()
                    self.wfile.write(b"data: [DONE]\n\n")
                    return
                text = service.caption(image, prompt, max_new_tokens=max_new)
                payload = json.dumps({"caption": text}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(payload)
            except Exception as e:  # surface errors to the client
                self.send_response(500)
                self.end_headers()
                self.wfile.write(json.dumps({"error": str(e)}).encode())

        def log_message(self, fmt, *args):
            print("[serve]", fmt % args)

    return Handler


def main(args, device="cuda"):
    from .chair_test import PROMPTS, make_engine

    if args.model not in ("llava-1.5", "llava-next"):
        raise SystemExit(NO_INSTRUCTBLIP)  # before the weights load
    engine, processor = make_engine(args, device=device)
    service = CaptionService(
        engine, processor, args.model, n_slots=args.slots,
        step_chunk=args.step_chunk,
        chunked_prefill=getattr(args, "chunked_prefill", None),
        batched_submit=getattr(args, "batched_submit", False),
    )
    httpd = ThreadingHTTPServer(("0.0.0.0", args.port), make_handler(service, PROMPTS[args.model]))
    print(f"serving on :{args.port} with {args.slots} decode slots")
    httpd.serve_forever()


def build_parser():
    """The JAX CLI's parser, flag for flag, name for name, default for
    default."""
    from .chair_test import str2bool

    p = argparse.ArgumentParser()
    p.add_argument("--model", default="llava-1.5")
    p.add_argument("--model-path", required=True)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--step-chunk", type=int, default=8,
                   help="decode steps between two rounds of joins, stream "
                   "deltas and harvests (latency vs join granularity)")
    p.add_argument("--batched-submit", type=str2bool, default=False,
                   help="batch plain same-budget llava-1.5 groups into one "
                   "prefill (DecodeServer.submit_many); off by default")
    p.add_argument("--original", type=str2bool, default=False)
    p.add_argument("--opera", type=str2bool, default=False)
    p.add_argument("--vcd", type=str2bool, default=False)
    p.add_argument("--num-beams", type=int, default=None)
    p.add_argument("--avg", type=str2bool, default=False)
    p.add_argument("--voting-numbers", type=int, default=3)
    p.add_argument("--use_random", type=str2bool, default=False)
    p.add_argument("--seed", type=int, default=None)
    # sampling (HF warper semantics; each request draws from its own
    # stream, so its slot never changes its tokens)
    p.add_argument("--do-sample", type=str2bool, default=False)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--fused-step", type=str2bool, default=True)
    p.add_argument(
        "--quantize", type=str, default=None, choices=[None, "int8", "w8a8", "int4"]
    )
    p.add_argument("--int8-kv", type=str2bool, default=False,
                   help="int8-quantized KV cache for the slot pool")
    p.add_argument("--chunked-prefill", type=int, default=None,
                   help="prefill joining requests in N-token pieces with "
                   "decode steps pumped between them: bounds how long "
                   "active streams stall during a long prefill "
                   "(engine.prefill_chunked; LLaVA-NeXT's ~3k-token prompts)")
    p.add_argument("--fuse-proj", type=str2bool, default=True,
                   help="fuse the qkv and gate+up weight leaves (identical "
                   "outputs; utils/quantize.fuse_projections)")
    p.add_argument("--w8a8-decode", type=str2bool, default=False,
                   help="int8 activations x int8 weights in the decode "
                   "projections (needs --quantize int8 or w8a8)")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
