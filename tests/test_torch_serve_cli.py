"""The port's HTTP caption service (``dropoutdecoding_tpu_torch/cli/serve.py``):
``CaptionService`` without HTTP (concurrent callers, stream deltas, stats,
budgets, chunked prefill, batched submits, a failing submit), one round
trip over ``127.0.0.1:0``, and the parser against the JAX CLI's.

Every caption must be **equal** to the caption of the engine's own
``generate`` of that request (the server's tokens equal solo tokens:
``test_torch_serving.py``), and the JAX ``CaptionService``'s captions on
the same tiny model with the JAX draws injected.
"""
import concurrent.futures as cf
import http.client
import json
import subprocess
import sys
import threading
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from dropoutdecoding_tpu.cli import serve as jserve
from dropoutdecoding_tpu.engine.generate import LlavaEngine as JaxEngine
from dropoutdecoding_tpu.utils import config as jax_config
from dropoutdecoding_tpu_torch.cli import serve as tserve
from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
from dropoutdecoding_tpu_torch.utils import config as torch_config
from dropoutdecoding_tpu_torch.utils.convert import llava_params_from_numpy
from test_torch_chair_cli import _actions
from test_torch_engine import SEED, jax_uniform
from test_torch_models import tiny_config, tiny_tree

T = 5
PROMPT = "Describe the image."


class _Processor:
    """A stand-in for ``VlmProcessor``: fixed prompt ids, 28 px pixels, one
    word a token."""

    class tokenizer:  # noqa: N801 (VlmProcessor's attribute)
        eos_token_id = 2

    def __init__(self, cfg):
        self.cfg = cfg

    def __call__(self, prompt, image=None):
        out = {"input_ids": np.array([[1, 5, 9, self.cfg.image_token_index, 11, 13]], np.int32)}
        if image is not None:
            arr = np.asarray(image.resize((28, 28)), np.float32) / 255.0
            out["pixel_values"] = arr.transpose(2, 0, 1)[None]
        return out

    def decode(self, token_ids, skip_special_tokens=True):
        return " ".join(f"t{int(t)}" for t in token_ids)


def _image(i):
    return Image.fromarray((np.random.default_rng(i).random((30, 30, 3)) * 255).astype(np.uint8),
                           "RGB")


@pytest.fixture(scope="module")
def weights():
    tree, _ = tiny_tree()
    return jax.tree.map(jnp.asarray, tree), llava_params_from_numpy(tree)


def _engine(weights, max_len=48):
    return LlavaEngine(
        cfg=tiny_config(torch_config), params=weights[1],
        ens=torch_config.EnsembleConfig(fused_step=True),
        gen=torch_config.GenerationConfig(max_new_tokens=T, eos_token_id=-1, pad_token_id=0),
        max_len=max_len, seed=SEED, uniform=jax_uniform(SEED),
    )


def _direct(eng, image):
    """The caption of the engine's own ``generate`` of one request."""
    proc = _Processor(eng.cfg)
    inputs = proc(PROMPT, image)
    return proc.decode(eng.generate(inputs["input_ids"], inputs["pixel_values"]).tokens[0])


@pytest.fixture
def service(weights):
    services = []

    def make(**kw):
        eng = _engine(weights, kw.pop("max_len", 48))
        svc = tserve.CaptionService(eng, _Processor(eng.cfg), "llava-1.5", n_slots=2, **kw)
        services.append(svc)
        return svc

    yield make
    for svc in services:
        svc.close()
        assert not svc.worker.is_alive()


@pytest.mark.parametrize("kw", [{}, {"batched_submit": True}, {"chunked_prefill": 8},
                                {"step_chunk": 1}],
                         ids=["per-request", "batched", "chunked", "step-chunk-1"])
def test_concurrent_captions_equal_direct_calls(service, kw):
    """Three callers on two slots at once: each caption is its request's
    own, whatever slot and step it joined at."""
    svc = service(**kw)
    with cf.ThreadPoolExecutor(max_workers=3) as ex:
        captions = list(ex.map(lambda i: svc.caption(_image(i), PROMPT, timeout=120), range(3)))
    want = [_direct(svc.engine, _image(i)) for i in range(3)]
    assert captions == want and len(set(want)) > 1
    assert svc.stats()["requests_done"] == 3


def test_captions_equal_the_jax_service(service, weights):
    """The same three captions from the JAX ``CaptionService`` over the JAX
    engine on the same weights (its own draws, injected into the port)."""
    je = JaxEngine(
        cfg=tiny_config(jax_config), params=weights[0],
        ens=jax_config.EnsembleConfig(fused_step=True),
        gen=jax_config.GenerationConfig(max_new_tokens=T, eos_token_id=-1, pad_token_id=0),
        max_len=48, seed=SEED,
    )
    je.param_dtype = jnp.float32
    ref_svc = jserve.CaptionService(je, _Processor(je.cfg), "llava-1.5", n_slots=2)
    svc = service()
    for i in range(3):
        assert svc.caption(_image(i), PROMPT, timeout=120) == ref_svc.caption(
            _image(i), PROMPT, timeout=300)


def test_stream_stats_budget(service):
    svc = service(step_chunk=2)
    img = _image(0)
    full = svc.caption(img, PROMPT, timeout=120)
    assert full == _direct(svc.engine, img) and len(full.split()) == T
    # one delta a step chunk (token 0 with the first chunk), reassembling the caption
    deltas = list(svc.caption_stream(img, PROMPT, timeout=120))
    assert len(deltas) > 1 and " ".join(deltas) == full
    short = svc.caption(img, PROMPT, timeout=120, max_new_tokens=2)
    assert short == " ".join(full.split()[:2])
    st = svc.stats()
    assert st["requests_done"] == 3 and st["tokens_generated"] == 2 * T + 2
    assert st["n_slots"] == 2 and st["active_slots"] == 0 and st["latency_p50_s"] > 0
    assert not svc.streams and not svc.results and not svc._starts


def test_a_failing_submit_reaches_its_caller_only(service, weights):
    """A budget past the engine's T, and one past the KV capacity: each
    caller gets the submit's ValueError; the worker goes on serving."""
    svc = service(max_len=24)  # prompt 21 + 5 - 1 = 25 > 24
    with pytest.raises(ValueError, match="exceeds max_len=24"):
        svc.caption(_image(0), PROMPT, timeout=60)
    with pytest.raises(ValueError, match="outside"):
        list(svc.caption_stream(_image(0), PROMPT, timeout=60, max_new_tokens=T + 1))
    assert svc.caption(_image(0), PROMPT, timeout=60, max_new_tokens=4) == " ".join(
        _direct(_engine(weights), _image(0)).split()[:4])
    assert svc.worker.is_alive()


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, resp.read().decode()


def test_http_round_trip(service, tmp_path):
    """``/caption``, ``/caption_stream`` (SSE) and ``/stats`` over
    ``127.0.0.1:0``; an unknown path is a 404, a missing image a 500 with
    its error."""
    svc = service()
    path = tmp_path / "img.png"
    _image(4).save(path)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), tserve.make_handler(svc, PROMPT))
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        want = _direct(svc.engine, Image.open(path).convert("RGB"))
        status, text = _post(port, "/caption", {"image_path": str(path)})
        assert status == 200 and json.loads(text) == {"caption": want}
        status, text = _post(port, "/caption_stream", {"image_path": str(path),
                                                       "max_new_tokens": 3})
        events = [line[len("data: "):] for line in text.split("\n\n") if line]
        assert status == 200 and events[-1] == "[DONE]"
        assert " ".join(json.loads(e)["delta"] for e in events[:-1]) == " ".join(want.split()[:3])
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        assert stats["requests_done"] == 2 and stats["tokens_generated"] == T + 3
        assert _post(port, "/nope", {})[0] == 404
        status, text = _post(port, "/caption", {"image_path": str(tmp_path / "missing.png")})
        assert status == 500 and "missing.png" in json.loads(text)["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(10)


def test_parser_keeps_every_flag_name_and_default():
    assert _actions(tserve.build_parser()) == _actions(jserve.build_parser())


def test_help_runs_as_a_module():
    out = subprocess.run([sys.executable, "-m", "dropoutdecoding_tpu_torch.cli.serve", "--help"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "--chunked-prefill" in out.stdout and "--w8a8-decode" in out.stdout


def test_instructblip_exits_with_the_jax_message(monkeypatch):
    """Before the weights load, with the JAX CLI's words (which it says
    after loading them)."""
    from dropoutdecoding_tpu.cli import chair_test as jchair
    from dropoutdecoding_tpu_torch.cli import chair_test as tchair

    argv = ["--model", "instructblip", "--model-path", "/unused"]
    monkeypatch.setattr(tchair, "make_engine", lambda *a, **k: pytest.fail("weights read"))
    with pytest.raises(SystemExit) as got:
        tserve.main(tserve.build_parser().parse_args(argv), device="cpu")
    monkeypatch.setattr(jchair, "make_engine", lambda args: (None, None))
    with pytest.raises(SystemExit) as ref:
        jserve.main(jserve.build_parser().parse_args(argv))
    assert str(got.value) == str(ref.value) == tserve.NO_INSTRUCTBLIP


def test_main_builds_the_engine_through_the_chair_cli(monkeypatch, weights):
    """``main`` takes its engine from the CHAIR CLI's ``make_engine`` with
    the serve flags (``--quantize w8a8 --w8a8-decode True``: int8 weights,
    both w8a8 fields) and serves it on ``--port``."""
    from dropoutdecoding_tpu_torch.cli import chair_test as tchair
    from dropoutdecoding_tpu_torch.models import llava as llava_mod

    cfg = tiny_config(torch_config)
    monkeypatch.setattr(llava_mod, "load", lambda *a: (cfg, weights[1]))
    monkeypatch.setattr(tchair, "load_processor", lambda path: _Processor(cfg))
    served = {}

    class _Server:
        def __init__(self, address, handler):
            served["address"] = address

        def serve_forever(self):
            served["served"] = True

    monkeypatch.setattr(tserve, "ThreadingHTTPServer", _Server)
    made = []
    real = tserve.CaptionService
    monkeypatch.setattr(tserve, "CaptionService", lambda *a, **k: made.append(real(*a, **k)))
    argv = ["--model-path", "/unused", "--port", "8123", "--slots", "3", "--quantize", "w8a8",
            "--w8a8-decode", "True"]
    tserve.main(tserve.build_parser().parse_args(argv), device="cpu")
    (svc,) = made
    svc.close()
    eng = svc.engine
    assert served == {"address": ("0.0.0.0", 8123), "served": True}
    assert svc.server.n_slots == 3 and eng.w8a8_prefill and eng.w8a8_decode
    assert eng.params.lm["layers"]["qkv_proj"]["q"].dtype == torch.int8
    assert eng.ens.fused_step  # serve's default


def test_llava_next_service_joins_by_chunked_prefill():
    """``--model llava-next --chunked-prefill 256``: the anyres tiles come
    from ``next_image_prep``, the request joins by ``submit_chunked``, and
    its caption equals the engine's own ``generate`` on those tiles."""
    from dropoutdecoding_tpu_torch.cli.chair_test import next_image_prep
    from dropoutdecoding_tpu_torch.engine.llavanext_engine import LlavaNextEngine
    from dropoutdecoding_tpu_torch.utils.convert import llavanext_params_from_numpy
    from test_torch_llavanext import narrow_config, narrow_tree

    eng = LlavaNextEngine(
        cfg=narrow_config(torch_config), params=llavanext_params_from_numpy(narrow_tree()),
        ens=torch_config.EnsembleConfig(mask_accumulate=False, topk=10, fused_step=True),
        gen=torch_config.GenerationConfig(max_new_tokens=T, eos_token_id=-1, pad_token_id=0),
        max_len=1344, seed=506,
    )
    proc = _Processor(eng.cfg)
    svc = tserve.CaptionService(eng, proc, "llava-next", n_slots=2, chunked_prefill=256)
    chunked = []
    submit_chunked = svc.server.submit_chunked
    svc.server.submit_chunked = lambda *a, **k: chunked.append(k["chunk"]) or submit_chunked(*a, **k)
    try:
        image = Image.fromarray((np.random.default_rng(3).random((150, 220, 3)) * 255)
                                .astype(np.uint8), "RGB")
        got = svc.caption(image, PROMPT, timeout=120)
    finally:
        svc.close()
    tiles, size = next_image_prep(eng)(image)
    want = proc.decode(eng.generate(proc(PROMPT)["input_ids"], tiles, size).tokens[0])
    assert got == want and chunked == [256]
