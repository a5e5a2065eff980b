"""The port's serving and baseline benches (``cli/stall_probe.py``,
``cli/baseline_batch_bench.py``) on narrow models through ``cfg``, on the
CPU.  Their numbers are times, which only the card gives; here they must
print the JAX tools' JSON lines (the same fields) and serve the same
tokens down every path they time: a chunked join's tokens equal the
one-shot join's, and each row of a batched VCD or beam-search run equals
that row run alone.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from dropoutdecoding_tpu_torch.cli import baseline_batch_bench as bench
from dropoutdecoding_tpu_torch.cli import stall_probe
from dropoutdecoding_tpu_torch.engine import baselines, serving
from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
from dropoutdecoding_tpu_torch.utils import config as C
from dropoutdecoding_tpu_torch.utils.convert import synthetic_llava_params
from test_torch_llavanext import TINY_PINPOINTS, narrow_config

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's tiny tensors: a pool of one
    per core, spinning beside the other test workers, made these tests
    tens of times slower under load than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the JAX tools' JSON lines (cli/stall_probe.py:163-172, cli/baseline_batch_bench.py:110-152)
STALL_FIELDS = {"metric", "one_shot", "chunked_best", "improvement"}
VCD_FIELDS = {"batch", "batched_tok_s", "serial_tok_s", "speedup"}
BEAM_FIELDS = VCD_FIELDS | {"num_beams"}


def _small_next():
    """The narrow NeXT's LM with 28 px tiles of 7 px patches: 88 visual
    slots, so a 600 x 800 image's prompt is about 100 tokens."""
    cfg = narrow_config(C)
    return dataclasses.replace(cfg, image_grid_pinpoints=TINY_PINPOINTS,
                               vision=dataclasses.replace(cfg.vision, image_size=28))


def test_stall_probe_joins_give_one_shot_tokens(monkeypatch, capsys):
    served = []  # a {request: tokens} a server, in order
    init, harvest = serving.DecodeServer.__post_init__, serving.DecodeServer.harvest

    def logged(self):
        init(self)
        served.append({})
        self.served = served[-1]

    def recording(self):
        out = harvest(self)
        self.served.update({rid: t.tolist() for rid, t in out.items()})
        return out

    build = stall_probe.build_engine

    def sharpened(*args):
        # every int8 matrix x10, so that the narrow LM's tokens follow its
        # prompt and requests a and b part
        eng = build(*args)
        for leaf in [*eng.params.lm["layers"].values(), eng.params.lm["lm_head"]]:
            if isinstance(leaf, dict):
                leaf["s"].mul_(10)
        return eng

    monkeypatch.setattr(stall_probe, "build_engine", sharpened)
    monkeypatch.setattr(serving.DecodeServer, "__post_init__", logged)
    monkeypatch.setattr(serving.DecodeServer, "harvest", recording)
    out = stall_probe.main(["--tokens", "6", "--chunks", "24", "--pump-steps", "2"],
                           device="cpu", cfg=_small_next())
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out and set(out) == STALL_FIELDS
    assert out["metric"] == "serving_max_stall_ms" and out["one_shot"] > 0
    # one server a case: one-shot, then chunked (5 pieces of the ~100-token
    # prompt); each serves the warm-up pair, then a and b (the same two)
    one_shot, *chunked = served
    assert len(chunked) == 1
    assert one_shot["w1"] == one_shot["a"] and one_shot["w2"] == one_shot["b"]
    assert one_shot["a"] != one_shot["b"]  # a swap of a and b would show
    for case in chunked:
        assert case == one_shot
    assert all(len(t) == 6 for t in one_shot.values())


def _narrow_llava():
    return C.LlavaConfig(
        text=C.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
                           head_dim=16),
        vision=C.ClipVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                  num_attention_heads=4, image_size=28, patch_size=14),
        image_token_index=120,
    )


def test_baseline_bench_batched_rows_equal_serial(monkeypatch, capsys):
    calls = {"vcd_generate": [], "beam_generate": []}
    vcd, beam = baselines.vcd_generate, baselines.beam_generate
    for name, kept in calls.items():
        fn = getattr(baselines, name)

        def recording(*args, _fn=fn, _kept=kept, **kw):
            out = _fn(*args, **kw)
            _kept.append((args, kw, out.tokens))
            return out

        monkeypatch.setattr(baselines, name, recording)
    res = bench.main(["--tokens", "6"], device="cpu", cfg=_narrow_llava())
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"layers": 2, "tokens": 6, **res}
    assert set(res["vcd"]) == VCD_FIELDS and set(res["beam"]) == BEAM_FIELDS
    assert res["vcd"]["batch"] == 4 and res["beam"]["batch"] == 2

    # three batched calls, then three serial ones on row 0: all equal
    (args, kw, vcd_b), *rest = calls["vcd_generate"]
    assert [t.shape for *_, t in calls["vcd_generate"]] == [(4, 6)] * 3 + [(1, 6)] * 3
    for *_, t in rest:
        np.testing.assert_array_equal(t, vcd_b if len(t) == 4 else vcd_b[:1])
    engine, states = args[0], kw["states"]
    for b in range(4):  # every row alone
        alone = vcd(engine, states=tuple(bench._row(s, b) for s in states), seed=7).tokens
        np.testing.assert_array_equal(alone[0], vcd_b[b])
    assert len({tuple(r) for r in vcd_b.tolist()}) > 1  # the rows differ: a real check

    (args, kw, beam_b), *rest = calls["beam_generate"]
    assert [t.shape for *_, t in calls["beam_generate"]] == [(2, 6)] * 3 + [(1, 6)] * 3
    engine, state = args[0], kw["state"]
    for b in range(2):
        alone = beam(engine, state=bench._row(state, b), num_beams=3).tokens
        np.testing.assert_array_equal(alone[0], beam_b[b])
    assert beam_b[0].tolist() != beam_b[1].tolist()


@pytest.mark.parametrize("B", [1, 3])
def test_build_state_shapes(B):
    cfg = _narrow_llava()
    eng = LlavaEngine(cfg=cfg, params=synthetic_llava_params(cfg, "cpu"),
                      max_len=bench.PROMPT_LEN + 4, ensemble=False)
    st = bench._build_state(eng, B, seed=2)
    L, KH, D = cfg.text.num_hidden_layers, cfg.text.num_key_value_heads, cfg.text.head_dim
    assert st.cache.k.shape == (L, B, bench.PROMPT_LEN + 4, KH, D)
    assert st.cache.k.dtype == eng.dtype and st.last_logits.shape == (B, cfg.text.vocab_size)
    assert st.cur_len.tolist() == [bench.PROMPT_LEN] * B and (st.epis > 0).all()
    row = bench._row(st, B - 1)
    assert row.cache.v.shape[1] == 1 and row.rng_id.tolist() == [B - 1]
