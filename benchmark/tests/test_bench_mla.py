"""The Kimi-VL-A3B cell (``drivers/caption_mla.py``) narrowed to a CPU run:
a sound run reads ``correct``, a router that leaves the bias out reads
``routes_unexplained_pct`` over its limit, and the counts and the K7 readers read
what they are given."""
from __future__ import annotations

import copy
from types import SimpleNamespace

import pytest
import torch

from benchmark import counts_mla, registry, run

CELL = "kimivl.caption_exact_b32"


def narrow(cell):
    c = copy.deepcopy(cell.config)
    c["text_config"].update(vocab_size=512, hidden_size=64, intermediate_size=128,
                            moe_intermediate_size=64, num_hidden_layers=3, num_attention_heads=4,
                            kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                            n_routed_experts=8, num_experts_per_tok=3)
    c["vision_config"].update(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                              num_attention_heads=2, image_size=28, patch_size=14)
    c.update(kv_capacity=160, image_token_index=500, init_std=0.05)
    t = copy.deepcopy(cell.traffic)
    t.update(batch=4, new_tokens=8, check_rows=2, image_size=[28, 28])
    return cell._replace(config=c, traffic=t)


def run_tiny(seed=3000000017):
    argv = ["--workload", CELL, "--seed", str(seed), "--seconds", "0.3", "--trace", "0"]
    return run.run(argv, device="cpu", adjust=narrow)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_a_sound_tiny_run_is_correct(one_thread):
    result = run_tiny()
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"logits_kl", "token_gap_mean", "votes_unexplained",
                                     "routes_unexplained_pct", "rerun_differs"}


def test_a_router_without_its_bias_is_caught(one_thread, monkeypatch):
    """The bias left out of the picks and of the scores the router reports,
    as a real fault would leave it: its picks are the top-k of its own
    scores and the reference follows them, so only the picks' distance from
    the reference's own choice can show it."""
    from dropoutdecoding_tpu_torch.models import mla_moe

    def no_bias(cfg, lp, h):
        scores = mla_moe._mm_f32(h, lp["router"]).sigmoid()
        idx = torch.topk(scores, cfg.num_experts_per_tok, dim=-1).indices
        w = scores.gather(1, idx)
        w = w / (w.sum(-1, keepdim=True) + mla_moe.ROUTE_EPS) * cfg.routed_scaling_factor
        return idx, w, scores

    monkeypatch.setattr(mla_moe, "route", no_bias)
    result = run_tiny()
    unexplained = result["checks"]["routes_unexplained_pct"]
    assert not result["correct"] and unexplained["value"] > unexplained["limit"]


def test_picks_are_judged_by_the_limit_not_the_programs_error():
    """Picks off the reference's top-k by more than twice the allowance are
    unexplained however far the program's own scores lie from the
    reference's; within it they are explained."""
    from benchmark.drivers.caption_mla import CaptionMla

    ref = torch.tensor([[0.9, 0.8, 0.5, 0.1]])
    own = torch.tensor([[0, 1]])
    far = torch.tensor([[0.0, 0.8, 0.95, 0.1]])  # the program's own scores, far off
    picks = torch.tensor([[1, 2]])  # expert 2 for 0: 0.4 below it, an allowance of 0.2
    extra, unexplained, err, need = CaptionMla._judge((picks, far), (ref, own), 0.1)
    assert (extra, unexplained) == (1, 1) and abs(err - 0.9) < 1e-6 and abs(need - 0.2) < 1e-6
    assert CaptionMla._judge((picks, far), (ref, own), 0.25)[:2] == (1, 0)
    assert CaptionMla._judge((own, ref), (ref, own), 0.0) == (0, 0, 0.0, 0.0)


def test_k7_counts_at_the_cells_widths():
    d = counts_mla.MlaDims.of(registry.cell(CELL).config)
    assert (d.D, d.Ie, d.E, d.k, d.Lm) == (2048, 1408, 64, 6, 26)
    flops, nbytes = counts_mla.k7_forward(d, 96)
    assert flops == 26 * 2 * 3 * 2048 * 1408 * 576
    # the 64 experts of 26 layers once (28.8 GB), the rows in and out
    assert nbytes == 64 * 26 * 3 * 2048 * 1408 * 2 + 26 * 576 * 2048 * 6
    f, b = counts_mla.k7_caption(d, 32, 3, 128)
    assert f == 127 * (counts_mla.k7_forward(d, 32)[0] + flops)
    assert b == 127 * (counts_mla.k7_forward(d, 32)[1] + nbytes)


def test_active_parameters_are_kimi_vl_a3bs():
    d = counts_mla.MlaDims.of(registry.cell(CELL).config)
    # about 2.24 B parameters a token in the layers (head and embedding
    # aside), a multiply-add each
    assert 2.2e9 < counts_mla.token_flops(d) // 2 < 2.3e9


def _ctx(seconds):
    trace = SimpleNamespace(op_seconds=lambda op: seconds if op == "moe_experts" else 0.0)
    return SimpleNamespace(cell=registry.cell(CELL), trace=trace,
                           shapes={"rows": 32, "members": 3, "new_tokens": 128},
                           peaks={"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12})


def test_the_k7_readers():
    d = counts_mla.MlaDims.of(registry.cell(CELL).config)
    _, nbytes = counts_mla.k7_caption(d, 32, 3, 128)
    bound = nbytes / 3.35e12
    ctx = _ctx(2 * bound)
    roof = registry.metric_reader("moe_decode_roofline")
    assert abs(roof(ctx) - 50.0) < 1e-6
    ms = registry.metric_reader("moe_decode_ms")
    assert abs(ms(ctx) - 1e3 * 2 * bound / 127) < 1e-9
    # a program without K7 (the parent) reads nothing
    assert roof(_ctx(0.0)) is None and ms(_ctx(0.0)) is None
