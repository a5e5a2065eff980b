"""The plain reference held against the port at a tiny size on random
weights, in fp32 on the CPU: the towers, the anyres packing, the decoder's
prefill and decode step, the uncertainty, the members' masks and draws, the
vote; and a whole tiny run of each cell, which the reference passes."""
from __future__ import annotations

import pytest
import torch

from benchmark import inputs, registry, weights
from benchmark.drivers.base import program_config, program_params
from benchmark.reference import dropout
from benchmark.reference.anyres import image_geometry, max_tokens
from benchmark.reference.model import Reference

from .tiny import narrow, run_tiny

CELLS = ["bakllava.caption_exact_b64", "llavanext.pope_batched_b8",
         "llavanext.pope_prefix", "llavanext.caption_exact_b16"]


def _tiny(cell_name):
    cell = narrow(registry.cell(cell_name))
    tree = weights.make(cell.config, seed=5, device="cpu", dtype=torch.float32)
    return cell, tree, program_params(cell.config, tree, None), Reference(cell.config, tree)


@pytest.mark.parametrize("cell_name", ["bakllava.caption_exact_b64", "llavanext.pope_batched_b8"])
def test_towers_and_packing(cell_name):
    from dropoutdecoding_tpu_torch.models import llava, llavanext

    cell, tree, params, ref = _tiny(cell_name)
    cfg = program_config(cell.config)
    size = tuple(cell.traffic["image_size"])
    crops = inputs.image(cell.config, 7, 0, size, "cpu")
    if cell.config["family"] == "llava":
        got = llava.image_features(cfg, params, crops)[0]
    else:
        geo = llavanext.image_geometry(size, cfg)
        assert geo == image_geometry(size, cell.config)
        assert llavanext.max_image_tokens(cfg) == max_tokens(cell.config)
        g, _ = llavanext.packing_indices(cfg, geo, geo["n_tokens"])
        got = llavanext.pack_image_features(cfg, params, crops, torch.as_tensor(g))
    torch.testing.assert_close(got, ref.visual_tokens(crops, size), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cell_name", ["bakllava.caption_exact_b64", "llavanext.caption_exact_b16"])
def test_prefill_and_decode_step(cell_name):
    from dropoutdecoding_tpu_torch.models import llama

    cell, tree, params, ref = _tiny(cell_name)
    cfg = program_config(cell.config).text
    S, M, Smax = 12, 3, 16
    x = torch.randn(1, S, cfg.hidden_size, generator=torch.Generator().manual_seed(1))
    hidden, kv = llama.prefill(params.lm, cfg, x, torch.arange(S)[None])
    want, ref_kv = ref.forward(x[0])
    torch.testing.assert_close(hidden[0], want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(kv.k[-1, 0], ref_kv[-1][0], rtol=1e-4, atol=1e-4)
    cache = llama.empty_cache(cfg, 1, Smax, torch.float32, "cpu")
    llama.cache_seed(cache, kv)
    mask = torch.rand(1, M, Smax, generator=torch.Generator().manual_seed(2)) < 0.7
    mask &= torch.arange(Smax) < S
    tok = torch.randn(1, M, cfg.hidden_size, generator=torch.Generator().manual_seed(3))
    tok[:, 1:] = tok[:, :1]
    h, k_new, _ = llama.decode_step(params.lm, cfg, tok, torch.tensor([S]), cache, mask)
    rc = [(kc[None, :S].clone(), vc[None, :S].clone()) for kc, vc in ref_kv]
    rc = [(torch.cat([k, k.new_zeros(1, Smax - S, *k.shape[2:])], 1),
           torch.cat([v, v.new_zeros(1, Smax - S, *v.shape[2:])], 1)) for k, v in rc]
    rh, rkv = ref.step(tok, torch.tensor([S]), rc, mask)
    torch.testing.assert_close(h, rh, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(k_new[0], rkv[0][0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(llama.lm_head(params.lm, h), ref.logits(rh), rtol=1e-4, atol=1e-4)


def test_uncertainty_masks_draws_and_vote():
    from dropoutdecoding_tpu_torch.decoding.aggregate import select_by_vote
    from dropoutdecoding_tpu_torch.decoding.masks import build_member_drop_mask, overlap_keep_mask
    from dropoutdecoding_tpu_torch.ops.uncertainty import topk_token_ids, vision_uncertainty
    from dropoutdecoding_tpu_torch.utils.prng import PhiloxUniform

    g = torch.Generator().manual_seed(4)
    logits = torch.randn(1, 20, 50, generator=g) * 3
    epis = vision_uncertainty(logits)["epis_uncert_per_token"][0]
    torch.testing.assert_close(epis, dropout.epistemic(logits[0]), rtol=1e-5, atol=1e-6)
    _, ids = topk_token_ids(logits, 5)
    assert torch.equal(ids[0].long(), dropout.top_ids(logits[0], 5))
    seed, step, row = 2**31 + 11, 7, 3
    source = PhiloxUniform(seed, "cpu")
    draws = [source(step, row, m, 20) for m in range(3)]
    for m in range(3):
        assert torch.equal(draws[m], dropout.member_draws(seed, step, row, m, 20, "cpu"))
    argmax = int(ids[0, 2, 0])
    overlap = overlap_keep_mask(torch.tensor([argmax]), ids)
    for accumulate in (True, False):
        prev, want = torch.zeros(1, 20, dtype=torch.bool), []
        for u, cap in zip(draws, (0.3, 0.5, 0.7)):
            prev = build_member_drop_mask(u[None], "epis", epis[None], cap, overlap, prev, accumulate)
            want.append(prev[0])
        got = dropout.drop_masks(epis, ids[0].long(), argmax, draws, (0.3, 0.5, 0.7), accumulate, 0.1)
        assert torch.equal(got, torch.stack(want))
    members = torch.randn(4, 3, 50, generator=g)
    members[0, 2] = members[0, 0]  # a 2-1 vote
    winner, token = select_by_vote(members)
    for b in range(4):
        assert dropout.vote(members[b]) == (int(winner[b]), int(token[b]))


def test_a_vote_is_judged_within_the_programs_error():
    from dropoutdecoding_tpu_torch.decoding.aggregate import select_by_vote

    from benchmark.drivers.base import vote_unexplained

    g = torch.Generator().manual_seed(6)
    for _ in range(50):  # a sound vote over rounded logits never counts
        ref = torch.randn(3, 40, generator=g)
        ref[1] = ref[0] + 0.01 * torch.randn(40, generator=g)  # members that nearly tie
        got = ref + 0.05 * torch.randn(3, 40, generator=g)
        w, tok = select_by_vote(got)
        assert vote_unexplained(ref, got, int(tok), int(w)) == 0
    ref = torch.zeros(3, 40)
    ref[0, 5], ref[1, 9], ref[2, 9] = 4.0, 4.0, 4.0  # members 1 and 2 agree on 9
    got = ref + 0.01
    assert vote_unexplained(ref, got, 9, 1) == 0
    assert vote_unexplained(ref, got, 5, 0) == 1  # member 0 served against the majority
    assert vote_unexplained(ref, got, 9, 2) == 1  # the right token from the wrong member
    near = ref.clone()
    near[1, 5] = 3.99  # member 1's 5 lies within the error: a 2-1 vote for 5 may be rounding
    assert vote_unexplained(near, near + 0.01 * (torch.arange(40) == 9), 5, 0) == 0


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_tiny_run_is_correct(cell_name):
    result = run_tiny(cell_name)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["checks"]) == set(registry.cell(cell_name).limits)


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_tiny_traced_run_reads_its_spans(cell_name):
    """The traced path at a tiny size: the sizes of the traced unit reach the
    readers, and the span metrics of the cell are read (on the CPU the trace
    holds no device operation, so the rooflines and idle shares are left
    out)."""
    result = run_tiny(cell_name, trace=1)
    assert result["correct"], result["checks"]
    spans = {"decode_step_ms", "prefill_ms.caption", "extend_ms.pope"}
    want = {m["name"] for m in registry.cell(cell_name).per_layer} & spans
    assert set(result["metrics"]) == want
    assert result["device"]["window_s"] > 0 and set(result["breakdown"]) == {"device_ops", "idle_gaps"}
