"""The port's InstructBLIP against tiny random HF models (transformers'
``InstructBlipForConditionalGeneration``): the vision tower, the Q-Former
pipeline and greedy generation, then the engine contracts the CLI's
batched paths rely on.  The port's counterpart of
``tests/test_instructblip_parity.py``, on the same tiny model, and
``slow`` like it.  Tolerances are that file's: 2e-4 for the tower, 3e-4
for the visual tokens (fp32, HF's eager attention against the port's)."""
import numpy as np
import pytest
import torch

from dropoutdecoding_tpu_torch.engine import baselines, opera
from dropoutdecoding_tpu_torch.engine.instructblip_engine import InstructBlipEngine
from dropoutdecoding_tpu_torch.models import blip_vit
from dropoutdecoding_tpu_torch.models import instructblip as ib_mod
from dropoutdecoding_tpu_torch.utils.config import (
    EnsembleConfig,
    GenerationConfig,
    InstructBlipConfig,
)
from dropoutdecoding_tpu_torch.utils.hf_io import state_dict_from_torch_module

pytestmark = pytest.mark.slow

IB_ENS = EnsembleConfig(mask_policy="epis_quantile", mask_accumulate=False, topk=10)


@pytest.fixture(scope="module")
def tiny_instructblip():
    from transformers import InstructBlipConfig as HFCfg
    from transformers import (
        InstructBlipForConditionalGeneration,
        InstructBlipQFormerConfig,
        InstructBlipVisionConfig,
    )
    from transformers import LlamaConfig as HFLCfg

    torch.manual_seed(5)
    hf_cfg = HFCfg(
        vision_config=InstructBlipVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=3, num_attention_heads=4,
            image_size=28, patch_size=7,
        ).to_dict(),
        qformer_config=InstructBlipQFormerConfig(
            vocab_size=48, hidden_size=24, num_hidden_layers=4, num_attention_heads=4,
            intermediate_size=48, cross_attention_frequency=2, encoder_hidden_size=32,
            max_position_embeddings=64,
        ).to_dict(),
        text_config=HFLCfg(
            vocab_size=64, hidden_size=40, intermediate_size=80, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=128,
            bos_token_id=1, eos_token_id=2,
        ).to_dict(),
        num_query_tokens=4,
        attn_implementation="eager",
    )
    hf_cfg.image_token_id = 63  # modern HF expects expanded image tokens
    model = InstructBlipForConditionalGeneration(hf_cfg).eval().float()
    cfg = InstructBlipConfig.from_hf_dict(hf_cfg.to_dict())
    params = ib_mod.params_from_hf(cfg, state_dict_from_torch_module(model), torch.float32, "cpu")
    pixels = np.random.default_rng(6).normal(size=(1, 3, 28, 28)).astype(np.float32)
    return model, cfg, params, pixels


def _engine(cfg, params, ensemble=False, **gen):
    kw = {"max_new_tokens": 4, "eos_token_id": 2, "pad_token_id": 2, **gen}
    return InstructBlipEngine(cfg=cfg, params=params, ens=IB_ENS, gen=GenerationConfig(**kw),
                              max_len=48, ensemble=ensemble, seed=5217)


def test_vision_tower_matches_hf(tiny_instructblip):
    model, cfg, params, pixels = tiny_instructblip
    with torch.no_grad():
        ref = model.vision_model(torch.from_numpy(pixels)).last_hidden_state.numpy()
    ours = blip_vit.apply(cfg.vision, params.vision, torch.from_numpy(pixels)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=2e-4)


def test_visual_tokens_match_hf_pipeline(tiny_instructblip):
    model, cfg, params, pixels = tiny_instructblip
    q_ids = np.array([[3, 7, 11, 13, 2]])
    with torch.no_grad():
        img = model.vision_model(torch.from_numpy(pixels)).last_hidden_state
        qt = model.query_tokens.expand(1, -1, -1)
        full_mask = torch.ones((1, qt.size(1) + q_ids.shape[1]), dtype=torch.long)
        q_out = model.qformer(
            input_ids=torch.from_numpy(q_ids), attention_mask=full_mask, query_embeds=qt,
            encoder_hidden_states=img,
            encoder_attention_mask=torch.ones(img.size()[:-1], dtype=torch.long),
            return_dict=True,
        ).last_hidden_state[:, : qt.size(1)]
        ref = model.language_projection(q_out).numpy()
    ours = ib_mod.visual_tokens(cfg, params, torch.from_numpy(pixels), torch.from_numpy(q_ids))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=3e-4, atol=3e-4)


def test_greedy_generate_matches_hf(tiny_instructblip):
    """HF 4.57 wants the image placeholders expanded in ``input_ids``; the
    reference (4.44) and the engine prepend the 4 query outputs themselves:
    the same merged sequence."""
    model, cfg, params, pixels = tiny_instructblip
    q_ids, input_ids = np.array([[3, 7, 11]]), np.array([[1, 9, 21, 33]])
    with torch.no_grad():
        ref = model.generate(
            pixel_values=torch.from_numpy(pixels), qformer_input_ids=torch.from_numpy(q_ids),
            input_ids=torch.from_numpy(np.array([[63] * 4 + [1, 9, 21, 33]])), max_new_tokens=6,
            do_sample=False,
        )[0].numpy()
    out = _engine(cfg, params, max_new_tokens=6).generate(input_ids, pixels, q_ids)
    n = min(int(out.num_tokens[0]), 6)
    got = list(out.tokens[0][:n])
    assert got == list(ref[-n:]) or got == list(ref[1 : 1 + n]), (got, ref)


def test_batched_generate_equals_per_row(tiny_instructblip):
    """B = 3 exact K = 3 equals each row run alone with its own draw
    stream: the CLI's --batch-size contract."""
    _, cfg, params, _ = tiny_instructblip
    pixels = np.random.default_rng(0).normal(size=(3, 3, 28, 28)).astype(np.float32)
    input_ids = np.array([[1, 9, 21, 33], [1, 11, 23, 35], [1, 13, 25, 37]])
    q_ids = np.array([[3, 7, 11]] * 3)
    batched = _engine(cfg, params, ensemble=True).generate(input_ids, pixels, q_ids)
    for b in range(3):
        solo = _engine(cfg, params, ensemble=True)
        state = solo.prefill(input_ids[b : b + 1], pixels[b : b + 1], q_ids[b : b + 1])
        row = solo.decode(state._replace(rng_id=torch.tensor([b]))).numpy()
        np.testing.assert_array_equal(batched.tokens[b], row[0], err_msg=f"row {b}")


def test_probe_matches_prefill_with_image_dedupe(tiny_instructblip):
    """Right-padded rows with a masked Q-Former instruction: ``probe`` (with
    and without ``image_index``) equals ``prefill``, and each row its own
    unpadded prefill."""
    _, cfg, params, _ = tiny_instructblip
    rows = [[1, 9, 21, 33, 40], [1, 11, 23], [1, 13, 25, 37], [1, 8, 9]]
    q_rows = [[3, 7, 11, 13], [3, 7], [3, 9, 11], [3, 5]]
    unique = np.random.default_rng(0).normal(size=(2, 3, 28, 28)).astype(np.float32)
    index = np.array([0, 0, 1, 1], np.int32)
    ids, q_ids, q_mask = (np.zeros((4, n), np.int32) for n in (5, 4, 4))
    for i in range(4):
        ids[i, : len(rows[i])] = rows[i]
        q_ids[i, : len(q_rows[i])] = q_rows[i]
        q_mask[i, : len(q_rows[i])] = 1
    lens = np.array([len(r) for r in rows], np.int32)
    e = _engine(cfg, params, ensemble=True)
    ref = e.prefill(ids, unique[index], q_ids, text_lens=lens, qformer_attention_mask=q_mask)
    for kw in ({}, {"image_index": index}):
        px = unique if kw else unique[index]
        got = e.probe(ids, px, q_ids, text_lens=lens, qformer_attention_mask=q_mask, **kw)
        np.testing.assert_array_equal(got.first_token.numpy(), ref.first_token.numpy())
        np.testing.assert_allclose(got.last_logits.numpy(), ref.last_logits.numpy(), atol=1e-5,
                                   rtol=1e-5)
    for i in range(4):
        one = e.prefill(np.array([rows[i]]), unique[index[i] : index[i] + 1], np.array([q_rows[i]]))
        assert int(ref.cur_len[i]) == int(one.cur_len[0]) == len(rows[i]) + 4
        assert int(ref.first_token[i]) == int(one.first_token[0])
        np.testing.assert_allclose(ref.last_logits[i].numpy(), one.last_logits[0].numpy(),
                                   atol=2e-4, rtol=1e-4)


def test_vcd_states_path_batched_matches_serial(tiny_instructblip):
    """VCD over InstructBLIP as the CLI runs it (the ViT's input noised),
    batched equal to serial."""
    _, cfg, params, pixels = tiny_instructblip
    eng = _engine(cfg, params, max_new_tokens=5, use_cd=True)
    ids, q_ids = np.array([[1, 9, 21]]), np.array([[3, 7]])
    px = np.concatenate([pixels, pixels * 0.75 + 0.05])

    def run(rows):
        noised = torch.stack([baselines.noised_pixels(eng, p) for p in px[rows]])
        n = len(rows)
        states = (eng.prefill(np.repeat(ids, n, 0), px[rows], np.repeat(q_ids, n, 0)),
                  eng.prefill(np.repeat(ids, n, 0), noised, np.repeat(q_ids, n, 0)))
        return baselines.vcd_generate(eng, states=states).tokens

    batched = run([0, 1])
    np.testing.assert_array_equal(batched[0], run([0])[0])
    np.testing.assert_array_equal(batched[1], run([1])[0])


def test_opera_matches_beam_at_zero_penalty(tiny_instructblip):
    """OPERA over the engine's state with no penalty and a full candidate
    pool is beam search on the same prefill."""
    _, cfg, params, pixels = tiny_instructblip
    eng = _engine(cfg, params, max_new_tokens=5, eos_token_id=-1, pad_token_id=0, num_beams=2)
    state = eng.prefill(np.array([[1, 9, 21, 33]]), pixels, np.array([[3, 7, 11]]))
    beam = baselines.beam_generate(eng, state=state, num_beams=2)
    op = opera.opera_generate(eng, state=state, num_beams=2, penalty_weights=0.0,
                              num_attn_candidates=4, threshold=10**6)
    np.testing.assert_array_equal(op.tokens, beam.tokens)
