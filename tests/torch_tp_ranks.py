"""The rank side of ``tests/test_torch_tp.py``: one process of a two-rank
gloo group on the CPU.  It imports no JAX (the parent runs the JAX side).

Run as ``python tests/torch_tp_ranks.py STORE RANK WORLD IN OUT``: it joins
the group through a file rendezvous at STORE, reads the parent's pickled
configs, numpy weights, inputs and JAX draw tables from IN, runs every case
of ``CASES`` (each under tensor parallelism or data parallelism, and,
on rank 0 only, the same call unsharded) and pickles {case: results} to
OUT.  Every case runs on both ranks in the same order, since the
collectives pair them up.
"""
from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

from dropoutdecoding_tpu_torch.engine import baselines, opera
from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
from dropoutdecoding_tpu_torch.engine.instructblip_engine import InstructBlipEngine
from dropoutdecoding_tpu_torch.engine.llavanext_engine import LlavaNextEngine
from dropoutdecoding_tpu_torch.engine.serving import DecodeServer
from dropoutdecoding_tpu_torch.engine.speculative import SpeculativeGreedy
from dropoutdecoding_tpu_torch.models import llama as llama_mod
from dropoutdecoding_tpu_torch.models import llava as llava_mod
from dropoutdecoding_tpu_torch.parallel import distributed as pd
from dropoutdecoding_tpu_torch.parallel import mesh as pm
from dropoutdecoding_tpu_torch.utils import config as C
from dropoutdecoding_tpu_torch.utils.convert import (
    instructblip_params_from_numpy,
    llava_params_from_numpy,
    llavanext_params_from_numpy,
)
from dropoutdecoding_tpu_torch.utils.quantize import (
    int8_column_major,
    quantize_llama_params,
    quantize_llama_params_int4,
)

SEED = 24


class TableUniform:
    """The JAX engine's mask draws, computed by the parent, as a draw
    source: {(step, row, member): [n] float32}."""

    def __init__(self, table):
        self.table = table

    def __call__(self, step, row, member, n):
        return torch.from_numpy(self.table[(step, row, member)][:n])


def _gen(T, **kw):
    return C.GenerationConfig(max_new_tokens=T, eos_token_id=-1, pad_token_id=0, **kw)


def llava_engine(d, params, ensemble=True, T=6, int8_kv=False, ens=None, **kw):
    return LlavaEngine(
        cfg=d["cfg"], params=params, ens=C.EnsembleConfig(**(ens or {})), gen=_gen(T),
        max_len=64, seed=SEED, ensemble=ensemble, int8_kv=int8_kv,
        uniform=TableUniform(d["uniform"]), **kw,
    )


def on_rank0(fn):
    """``fn()`` on rank 0 (the unsharded reference), None elsewhere."""
    return fn() if dist.get_rank() == 0 else None


# --- the cases --------------------------------------------------------------


def case_llava_tiers(inp, tp, dp):
    """TP (1 x 2) against unsharded: dense (prefill logits and epis, then
    greedy / exact / fused tokens), int8 with int8_kv and int4 (exact), the
    counterparts of tests/test_mesh.py:115, :257 and :371."""
    d = inp["llava"]
    params = llava_params_from_numpy(d["tree"])
    ids, px = d["ids"], d["pixels"]
    out = {}
    tiers = {
        "dense": (params, False),
        "int8": (params._replace(lm=quantize_llama_params(params.lm)), True),
        "int4": (params._replace(lm=quantize_llama_params_int4(params.lm)), False),
    }
    for tier, (p, int8_kv) in tiers.items():
        sp = pm.shard_llava_params(p, tp)
        modes = {"exact": dict(ensemble=True)}
        if tier == "dense":
            modes = {"greedy": dict(ensemble=False), **modes,
                     "fused": dict(ensemble=True, ens={"fused_step": True})}
        for mode, kw in modes.items():
            eng = llava_engine(d, sp, int8_kv=int8_kv, **kw)
            assert eng.tp_mesh is tp
            out[f"{tier}/{mode}/tp"] = eng.generate(ids, px).tokens
            out[f"{tier}/{mode}/ref"] = on_rank0(
                lambda: llava_engine(d, p, int8_kv=int8_kv, **kw).generate(ids, px).tokens)
        if tier == "dense":
            st = llava_engine(d, sp).prefill(ids, px)
            out["dense/logits/tp"] = st.last_logits.numpy()
            out["dense/epis/tp"] = st.epis.numpy()
            ref = on_rank0(lambda: llava_engine(d, p).prefill(ids, px))
            if ref is not None:
                out["dense/logits/ref"] = ref.last_logits.numpy()
                out["dense/epis/ref"] = ref.epis.numpy()
    return out


def case_probe(inp, tp, dp):
    """The POPE path over TP params: ``probe``, and ``probe_prefix`` /
    ``probe_extend`` over a dense and an int8 prefix (each rank's heads;
    the extend reads the prefix in its reader layout)."""
    d = inp["llava"]
    p = llava_params_from_numpy(d["tree"])
    ids, px = d["ids"], d["pixels"]
    tails = np.array([[7, 9, 11], [13, 15, 0]])
    out = {}
    for label, params in (("tp", pm.shard_llava_params(p, tp)), ("ref", p)):
        if label == "ref" and dist.get_rank() != 0:
            continue
        for int8 in (False, True):
            eng = llava_engine(d, params, ensemble=False, int8_prefix_cache=int8)
            got = eng.probe_extend(eng.probe_prefix(ids[:1, :3], px[:1]), tails,
                                   text_lens=np.array([3, 2]))
            out[f"extend{'/int8' if int8 else ''}/{label}"] = (
                got.first_token.numpy(), got.last_logits.numpy())
        got = llava_engine(d, params, ensemble=False).probe(ids, px)
        out[f"probe/{label}"] = (got.first_token.numpy(), got.last_logits.numpy())
    return out


def case_winner_kv(inp, tp, dp):
    """One exact step on a TP cache: this rank's heads of every written row
    (prefill and the winner's) against the unsharded cache's same heads
    (tests/test_mesh.py:196)."""
    d = inp["llava"]
    p = llava_params_from_numpy(d["tree"])
    ids, px = d["ids"], d["pixels"]

    def run(params):
        eng = llava_engine(d, params, T=2)
        st = eng.prefill(ids, px)
        eng.decode(st)
        return st.cache, st.cur_len

    cache, cur = run(pm.shard_llava_params(p, tp))
    out = {"cur": cur.numpy(), "k/tp": cache.k.numpy(), "v/tp": cache.v.numpy()}
    ref = on_rank0(lambda: run(p))
    if ref is not None:  # rank 0's heads are the first half
        kh = cache.k.shape[3]
        out["k/ref"] = ref[0].k[:, :, :, :kh].numpy()
        out["v/ref"] = ref[0].v[:, :, :, :kh].numpy()
    return out


def case_dp(inp, tp, dp):
    """DP (2 x 1): each data rank decodes its block of a B = 2 batch;
    gathered, the rows equal per-row unsharded runs with their rng_id
    pinned to the row (tests/test_mesh.py:233)."""
    d = inp["llava"]
    p = llava_params_from_numpy(d["tree"])
    ids, px = d["ids"], d["pixels"]
    eng = llava_engine(d, pm.shard_llava_params(p, dp))
    local = eng.generate(pm.data_split(ids, dp), pm.data_split(px, dp))
    out = {"local": local.tokens, "gathered": pm.gather_results(local, dp).tokens}

    def per_row():
        solo = llava_engine(d, p)
        rows = []
        for b in range(ids.shape[0]):
            st = solo.prefill(ids[b:b + 1], px[b:b + 1])
            rows.append(solo.decode(st._replace(rng_id=torch.tensor([b]))).numpy()[0])
        return np.stack(rows)

    out["ref"] = on_rank0(per_row)
    return out


def case_server(inp, tp, dp):
    """DecodeServer over TP params, two slots, three requests: each equals
    the unsharded solo generate (tests/test_mesh.py:398)."""
    d = inp["llava"]
    p = llava_params_from_numpy(d["tree"])
    ids, px = d["ids3"], d["pixels3"]
    reqs = {f"r{b}": (ids[b:b + 1], px[b:b + 1]) for b in range(3)}
    server = DecodeServer(engine=llava_engine(d, pm.shard_llava_params(p, tp)), n_slots=2)
    got = server.run(list(reqs), lambda rid: reqs[rid], batch_prefill=False)
    out = {f"{rid}/tp": np.asarray(t) for rid, t in got.items()}
    solo = on_rank0(lambda: llava_engine(d, p))
    for rid, a in reqs.items():
        out[f"{rid}/ref"] = None if solo is None else solo.generate(*a).tokens[0]
    return out


def case_budget(inp, tp, dp):
    """The collectives a TP forward makes, counted at the helpers: a decode
    forward (decode_step + lm_head), a prefill, and the vision path
    (tests/test_mesh.py:293)."""
    d = inp["llava"]
    cfg = d["cfg"]
    sp = pm.shard_llava_params(llava_params_from_numpy(d["tree"]), tp)
    eng = llava_engine(d, sp)
    counts = {}

    def count(label, fn):
        pm.reset_counts()
        fn()
        counts[label] = (pm.all_reduce.calls, pm.all_gather.calls)

    st = eng.prefill(d["ids"], d["pixels"])
    B = d["ids"].shape[0]
    x = llama_mod.embed(sp.lm, st.first_token)[:, None]
    mask = (torch.arange(eng.max_len)[None] < st.cur_len[:, None])[:, None]
    count("decode", lambda: llama_mod.lm_head(sp.lm, llama_mod.decode_step(
        sp.lm, cfg.text, x, st.cur_len, st.cache, mask, tp_mesh=tp)[0]))
    count("decode_m3", lambda: llama_mod.lm_head(sp.lm, llama_mod.decode_step(
        sp.lm, cfg.text, x.expand(B, 3, -1), st.cur_len, st.cache, mask.expand(B, 3, -1))[0]))
    count("vision", lambda: llava_mod.image_features(cfg, sp, torch.as_tensor(d["pixels"])))
    count("prefill", lambda: eng.prefill(d["ids"], d["pixels"]))
    # DP (2 x 1): the "model" axis has one rank, so a forward issues none
    dsp = pm.shard_llava_params(llava_params_from_numpy(d["tree"]), dp)
    deng = llava_engine(d, dsp)
    ids, px = pm.data_split(d["ids"], dp), pm.data_split(d["pixels"], dp)
    dst = deng.prefill(ids, px)
    dx = llama_mod.embed(dsp.lm, dst.first_token)[:, None]
    dmask = (torch.arange(deng.max_len)[None] < dst.cur_len[:, None])[:, None]
    count("decode_dp", lambda: llama_mod.lm_head(dsp.lm, llama_mod.decode_step(
        dsp.lm, cfg.text, dx, dst.cur_len, dst.cache, dmask, tp_mesh=deng.tp_mesh)[0]))
    count("prefill_dp", lambda: deng.prefill(ids, px))
    return {"counts": counts, "L": cfg.text.num_hidden_layers,
            "vision_layers": cfg.vision.num_hidden_layers + 1 + cfg.vision_feature_layer}


def case_next(inp, tp, dp):
    """LLaVA-NeXT under TP: greedy and exact (the Mistral GQA split, CLIP
    and projector, image_newline whole; tests/test_llavanext_parity.py:437)."""
    d = inp["next"]
    p = llavanext_params_from_numpy(d["tree"])
    sp = pm.shard_llavanext_params(p, tp)
    out = {}

    def mk(params, ensemble):
        return LlavaNextEngine(
            cfg=d["cfg"], params=params, ens=C.EnsembleConfig(mask_accumulate=False, topk=10),
            gen=_gen(5), max_len=d["max_len"], seed=506, ensemble=ensemble,
        )

    for mode, ensemble in (("greedy", False), ("exact", True)):
        out[f"{mode}/tp"] = mk(sp, ensemble).generate(d["ids"], d["tiles"], d["size"]).tokens
        out[f"{mode}/ref"] = on_rank0(
            lambda: mk(p, ensemble).generate(d["ids"], d["tiles"], d["size"]).tokens)
    return out


def case_instructblip(inp, tp, dp):
    """InstructBLIP under TP: the Vicuna LM split, the towers whole; greedy
    and fused (tests/test_instructblip_parity.py:310)."""
    d = inp["ib"]
    p = instructblip_params_from_numpy(d["tree"])
    sp = pm.shard_instructblip_params(p, tp)
    out = {}

    def mk(params, ensemble, **ens):
        return InstructBlipEngine(
            cfg=d["cfg"], params=params,
            ens=C.EnsembleConfig(mask_policy="epis_quantile", mask_accumulate=False, topk=10,
                                 **ens),
            gen=_gen(5), max_len=48, seed=5217, ensemble=ensemble,
        )

    for mode, ensemble, ens in (("greedy", False, {}), ("fused", True, {"fused_step": True})):
        out[f"{mode}/tp"] = mk(sp, ensemble, **ens).generate(d["ids"], d["pixels"], d["q_ids"]).tokens
        out[f"{mode}/ref"] = on_rank0(
            lambda: mk(p, ensemble, **ens).generate(d["ids"], d["pixels"], d["q_ids"]).tokens)
    return out


def case_baselines(inp, tp, dp):
    """VCD, beam search and OPERA over TP params against unsharded.  OPERA's
    head-mean attention is summed over the model ranks: the JAX package
    never ran OPERA on a mesh, so the unsharded port is the reference."""
    d = inp["llava"]
    p = llava_params_from_numpy(d["tree"])
    sp = pm.shard_llava_params(p, tp)
    ids, px = d["ids"], d["pixels"]
    vcd_gen = _gen(6, do_sample=True, use_cd=True)
    runs = {
        "vcd": lambda e: baselines.vcd_generate(e, ids, px, seed=3).tokens,
        "beam": lambda e: baselines.beam_generate(e, ids, px, num_beams=3).tokens,
        "opera": lambda e: opera.opera_generate(
            e, ids[:1], px[:1], num_beams=3, num_attn_candidates=2, scale_factor=50.0,
            threshold=2).tokens,
    }
    out = {}
    for name, run in runs.items():
        def mk(params):
            eng = llava_engine(d, params, ensemble=False)
            if name == "vcd":
                eng.gen = vcd_gen
            return eng

        out[f"{name}/tp"] = run(mk(sp))
        out[f"{name}/ref"] = on_rank0(lambda: run(mk(p)))
    # OPERA's capture itself: the last layer's head-mean row
    eng = llava_engine(d, sp, ensemble=False)
    st = eng.prefill(ids[:1], px[:1])
    pos = int(st.cur_len[0])

    def attn_row(params, cache):
        return llama_mod.decode_step_attn(
            params.lm, d["cfg"].text, llama_mod.embed(params.lm, st.first_token), st.cur_len,
            llama_mod.cache_live(cache, pos), torch.ones((1, pos), dtype=torch.bool))[3].numpy()

    out["attn/tp"] = attn_row(sp, st.cache)
    out["attn/ref"] = on_rank0(
        lambda: attn_row(p, llava_engine(d, p, ensemble=False).prefill(ids[:1], px[:1]).cache))
    return out


def case_speculative(inp, tp, dp):
    """Speculative greedy over a TP target: the int4 self-draft cut like
    the target, and the n-gram draft; both equal the unsharded greedy
    tokens, and so the unsharded speculative run."""
    d = inp["llava"]
    p = llava_params_from_numpy(d["tree"])
    sp = pm.shard_llava_params(p, tp)
    ids, px = d["ids"][:1], d["pixels"][:1]
    draft = quantize_llama_params_int4(p.lm)
    out = {}
    for kind in ("lm", "ngram"):
        def run(params, dlm):
            eng = llava_engine(d, params, ensemble=False, T=10)
            return SpeculativeGreedy(engine=eng, draft_lm=dlm if kind == "lm" else None,
                                     gamma=3, draft=kind).generate(ids, px)[0]

        out[f"{kind}/tp"] = run(sp, pm.shard_llama_params(draft, tp))
        out[f"{kind}/ref"] = on_rank0(lambda: run(p, draft))
    out["greedy/ref"] = on_rank0(
        lambda: llava_engine(d, p, ensemble=False, T=10).generate(ids, px).tokens[0])
    return out


def case_w8a8(inp, tp, dp):
    """w8a8 under TP.  A row-parallel product whose row maxima lie in the
    other rank's shard: with the all-reduced row max it equals the
    unsharded product bit for bit (int32 sums are exact); a rank-local max
    would not.  Then engines with w8a8 prefill and decode, token-equal."""
    d = inp["llava"]
    r = np.random.default_rng(7)
    D, E = 64, 16
    x = torch.from_numpy(r.normal(size=(2, D)).astype(np.float32))
    x[0, D // 2 + 5] = 9.0  # row 0's max in rank 1's half
    x[1, 3] = -9.0  # row 1's max in rank 0's half
    w = quantize_llama_params({"layers": {n: torch.from_numpy(
        r.normal(size=(1, D, E)).astype(np.float32)) for n in
        ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")},
        "lm_head": torch.zeros(D, 2)})["layers"]["o_proj"]
    w0 = {"q": w["q"][0], "s": w["s"][0]}
    half = slice(tp.model_rank * D // 2, (tp.model_rank + 1) * D // 2)
    w_local = {"q": w0["q"][half], "s": w0["s"]}
    out = {
        "mm/tp": llama_mod._mm_w8a8(x[:, half].contiguous(), w_local, tp).numpy(),
        "mm/local_max": llama_mod._mm_w8a8(x[:, half].contiguous(), w_local).numpy(),
        "mm/ref": llama_mod._mm_w8a8(x, w0).numpy(),
    }
    p = llava_params_from_numpy(d["tree"])
    q = p._replace(lm=int8_column_major(quantize_llama_params(p.lm)))
    sq = pm.shard_llava_params(q, tp)
    kw = dict(w8a8_prefill=True, w8a8_decode=True)
    for mode, ens in (("greedy", False), ("exact", True)):
        out[f"{mode}/tp"] = llava_engine(d, sq, ensemble=ens, **kw).generate(
            d["ids"], d["pixels"]).tokens
        out[f"{mode}/ref"] = on_rank0(lambda: llava_engine(d, q, ensemble=ens, **kw).generate(
            d["ids"], d["pixels"]).tokens)
    return out


CASES = {
    "llava_tiers": case_llava_tiers,
    "probe": case_probe,
    "winner_kv": case_winner_kv,
    "dp": case_dp,
    "server": case_server,
    "budget": case_budget,
    "next": case_next,
    "instructblip": case_instructblip,
    "baselines": case_baselines,
    "speculative": case_speculative,
    "w8a8": case_w8a8,
}


def main(store_path, rank, world, in_path, out_path):
    torch.set_num_threads(1)  # tiny tensors, beside other test workers
    with open(in_path, "rb") as f:
        inp = pickle.load(f)
    assert pd.init_multihost(coordinator_address=f"file://{os.path.abspath(store_path)}",
                             num_processes=world, process_id=rank, backend="gloo")
    tp = pm.make_mesh(n_data=1, n_model=world)
    dp = pm.make_mesh(n_data=world, n_model=1)
    with torch.no_grad():
        results = {name: fn(inp, tp, dp) for name, fn in CASES.items()}
    with open(out_path, "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
