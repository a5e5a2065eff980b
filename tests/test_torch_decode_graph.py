"""The decode forwards' graph runner (``engine/decode_graphs.py``), driven on
the CPU by a stand-in for a CUDA graph: its capture runs the eager forward
once and hands back output buffers that hold nothing yet, and each replay
runs the forward again into those same buffers, as a graph does.  Tokens,
winners and the cache equal the eager loop's in every mode, a miss
captures and a hit replays, the counters count them and the kernel
wrappers' launch counts read as eager; on the CPU and under a TP mesh the
engine takes the eager path."""
import numpy as np
import pytest
import torch

from dropoutdecoding_tpu_torch.engine import decode_graphs, trace
from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
from dropoutdecoding_tpu_torch.engine.llavanext_engine import LlavaNextEngine
from dropoutdecoding_tpu_torch.models import llavanext as next_mod
from dropoutdecoding_tpu_torch.ops.cuda_decode_attention import ensemble_decode_attention_fused
from dropoutdecoding_tpu_torch.ops.cuda_int4_matmul import int4_matmul
from dropoutdecoding_tpu_torch.parallel import mesh as pm
from dropoutdecoding_tpu_torch.utils import config as C
from dropoutdecoding_tpu_torch.utils.convert import (
    synthetic_llava_params,
    synthetic_llavanext_params,
)

TEXT = C.LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                     num_attention_heads=4, num_key_value_heads=2, head_dim=8,
                     max_position_embeddings=256)
VISION = C.ClipVisionConfig(hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                            num_attention_heads=2, image_size=28, patch_size=14)
IMAGE = 60
IDS = np.array([[1, 5, IMAGE, 11, 13, 17]] * 2)  # B = 2
B, T, K = 2, 6, 3
SIZE = (30, 50)  # anyres: one base tile and a grid of crops

# mode -> (engine fields, EnsembleConfig fields, sampled, forwards a step)
MODES = {
    "exact": (dict(ensemble=True), {}, False, 2),
    "fused": (dict(ensemble=True), {"fused_step": True}, False, 1),
    "greedy": (dict(ensemble=False), {}, False, 1),
    "exact-sampled": (dict(ensemble=True), {}, True, 2),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's tiny tensors: a pool of one
    per core, spinning beside the other test workers, made such tests tens
    of times slower under load than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class StandIn:
    """A CUDA graph on the CPU: ``capture`` runs the forward once and hands
    back NaN buffers of its outputs' shapes (a captured graph has run
    nothing), each ``replay`` runs it again into them; a graph's replay
    calls no wrapper, so the launches the run counted are taken back."""

    def warm(self, fn):
        return fn()

    def capture(self, fn):
        self.fn = fn
        self.outputs = tuple(torch.full_like(t, float("nan")) for t in fn())
        return self.outputs

    def replay(self):
        before = decode_graphs._launch_counts()
        out = self.fn()
        decode_graphs._take_back(before)
        for static, t in zip(self.outputs, out):
            static.copy_(t)


def _graphed(eng, max_graphs=decode_graphs.MAX_GRAPHS):
    eng._graphs = decode_graphs.DecodeGraphs(torch.device("cpu"), StandIn, max_graphs)
    return eng


@pytest.fixture(scope="module")
def llava_weights():
    cfg = C.LlavaConfig(text=TEXT, vision=VISION, image_token_index=IMAGE)
    return cfg, synthetic_llava_params(cfg, "cpu", torch.float32, seed=3)


@pytest.fixture(scope="module")
def next_weights():
    cfg = C.LlavaNextConfig(text=TEXT, vision=VISION, image_token_index=IMAGE,
                            image_grid_pinpoints=((28, 56), (56, 28), (56, 56)))
    return cfg, synthetic_llavanext_params(cfg, "cpu", torch.float32, seed=4)


def _engine(family, weights, mode="exact", **kw):
    cfg, params = weights
    fields, ens, sample, _ = MODES[mode]
    gen = C.GenerationConfig(max_new_tokens=T, eos_token_id=-1, pad_token_id=0, do_sample=sample)
    cls = LlavaEngine if family == "llava" else LlavaNextEngine
    return cls(cfg=cfg, params=params, ens=C.EnsembleConfig(**ens), gen=gen,
               max_len=32 if family == "llava" else 128, seed=5, **fields, **kw)


def _images(family, cfg):
    if family == "llava":
        px = torch.randn(1, 3, 28, 28, generator=torch.Generator().manual_seed(0))
        return (px.expand(B, 3, 28, 28),)
    n = next_mod.image_geometry(SIZE, cfg)["n_tiles"]
    tiles = torch.randn(n, 3, 28, 28, generator=torch.Generator().manual_seed(1))
    return [tiles, tiles], [SIZE, SIZE]


def _decode(eng, images):
    """(tokens, winners, the cache's leaves) of a prefill and its decode."""
    state = eng.prefill(IDS, *images)
    winners = []
    tokens = eng.decode(state, winners)
    winners = torch.stack(winners) if winners[0] is not None else None
    return tokens, winners, (state.cache.k, state.cache.v)


def test_the_engine_takes_the_eager_path_on_the_cpu_and_under_a_tp_mesh(llava_weights):
    cfg, params = llava_weights
    assert _engine("llava", llava_weights)._graphs is None
    sharded = _engine("llava", (cfg, pm.shard_llava_params(params, pm.Mesh(1, 2, model_rank=1))))
    assert sharded.tp_mesh is not None and sharded._graphs is None
    cuda = torch.device("cuda")
    assert decode_graphs.for_engine(cuda, sharded.tp_mesh) is None
    assert decode_graphs.for_engine(torch.device("cpu"), None) is None
    assert isinstance(decode_graphs.for_engine(cuda, None), decode_graphs.DecodeGraphs)


@pytest.mark.parametrize("family", ["llava", "llavanext"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_replays_give_the_eager_loops_tokens_winners_and_cache(llava_weights, next_weights,
                                                                family, mode):
    weights = llava_weights if family == "llava" else next_weights
    images = _images(family, weights[0])
    eager = _decode(_engine(family, weights, mode, text_mask_policy="logits"), images)
    eng = _graphed(_engine(family, weights, mode, text_mask_policy="logits"))
    with trace.recording() as rec:
        graphed = _decode(eng, images)
    forwards = MODES[mode][3]
    assert rec.counters["decode.graph_captures"] == forwards
    assert rec.counters["decode.graph_replays"] == forwards * (T - 2)
    assert torch.equal(graphed[0], eager[0])
    if eager[1] is None:
        assert graphed[1] is None
    else:
        assert torch.equal(graphed[1], eager[1])
    assert all(torch.equal(a, b) for a, b in zip(graphed[2], eager[2]))


def test_a_miss_captures_a_hit_replays_and_the_oldest_graph_goes(llava_weights):
    """Keyed on the cache's storage: a new cache captures, the same one
    replays at every step; past ``max_graphs`` the least recently used
    graph goes, and its cache captures again."""
    eng = _graphed(_engine("llava", llava_weights), max_graphs=4)
    images = _images("llava", llava_weights[0])
    states = [eng.prefill(IDS, *images) for _ in range(3)]
    want = eng.decode(eng.prefill(IDS, *images))

    def decode(state):
        with trace.recording() as rec:
            keep = [t.clone() for t in (state.cache.k, state.cache.v)]
            tokens = eng.decode(state)
            state.cache.k.copy_(keep[0])  # the prefill's cache again
            state.cache.v.copy_(keep[1])
        assert torch.equal(tokens, want)
        return rec.counters["decode.graph_captures"], rec.counters["decode.graph_replays"]

    assert decode(states[0]) == (2, 2 * (T - 2))
    assert decode(states[0]) == (0, 2 * (T - 1))
    assert decode(states[1]) == (2, 2 * (T - 2))
    assert len(eng._graphs.graphs) == 4
    assert decode(states[2]) == (2, 2 * (T - 2))  # states[0]'s two graphs go
    assert len(eng._graphs.graphs) == 4
    assert decode(states[1]) == (0, 2 * (T - 1))
    assert decode(states[0]) == (2, 2 * (T - 2))


def test_a_replay_counts_the_launches_its_capture_recorded(monkeypatch):
    """The wrappers count Python calls: the warm-up's count stays (it ran),
    the capture's is taken back, and each replay adds it again."""
    monkeypatch.setattr(ensemble_decode_attention_fused, "launches", 0)
    monkeypatch.setattr(int4_matmul, "launches", 0)
    monkeypatch.setattr(int4_matmul, "route_launches", dict.fromkeys(int4_matmul.route_launches, 0))

    def forward(x):
        ensemble_decode_attention_fused.launches += 3
        int4_matmul.launches += 2
        int4_matmul.route_launches["tiles"] += 2
        return (x * 2,)

    graphs = decode_graphs.DecodeGraphs(torch.device("cpu"), StandIn)
    x = torch.arange(4.0)
    with trace.recording() as rec:
        for i in range(5):
            (out,) = graphs(forward, (x + i,), ())
            assert torch.equal(out, (x + i) * 2)
    assert rec.counters == {"decode.graph_captures": 1, "decode.graph_replays": 4}
    assert ensemble_decode_attention_fused.launches == 3 * 5
    assert int4_matmul.launches == int4_matmul.route_launches["tiles"] == 2 * 5
    # the counters reset between two runs, as chip_smoke.drive resets them
    int4_matmul.route_launches = dict.fromkeys(int4_matmul.route_launches, 0)
    graphs(forward, (x,), ())
    assert int4_matmul.route_launches["tiles"] == 2


def test_addresses_name_storage_shape_and_dtype():
    t = torch.zeros(2, 3)
    key = decode_graphs.addresses({"a": t, "b": [t[0], {"c": t.T}], "n": 3})
    assert key == decode_graphs.addresses({"a": t, "b": [t[0], {"c": t.T}], "n": 4})
    assert len(key) == 3 and key[0][0] == key[1][0] == key[2][0]
    assert key[0][1:] == ((2, 3), (3, 1), torch.float32) and key[2][2] == (1, 3)
    assert decode_graphs.addresses({"a": t.clone()}) != decode_graphs.addresses({"a": t})
