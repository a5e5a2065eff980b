"""``counts.py`` against small cases worked by hand."""
from __future__ import annotations

from benchmark import counts

# a 2-layer toy: D 8, FFN 16, 4 query heads over 1 KV head of 2 (G = 4),
# vocabulary 10; a vision tower of width 4, FFN 8, 1 layer, 2 x 2 patches of 2 px
D = counts.Dims(D=8, I=16, L=2, H=4, KH=1, Dh=2, V=10, Dv=4, Iv=8, Lv=1, patch=2, image=4)


def test_causal_pairs_with_key_padding():
    # 3 real tokens: rows 0..2 see 1, 2, 3 keys
    assert counts.causal_pairs(3) == 6
    # K5 on two rows of 3 and 5 real tokens, whatever they are padded to:
    # the real rows' causal pairs alone, 6 + 15, 4·Dh·H each
    assert counts.flash_prefill_flops(D, [3, 5]) == 4 * 2 * 4 * (6 + 15)


def test_decode_attention_bytes_at_gqa_4():
    # 2 rows, 3 members, 5 filled slots of 7: K and V of 1 KV head of 2 a slot
    # (2 rows x 5 slots x 1 x 2 x 2 (K, V) x 2 bytes = 80); q and out 2 x 2 x 3
    # x 4 x 2 x 2 = 192; own K/V 2 x 3 x 1 x 2 x 2 x 2 = 48; masks 2 x 3 x 7 = 42
    assert counts.decode_attn_bytes(D, rows=2, members=3, filled=5, slots=7) == 80 + 192 + 48 + 42
    # G = 4 reads each KV head once for its 4 query heads: 4x fewer cache bytes
    mha = counts.Dims(**{**D.__dict__, "KH": 4})
    assert counts.decode_attn_bytes(mha, 2, 3, 5, 7) - 192 - 42 == 4 * (80 + 48)


def test_a_caption_batch_of_decode_attention_calls():
    # 2 rows, 3 members, a 5-token prompt, 3 new tokens: 2 exact steps over 5
    # and 6 filled slots, one call for the unmasked stream and one for the
    # members in each, in both layers
    flops, nbytes = counts.exact_decode_attn(D, rows=2, members=3, real=5, new_tokens=3, slots=7)
    calls = [(m, f) for f in (5, 6) for m in (1, 3)]
    assert flops == 2 * sum(counts.decode_attn_flops(D, 2, m, f) for m, f in calls)
    assert nbytes == 2 * sum(counts.decode_attn_bytes(D, 2, m, f, 7) for m, f in calls)


def test_exact_step_counts_four_b_rows():
    # per token: q 8x8, k and v 8x2 each, o 8x8, gate / up / down 8x16 each:
    # 64 + 32 + 64 + 384 = 544 MACs a layer, 2 layers, 2 operations a MAC
    assert counts.lm_token_flops(D) == 2 * 2 * 544
    rows, members, filled = 3, 3, 9
    r = rows * (1 + members)  # 4B rows: the unmasked stream and 3 members
    want = r * (2 * 2 * 544 + 4 * 2 * 4 * (filled + 1) * 2) + 2 * r * 8 * 10
    assert counts.exact_step_flops(D, rows, members, filled) == want


def test_extend_and_prefix_probe():
    # tails of 2 and 3 over a 4-token prefix: 2·4 + 3 and 3·4 + 6 pairs
    assert counts.extend_pairs(4, 2) == 11 and counts.extend_pairs(4, 3) == 18
    assert counts.extend_attn_flops(D, 4, [2, 3]) == 4 * 2 * 4 * 29
    # the prefix's K/V once (4 x 1 x 2 x 2), the 5 tail tokens' q, out (2 x 8) and k, v (2 x 2)
    assert counts.extend_attn_bytes(D, 4, [2, 3]) == (16 + 5 * (16 + 4)) * 2


def test_vision_tower():
    # 4 patches + CLS: embed 2·4·12·4; a layer 2·5·4·16 + 2·5·2·32 + 4·25·4;
    # projector 2·4·(4·8 + 8·8)
    want = 2 * 4 * 12 * 4 + (2 * 5 * 4 * 16 + 2 * 5 * 2 * 32 + 4 * 25 * 4) + 2 * 4 * (32 + 64)
    assert counts.vision_flops(D, 1) == want
    assert counts.vision_flops(D, 3) == 3 * want


def test_bound_takes_the_longer_side():
    peaks = {"bf16_flops": 1e12, "hbm_bytes_per_s": 1e9}
    assert counts.bound_seconds(2e12, 1e9, peaks) == 2.0
    assert counts.bound_seconds(1e9, 3e9, peaks) == 3.0


def test_each_roofline_reader_counts_from_the_traced_units_sizes():
    """A roofline reader counts its operation's work from the sizes a
    driver's ``traced_unit`` returns and the cell's configuration; one second
    of device time against the H100's peaks."""
    from types import SimpleNamespace

    from benchmark import registry
    from benchmark.peaks import H100

    def read(metric, cell, shapes):
        c = registry.cell(cell)
        trace = SimpleNamespace(op_seconds=lambda op: 1.0, span_seconds=lambda span: 1.0)
        ctx = SimpleNamespace(cell=c, shapes=shapes, trace=trace, peaks=H100)
        return registry.metric_reader(metric)(ctx), counts.Dims.of(c.config)

    cap = {"rows": 64, "members": 3, "real": 595, "visual": 576, "new_tokens": 128, "tiles": 64,
           "slots": 1152}
    got, d = read("decode_attn_roofline", "bakllava.caption_exact_b64", cap)
    flops, nbytes = counts.exact_decode_attn(d, 64, 3, 595, 128, 1152)
    assert got == 100.0 * max(flops / H100["bf16_flops"], nbytes / H100["hbm_bytes_per_s"])
    got, d = read("prefill_attn_roofline", "llavanext.pope_batched_b8", {"reals": [2350, 2352], "tiles": 10})
    assert got == 100.0 * d.L * counts.flash_prefill_flops(d, [2350, 2352]) / H100["bf16_flops"]
    pre = {"prefix": 2343, "tails": [9, 9, 10, 10, 11, 12], "tiles": 5}
    got, d = read("extend_attn_roofline", "llavanext.pope_prefix", pre)
    want = counts.bound_seconds(d.L * counts.extend_attn_flops(d, 2343, pre["tails"]),
                                d.L * counts.extend_attn_bytes(d, 2343, pre["tails"]), H100)
    assert got == 100.0 * want
    # a reader given another kind of unit finds nothing to read
    assert read("decode_attn_roofline", "bakllava.caption_exact_b64", pre)[0] is None
    assert read("extend_attn_roofline", "llavanext.pope_prefix", cap)[0] is None


def test_the_idle_share_takes_the_untraced_units_time():
    from types import SimpleNamespace

    from benchmark import registry
    from benchmark.peaks import H100

    trace = SimpleNamespace(busy_s=lambda: 3.0, window_s=9.0)
    ctx = SimpleNamespace(trace=trace, unit_s=[5.0, 7.0], peaks=H100)
    assert registry.metric_reader("device_idle_pct.caption")(ctx) == 50.0
