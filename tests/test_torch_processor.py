"""The port's input processing (``utils/processor.py``) bit-equal to the
JAX package's on seeded images of several aspect ratios, and the port's
``PrefetchLoader`` (``utils/native_image.py``): order, bounded look-ahead,
errors raised where their image would have been."""
import json
import threading
import time

import numpy as np
import pytest
from PIL import Image

from dropoutdecoding_tpu.utils import processor as jproc
from dropoutdecoding_tpu_torch.utils import processor as tproc
from dropoutdecoding_tpu_torch.utils.native_image import PrefetchLoader

SIZES = [(40, 52), (52, 40), (336, 336), (480, 640), (640, 427), (100, 30), (13, 333)]  # (h, w)
PINPOINTS = [[336, 672], [672, 336], [672, 672], [1008, 336], [336, 1008]]


def _image(h, w, seed=0):
    rng = np.random.default_rng(seed + 7 * h + w)
    return Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8), "RGB")


@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_clip_preprocessor_bit_equal(size):
    img = _image(*size)
    for kw in ({}, {"size": 224, "crop_size": 200}, {"resample": "bilinear"}):
        got = tproc.ClipImagePreprocessor(**kw)(img)
        want = jproc.ClipImagePreprocessor(**kw)(img)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_llavanext_preprocessor_bit_equal(size):
    img = _image(*size)
    for pinpoints, tile in ((PINPOINTS, 336), ([[28, 56], [56, 28], [56, 56]], 28)):
        (tiles, orig) = tproc.LlavaNextImagePreprocessor(pinpoints, tile_size=tile)(img)
        (want, worig) = jproc.LlavaNextImagePreprocessor(pinpoints, tile_size=tile)(img)
        assert orig == worig == size
        np.testing.assert_array_equal(tiles, want)


def test_from_checkpoint_reads_the_preprocessor_config(tmp_path):
    cfg = {
        "size": {"shortest_edge": 224}, "crop_size": {"height": 200, "width": 200},
        "image_mean": [0.5, 0.4, 0.3], "image_std": [0.2, 0.25, 0.3],
        "image_grid_pinpoints": [[224, 448], [448, 224]],
    }
    (tmp_path / "preprocessor_config.json").write_text(json.dumps(cfg))
    img = _image(90, 130)
    for cls in ("ClipImagePreprocessor", "LlavaNextImagePreprocessor"):
        got = getattr(tproc, cls).from_checkpoint(str(tmp_path))(img)
        want = getattr(jproc, cls).from_checkpoint(str(tmp_path))(img)
        got, want = (got[0], want[0]) if isinstance(got, tuple) else (got, want)
        np.testing.assert_array_equal(got, want)


class _Tok:
    """A tokenizer with the ``transformers`` surface VlmProcessor uses."""

    eos_token_id = 2

    def __call__(self, text, return_tensors=None):
        return {"input_ids": np.array([[1] + [3 + len(w) for w in text.split()]], np.int64)}

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"w{i}" for i in ids)


def test_vlm_processor_matches():
    img = _image(60, 80)
    ours = tproc.VlmProcessor(_Tok(), tproc.ClipImagePreprocessor(size=56))
    ref = jproc.VlmProcessor(_Tok(), jproc.ClipImagePreprocessor(size=56))
    got, want = ours("USER: <image>\nDescribe the image.", img), ref("USER: <image>\nDescribe the image.", img)
    assert sorted(got) == sorted(want) == ["input_ids", "pixel_values"]
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert ours.decode(np.array([5, 6])) == ref.decode(np.array([5, 6])) == "w5 w6"
    np.testing.assert_array_equal(ours.qformer_ids("a b"), ref.qformer_ids("a b"))


def test_prefetch_keeps_order_and_bounds_lookahead():
    started, lock = [], threading.Lock()

    def slow(i):
        with lock:
            started.append(i)
        time.sleep(0.002 * ((i * 7) % 5))  # out-of-order finishes
        return i * i

    loader = PrefetchLoader(range(40), slow, depth=3, workers=4)
    got = []
    for path, res in loader:
        with lock:
            assert max(started) < path + 1 + 3  # never more than depth ahead
        got.append((path, res))
        time.sleep(0.001)
    assert got == [(i, i * i) for i in range(40)]
    for t in loader.workers:
        t.join(timeout=5)
        assert not t.is_alive()


def test_prefetch_raises_at_the_failing_image():
    def fn(i):
        if i == 3:
            raise OSError("bad jpeg 3")
        return i

    seen = []
    with pytest.raises(OSError, match="bad jpeg 3"):
        for path, res in PrefetchLoader(range(6), fn, depth=2, workers=2):
            seen.append(res)
    assert seen == [0, 1, 2]
