"""The port's copy of the evalsuite (``dropoutdecoding_tpu_torch/evalsuite``,
``cli/chair2throne.py``) against the JAX package's original, function by
function: each case runs once through each package on the same input, and
the results must be equal (the copies are the same pure-Python code, so
equal means equal, floats included).

The inputs are those of ``tests/test_evalsuite.py``,
``tests/test_metrics_golden.py`` and ``tests/test_throne.py``.
"""
import importlib
import json

import pytest

JAX, PORT = "dropoutdecoding_tpu", "dropoutdecoding_tpu_torch"


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


# --- inputs ------------------------------------------------------------------

SINGULARIZE = [
    "dogs", "people", "men", "women", "children", "benches", "knives", "buses", "couches",
    "sandwiches", "pizzas", "giraffes", "bananas", "oranges", "cars", "boxes", "wolves",
    "vases", "gloves", "microwaves", "shoes", "glasses", "scissors", "movies", "has", "his",
    "was", "this", "its", "bus", "glass", "various", "slice", "skis",
]
CAPTIONS = [
    "A man riding a horse. He smiles!",
    "A baby dog chases a hot dog near the stop sign.",
    "the seat of the toilet is up",
    "a puppy and a kitten on a sofa",
    "Two giraffes standing by the wine glasses, next to a teddy bear.",
]
PTB = [
    "A man, riding; a horse.",
    "The dog doesn't run.",
    "I can't believe it's the dog's ball!",
    "He cannot swim; she won't either.",
    "A well-known artist -- truly great (I think).",
    "It is 1.5 meters tall, costing $3.50.",
    '"Quoted text" and \'single\' quotes',
    "We're gonna win... maybe",
    "ends with dots...",
    "multi  \n whitespace",
]
# (hyps, refs) of the metric goldens
METRIC_PAIRS = [
    ({1: ["the cat sat on the mat"]}, {1: ["the cat sat on a mat", "a cat was sitting on the mat"]}),
    ({1: ["a b c d"]}, {1: ["a b c d e", "a b"]}),
    ({1: ["a b c d"]}, {1: ["a b c", "a b c d e"]}),
    ({1: ["x y z w"]}, {1: ["x q r s"]}),
    ({1: ["a b"], 2: ["c d e f"]}, {1: ["a x"], 2: ["c x y z"]}),
    ({1: ["a b c d"]}, {1: ["a b c x", "d"]}),
    ({1: ["a b"]}, {1: ["x y"]}),
    ({1: ["a cat sat"]}, {1: ["a cat sat"]}),
    ({1: ["a b c d e"], 2: ["v w x y z"]}, {1: ["a b c d e"], 2: ["v w x y z"]}),
    ({1: ["a a"], 2: ["q r s t"]}, {1: ["a"], 2: ["q r s t"]}),
    ({1: ["the cat"]}, {1: ["the cat sat"]}),
    ({1: ["happy"]}, {1: ["happiness"]}),
    ({1: ["the"]}, {1: ["the cat"]}),
    ({1: ["d c b a"]}, {1: ["a b c d"]}),
    ({1: ["the cat sat on the mat"]}, {1: ["a cat sat on a mat", "the dog and the cat"]}),
    ({1: ["the of and"]}, {1: ["cat"]}),
]
INSTANCES = {
    "categories": [{"id": 1, "name": "dog"}, {"id": 2, "name": "frisbee"}],
    "annotations": [
        {"image_id": 1, "category_id": 1},
        {"image_id": 1, "category_id": 2},
        {"image_id": 2, "category_id": 1},
    ],
}
GT_CAPTIONS = {
    "annotations": [
        {"image_id": 1, "caption": "a dog catching a frisbee"},
        {"image_id": 2, "caption": "two dogs playing in the park"},
    ]
}
SELF_CRITICAL = {
    "images": [{"id": 1, "file_name": "a.jpg"}, {"id": 2, "file_name": "b.jpg"}],
    "annotations": [
        {"id": 10, "image_id": 1, "caption": "a dog runs in the park"},
        {"id": 11, "image_id": 1, "caption": "a brown dog running"},
        {"id": 12, "image_id": 2, "caption": "a cat sits on a mat"},
    ],
}
THRONE = [
    {"image_id": 1, "response": "a dog sitting on a chair"},
    {"image_id": 2, "response": "a cat next to a dog"},
    {"image_id": 3, "response": "an empty room"},
]


def _evaluator(pkg):
    ev = _mod(pkg, "evalsuite.chair").ChairEvaluator([1, 2])
    ev.add_annotations_from_instances(INSTANCES)
    ev.add_annotations_from_captions(GT_CAPTIONS)
    return ev


def _chair_compute(pkg):
    caps = [
        {"image_id": 1, "caption": "a dog with a frisbee"},
        {"image_id": 2, "caption": "a dog next to a cat"},
    ]
    return _evaluator(pkg).compute(caps)


def _metric(name, fn):
    return lambda pkg: [getattr(_mod(pkg, f"evalsuite.metrics.{name}"), fn)(h, r) for h, r in METRIC_PAIRS]


def _self_critical(pkg, results):
    coco = _mod(pkg, "evalsuite.coco").Coco(dataset=SELF_CRITICAL)
    return _mod(pkg, "evalsuite.metrics.evalcap").chunked_self_critical_eval(coco, results)


CASES = {
    "word_tokenize": lambda pkg: [_mod(pkg, "evalsuite.text").word_tokenize(c) for c in CAPTIONS],
    "singularize": lambda pkg: [_mod(pkg, "evalsuite.text").singularize(w) for w in SINGULARIZE],
    "caption_to_words": lambda pkg: [_evaluator(pkg).caption_to_words(c) for c in CAPTIONS],
    "ChairEvaluator.compute": _chair_compute,
    "metric_table": lambda pkg: _mod(pkg, "evalsuite.chair").metric_table(_chair_compute(pkg)),
    "metric_table with notes": lambda pkg: _mod(pkg, "evalsuite.chair").metric_table({
        "overall_metrics": {
            "SPICE": 0.1, "METEOR": 0.2, "CIDEr": 0.0, "CHAIRs": 0.3, "CHAIRi": 0.07,
            "_metric_notes": dict(_mod(pkg, "evalsuite.metrics.evalcap").METRIC_NOTES),
        }
    }),
    "bleu_scores": _metric("bleu", "bleu_scores"),
    "CiderScorer": lambda pkg: [
        _mod(pkg, "evalsuite.metrics.cider").CiderScorer().compute(h, r) for h, r in METRIC_PAIRS
    ],
    "rouge_l": _metric("rouge", "rouge_l"),
    "meteor_lite": _metric("meteor", "meteor_lite"),
    "spice_lite": _metric("spice_lite", "spice_lite"),
    "ptb_tokenize": lambda pkg: [_mod(pkg, "evalsuite.metrics.evalcap").ptb_tokenize(s) for s in PTB],
    "chunked_self_critical_eval": lambda pkg: _self_critical(pkg, [
        {"image_id": 1, "caption": "a dog runs in the park"},
        {"image_id": 2, "caption": "a dog on a mat"},
    ]),
    "chunked_self_critical_eval, one image": lambda pkg: _self_critical(pkg, [
        {"image_id": 2, "caption": "a cat sitting on the mat"},
    ]),
    "evaluate_throne": lambda pkg: _mod(pkg, "evalsuite.throne").evaluate_throne(
        THRONE, {1: {"dog", "chair"}, 2: {"dog"}, 3: {"person"}}
    ),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_copy_matches_original(case):
    got, want = CASES[case](PORT), CASES[case](JAX)
    assert got == want
    assert want  # the case computed something


def _coco_dir(tmp_path):
    ann = tmp_path / "annotations"
    ann.mkdir()
    (ann / "captions_val2014.json").write_text(json.dumps(SELF_CRITICAL))
    (ann / "instances_val2014.json").write_text(json.dumps({**INSTANCES, "images": SELF_CRITICAL["images"]}))
    return tmp_path


def test_load_coco_data_matches(tmp_path):
    d = str(_coco_dir(tmp_path))
    (c1, a1), (c2, a2) = (_mod(pkg, "evalsuite.coco").load_coco_data(d) for pkg in (PORT, JAX))
    assert a1 == a2
    assert c1.getImgIds() == c2.getImgIds()
    assert c1.dataset == c2.dataset and dict(c1.imgToAnns) == dict(c2.imgToAnns)
    res = [{"image_id": 1, "caption": "a dog"}]
    assert c1.loadRes(res).dataset == c2.loadRes(res).dataset


def test_chair_annotations_and_throne_file_match(tmp_path):
    """``load_annotations`` from a COCO directory, ``convert`` of a caption
    JSONL with a duplicate, and ``evaluate_throne_file`` of the export."""
    d = _coco_dir(tmp_path)
    cap = tmp_path / "caps.jsonl"
    cap.write_text("".join(
        json.dumps({"image_id": i, "caption": t}) + "\n"
        for i, t in [(1, "a dog and a frisbee"), (2, "a cat"), (1, "dup ignored")]
    ))
    out = {}
    for pkg in (PORT, JAX):
        ev = _mod(pkg, "evalsuite.chair").ChairEvaluator([1, 2])
        ev.load_annotations(str(d / "annotations"))
        path = tmp_path / f"{pkg}.jsonl"
        n = _mod(pkg, "cli.chair2throne").convert(str(cap), str(path))
        score = _mod(pkg, "evalsuite.throne").evaluate_throne_file(
            str(path), {i: ev.imid_to_objects[i] for i in (1, 2)}
        )
        out[pkg] = (ev.imid_to_objects, n, path.read_text(), score)
    assert out[PORT] == out[JAX]
    assert out[JAX][1] == 2


def test_synonyms_file_is_the_same():
    import os

    files = [
        os.path.join(os.path.dirname(_mod(pkg, "evalsuite.chair").__file__), "data", "synonyms.txt")
        for pkg in (PORT, JAX)
    ]
    assert open(files[0]).read() == open(files[1]).read()
