"""The port's framework-free eval twins against the JAX package's: the
caption metrics (BLEU-1..4, METEOR with all four stages, ROUGE-L, CIDEr-D,
SPICE and its per-category P/R/F) corpus and per instance to 1e-12, on
`tests/test_metric_reference_parity.py`'s split and on 64 seeded captions;
the Porter stemmer over a seeded word list; dense-captioning mAP and its
IoU x METEOR table; the box remaps of `utils/geometry.py`;
`CocoAnnotations`; `load_dotenv`; `variant_markers`; and the PAC-S
rendering of `utils/drawing.py`, pixel for pixel.
"""

import json

import numpy as np
import pytest

from patchioner_tpu.eval import densecap_map as jmap
from patchioner_tpu.eval import metrics as jmetrics
from patchioner_tpu.eval import spice as jspice
from patchioner_tpu.io import coco as jcoco
from patchioner_tpu.text import porter as jporter
from patchioner_tpu.utils import drawing as jdrawing
from patchioner_tpu.utils import env as jenv
from patchioner_tpu.utils import geometry as jgeometry
from patchioner_tpu_torch.eval import densecap_map, metrics, spice
from patchioner_tpu_torch.io import coco
from patchioner_tpu_torch.text import porter
from patchioner_tpu_torch.utils import drawing, env, geometry
from test_metric_reference_parity import CANDS, REFS, _SPICE_WORDS

TOL = 1e-12
WORDS = tuple(sorted(set(_SPICE_WORDS) | {
    "dogs", "running", "runs", "cats", "standing", "stands", "happily", "generously",
    "relational", "conditional", "rational", "hopeful", "goodness", "electricity",
    "adjustable", "formality", "sensitivity", "people", "horses", "beaches", "riding",
    "sheep", "grassy", "fields", "plates", "tables", "pizza", "pizzas", "sat", "sits"}))


def _seeded(n: int, seed: int):
    """n candidates with 1-3 references each, 3-10 words of WORDS."""
    rng = np.random.default_rng(seed)

    def sent():
        return " ".join(rng.choice(WORDS, int(rng.integers(3, 11))))

    return ([sent() for _ in range(n)],
            [[sent() for _ in range(int(rng.integers(1, 4)))] for _ in range(n)])


SPLITS = {"reference_parity_split": (CANDS, REFS), "seeded_64": _seeded(64, 11)}


def _close(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _close(a, b)
    elif isinstance(want, float):
        assert abs(got - want) <= TOL, (got, want)
    else:
        assert got == want


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("synonyms", [None, "groups"])
def test_all_metrics_equal_jax(split, synonyms):
    cands, refs = SPLITS[split]
    # a synonym table, so that METEOR's third stage and SPICE's synonym
    # matching run (no WordNet corpus is needed for the comparison)
    syn = None if synonyms is None else (lambda w: frozenset({w[:3]}))
    got = metrics.compute_all_metrics(cands, refs, synonyms=syn)
    want = jmetrics.compute_all_metrics(cands, refs, synonyms=syn)
    assert list(got) == list(want) == ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L",
                                       "CIDEr", "METEOR", "SPICE"]
    _close(got, want)


@pytest.mark.parametrize("split", SPLITS)
def test_each_scorer_and_spice_categories_equal_jax(split):
    cands, refs = SPLITS[split]
    cand_t = [metrics.ptb_tokenize(c) for c in cands]
    refs_t = [[metrics.ptb_tokenize(r) for r in rs] for rs in refs]
    assert cand_t == [jmetrics.ptb_tokenize(c) for c in cands]
    for name in ("bleu", "rouge_l", "cider_d"):
        _close(getattr(metrics, name)(cand_t, refs_t), getattr(jmetrics, name)(cand_t, refs_t))
    # the four METEOR stages: exact, stem, synonym and paraphrase tables
    syn = lambda w: frozenset({w[:2]})  # noqa: E731
    para = {"a dog": frozenset({1}), "the cat": frozenset({1}), "on the": frozenset({2}),
            "near": frozenset({2}), "sitting on": frozenset({3}), "riding": frozenset({3})}
    for kw in (dict(), dict(synonyms=syn), dict(synonyms=syn, paraphrases=para.get)):
        _close(metrics.meteor(cand_t, refs_t, **kw), jmetrics.meteor(cand_t, refs_t, **kw))
    lex = spice.SpiceLexicon.vendored()
    jlex = jspice.SpiceLexicon.vendored()
    for toks in cand_t + [r for rs in refs_t for r in rs]:
        assert spice.parse_scene_graph(toks, lex) == jspice.parse_scene_graph(toks, jlex)
    for kw in (dict(), dict(synonyms=syn)):
        got = spice.spice(cand_t, refs_t, lexicon=lex, **kw)
        want = jspice.spice(cand_t, refs_t, lexicon=jlex, **kw)
        assert [sorted(e) for e in got[1]] == [["All", "Attribute", "Object", "Relation"]] * len(
            cand_t)
        _close(got, want)


def test_variant_markers_equal_jax():
    for syn in ("auto", None, lambda w: {w}):
        assert metrics.variant_markers(synonyms=syn) == jmetrics.variant_markers(synonyms=syn)
    assert metrics.variant_markers(synonyms=None) == {
        "METEOR_variant": "exact+stem", "SPICE_variant": "lexicon/exact+stem"}


def test_porter_stemmer_equals_jax():
    rng = np.random.default_rng(5)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    suffixes = ("ing", "ed", "s", "es", "ies", "ational", "tional", "izer", "ousness", "iveness",
                "fulness", "ality", "ement", "ment", "ent", "ion", "ous", "ive", "ize", "ly",
                "bli", "logi", "alli", "eli", "ousli", "ization", "ation", "ator", "alism", "e",
                "ll", "icate", "ative", "alize", "iciti", "ical", "ful", "ness", "able", "ible")
    words = list(WORDS) + ["".join(rng.choice(letters, int(rng.integers(1, 9)))) +
                           str(rng.choice(suffixes)) for _ in range(2000)]
    assert [porter.stem(w) for w in words] == [jporter.stem(w) for w in words]


def _boxes(rng, n, image_ids):
    return [{"image_id": int(rng.choice(image_ids)),
             "bbox": [float(v) for v in np.concatenate(
                 [rng.uniform(0, 60, 2), rng.uniform(1, 40, 2)])]} for _ in range(n)]


def test_densecap_map_equals_jax():
    rng = np.random.default_rng(9)
    cands, refs = _seeded(40, 12)
    gts = [dict(b, caption=r[0]) for b, r in zip(_boxes(rng, 40, [1, 2, 3]), refs)]
    preds = [dict(b, caption=c, score=float(rng.uniform())) for b, c in
             zip(_boxes(rng, 30, [1, 2, 3]), cands)]
    # predictions on the very boxes, some with their own captions
    preds += [dict(g, caption=g["caption"] if i % 2 else cands[i], score=float(rng.uniform()))
              for i, g in enumerate(gts[:20])]
    for kw in (dict(), dict(iou_thresholds=(0.2, 0.5), meteor_thresholds=(0.0, 0.3))):
        got = densecap_map.densecap_map(preds, gts, **kw)
        want = jmap.densecap_map(preds, gts, **kw)
        assert got["ap_table"].keys() == want["ap_table"].keys()
        _close(got["map"], want["map"])
        _close(list(got["ap_table"].values()), list(want["ap_table"].values()))
    assert 0.0 < got["map"] < 1.0
    assert densecap_map.IOU_THRESHOLDS == jmap.IOU_THRESHOLDS
    assert densecap_map.METEOR_THRESHOLDS == jmap.METEOR_THRESHOLDS
    for a, b in zip(_boxes(rng, 50, [1]), _boxes(rng, 50, [1])):
        assert densecap_map.iou_xywh(a["bbox"], b["bbox"]) == jmap.iou_xywh(a["bbox"], b["bbox"])


def test_geometry_equals_jax():
    rng = np.random.default_rng(3)
    for _ in range(200):
        w, h = (int(v) for v in rng.integers(20, 900, 2))
        box = [float(rng.uniform(0, w)), float(rng.uniform(0, h)),
               float(rng.uniform(0, w)), float(rng.uniform(0, h))]
        resize, crop = int(rng.integers(56, 600)), int(rng.integers(56, 600))
        assert (geometry.adjust_bbox_for_transform(w, h, box, resize, crop)
                == jgeometry.adjust_bbox_for_transform(w, h, box, resize, crop))
        assert (geometry.adjust_bbox_for_transform_no_scale(w, h, box, resize, crop)
                == jgeometry.adjust_bbox_for_transform_no_scale(w, h, box, resize, crop))


def test_coco_annotations_equal_jax(tmp_path):
    data = {"images": [{"id": i, "file_name": f"{i:012d}.jpg"} for i in (5, 1, 9)],
            "annotations": [{"id": j, "image_id": (5, 1, 9)[j % 3], "caption": f"c{j}"}
                            for j in range(7)], "categories": []}
    path = tmp_path / "captions.json"
    path.write_text(json.dumps(data))
    got, want = coco.CocoAnnotations(str(path)), jcoco.CocoAnnotations(str(path))
    assert got.image_ids == want.image_ids == [5, 1, 9]
    assert got.imgs == want.imgs and got.anns == want.anns
    assert dict(got.img_to_anns) == dict(want.img_to_anns)
    assert got.load_imgs([9, 5]) == want.load_imgs([9, 5]) and got.load_imgs(1) == want.load_imgs(1)


def test_load_dotenv_equals_jax(tmp_path, monkeypatch):
    path = tmp_path / ".env"
    path.write_text("\n".join([
        "# a comment", "", "PT_EVAL_A=1", "export PT_EVAL_B = two words ",
        'PT_EVAL_C="quoted # kept" # dropped', "PT_EVAL_D='single'", "PT_EVAL_E=x # note",
        "PT_EVAL_F=#only", "no equals sign", "PT_EVAL_G=kept-from-env"]))
    results = []
    for load in (env.load_dotenv, jenv.load_dotenv):
        for key in "ABCDEF":
            monkeypatch.delenv(f"PT_EVAL_{key}", raising=False)
        monkeypatch.setenv("PT_EVAL_G", "from-env")
        loaded = load(str(path))
        results.append((loaded, {k: v for k, v in __import__("os").environ.items()
                                 if k.startswith("PT_EVAL_")}))
        assert load(str(tmp_path / "absent.env")) == {}
    assert results[0] == results[1]
    assert results[0][0]["PT_EVAL_C"] == "quoted # kept"
    assert results[0][1]["PT_EVAL_G"] == "from-env"


def test_drawing_equals_jax():
    from PIL import Image

    rng = np.random.default_rng(4)
    img = Image.fromarray(rng.integers(0, 256, (60, 90, 3), dtype=np.uint8))
    trace = [{"x": float(x), "y": float(y)} for x, y in rng.uniform(-0.2, 1.2, (40, 2))]
    got = drawing.draw_trace_points(img, trace)
    want = jdrawing.draw_trace_points(img, trace)
    assert np.array_equal(np.asarray(got), np.asarray(want))
    assert not np.array_equal(np.asarray(got), np.asarray(img))
    boxes = [[5, 5, 40, 30], [20, 10, 80, 55]]
    got = drawing.draw_bounding_boxes(img, boxes, captions=["a dog", ""])
    want = jdrawing.draw_bounding_boxes(img, boxes, captions=["a dog", ""])
    assert np.array_equal(np.asarray(got), np.asarray(want))
