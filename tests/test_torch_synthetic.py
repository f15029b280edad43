"""The port's synthetic world (`patchioner_tpu_torch/train/synthetic.py`)
against the JAX package's module, on the CPU: the same combos, splits,
captions, traces and masks, bit-equal renders and training batches for
the same `np.random.Generator` seed, and `write_eval_dataset`'s
annotation JSON and decoded JPEG pixels equal file for file. Exact
equality throughout: both are the same numpy and PIL arithmetic.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from patchioner_tpu.train import synthetic as jsynth
from patchioner_tpu_torch.train import synthetic

WORLDS = [
    (None, None, None),
    (("red", "green", "blue", "yellow"), ("square", "circle", "cross"), None),
    (("red",), ("triangle", "diamond"), ("top left", "bottom right")),
]


def _pairs(vocab):
    return jsynth.all_combos(*vocab), synthetic.all_combos(*vocab)


def test_vocabulary_is_the_jax_modules():
    assert synthetic.COLORS == jsynth.COLORS
    assert synthetic.SHAPES == jsynth.SHAPES
    assert synthetic.POSITIONS == jsynth.POSITIONS
    assert synthetic.__all__ == jsynth.__all__


@pytest.mark.parametrize("vocab", WORLDS)
def test_combos_and_captions_match(vocab):
    ref, got = _pairs(vocab)
    assert [dataclass_tuple(c) for c in got] == [dataclass_tuple(c) for c in ref]
    assert [c.caption for c in got] == [c.caption for c in ref]
    assert synthetic.caption_for("red", "cross", "top left") == "a red cross in the top left"


def dataclass_tuple(c):
    return c.color, c.shape, c.position


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("held_out", [6, 16])
def test_split_combos_matches(seed, held_out):
    ref, got = _pairs(WORLDS[0])
    rt, rh = jsynth.split_combos(ref, held_out, seed=seed)
    gt, gh = synthetic.split_combos(got, held_out, seed=seed)
    assert [c.caption for c in gt] == [c.caption for c in rt]
    assert [c.caption for c in gh] == [c.caption for c in rh]


@pytest.mark.parametrize("shape", jsynth.SHAPES)
@pytest.mark.parametrize("img_size", [56, 84])
def test_render_combo_is_bit_equal(shape, img_size):
    for i, position in enumerate(jsynth.POSITIONS):
        ref = jsynth.render_combo(jsynth.Combo("purple", shape, position),
                                  np.random.default_rng(i), img_size)
        got = synthetic.render_combo(synthetic.Combo("purple", shape, position),
                                     np.random.default_rng(i), img_size)
        assert got.dtype == np.uint8 and np.array_equal(got, ref)


def test_unknown_shape_raises_in_both():
    for mod in (jsynth, synthetic):
        with pytest.raises(ValueError, match="unknown shape"):
            mod.render_combo(mod.Combo("red", "star", "top left"), np.random.default_rng(0))


@pytest.mark.parametrize("seed", [0, 3])
def test_training_batch_and_generator_state_match(seed):
    ref, got = _pairs(WORLDS[1])
    rr, gr = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(2):  # the generator's state carries over batch to batch
        idx = rr.permutation(len(ref))[:12]
        assert np.array_equal(gr.permutation(len(got))[:12], idx)
        a = jsynth.render_training_batch([ref[i] for i in idx], rr, 56)
        b = synthetic.render_training_batch([got[i] for i in idx], gr, 56)
        assert b.shape == (12, 56, 56, 3) and np.array_equal(a, b)


@pytest.mark.parametrize("n_points", [1, 12])
def test_traces_match(n_points):
    ref, got = _pairs(WORLDS[0])
    rr, gr = np.random.default_rng(4), np.random.default_rng(4)
    for r, g in zip(ref, got):
        assert synthetic.trace_for(g, gr, n_points) == jsynth.trace_for(r, rr, n_points)


@pytest.mark.parametrize("grid", [4, 8])
def test_patch_masks_match(grid):
    ref, got = _pairs(WORLDS[0])
    for r, g in zip(ref, got):
        m = synthetic.patch_mask_for(g, grid)
        assert m.dtype == bool and np.array_equal(m, jsynth.patch_mask_for(r, grid))


@pytest.mark.parametrize("samples_per_combo", [1, 2])
def test_eval_dataset_files_match(tmp_path, samples_per_combo):
    ref, got = _pairs(WORLDS[2])
    kw = dict(samples_per_combo=samples_per_combo, img_size=56, seed=11)
    a = jsynth.write_eval_dataset(str(tmp_path / "jax"), ref, **kw)
    b = synthetic.write_eval_dataset(str(tmp_path / "port"), got, **kw)
    assert os.path.basename(a) == os.path.basename(b) == "synth_trace_test.json"
    ann_a, ann_b = json.load(open(a)), json.load(open(b))
    assert ann_b == ann_a and len(ann_b) == len(got) * samples_per_combo
    for img_id in ann_a:
        pa = np.asarray(Image.open(tmp_path / "jax" / "images" / f"{img_id}.jpg"))
        pb = np.asarray(Image.open(tmp_path / "port" / "images" / f"{img_id}.jpg"))
        assert pb.shape == (56, 56, 3) and np.array_equal(pa, pb)
