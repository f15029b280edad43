"""The port's region pooling (`patchioner_tpu_torch/ops/region_pooling.py`)
against its JAX twins (`patchioner_tpu/ops/region_pooling.py`) on the same
seeded numpy inputs. Tolerance: 1e-6 * max(1, max|ref|) in f32 where the
two sum in another order or take exp from another library; exact where the
function is exact (grid coordinates, masks, uniform and one-hot weights)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchioner_tpu.ops import region_pooling as jrp
from patchioner_tpu_torch.ops import region_pooling as rp

PATCH = 14


def _close(got, want):
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 1e-6 * max(1.0, np.max(np.abs(want)))


def _exact(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _boxes(g, seed, b=3, nb=6):
    """(b, nb, 4) pixel boxes on a g x g grid: random ones, some running
    past the grid's edge, a one-patch box, the server's [0, 0, 1, 1] pad and
    a [-1] * 4 dummy."""
    rng = np.random.default_rng(seed)
    size = g * PATCH
    xy = rng.uniform(0, size, (b, nb, 2))
    wh = rng.uniform(0, size, (b, nb, 2))
    boxes = np.concatenate([xy, wh], axis=-1).astype(np.float32)
    boxes[:, 0] = [PATCH, PATCH, 0, 0]
    boxes[:, 1] = [0, 0, 1, 1]
    boxes[1, 2] = -1
    boxes[2, 3] = [size - 3, 2, 40, size]  # past the right and bottom edges
    return boxes


def _tokens(g, seed, b=3, d=16):
    return np.random.default_rng(seed).standard_normal((b, g * g, d)).astype(np.float32)


def _attention(g, seed, b=3):
    a = np.random.default_rng(seed).uniform(0, 1, (b, g * g)).astype(np.float32)
    return a / a.sum(-1, keepdims=True)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("g", [4, 5])
def test_grid_boxes_and_inside_masks_match(g):
    boxes = _boxes(g, 0)
    gb = rp.bboxes_to_grid(_t(boxes), PATCH)
    _exact(gb, jrp.bboxes_to_grid(jnp.asarray(boxes), PATCH))
    assert gb.dtype == torch.int32
    _exact(rp._box_inside_mask(gb, g), jrp._box_inside_mask(jnp.asarray(gb.numpy()), g))
    # inclusive ends: a box of one patch width spans two columns
    assert rp._box_inside_mask(torch.tensor([0, 0, 1, 0], dtype=torch.int32), g).sum() == 2


@pytest.mark.parametrize("g", [4, 5])
def test_uniform_box_weights_match(g):
    gb = np.asarray(jrp.bboxes_to_grid(jnp.asarray(_boxes(g, 1)), PATCH))
    _exact(rp._uniform_box_weights(_t(gb), g), jrp._uniform_box_weights(jnp.asarray(gb), g))


@pytest.mark.parametrize("variance,even_center", [
    (0.0, "low"), (0.0, "high"), (0.5, "low"), (0.7, "low")])
@pytest.mark.parametrize("g", [4, 5])
def test_gaussian_box_weights_match(g, variance, even_center):
    gb = np.asarray(jrp.bboxes_to_grid(jnp.asarray(_boxes(g, 2)), PATCH))
    got = rp._gaussian_box_weights(_t(gb), g, variance, even_center=even_center)
    want = jrp._gaussian_box_weights(jnp.asarray(gb), g, variance, even_center=even_center)
    (_exact if variance == 0 else _close)(got, want)


def test_gaussian_span_is_clipped_at_the_grid_edge():
    # a box from row 2 nominally 5 rows long on a 4-row grid weights rows 2
    # and 3 as linspace(-1, 1, 2): its rows sum to the same
    gb = torch.tensor([[0, 2, 0, 4]], dtype=torch.int32)
    w = rp._gaussian_box_weights(gb, 4, 0.5)[0]
    rows = w.sum(dim=-1)
    assert rows[:2].sum() == 0 and torch.allclose(rows[2], rows[3])


def test_random_even_center_picks_a_central_patch_per_axis():
    # a 2 x 2 box (grid span 2 on each axis) at the origin: each draw is
    # one-hot at row 0 or 1 and column 0 or 1, the axes independently
    gb = torch.tensor([[0, 0, 1, 1]] * 64, dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    w = rp._gaussian_box_weights(gb, 4, 0.0, even_center="random", generator=gen)
    assert torch.all(w.sum(dim=(-2, -1)) == 1)
    ys, xs = (w.amax(dim=d).argmax(dim=-1) for d in (-1, -2))
    assert set(ys.tolist()) == {0, 1} and set(xs.tolist()) == {0, 1}
    assert (ys != xs).any()  # not one draw shared by both axes
    with pytest.raises(ValueError, match="Generator"):
        rp._gaussian_box_weights(gb, 4, 0.0, even_center="random")


@pytest.mark.parametrize("g", [4, 5])
def test_attention_box_weights_match_in_order(g):
    # overlapping boxes: a later box sees the attention an earlier one
    # normalised; the [-1] * 4 dummy gives a zero map
    boxes = _boxes(g, 3)
    boxes[0, 2] = [0, 0, 2 * PATCH, 2 * PATCH]
    boxes[0, 3] = [PATCH, PATCH, 2 * PATCH, 2 * PATCH]
    gb = np.asarray(jrp.bboxes_to_grid(jnp.asarray(boxes), PATCH))
    attn = _attention(g, 4).reshape(-1, g, g)
    w, final = rp._attention_box_weights(_t(gb), _t(attn))
    jw, jfinal = jrp._attention_box_weights(jnp.asarray(gb), jnp.asarray(attn))
    _close(w, jw)
    _close(final, jfinal)
    assert torch.all(w[1, 2] == 0) and torch.isfinite(w).all()


@pytest.mark.parametrize("kw", [
    dict(), dict(gaussian_avg=True, gaussian_bbox_variance=0.7),
    dict(gaussian_avg=True, gaussian_bbox_variance=0.0),
    dict(attention=True), dict(attention=True, gaussian_avg=True)],
    ids=["uniform", "gaussian", "onehot", "attention", "attention_over_gaussian"])
def test_bbox_weight_maps_match_with_the_mode_priority(kw):
    g = 5
    kw = dict(kw)
    boxes = _boxes(g, 5)
    attn = _attention(g, 6) if kw.pop("attention", False) else None
    got = rp.bbox_weight_maps(_t(boxes), g, PATCH, attention_map=None if attn is None
                              else _t(attn), **kw)
    want = jrp.bbox_weight_maps(jnp.asarray(boxes), g, PATCH, attention_map=None
                                if attn is None else jnp.asarray(attn), **kw)
    _close(got, want)


FEATURE_MODES = {
    "uniform": dict(),
    "gaussian_0.5": dict(gaussian_avg=True, gaussian_bbox_variance=0.5),
    "gaussian_0.7": dict(gaussian_avg=True, gaussian_bbox_variance=0.7),
    "gaussian_0_low": dict(gaussian_avg=True, gaussian_bbox_variance=0.0),
    "gaussian_0_high": dict(gaussian_avg=True, gaussian_bbox_variance=0.0,
                            even_center="high"),
    "attention": dict(attention=True),
}


def _feature_args(g, seed, mode):
    kw = dict(FEATURE_MODES[mode])
    attn = _attention(g, seed + 2) if kw.pop("attention", False) else None
    return _boxes(g, seed), _tokens(g, seed + 1), attn, kw


@pytest.mark.parametrize("mode", FEATURE_MODES)
@pytest.mark.parametrize("g", [4, 5])
def test_extract_bbox_features_match(g, mode):
    boxes, tokens, attn, kw = _feature_args(g, 10, mode)
    got = rp.extract_bbox_features(_t(tokens), _t(boxes), patch_size=PATCH,
                                   attention_map=None if attn is None else _t(attn), **kw)
    want = jrp.extract_bbox_features(jnp.asarray(tokens), jnp.asarray(boxes),
                                     patch_size=PATCH, attention_map=None if attn is None
                                     else jnp.asarray(attn), **kw)
    _close(got, want)
    assert torch.all(got[1, 2] == 0)  # the [-1] * 4 dummy pools a zero feature


@pytest.mark.parametrize("mode", FEATURE_MODES)
@pytest.mark.parametrize("g", [4, 5])
def test_extract_bbox_features_single_match(g, mode):
    boxes, tokens, attn, kw = _feature_args(g, 20, mode)
    got = rp.extract_bbox_features_single(
        _t(tokens), _t(boxes), patch_size=PATCH,
        attention_map=None if attn is None else _t(attn), **kw)
    want = jrp.extract_bbox_features_single(
        jnp.asarray(tokens), jnp.asarray(boxes), patch_size=PATCH,
        attention_map=None if attn is None else jnp.asarray(attn), **kw)
    _close(got, want)


def test_region_set_skips_its_dummy_boxes():
    g = 4
    boxes = np.full((1, 3, 4), -1, np.float32)
    boxes[0, 0] = [0, 0, PATCH, PATCH]
    tokens = _t(_tokens(g, 30, b=1))
    got = rp.extract_bbox_features_single(tokens, _t(boxes), patch_size=PATCH)
    alone = rp.extract_bbox_features_single(tokens, _t(boxes[:, :1]), patch_size=PATCH)
    torch.testing.assert_close(got, alone, rtol=0, atol=0)


@pytest.mark.parametrize("variance,even_center", [
    (0.0, "low"), (0.0, "high"), (0.5, "low"), (1.0, "low"), (100.0, "low")])
@pytest.mark.parametrize("g", [4, 5, 37])
def test_compute_region_means_match(g, variance, even_center):
    tokens = _tokens(g, 40 + g, b=2)
    got = rp.compute_region_means(_t(tokens), variance, even_center=even_center)
    want = jrp.compute_region_means(jnp.asarray(tokens), variance, even_center=even_center)
    _close(got, want)


def test_compute_region_means_random_center_is_a_central_patch():
    g = 4
    tokens = _t(np.eye(g * g, dtype=np.float32)[None].repeat(64, axis=0))
    gen = torch.Generator().manual_seed(1)
    w = rp.compute_region_means(tokens, 0.0, even_center="random", generator=gen)
    ys, xs = w.argmax(dim=-1) // g, w.argmax(dim=-1) % g
    assert torch.all(w.sum(dim=-1) == 1)
    assert set(ys.tolist()) == {1, 2} and set(xs.tolist()) == {1, 2} and (ys != xs).any()


@pytest.mark.parametrize("attn", [False, True])
def test_trace_pooling_matches(attn):
    g = 5
    rng = np.random.default_rng(50)
    pts = rng.uniform(-0.2, 1.2, (3, 16, 2)).astype(np.float32)
    valid = (rng.uniform(0, 1, (3, 16)) > 0.2).astype(np.float32)
    grid = rp.traces_to_grid(_t(pts), _t(valid), g)
    jgrid = jrp.traces_to_grid(jnp.asarray(pts), jnp.asarray(valid), g)
    _exact(grid, jgrid)
    tokens, a = _tokens(g, 51), _attention(g, 52) if attn else None
    _close(rp.trace_pool(_t(tokens), grid, None if a is None else _t(a)),
           jrp.trace_pool(jnp.asarray(tokens), jgrid, None if a is None else jnp.asarray(a)))
