"""The last of `Patchioner.forward`'s flags and `caption_tokens`' modes in
the port, against the JAX package on the CPU in f32 on the same bridged
weights, at the goldens' reduced geometry (`tests/test_golden_captions.py`:
a 140 px crop and a 256-row bank): DINOv2 ViT-B/14-reg cut to 2 blocks,
layerscale drawn near 1, a 2-layer, 128-wide DeCap decoder (wte x 20, so
that the greedy steps are peaked: `WTE_SCALE`).

- `memory_argmax` and `memory_topk_sims` on f32, bf16-stored and int8
  banks padded past `num_real`, k in {1, 5}, chunked and not; a tie takes
  the lowest index;
- `ctx_cleaner` for both types and its unknown-type ValueError;
- `forward(cleaning_type=...)` over the grid of types, orders and
  sources with patch, whole-image mean, box, trace and box-set captions,
  and on the int8 bank;
- `forward(get_attn_heads_capt=True)`, with and without scores and beside
  cleaning;
- `return_n_best_sims` through `caption_tokens`, the box path and the
  AlphaCLIP path;
- the argmax-text mode set on a built model (f32 and int8 banks), set by
  `from_config` on DINOv2, CLIP, ProxyCLIP and DINO.txt configs (no
  decoder built), and served by both packages' servers;
- each ValueError of the JAX package on these paths.
Captions are equal string for string, scores and similarities within
1e-4 relative.
"""

import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchioner_tpu.models import decap as jdecap
from patchioner_tpu.models import gpt2 as jgpt2
from patchioner_tpu.models import vit as jvit
from patchioner_tpu.models.patchioner import Patchioner as JaxPatchioner
from patchioner_tpu.ops import memory_projection as jmp
from patchioner_tpu.ops import region_pooling as jrp
from patchioner_tpu.serve import CaptionServer as JaxServer
from patchioner_tpu_torch.io import bridge
from patchioner_tpu_torch.models import gpt2, vit
from patchioner_tpu_torch.models.patchioner import Patchioner
from patchioner_tpu_torch.ops import memory_projection as mp
from patchioner_tpu_torch.ops import region_pooling as rp
from patchioner_tpu_torch.serve import CaptionServer

CROP, BANK_ROWS, D = 140, 256, 768
DEPTH = 2
DECAP_GEOM = dict(vocab_size=49408, n_layer=2, n_head=4, n_embd=128)
# A score is exp of 30 summed log-probabilities: f32 rounding of a logit
# (~1e-6 of it) moves log p by (1 - p) times that, so a decoder whose
# greedy tokens are not peaked lets the two packages' scores drift past 1e-4
# relative (up to 2.3e-4 on 768-wide prefixes at x 10). At x 20 p is near 1
# at every step and no near-tie flips a token.
WTE_SCALE = 20
TEXTS = [f"caption {i}" for i in range(BANK_ROWS)]
# JAX's prepare_bank pads the rows to a multiple of its block: 256 -> 300
BLOCK_M = 100


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # small tensors: intra-op threads only contend with the suite's workers
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_bank(kind: str, block_m: int = BLOCK_M):
    rows = jax.random.normal(jax.random.PRNGKey(3), (BANK_ROWS, D))
    if kind == "int8":
        return jmp.quantize_bank(rows, block_m=block_m)
    return jmp.prepare_bank(rows, block_m=BLOCK_M,
                            dtype=jnp.bfloat16 if kind == "bf16" else None)


def _real_rows(jbank):
    """(the JAX package's real bank rows, the port's) of one bank, through
    each package's `_bank_real_rows`."""
    return (np.asarray(JaxPatchioner._bank_real_rows(types.SimpleNamespace(bank=jbank))),
            Patchioner._bank_real_rows(types.SimpleNamespace(bank=bridge.bank_from_jax(jbank))))


@pytest.fixture(scope="module")
def models():
    """{bank kind: (JAX Patchioner, port Patchioner)} on one JAX init, for
    the f32 and the int8 bank."""
    jcfg = jvit.config_for("dinov2_vitb14_reg", img_size=CROP, depth=DEPTH)
    cfg = vit.config_for("dinov2_vitb14_reg", img_size=CROP, depth=DEPTH)
    params = jax.jit(jvit.init_vit, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    ls = np.random.default_rng(1).uniform(0.5, 1.5, (DEPTH, 2, D)).astype(np.float32)
    params["blocks"] = [dict(b, ls1=jnp.asarray(ls[i, 0]), ls2=jnp.asarray(ls[i, 1]))
                        for i, b in enumerate(params["blocks"])]
    jg = jgpt2.GPT2Config(**DECAP_GEOM)
    dec = jax.jit(jdecap.init_decap, static_argnums=(1, 2))(jax.random.PRNGKey(2), jg, D)
    dec = dec._replace(gpt2=dict(dec.gpt2, wte=dec.gpt2["wte"] * WTE_SCALE))
    out = {}
    for kind in ("f32", "int8"):
        # the JAX kernel H reads the int8 bank in blocks of 1024 rows
        bank = _jax_bank(kind, 1024 if kind == "int8" else BLOCK_M)
        jm = JaxPatchioner(vit_cfg=jcfg, vit_params=params, gpt2_cfg=jg, decoder=dec,
                           bank=bank, bank_texts=TEXTS, normalize=True)
        pm = Patchioner(vit_cfg=cfg, vit_params=bridge.vit_from_jax(params, cfg),
                        gpt2_cfg=gpt2.GPT2Config(**DECAP_GEOM),
                        decoder=bridge.decap_from_jax(dec), bank=bridge.bank_from_jax(bank),
                        bank_texts=TEXTS, normalize=True, device="cpu")
        out[kind] = (jm, pm)
    return out


@pytest.fixture(scope="module")
def imgs():
    return np.random.default_rng(0).integers(0, 256, (2, CROP, CROP, 3), dtype=np.uint8)


BOXES = np.asarray([[[0, 0, 70, 70], [28, 28, 84, 84], [0, 0, 1, 1]],
                    [[14, 14, 98, 98], [0, 0, 140, 40], [60, 4, 40, 100]]], np.float32)
SETS = np.asarray([[[0, 0, 70, 70], [28, 28, 84, 84]],
                   [[14, 14, 98, 98], [-1, -1, -1, -1]]], np.float32)
TRACES = [[{"x": 0.1, "y": 0.2}, {"x": 0.5, "y": 0.5}, {"x": 0.9, "y": 0.3}],
          [(0.3, 0.7), (0.35, 0.75)]]


def _equal(got, want, at):
    """Outputs equal: strings exactly, numbers within 1e-4 relative."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), at
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{at}[{i}]")
    elif isinstance(want, str):
        assert got == want, at
    else:
        assert got == pytest.approx(float(want), rel=1e-4, nan_ok=True), at


def _same_outputs(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key in want:
        _equal(got[key], want[key], key)


def _both(models, kind, imgs, **kw):
    """(the port's forward, the JAX package's) on the models of a bank
    kind. On the int8 bank the JAX side projects through its kernel H in
    interpret mode: its XLA path renormalises the dequantized rows, where
    H and the port score with the original rows' norms."""
    jm, pm = models[kind]
    got = pm.forward(imgs, **kw)
    if kind != "int8":
        return got, jm.forward(imgs, **kw)
    from jax.experimental.pallas import tpu as pltpu

    jm._use_pallas = True
    try:
        with pltpu.force_tpu_interpret_mode():
            return got, jm.forward(imgs, **kw)
    finally:
        jm._use_pallas = False


# ------------------------------------------------ argmax and top-k sims


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_memory_argmax_and_topk_sims_equal_jax(kind, k, monkeypatch):
    jbank = _jax_bank(kind)
    want_rows, rows = _real_rows(jbank)
    # the padded tail (300 rows stored, 256 real) is never scored
    assert jbank.rows.shape[0] == 300 and rows.shape == (BANK_ROWS, D)
    np.testing.assert_array_equal(rows.numpy(), want_rows)
    feats = np.random.default_rng(7).standard_normal((20, D)).astype(np.float32)
    want_idx = np.asarray(jmp.memory_argmax(jnp.asarray(feats), jnp.asarray(want_rows)))
    want_sims = np.asarray(jmp.memory_topk_sims(jnp.asarray(feats), jnp.asarray(want_rows), k))
    f = torch.from_numpy(feats)
    # one chunk, then the byte budget cut to 3 rows of this bank's sims
    for name, chunk in (("one chunk", None), ("3 rows a chunk", 3)):
        if chunk is not None:
            monkeypatch.setattr(mp, "SIM_CHUNK_BYTES", chunk * 4 * BANK_ROWS)
        idx, sims = mp.memory_argmax(f, rows), mp.memory_topk_sims(f, rows, k)
        assert idx.dtype == torch.int64 and sims.shape == (20, k), name
        np.testing.assert_array_equal(idx.numpy(), want_idx, err_msg=name)
        np.testing.assert_allclose(sims.numpy(), want_sims, rtol=1e-4, err_msg=name)


def test_memory_argmax_takes_the_lowest_index_on_a_tie(monkeypatch):
    rows = np.random.default_rng(8).standard_normal((40, 16)).astype(np.float32)
    rows[29] = rows[6]  # the same row twice: an exact tie
    feats = rows[[6, 29, 3]] + 0.0
    want = np.asarray(jmp.memory_argmax(jnp.asarray(feats), jnp.asarray(rows)))
    for chunk in (None, 1, 2):
        if chunk is not None:
            monkeypatch.setattr(mp, "SIM_CHUNK_BYTES", chunk * 4 * rows.shape[0])
        got = mp.memory_argmax(torch.from_numpy(feats), torch.from_numpy(rows))
        np.testing.assert_array_equal(got.numpy(), want)
    assert want.tolist() == [6, 6, 3]


# ----------------------------------------------------------- ctx_cleaner


@pytest.mark.parametrize("cleaning_type", ["orthogonal_projection", "contrastive_mask"])
def test_ctx_cleaner_equals_jax(cleaning_type):
    rng = np.random.default_rng(9)
    dirty = rng.standard_normal((2, 7, 32)).astype(np.float32)
    ctx = rng.standard_normal((2, 32)).astype(np.float32)
    want = np.asarray(jrp.ctx_cleaner(jnp.asarray(dirty), jnp.asarray(ctx), cleaning_type, 0.7))
    got = rp.ctx_cleaner(torch.from_numpy(dirty), torch.from_numpy(ctx), cleaning_type, 0.7)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert np.abs(want - dirty).max() > 0.1  # the cleaning moved the rows


def test_ctx_cleaner_refuses_an_unknown_type():
    x, c = np.ones((1, 2, 4), np.float32), np.ones((1, 4), np.float32)
    with pytest.raises(ValueError) as want:
        jrp.ctx_cleaner(jnp.asarray(x), jnp.asarray(c), "nope")
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        rp.ctx_cleaner(torch.from_numpy(x), torch.from_numpy(c), "nope")


# -------------------------------------------------------------- cleaning


CLEANING = [(t, after, src) for t in ("orthogonal_projection", "contrastive_mask")
            for after in (True, False) for src in ("cls", "avg_self_attn")]


@pytest.mark.parametrize("cleaning_type,after,clean_from", CLEANING)
def test_cleaning_grid_equals_jax(models, imgs, cleaning_type, after, clean_from):
    clean = dict(cleaning_type=cleaning_type, clean_after_projection=after,
                 clean_from=clean_from, alpha=0.7)
    _same_outputs(*_both(models, "f32", imgs, get_cls_capt=False, get_patch_capts=True,
                         get_avg_patch_capt=True, bboxes=BOXES, traces=TRACES,
                         compute_scores=True, **clean))
    _same_outputs(*_both(models, "f32", imgs, get_cls_capt=False, bboxes=SETS,
                         get_controllable_capts=True, **clean))


def test_cleaning_on_the_int8_bank_equals_jax(models, imgs):
    got, want = _both(models, "int8", imgs, get_cls_capt=True, get_patch_capts=True,
                      bboxes=BOXES, cleaning_type="orthogonal_projection",
                      clean_after_projection=True, compute_scores=True)
    _same_outputs(got, want)


def test_cleaned_patch_tokens_skip_the_second_projection(models, imgs, monkeypatch):
    """The features `caption_tokens` gets for the cleaned patch tokens: the
    cleaner's output on projected rows, with `project=False`."""
    _, pm = models["f32"]
    seen = []
    caption_tokens = pm.caption_tokens
    monkeypatch.setattr(pm, "caption_tokens", lambda feats, project=True, **kw: (
        seen.append((feats, project)), caption_tokens(feats, project=project, **kw))[1])
    pm.forward(imgs, get_cls_capt=False, get_patch_capts=True,
               cleaning_type="contrastive_mask", clean_after_projection=True)
    (feats, project), = seen
    enc = pm.encode_images(imgs)
    want = rp.ctx_cleaner(pm.project_features(enc["x_norm_patchtokens"].reshape(-1, D),
                                              normalize=True).reshape(2, -1, D),
                          pm.project_features(enc["x_norm_clstoken"], normalize=True),
                          "contrastive_mask")
    assert project is False and feats.shape == (200, D)
    torch.testing.assert_close(feats, want.reshape(-1, D), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------- per-head captions


HEADS = {"heads": dict(get_attn_heads_capt=True),
         "heads, scores": dict(get_attn_heads_capt=True, compute_scores=True),
         "heads beside cleaning": dict(get_attn_heads_capt=True, get_patch_capts=True,
                                       cleaning_type="orthogonal_projection")}


@pytest.mark.parametrize("flags", HEADS)
def test_attn_heads_captions_equal_jax(models, imgs, flags):
    got, want = _both(models, "f32", imgs, get_cls_capt=False, **HEADS[flags])
    _same_outputs(got, want)
    # ViT-B's extraction reads 16 heads (the reference's quirk)
    assert [len(row) for row in got["attn_heads_capts"]] == [16, 16]


# ------------------------------------------------------------ n-best sims


@pytest.mark.parametrize("compute_scores", [False, True])
@pytest.mark.parametrize("k", [1, 5])
def test_n_best_sims_through_caption_tokens_equal_jax(models, k, compute_scores):
    jm, pm = models["f32"]
    feats = np.random.default_rng(10).standard_normal((6, D)).astype(np.float32)
    got = pm.caption_tokens(torch.from_numpy(feats), return_n_best_sims=k,
                            compute_scores=compute_scores)
    want = jm.caption_tokens(jnp.asarray(feats), return_n_best_sims=k,
                             compute_scores=compute_scores)
    _equal(got, want, "caption_tokens")
    capts, sims = got[0] if compute_scores else got
    assert len(capts) == 6 and np.shape(sims) == (6, k)


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_n_best_sims_of_boxes_equal_jax(models, imgs, kind):
    got, want = _both(models, kind, imgs, get_cls_capt=False, bboxes=BOXES,
                      gaussian_avg=True, return_n_best_sims=5, compute_scores=True)
    _same_outputs(got, want)
    assert np.shape(got["bbox_sims"]) == (2, 3, 5)


@pytest.mark.parametrize("variant", ["AlphaCLIP", "AlphaCLIP patch mean"])
def test_n_best_sims_of_alphaclip_boxes_equal_jax(variant):
    from test_torch_clip_backbones import DUMMY_BOXES
    from test_torch_clip_backbones import _models as clip_models

    jm, pm = clip_models(variant)
    imgs = np.random.default_rng(11).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    kw = dict(get_cls_capt=False, bboxes=DUMMY_BOXES, return_n_best_sims=3,
              compute_scores=True)
    got, want = pm.forward(imgs, **kw), jm.forward(imgs, **kw)
    _same_outputs(got, want)
    assert got["bbox_sims"][0][1] == [] and len(got["bbox_sims"][0][0]) == 3  # a dummy box


# -------------------------------------------------------------- argmax text


ARGMAX_FLAGS = {
    "cls, avg_self_attn, avg_patch, scores": dict(
        get_cls_capt=True, get_avg_self_attn_capt=True, get_avg_patch_capt=True,
        compute_scores=True),
    "patches, registers": dict(get_cls_capt=False, get_patch_capts=True,
                               get_register_capts=True),
    "boxes, n-best, scores": dict(get_cls_capt=False, bboxes=BOXES, return_n_best_sims=5,
                                  compute_scores=True),
    "box sets, traces": dict(get_cls_capt=False, bboxes=SETS, get_controllable_capts=True,
                             traces=TRACES, use_attention_tracing=True),
    "heads, cleaning": dict(get_cls_capt=False, get_attn_heads_capt=True, get_patch_capts=True,
                            cleaning_type="contrastive_mask", clean_after_projection=False),
}


@pytest.fixture()
def argmax_text(models):
    """Both packages' models with the argmax-text mode toggled on, as
    `tests/test_patchioner.py` toggles it."""
    for pair in models.values():
        for m in pair:
            m.calculate_argmax_text = True
    yield models
    for pair in models.values():
        for m in pair:
            m.calculate_argmax_text = False


@pytest.mark.parametrize("flags", ARGMAX_FLAGS)
def test_argmax_text_toggled_on_a_built_model_equals_jax(argmax_text, imgs, flags):
    got, want = _both(argmax_text, "f32", imgs, **ARGMAX_FLAGS[flags])
    _same_outputs(got, want)
    assert all(c in TEXTS for key, v in got.items() if key.endswith("capts")
               for row in v for c in (row if isinstance(row, list) else [row]))
    assert not argmax_text["f32"][1].supports_fused_trace_path()


@pytest.mark.parametrize("flags", ["cls, avg_self_attn, avg_patch, scores",
                                   "boxes, n-best, scores"])
def test_argmax_text_on_the_int8_bank_equals_jax(argmax_text, imgs, flags):
    _same_outputs(*_both(argmax_text, "int8", imgs, **ARGMAX_FLAGS[flags]))


# each backbone family the argmax-text mode is set on through from_config:
# its config keys, and the flags its tower can caption
FROM_CONFIG = {
    "DINOv2": (dict(dino_model="dinov2_vitb14_reg", crop_dim=CROP, prefix_size=D,
                    dino_geometry={"depth": 1}), dict(get_cls_capt=True)),
    "CLIP": (dict(dino_model="vit_base_patch16_clip_224.openai", crop_dim=32,
                  prefix_size=512), dict(get_cls_capt=True)),
    "ProxyCLIP": (dict(dino_model=None, proxyclip_clipmodel="ViT-B/16", crop_dim=56,
                       prefix_size=512), dict(get_cls_capt=False, get_avg_patch_capt=True)),
    "DINO.txt": (dict(dino_model="dinov2_vitl14_reg4_dinotxt_tet1280d20h24l", crop_dim=28,
                      prefix_size=1024, dino_geometry={"depth": 1}),
                 dict(get_cls_capt=True)),
}


def _jax_build(config, monkeypatch, **kw):
    """The JAX package's `from_config` with its draws run eagerly: it wraps
    each in a new `jax.jit`, compiled anew at every build."""
    with monkeypatch.context() as m:
        m.setattr(jax, "jit", lambda fun, **_: fun)
        return JaxPatchioner.from_config(config, **kw)


def _bridged_tower(jm, pm):
    if pm.backbone_type == "ProxyCLIP":
        return bridge.proxyclip_from_jax(jm.vit_params, pm.vit_cfg)
    if pm.backbone_type == "DINO":
        return bridge.vit_from_jax(jm.vit_params, pm.vit_cfg)
    return bridge.clip_vision_from_jax(jm.vit_params, pm.vit_cfg)


@pytest.mark.parametrize("backbone", FROM_CONFIG)
def test_argmax_text_through_from_config_equals_jax(backbone, tmp_path, monkeypatch):
    keys, flags = FROM_CONFIG[backbone]
    # no bank file under the memory path: both draw a random bank
    monkeypatch.setenv("IM2TXT_MEMORY_PATH", str(tmp_path))
    config = dict(keys, support_memory_size=64, normalize=True, calculate_argmax_text=True,
                  decap_weights=str(tmp_path / "missing.pt"))
    jm = _jax_build(config, monkeypatch, allow_missing_weights=True)
    pm = Patchioner.from_config(config, allow_missing_weights=True, device="cpu")
    assert pm.calculate_argmax_text and jm.calculate_argmax_text
    assert pm.decoder is None and pm.decode is None and jm.decoder is None
    assert not pm.supports_fused_trace_path() and not jm.supports_fused_trace_path()
    assert pm.backbone_type == jm.backbone_type
    # the port's own draws caption from its own bank's texts
    crop = pm.crop_dim
    imgs = np.random.default_rng(12).integers(0, 256, (2, crop, crop, 3), dtype=np.uint8)
    boxes = np.asarray([[[0, 0, crop // 2, crop // 2]], [[2, 2, crop - 4, crop - 4]]],
                       np.float32)
    kw = dict(flags, bboxes=boxes, return_n_best_sims=2, compute_scores=True)
    own = pm.forward(imgs, **kw)
    assert all(c in pm.bank_texts for row in own["bbox_capts"] for c in row)
    # on the JAX draws carried across, the JAX captions
    pm.vit_params = _bridged_tower(jm, pm)
    pm.bank, pm.bank_texts = bridge.bank_from_jax(jm.bank), jm.bank_texts
    _same_outputs(pm.forward(imgs, **kw), jm.forward(imgs, **kw))


def test_a_server_serves_an_argmax_text_model_as_jax(argmax_text, imgs):
    jm, pm = argmax_text["f32"]
    rng = np.random.default_rng(13)
    traces = [rng.uniform(0, 1, (int(rng.integers(1, 6)), 2)).tolist() for _ in range(3)]
    boxes = [[(0.1, 0.1, 0.5, 0.6)], [(0.0, 0.0, 1.0, 1.0), (0.2, 0.3, 0.9, 0.8)]]
    results = {}
    for name, server_cls, model in (("port", CaptionServer, pm), ("jax", JaxServer, jm)):
        with server_cls(model, max_batch=4, max_delay_ms=50.0, max_boxes=4) as server:
            server.warmup(trace=True, cls=True, bbox=True, region_set=True, buckets=[4])
            futs = [server.submit(imgs[i % 2], trace=tr) for i, tr in enumerate(traces)]
            futs += [server.submit(imgs[i % 2], bboxes=b) for i, b in enumerate(boxes)]
            futs += [server.submit(imgs[i % 2], bboxes=b, region_set=True)
                     for i, b in enumerate(boxes)]
            futs += [server.submit(imgs[i]) for i in range(2)]
            results[name] = [f.result(timeout=300) for f in futs]
            snap = server.snapshot()
        if name == "port":
            # through forward: the decoder's graphs never ran
            assert snap["decode_captures"] == snap["decode_replays"] == 0
            assert snap["completed"] == len(futs) and snap["errors"] == 0
    assert results["port"] == results["jax"]
    assert [len(c) for c in results["port"][3:5]] == [1, 2]


# ------------------------------------------------------------ ValueErrors


def _no_bank(models):
    """(JAX, port) Patchioner on the f32 models' weights without a bank."""
    jm, pm = models["f32"]
    return (JaxPatchioner(vit_cfg=jm.vit_cfg, vit_params=jm.vit_params, gpt2_cfg=jm.gpt2_cfg,
                          decoder=jm.decoder, bank=None, bank_texts=None),
            Patchioner(vit_cfg=pm.vit_cfg, vit_params=pm.vit_params, gpt2_cfg=pm.gpt2_cfg,
                       decoder=pm.decoder, device="cpu"))


def _no_attention():
    from test_torch_clip_backbones import _models as clip_models

    return clip_models("CLIP B/16")


ERRORS = {
    "argmax text without a bank": (
        _no_bank, dict(get_cls_capt=True), True),
    "n-best sims without a bank": (
        _no_bank, dict(get_cls_capt=False, bboxes=BOXES, return_n_best_sims=2), False),
    "head captions without attention": (
        lambda models: _no_attention(), dict(get_cls_capt=False, get_attn_heads_capt=True),
        False),
    "double-DINO before cleaning": (
        lambda models: _no_attention(), dict(get_cls_capt=False, bboxes=BOXES,
                                             double_DINO_for_bboxes=True,
                                             cleaning_type="orthogonal_projection"), False),
}


@pytest.mark.parametrize("case", ERRORS)
def test_value_errors_as_in_jax(models, case):
    make, kw, argmax = ERRORS[case]
    jm, pm = make(models)
    jm.calculate_argmax_text = pm.calculate_argmax_text = argmax
    size = pm.crop_dim
    imgs = np.random.default_rng(14).integers(0, 256, (2, size, size, 3), dtype=np.uint8)
    with pytest.raises(ValueError) as want:
        jm.forward(imgs, **kw)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        pm.forward(imgs, **kw)
