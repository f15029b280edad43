"""The CLIP backbone family of the port's `Patchioner` against the JAX
package's, on the CPU in f32.

- `forward` on a small CLIP tower (64 px, width 64, two blocks, four
  heads) with the same bridged weights, DeCap decoder and bank in both
  packages, for each of the five variants the JAX builder makes on the
  tower (OpenAI CLIP, INViTE, OpenCLIP, AlphaCLIP with the CLS token and
  with the patch-grid mean, DenseCLIP): the whole image, boxes (for
  AlphaCLIP one encoder pass a box, a dummy box among them), traces,
  attention-map boxes and attention tracing (uniform pooling where the
  tower's attention is not read), the box sets of AlphaCLIP and the
  attention-weighted mean of DenseCLIP; captions string for string,
  scores within 1e-4 relative; the attention-weighted mean raises on the
  other towers, as in JAX; both servers serve a CLIP model alike;
- a DenseCLIP model loaded through `from_config` from files (its
  geometry, a `backbone.`-prefixed checkpoint in a `state_dict`, a DeCap
  file and a bank file whose rows are not at unit norm) captions as the
  JAX package's on the same files.
"""

import jax
import numpy as np
import pytest
import torch
import yaml

import patchioner_tpu.models.gpt2 as jgpt2
from patchioner_tpu.models import clip as jclip
from patchioner_tpu.models import decap as jdecap
from patchioner_tpu.models.patchioner import Patchioner as JaxPatchioner
from patchioner_tpu.ops import memory_projection as jmp
from patchioner_tpu.serve import CaptionServer as JaxServer
from patchioner_tpu_torch.io import bridge, memory_bank
from patchioner_tpu_torch.models import clip, gpt2
from patchioner_tpu_torch.models.patchioner import Patchioner
from patchioner_tpu_torch.serve import CaptionServer
from test_torch_clip import openai_clip_vision

GEOM = dict(img_size=64, patch_size=16, width=64, depth=2, heads=4, proj_dim=48)
DECAP_GEOM = dict(vocab_size=49408, n_layer=2, n_head=4, n_embd=128)

# the Patchioner keywords and config of each variant the JAX builder makes
VARIANTS = {
    "CLIP B/16": dict(backbone_type="CLIP",
                      config={"dino_model": "vit_base_patch16_clip_224.openai"}),
    "INViTE": dict(backbone_type="INViTE", diag_last_layers=1,
                   config={"dino_model": "INViTE_B16",
                           "invite_config": {"name": "ViT-B/16", "extract_last_k_th_token": 1}}),
    "OpenCLIP": dict(backbone_type="OpenCLIP", skip_ln_post=True,
                     config={"dino_model": "ViT-B/16", "use_open_clip": True}),
    "AlphaCLIP": dict(backbone_type="AlphaClip",
                      config={"dino_model": "alphaclip_vitb16", "alphaclip_config": {
                          "name": "ViT-B/16", "use_cls_for_localized_captions": True}}),
    "AlphaCLIP patch mean": dict(backbone_type="AlphaClip", config={
        "dino_model": "alphaclip_vitb16",
        "alphaclip_config": {"name": "ViT-B/16", "use_cls_for_localized_captions": False}}),
    "DenseCLIP": dict(backbone_type="DenseClip",
                      config={"dino_model": "denseclip_vitb16",
                              "denseclip_config": "denseclip_segmentation_vitb16"}),
}


def _models(variant):
    """(JAX Patchioner, port Patchioner) of one variant on the same weights:
    the small tower (AlphaCLIP's alpha conv drawn large enough to move the
    features), the 2-layer, 128-wide DeCap decoder of test_torch_forward.py,
    its wte scaled by 10 (so that the greedy steps are no near-ties), and a
    200-row bank."""
    kw = dict(VARIANTS[variant])
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(0), 4)
    jcfg = jclip.ClipVisionConfig(**GEOM)
    vparams = jclip.init_clip_vision(k1, jcfg)
    if kw["backbone_type"] == "AlphaClip":
        vparams["alpha_embed_w"] = jclip.init_alpha_embed(k4, jcfg) * 50
    jg = jgpt2.GPT2Config(**DECAP_GEOM)
    dec = jdecap.init_decap(k2, jg, prefix_size=GEOM["proj_dim"])
    dec = dec._replace(gpt2=dict(dec.gpt2, wte=dec.gpt2["wte"] * 10))
    bank = jmp.prepare_bank(jax.random.normal(k3, (200, GEOM["proj_dim"])))
    jm = JaxPatchioner(vit_cfg=jcfg, vit_params=vparams, gpt2_cfg=jg, decoder=dec, bank=bank,
                       bank_texts=None, normalize=False, **kw)
    pm = Patchioner(vit_cfg=clip.ClipVisionConfig(**GEOM),
                    vit_params=bridge.clip_vision_from_jax(vparams, clip.ClipVisionConfig(**GEOM)),
                    gpt2_cfg=gpt2.GPT2Config(**DECAP_GEOM), decoder=bridge.decap_from_jax(dec),
                    bank=bridge.bank_from_jax(bank), normalize=False, device="cpu", **kw)
    return jm, pm


@pytest.fixture(scope="module")
def imgs():
    return np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)


BOXES = np.asarray([[[0, 0, 32, 32], [16, 16, 40, 40], [0, 0, 1, 1]],
                    [[8, 8, 48, 48], [0, 0, 64, 20], [33, 2, 20, 50]]], np.float32)
DUMMY_BOXES = np.asarray([[[0, 0, 32, 32], [-1, -1, -1, -1]],
                          [[8, 8, 48, 48], [30, 2, 20, 50]]], np.float32)
SETS = np.asarray([[[0, 0, 32, 32], [16, 16, 40, 40]],
                   [[8, 8, 48, 48], [-1, -1, -1, -1]]], np.float32)
TRACES = [[{"x": 0.1, "y": 0.2}, {"x": 0.5, "y": 0.5}, {"x": 0.9, "y": 0.3}],
          [(0.3, 0.7), (0.35, 0.75)]]
FLAGS = {
    "cls, avg_patch, scores": dict(get_cls_capt=True, get_avg_patch_capt=True,
                                   gaussian_img_variance=0.5, compute_scores=True),
    "boxes, traces": dict(get_cls_capt=False, bboxes=BOXES, traces=TRACES),
    "attention-map boxes, attention tracing, scores": dict(
        get_cls_capt=False, bboxes=BOXES, traces=TRACES, use_attn_map_for_bboxes=True,
        use_attention_tracing=True, compute_scores=True),
    "box sets, traces": dict(get_cls_capt=False, bboxes=SETS, traces=TRACES,
                             get_controllable_capts=True),
    "patches": dict(get_cls_capt=False, get_patch_capts=True),
    "registers (none), scores": dict(get_cls_capt=False, get_register_capts=True,
                                     compute_scores=True),
    "dummy box, scores": dict(get_cls_capt=False, bboxes=DUMMY_BOXES, compute_scores=True),
    "box sets alone": dict(get_cls_capt=False, bboxes=SETS, get_controllable_capts=True),
    "avg_self_attn": dict(get_cls_capt=False, get_avg_self_attn_capt=True),
}
# each variant on the flags where its path differs: the whole image and
# boxes and traces everywhere; the attention flags where the tower's
# attention is read (DenseCLIP) and where it is not (CLIP); AlphaCLIP's own
# region path with box sets and dummy boxes, by CLS and by patch mean
CASES = [(v, f) for v, flags in (
    ("CLIP B/16", ("cls, avg_patch, scores", "boxes, traces",
                   "attention-map boxes, attention tracing, scores", "patches",
                   "registers (none), scores")),
    ("INViTE", ("cls, avg_patch, scores", "boxes, traces")),
    ("OpenCLIP", ("cls, avg_patch, scores", "boxes, traces")),
    ("AlphaCLIP", ("cls, avg_patch, scores", "boxes, traces", "box sets, traces",
                   "dummy box, scores", "box sets alone")),
    ("AlphaCLIP patch mean", ("boxes, traces", "box sets, traces", "dummy box, scores")),
    ("DenseCLIP", ("cls, avg_patch, scores", "boxes, traces",
                   "attention-map boxes, attention tracing, scores", "avg_self_attn")),
) for f in flags]


class _Pairs(dict):
    """Each variant's model pair, built on first use."""

    def __missing__(self, variant):
        self[variant] = _models(variant)
        return self[variant]


@pytest.fixture(scope="module")
def models():
    return _Pairs()


def _equal(got, want, at):
    """Strings exactly, scores within 1e-4 relative (a DeCap score is exp of
    the sum of 30 f32 log-probabilities)."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), at
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{at}[{i}]")
    elif isinstance(want, str):
        assert got == want, at
    else:
        assert got == pytest.approx(float(want), rel=1e-4, nan_ok=True), at


@pytest.mark.parametrize("variant,flags", CASES)
def test_forward_equals_jax(models, imgs, variant, flags):
    jm, pm = models[variant]
    kw = FLAGS[flags]
    got, want = pm.forward(imgs, **kw), jm.forward(imgs, **kw)
    assert sorted(got) == sorted(want)
    for key in want:
        _equal(got[key], want[key], key)
    if variant.startswith("AlphaCLIP") and "dummy box" in flags:
        assert got["bbox_capts"][0][1] == ""
        if "bbox_scores" in got:
            assert got["bbox_scores"][0][1] == 0.0


@pytest.mark.parametrize("variant", ["CLIP B/16", "INViTE", "OpenCLIP", "AlphaCLIP",
                                     "DenseCLIP"])
def test_encode_images_equals_jax(models, imgs, variant):
    jm, pm = models[variant]
    enc, want = pm.encode_images(imgs), jm.encode_images(imgs)
    assert enc["x_norm_regtokens"].shape == (2, 0, GEOM["proj_dim"])
    assert pm.extract_heads == jm.extract_heads == 16 and pm.num_global_tokens == 1
    for key in ("x_norm_clstoken", "x_norm_patchtokens", "tokens_preproj", "qkv_last",
                "self_attn", "self_attn_maps"):
        ref = np.asarray(want[key])
        assert np.max(np.abs(enc[key].numpy() - ref)) <= 1e-5 * max(1.0, np.max(np.abs(ref)))
    assert not pm.supports_fused_trace_path()
    with pytest.raises(ValueError, match="forward"):
        pm.caption_images_fused(imgs)


@pytest.mark.parametrize("variant", ["CLIP B/16", "INViTE", "OpenCLIP", "AlphaCLIP"])
def test_avg_self_attn_raises_without_the_towers_attention(models, imgs, variant):
    for model in models[variant]:
        with pytest.raises(ValueError, match="self-attention"):
            model.forward(imgs, get_avg_self_attn_capt=True)


@pytest.mark.parametrize("variant", ["CLIP B/16", "AlphaCLIP"])
def test_servers_serve_a_clip_model_alike(models, imgs, variant):
    """Every request kind reaches `forward` in both servers, after warmup()."""
    jm, pm = models[variant]
    traces = [[(0.2, 0.3), (0.6, 0.6)], [(0.9, 0.1)]]
    boxes = [[(0.1, 0.1, 0.5, 0.6)], [(0.0, 0.0, 1.0, 1.0), (0.2, 0.3, 0.9, 0.8)]]
    results = {}
    for name, server_cls, model in (("port", CaptionServer, pm), ("jax", JaxServer, jm)):
        with server_cls(model, max_batch=2, max_delay_ms=2000.0, max_boxes=2) as server:
            server.warmup(trace=True, cls=True, bbox=True, region_set=True, buckets=[2])
            futs = [server.submit(imgs[i], trace=tr) for i, tr in enumerate(traces)]
            futs += [server.submit(imgs[i], bboxes=b) for i, b in enumerate(boxes)]
            futs += [server.submit(imgs[i], bboxes=b, region_set=True)
                     for i, b in enumerate(boxes)]
            futs += [server.submit(imgs[i]) for i in range(2)]
            results[name] = [f.result(timeout=300) for f in futs]
            snap = server.snapshot()
        if name == "port":
            assert snap["completed"] == len(futs) and snap["errors"] == 0
    assert results["port"] == results["jax"]
    assert [len(c) for c in results["port"][2:4]] == [1, 2]


def test_denseclip_loaded_from_files_captions_as_jax(tmp_path, imgs):
    """DenseCLIP end to end from files, `allow_missing_weights=False` in
    both packages: a geometry file, the tower in the openai layout under
    `backbone.` inside `state_dict`, a DeCap file and an HDF5 bank whose
    rows are not at unit norm (a CLIP-space bank is normalised at load)."""
    from test_torch_checkpoints import decap_sd

    geometry = tmp_path / "denseclip_tiny.yaml"
    geometry.write_text(yaml.safe_dump({"model": {"vision": {
        "vision_patch_size": 16, "vision_width": 64, "vision_layers": 2, "embed_dim": 48}}}))
    sd = {f"backbone.{k}": v for k, v in openai_clip_vision(31, alpha=False).items()}
    sd["decode_head.conv.weight"] = torch.zeros(2, 2)
    weights = str(tmp_path / "denseclip.pth")
    torch.save({"state_dict": sd}, weights)
    dec = str(tmp_path / "decap.pt")
    torch.save(decap_sd(32, 48), dec)
    rows = 3 * np.random.default_rng(33).standard_normal((40, 48)).astype(np.float32)
    bank = str(tmp_path / "bank.h5")
    memory_bank.save_bank(bank, "coco_captions",
                          memory_bank.MemoryBank(rows, [f"c{i}" for i in range(40)]))
    config = {"dino_model": "denseclip_vitb16", "denseclip_config": str(geometry),
              "denseclip_weights": weights, "decap_weights": dec, "memory_bank_path": bank,
              "prefix_size": 48, "support_memory_size": 40, "normalize": False,
              "crop_dim": 64, "projection_type": "coco",
              "decap_arch": {"n_layer": 2, "n_head": 4, "n_embd": 128, "vocab_size": 1000}}
    jm = JaxPatchioner.from_config(config, allow_missing_weights=False)
    pm = Patchioner.from_config(config, allow_missing_weights=False, device="cpu")
    assert pm.backbone_type == jm.backbone_type == "DenseClip"
    inv = pm.bank.inv_norm[:pm.bank.num_real]
    torch.testing.assert_close(inv, torch.ones_like(inv))  # unit rows
    n = pm.bank.num_real
    assert n == jm.bank.num_real == 40
    np.testing.assert_array_equal(pm.bank.rows[:n].numpy(), np.asarray(jm.bank.rows)[:n])
    kw = dict(get_cls_capt=True, get_avg_self_attn_capt=True, bboxes=BOXES, traces=TRACES,
              use_attn_map_for_bboxes=True, compute_scores=True)
    got, want = pm.forward(imgs, **kw), jm.forward(imgs, **kw)
    assert sorted(got) == sorted(want)
    for key in want:
        _equal(got[key], want[key], key)
