"""The encoder options the port's `from_config` takes since the double-DINO
slice, against the JAX package on the CPU in f32 (bf16 where named), both
sides on one JAX init carried across by `io.bridge.vit_from_jax` at
`tests/test_double_dino.py`'s geometry (70 px, D = 64, depth 2, four heads,
four registers) with the layerscale set to 1, so that every block's
residual branches count:

- `reorder_qkv_params` ('kkv', 'vkq', 'qkv' returned as is, malformed
  strings refused);
- `softmax_f32=False` under 'xla' (f32 and bf16, block by block), refused
  under every other `attn_impl` with the reference's message;
- `vit_forward(return_block_input=True)`;
- `last_block_rerun` on random key masks, a full mask, a row with every
  key masked, chunk sizes, a SwiGLU block and the tanh GELU;
- `Patchioner._double_dino_features` and `forward(double_DINO_for_bboxes=
  True)` for the four (use_cls, return_type) cases of the JAX test, with
  an empty box and a box past the grid's edge; the non-DINO refusal;
- `from_config` with `attention_type: kkv` on each of the eight backbone
  types (reordered as in JAX, or the same ValueError), and the flagship
  config with `attention_type: kkv` and with `softmax_f32: false`.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchioner_tpu.io import checkpoints as jcheckpoints
from patchioner_tpu.models import clip as jclip
from patchioner_tpu.models import decap as jdecap
from patchioner_tpu.models import gpt2 as jgpt2
from patchioner_tpu.models import resnet_clip as jresnet
from patchioner_tpu.models import vit as jvit
from patchioner_tpu.models.patchioner import Patchioner as JaxPatchioner
from patchioner_tpu.ops import memory_projection as jmp
from patchioner_tpu_torch.io import bridge, checkpoints
from patchioner_tpu_torch.models import clip, gpt2, resnet_clip, vit
from patchioner_tpu_torch.models.patchioner import Patchioner

GEOM = dict(img_size=70, patch_size=14, embed_dim=64, depth=2, num_heads=4,
            num_registers=4, extract_heads=4, pos_grid=5)
GPT_GEOM = dict(vocab_size=49408, n_layer=1, n_head=2, n_embd=64)
TINY_DECAP = {"n_layer": 1, "n_head": 2, "n_embd": 32}
# the JAX test's boxes (elements read as [x1, y1, x2, y2] pixels), an empty
# box (x2 < x1) and a box past the 5 x 5 grid's edge
BOXES = np.asarray([[[0, 0, 28, 42], [14, 14, 56, 56], [40, 40, 10, 10]],
                    [[0, 14, 42, 28], [28, 0, 69, 69], [42, 28, 300, 250]]], np.float32)
CASES = [(True, "cls"), (True, "avg"), (False, "avg"), (True, "gaussian_avg")]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # tiny tensors: intra-op threads only contend with the suite's workers
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want))))


# one compile a config, not an op at a time; `cheap_towers` replaces the
# module's init_vit
_INIT_VIT = jax.jit(jvit.init_vit, static_argnums=1)


def _jax_params(cfg, seed=0):
    params = _INIT_VIT(jax.random.PRNGKey(seed), cfg)
    params["blocks"] = [dict(b, ls1=jnp.ones_like(b["ls1"]), ls2=jnp.ones_like(b["ls2"]))
                        for b in params["blocks"]]
    return params


@pytest.fixture(scope="module")
def tower():
    jcfg, cfg = jvit.ViTConfig(**GEOM), vit.ViTConfig(**GEOM)
    params = _jax_params(jcfg)
    imgs = np.random.default_rng(0).standard_normal((2, 70, 70, 3)).astype(np.float32)
    return jcfg, cfg, params, bridge.vit_from_jax(params, cfg), imgs


@pytest.fixture(scope="module")
def models(tower):
    """A JAX Patchioner and the port's twin on the same bridged weights: the
    tower above, a 1-layer DeCap (wte x 10, so that the greedy steps are no
    near-ties) and a 64-row bank."""
    jcfg, cfg, params, _, imgs = tower
    jg = jgpt2.GPT2Config(**GPT_GEOM)
    dec = jax.jit(jdecap.init_decap, static_argnums=(1, 2))(jax.random.PRNGKey(1), jg, 64)
    dec = dec._replace(gpt2=dict(dec.gpt2, wte=dec.gpt2["wte"] * 10))
    bank = jmp.prepare_bank(jax.random.normal(jax.random.PRNGKey(2), (64, 64)))
    jm = JaxPatchioner(vit_cfg=jcfg, vit_params=params, gpt2_cfg=jg, decoder=dec, bank=bank,
                       bank_texts=None)
    pm = Patchioner(vit_cfg=cfg, vit_params=bridge.vit_from_jax(params, cfg),
                    gpt2_cfg=gpt2.GPT2Config(**GPT_GEOM), decoder=bridge.decap_from_jax(dec),
                    bank=bridge.bank_from_jax(bank), device="cpu")
    return jm, pm, imgs, jm.encode_images(imgs)


# -------------------------------------------------------------- reorder


@pytest.mark.parametrize("attention_type", ["kkv", "vkq"])
def test_reorder_qkv_params_equals_jax(tower, attention_type):
    _, _, params, port, _ = tower
    last = {k: v.clone() for k, v in port["blocks"][-1]["qkv"].items()}
    got = vit.reorder_qkv_params(port, attention_type)
    want = jvit.reorder_qkv_params(params, attention_type)
    for key in ("w", "b"):
        np.testing.assert_array_equal(got["blocks"][-1]["qkv"][key].numpy(),
                                      np.asarray(want["blocks"][-1]["qkv"][key]))
        # the caller's tree is left as it was
        assert torch.equal(port["blocks"][-1]["qkv"][key], last[key])
    assert got is not port and got["blocks"] is not port["blocks"]
    assert got["blocks"][0] is port["blocks"][0] and got["patch_embed"] is port["patch_embed"]
    assert set(got["blocks"][-1]) == set(port["blocks"][-1])


def test_reorder_qkv_params_returns_qkv_as_is(tower):
    port = tower[3]
    assert vit.reorder_qkv_params(port, "qkv") is port


@pytest.mark.parametrize("bad", ["", "qk", "qkvv", "qxv"])
def test_reorder_qkv_params_refuses_malformed_strings(tower, bad):
    _, _, params, port, _ = tower
    with pytest.raises(ValueError, match="attention_type"):
        vit.reorder_qkv_params(port, bad)
    with pytest.raises(ValueError, match="attention_type"):
        jvit.reorder_qkv_params(params, bad)


# -------------------------------------------------------- softmax_f32


def _per_block(out) -> list:
    """Each of the two blocks' output: the last block's input, then its own."""
    return [np.asarray(out["last_block_input"], np.float32),
            np.asarray(out["x_prenorm"], np.float32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compute_type_softmax_equals_jax(tower, dtype):
    jcfg, cfg, params, port, imgs = tower
    jc = jvit.ViTConfig(**dict(GEOM, softmax_f32=False, dtype=jnp.dtype(dtype)))
    pc = vit.ViTConfig(**dict(GEOM, softmax_f32=False, dtype=getattr(torch, dtype)))
    px = torch.from_numpy(imgs)
    want = _per_block(jvit.vit_forward(params, jnp.asarray(imgs), jc, return_block_input=True))
    got = _per_block({k: v.float() for k, v in vit.vit_forward(
        port, px, pc, return_block_input=True).items()})
    tol = 1e-5 if dtype == "float32" else 2e-2
    for g, w in zip(got, want):
        assert _rel(g, w) <= tol
    if dtype == "float32":
        # at f32 the compute-type softmax is the default route's function
        default = vit.vit_forward(port, px, cfg)["x_prenorm"]
        assert _rel(got[-1], default.numpy()) <= 1e-5


@pytest.mark.parametrize("impl", ["fusedqkv", "fusedqkv_proj", "flash", "flash1p",
                                  "flash_builtin"])
def test_compute_type_softmax_refused_by_the_kernels(tower, impl):
    _, _, params, port, imgs = tower
    opts = dict(GEOM, softmax_f32=False, attn_impl=impl)
    with pytest.raises(ValueError) as want:
        jvit.vit_forward(params, jnp.asarray(imgs), jvit.ViTConfig(**opts))
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        vit.vit_forward(port, torch.from_numpy(imgs), vit.ViTConfig(**opts))


# ------------------------------------------------------ last block re-run


def test_return_block_input_equals_jax(tower):
    jcfg, cfg, params, port, imgs = tower
    want = jvit.vit_forward(params, jnp.asarray(imgs), jcfg, return_block_input=True)
    got = vit.vit_forward(port, torch.from_numpy(imgs), cfg, return_block_input=True)
    assert _rel(got["last_block_input"].numpy(), want["last_block_input"]) <= 1e-5
    first = vit.vit_forward(dict(port, blocks=port["blocks"][:1]), torch.from_numpy(imgs), cfg)
    torch.testing.assert_close(got["last_block_input"], first["x_prenorm"], rtol=0, atol=0)
    assert "last_block_input" not in vit.vit_forward(port, torch.from_numpy(imgs), cfg)


def _masks(kind, b, n, seed=3):
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=(b, n)) < 0.4
    if kind == "full":
        mask[:] = True
    elif kind == "all masked row":
        mask[1] = False
    return mask


@pytest.mark.parametrize("kind,opts", [
    ("random", {}), ("full", {}), ("all masked row", {}),
    ("random", {"gelu_approx": True}),
    ("random", {"ffn": "swiglu"}),
])
def test_last_block_rerun_equals_jax(tower, kind, opts):
    jcfg = jvit.ViTConfig(**dict(GEOM, **opts))
    cfg = vit.ViTConfig(**dict(GEOM, **opts))
    params = tower[2]
    if opts.get("ffn"):
        # the last block with a SwiGLU FFN (hidden 176) in place of its MLP
        rng = np.random.default_rng(5)
        h = cfg.ffn_hidden
        blk = {k: v for k, v in params["blocks"][-1].items() if k not in ("fc1", "fc2")}
        blk.update(w12={"w": rng.standard_normal((64, 2 * h)) / 8, "b": np.zeros(2 * h)},
                   w3={"w": rng.standard_normal((h, 64)) / h ** 0.5, "b": np.zeros(64)})
        blk = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), blk)
        params = dict(params, blocks=[*params["blocks"][:-1], blk])
    port = bridge.to_torch(params)
    # the base tower's encoding in every case: the re-run reads the last
    # block alone
    enc = jvit.vit_forward(tower[2], jnp.asarray(tower[4]), tower[0], return_block_input=True)
    tokens = np.asarray(enc["last_block_input"])
    tokens = np.concatenate([tokens, tokens[::-1] * 0.5], axis=0)  # 4 rows
    mask = _masks(kind, *tokens.shape[:2])
    want = np.asarray(jvit.last_block_rerun(params, jnp.asarray(tokens), jnp.asarray(mask),
                                            jcfg))
    got = vit.last_block_rerun(port, torch.from_numpy(tokens), torch.from_numpy(mask), cfg)
    assert np.isfinite(got.numpy()).all()
    assert _rel(got.numpy(), want) <= 1e-5
    # the plain twin is the same function
    plain = vit.last_block_rerun_plain(port, torch.from_numpy(tokens), torch.from_numpy(mask),
                                       cfg)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    if kind == "full" and not opts:
        # every key kept: the block as the encoder ran it
        assert _rel(got.numpy()[:2], enc["x_prenorm"]) <= 1e-5
    if kind == "all masked row":
        # the uniform softmax over all T keys, as in JAX: no NaN
        assert _rel(got.numpy()[1], want[1]) <= 1e-5


def test_last_block_rerun_does_not_depend_on_the_chunk(tower):
    _, cfg, params, port, imgs = tower
    enc = vit.vit_forward(port, torch.from_numpy(imgs), cfg, return_block_input=True)
    tokens = enc["last_block_input"].repeat(4, 1, 1)  # 8 rows
    mask = torch.from_numpy(_masks("random", *tokens.shape[:2], seed=7))
    outs = [vit.last_block_rerun(port, tokens, mask, cfg, chunk=c) for c in (1, 3, 8)]
    for out in outs[1:]:
        torch.testing.assert_close(out, outs[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="chunk"):
        vit.last_block_rerun(port, tokens, mask, cfg, chunk=0)


# ------------------------------------------------------------ double-DINO


@pytest.mark.parametrize("use_cls,return_type", CASES)
def test_double_dino_features_equal_jax(models, use_cls, return_type):
    jm, pm, imgs, jenc = models
    want = np.asarray(jm._double_dino_features(
        jenc, jnp.asarray(BOXES), return_type=return_type,
        use_cls=use_cls, gaussian_bbox_variance=0.5))
    got = pm._double_dino_features(pm.encode_images(imgs), torch.from_numpy(BOXES),
                                   return_type=return_type, use_cls=use_cls,
                                   gaussian_bbox_variance=0.5)
    assert got.shape == want.shape == (2, 3, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if return_type == "avg":  # the empty box's feature is zero
        assert not got[0, 2].any()


@pytest.mark.parametrize("use_cls,return_type", CASES)
def test_forward_double_dino_captions_equal_jax(models, use_cls, return_type):
    jm, pm, imgs, _ = models
    kw = dict(get_cls_capt=False, bboxes=BOXES, double_DINO_for_bboxes=True,
              double_DINO_for_bboxes_return_type=return_type, double_DINO_use_cls=use_cls,
              compute_scores=True)
    got, want = pm.forward(imgs, **kw), jm.forward(imgs, **kw)
    assert sorted(got) == sorted(want) == ["bbox_capts", "bbox_scores"]
    assert got["bbox_capts"] == want["bbox_capts"]
    assert [len(row) for row in got["bbox_capts"]] == [3, 3]
    # the features agree to ~1e-6 of their largest; the projection at
    # T = 0.01 and 30 steps' probabilities take that to ~6e-4 of a score,
    # as they do on the uniform box path of this model (an empty box's NaN
    # prefix gives NaN scores on both sides)
    np.testing.assert_allclose(np.asarray(got["bbox_scores"], np.float64),
                               np.asarray(want["bbox_scores"], np.float64), rtol=2e-3)


def test_double_dino_refused_before_anything_else_on_other_backbones(models):
    jm, pm, imgs, _ = models
    for m in (jm, pm):
        m.backbone_type = "CLIP"
    try:
        for kw in (dict(), dict(cleaning_type="orthogonal_projection")):
            for m in (jm, pm):
                with pytest.raises(ValueError, match="requires a DINO backbone"):
                    m.forward(imgs, bboxes=BOXES, double_DINO_for_bboxes=True, **kw)
    finally:
        for m in (jm, pm):
            m.backbone_type = "DINO"
    with pytest.raises(ValueError, match="unknown double-DINO return type"):
        pm._double_dino_features(pm.encode_images(imgs), torch.from_numpy(BOXES),
                                 return_type="max")


# ------------------------------------------------------------ from_config

# each backbone type of the JAX builder with attention_type 'kkv': the five
# CLIP ViT towers and DINOv2 carry a fused last-block qkv and are
# reordered; RegionCLIP's ResNet and ProxyCLIP's pair of towers raise
BACKBONES = {
    "DINO": dict(dino_model="dinov2_vits14_reg", prefix_size=64),
    "CLIP": dict(dino_model="vit_base_patch16_clip_224.openai"),
    "INViTE": dict(dino_model="INViTE_B16", invite_config={
        "name": "ViT-B/16", "extract_last_k_th_token": 1}),
    "OpenCLIP": dict(dino_model="ViT-B/16", use_open_clip=True),
    "AlphaClip": dict(dino_model="alphaclip_vitb16", alphaclip_config={"name": "ViT-B/16"}),
    "DenseClip": dict(dino_model="denseclip_vitb16",
                      denseclip_config="denseclip_segmentation_vitb16"),
    "RegionCLIP": dict(dino_model="RN50_regionclip", regionclip_config={"config": "RN50"},
                       prefix_size=1024),
    "ProxyCLIP": dict(dino_model=None, proxyclip_clipmodel="ViT-B/16"),
}


def _zeros_with_last_qkv(tree, zeros, from_numpy):
    """A tower's tree as zeros but its last block's qkv, drawn from a numpy
    seed: the same numbers in both packages, at full width in a fraction
    of a second."""
    out = jax.tree_util.tree_map(lambda s: zeros(tuple(s.shape)), tree)
    if isinstance(out, dict) and "blocks" in out:
        rng = np.random.default_rng(11)
        last = out["blocks"][-1]["qkv"]
        last["w"] = from_numpy(rng.standard_normal(tuple(last["w"].shape)).astype(np.float32))
        last["b"] = from_numpy(rng.standard_normal(tuple(last["b"].shape)).astype(np.float32))
    return out


def _shapes(template):
    return jax.tree_util.tree_map(lambda t: jax.ShapeDtypeStruct(tuple(t.shape), np.float32),
                                  template, is_leaf=torch.is_tensor)


@pytest.fixture()
def cheap_towers(monkeypatch):
    """Both packages' full-width tower draws give `_zeros_with_last_qkv`
    trees: the builders' decision is under test, and a full-width draw
    takes seconds."""
    for mod, name in ((jclip, "init_clip_vision"), (jresnet, "init_resnet_clip"),
                      (jvit, "init_vit")):
        init = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda key, cfg, _init=init: _zeros_with_last_qkv(
            jax.eval_shape(lambda k: _init(k, cfg), key),
            lambda shape: jnp.asarray(np.zeros(shape, np.float32)), jnp.asarray))
    for mod, name, template in (
            (clip, "init_clip_vision", lambda cfg: clip.param_template(cfg, cfg.num_tokens)),
            (resnet_clip, "init_resnet_clip", resnet_clip.param_template),
            (vit, "init_vit", vit.param_template)):
        monkeypatch.setattr(mod, name, lambda cfg, gen, device="cpu", _t=template:
                            _zeros_with_last_qkv(_shapes(_t(cfg)), torch.zeros,
                                                 torch.from_numpy))


def _jax_build(config, monkeypatch, **kw):
    """The JAX package's `from_config` with its draws run eagerly: it wraps
    each in a new `jax.jit`, compiled anew at every build."""
    with monkeypatch.context() as m:
        m.setattr(jax, "jit", lambda fun, **_: fun)
        return JaxPatchioner.from_config(config, **kw)


@pytest.mark.parametrize("kind", BACKBONES)
def test_from_config_kkv_on_each_backbone_as_in_jax(kind, tmp_path, cheap_towers, monkeypatch):
    config = dict({"crop_dim": 32, "prefix_size": 512, "decap_arch": TINY_DECAP,
                   "support_memory_size": 0, "normalize": False, "attention_type": "kkv"},
                  **BACKBONES[kind])
    if kind == "DINO":
        # both packages load one JAX init (layerscale 1) from an .npz
        config.update(crop_dim=70, dino_geometry=dict(
            embed_dim=64, depth=2, num_heads=4, extract_heads=4, pos_grid=5))
        path = str(tmp_path / "dino.npz")
        jcheckpoints.save_params_npz(path, _jax_params(jvit.config_for(
            "dinov2_vits14_reg", img_size=70, **config["dino_geometry"])))
        config["dino_weights"] = path
    build = dict(allow_missing_weights=True)
    if kind in ("RegionCLIP", "ProxyCLIP"):
        with pytest.raises(ValueError) as want:
            _jax_build(config, monkeypatch, **build)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            Patchioner.from_config(config, device="cpu", **build)
        assert kind in str(want.value)
        return
    jm = _jax_build(config, monkeypatch, **build)
    pm = Patchioner.from_config(config, device="cpu", **build)
    assert pm.backbone_type == jm.backbone_type == kind
    qkv = pm.vit_params["blocks"][-1]["qkv"]
    for key in ("w", "b"):
        np.testing.assert_array_equal(qkv[key].numpy(),
                                      np.asarray(jm.vit_params["blocks"][-1]["qkv"][key]))
    d = qkv["w"].shape[0]
    if kind != "DINO":
        # the seeded draw's key columns now stand in the query's place too
        drawn = np.random.default_rng(11).standard_normal((d, 3 * d)).astype(np.float32)
        np.testing.assert_array_equal(qkv["w"][:, :d].numpy(), drawn[:, d:2 * d])
        np.testing.assert_array_equal(qkv["w"][:, d:].numpy(), drawn[:, d:])
    else:
        old = checkpoints.load_params_npz(config["dino_weights"])["blocks"][-1]["qkv"]["w"]
        torch.testing.assert_close(qkv["w"][:, :d], old[:, d:2 * d], rtol=0, atol=0)
        # the keys serve as queries: the CLS->patch attention is built from
        # keys against keys, on the card's and the JAX package's paths alike
        # (the JAX side through the jitted forward the tests above compiled:
        # the builder's config equals GEOM's)
        imgs = np.random.default_rng(4).standard_normal((2, 70, 70, 3)).astype(np.float32)
        got = pm.encode_images(imgs)
        assert jm.vit_cfg == jvit.ViTConfig(**GEOM)
        want = jvit.vit_forward(jm.vit_params, jnp.asarray(imgs), jm.vit_cfg,
                                return_block_input=True)
        attn, _ = jvit.process_self_attention(want["qkv_last"], num_heads=4,
                                              num_global_tokens=5, scale=0.125)
        assert _rel(got["self_attn"].numpy(), attn) <= 1e-5
        assert _rel(got["x_norm_patchtokens"].numpy(), want["x_norm_patchtokens"]) <= 1e-5



FLAGSHIP = {"dino_model": "dinov2_vitb14_reg", "crop_dim": 140, "prefix_size": 768,
            "support_memory_size": 591753, "normalize": True, "attention_type": "qkv",
            "decap_arch": TINY_DECAP, "dino_geometry": {"depth": 2}}


@pytest.mark.parametrize("extra", [{"attention_type": "kkv"}, {"softmax_f32": False}])
def test_flagship_builds_with_the_option(extra):
    model = Patchioner.from_config(dict(FLAGSHIP, **extra), allow_missing_weights=True,
                                   random_bank_size=64, device="cpu")
    plain = Patchioner.from_config(FLAGSHIP, allow_missing_weights=True, random_bank_size=64,
                                   device="cpu")
    assert model.vit_cfg.softmax_f32 is ("softmax_f32" not in extra)
    assert model.vit_cfg.attn_impl == "xla" and model.supports_fused_trace_path()
    imgs = np.random.default_rng(5).integers(0, 256, (2, 140, 140, 3), dtype=np.uint8)
    caps = model.caption_images_fused(imgs)
    assert len(caps) == 2 and all(isinstance(c, str) for c in caps)
    got, ref = model.encode_images(imgs), plain.encode_images(imgs)
    if "softmax_f32" in extra:
        # at f32 the compute-type softmax computes the default's function
        assert _rel(got["x_norm_patchtokens"].numpy(), ref["x_norm_patchtokens"]) <= 1e-5
        # and every kernel's impl refuses it at its first encoder pass
        fused = Patchioner.from_config(dict(FLAGSHIP, attn_impl="fusedqkv", **extra),
                                       allow_missing_weights=True, random_bank_size=64,
                                       device="cpu")
        with pytest.raises(ValueError, match="always runs an f32 softmax"):
            fused.caption_images_fused(imgs)
    else:
        assert _rel(got["self_attn"].numpy(), ref["self_attn"]) > 1e-3


@pytest.mark.parametrize("extra", [
    {"dino_model": "dinov2_vitl14_reg4_dinotxt_tet1280d20h24l", "softmax_f32": False,
     "dino_geometry": {"depth": 1}},
    {"dino_model": "vit_base_patch16_clip_224.openai", "softmax_f32": False, "crop_dim": 32,
     "prefix_size": 512, "dino_geometry": None},
])
def test_softmax_f32_is_read_on_the_dinov2_branch_only(extra):
    model = Patchioner.from_config(dict(FLAGSHIP, **extra), allow_missing_weights=True,
                                   random_bank_size=8, device="cpu")
    if isinstance(model.vit_cfg, vit.ViTConfig):
        assert model.vit_cfg.softmax_f32 is False  # DINO.txt's inner DINOv2
    else:
        assert not hasattr(model.vit_cfg, "softmax_f32")  # ignored, as in JAX
