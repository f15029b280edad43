"""The port's CLIP vision tower against the JAX package's, on the CPU.

- `clip_visual_forward` on the same bridged weights of a small tower
  (width 64, depth 2, four heads, patch 16): plain, the last block
  dropped, the last block diagonal (INViTE), AlphaCLIP's alpha conv,
  OpenCLIP's projection before `ln_post`, and a stored 2 x 2 position grid
  resized to 4 x 4; every output within 1e-5 * max(1, max|ref|) at f32,
  and in bf16 within 2e-2 of it;
- both porters (the transformers layout and the openai/CLIP layout with
  AlphaCLIP's `conv1_alpha`) on state dicts built from a numpy seed: the
  trees equal the JAX package's leaf for leaf, and the patch layout
  equals the conv it came from;
- `boxes_to_pixel_masks`, dummy boxes included;
- the bridge's structure check, and the random init's tree;
- `from_config` on the 13 shipped CLIP configs (full width at 32 px, a
  tiny decoder and bank, GPT-2 base shrunk): the JAX builder's tower,
  options and extraction; ViT-L and AlphaCLIP's projection width; a
  DINOv2 `dino_model` before every CLIP key; a transformers-layout
  `clip_weights` file read into the JAX porter's tree; what the port
  still refuses;
- the DenseCLIP geometries in the port's data folder equal the YAML files
  they were converted from.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

from patchioner_tpu.models import clip as jclip
from patchioner_tpu.models.patchioner import Patchioner as JaxPatchioner
from patchioner_tpu.ops import region_pooling as jrp
from patchioner_tpu_torch.io import bridge
from patchioner_tpu_torch.models import clip, gpt2, patchioner
from patchioner_tpu_torch.models.patchioner import Patchioner
from patchioner_tpu_torch.ops import region_pooling as rp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOM = dict(img_size=32, patch_size=16, width=64, depth=2, heads=4, proj_dim=48)


def _tower(key=0, alpha=False):
    """(JAX params, port params) of the small tower on the same weights,
    LayerNorms and biases drawn away from their init so that they count."""
    cfg = jclip.ClipVisionConfig(**GEOM)
    params = jclip.init_clip_vision(jax.random.PRNGKey(key), cfg)
    rng = np.random.default_rng(key + 1)

    def perturb(tree):
        if isinstance(tree, dict):
            return {k: perturb(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [perturb(v) for v in tree]
        return tree + jnp.asarray(rng.standard_normal(tree.shape).astype(np.float32) * 0.05)

    params = perturb(params)
    if alpha:
        params["alpha_embed_w"] = jclip.init_alpha_embed(jax.random.PRNGKey(key + 2), cfg) * 10
    return params, bridge.clip_vision_from_jax(params, clip.ClipVisionConfig(**GEOM))


CASES = {
    "plain": dict(),
    "skip_last_layers": dict(skip_last_layers=1),
    "diag_last_layers": dict(diag_last_layers=1),
    "alpha": dict(alpha=True),
    "skip_ln_post": dict(skip_ln_post=True),
    "grid 4 from a stored grid of 2": dict(img=64),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_clip_visual_forward_equals_jax(case, dtype):
    kw = dict(CASES[case])
    img = kw.pop("img", 32)
    use_alpha = kw.pop("alpha", False)
    jparams, params = _tower(alpha=use_alpha)
    rng = np.random.default_rng(3)
    pixels = rng.standard_normal((2, img, img, 3)).astype(np.float32)
    alpha = (rng.uniform(size=(2, img, img, 1)) > 0.5).astype(np.float32) if use_alpha else None
    jcfg = jclip.ClipVisionConfig(**dict(GEOM, img_size=img), dtype=getattr(jnp, dtype))
    cfg = clip.ClipVisionConfig(**dict(GEOM, img_size=img), dtype=getattr(torch, dtype))
    want = jclip.clip_visual_forward(jparams, jnp.asarray(pixels), jcfg,
                                     alpha=None if alpha is None else jnp.asarray(alpha), **kw)
    got = clip.clip_visual_forward(params, torch.from_numpy(pixels), cfg,
                                   alpha=None if alpha is None else torch.from_numpy(alpha), **kw)
    g = img // GEOM["patch_size"]
    shapes = {"x_norm_clstoken": (2, 48), "x_norm_patchtokens": (2, g * g, 48),
              "tokens_preproj": (2, 1 + g * g, 64), "qkv_last": (2, 1 + g * g, 192)}
    for key, shape in shapes.items():
        ref = np.asarray(want[key].astype(jnp.float32))
        out = got[key].float().numpy()
        assert out.shape == ref.shape == shape, key
        assert got[key].dtype == getattr(torch, dtype), key
        tol = (1e-5 if dtype == "float32" else 2e-2) * max(1.0, np.abs(ref).max())
        assert np.abs(out - ref).max() <= tol, key


def test_diagonal_attention_changes_the_last_block_only():
    _, params = _tower()
    cfg = clip.ClipVisionConfig(**GEOM)
    pixels = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 32, 32, 3))
                              .astype(np.float32))
    plain = clip.clip_visual_forward(params, pixels, cfg)
    diag = clip.clip_visual_forward(params, pixels, cfg, diag_last_layers=1)
    assert not torch.allclose(plain["x_norm_clstoken"], diag["x_norm_clstoken"])
    # the block's qkv reads the same input either way
    torch.testing.assert_close(plain["qkv_last"], diag["qkv_last"])


# ------------------------------------------------------------------ porters

def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def hf_clip_vision(seed, d=64, depth=2, p=16, grid=2, proj=48):
    """A transformers CLIPModel's vision keys (`vision_model.*`,
    `visual_projection`), seeded."""
    rng = np.random.default_rng(seed)
    v = "vision_model"
    sd = {f"{v}.embeddings.patch_embedding.weight": _rand(rng, d, 3, p, p, scale=0.02),
          f"{v}.embeddings.class_embedding": _rand(rng, d),
          f"{v}.embeddings.position_embedding.weight": _rand(rng, 1 + grid * grid, d),
          "visual_projection.weight": _rand(rng, proj, d)}
    for name in ("pre_layrnorm", "post_layernorm"):
        sd[f"{v}.{name}.weight"], sd[f"{v}.{name}.bias"] = _rand(rng, d), _rand(rng, d)
    for i in range(depth):
        p_ = f"{v}.encoder.layers.{i}"
        for name, out, fan_in in (("self_attn.q_proj", d, d), ("self_attn.k_proj", d, d),
                                  ("self_attn.v_proj", d, d), ("self_attn.out_proj", d, d),
                                  ("mlp.fc1", 4 * d, d), ("mlp.fc2", d, 4 * d)):
            sd[f"{p_}.{name}.weight"] = _rand(rng, out, fan_in, scale=fan_in ** -0.5)
            sd[f"{p_}.{name}.bias"] = _rand(rng, out)
        for name in ("layer_norm1", "layer_norm2"):
            sd[f"{p_}.{name}.weight"], sd[f"{p_}.{name}.bias"] = _rand(rng, d), _rand(rng, d)
    return sd


def openai_clip_vision(seed, prefix="visual.", alpha=True, d=64, depth=2, p=16, grid=2,
                       proj=48):
    """An openai/CLIP visual tower under `prefix`, with AlphaCLIP's
    `conv1_alpha` under `alpha`, seeded."""
    rng = np.random.default_rng(seed)
    sd = {"conv1.weight": _rand(rng, d, 3, p, p, scale=0.02), "class_embedding": _rand(rng, d),
          "positional_embedding": _rand(rng, 1 + grid * grid, d), "proj": _rand(rng, d, proj)}
    if alpha:
        sd["conv1_alpha.weight"] = _rand(rng, d, 1, p, p, scale=0.02)
    for name in ("ln_pre", "ln_post"):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = _rand(rng, d), _rand(rng, d)
    for i in range(depth):
        q = f"transformer.resblocks.{i}"
        sd[f"{q}.attn.in_proj_weight"] = _rand(rng, 3 * d, d, scale=d ** -0.5)
        sd[f"{q}.attn.in_proj_bias"] = _rand(rng, 3 * d)
        for name, out, fan_in in (("attn.out_proj", d, d), ("mlp.c_fc", 4 * d, d),
                                  ("mlp.c_proj", d, 4 * d)):
            sd[f"{q}.{name}.weight"] = _rand(rng, out, fan_in, scale=fan_in ** -0.5)
            sd[f"{q}.{name}.bias"] = _rand(rng, out)
        for name in ("ln_1", "ln_2"):
            sd[f"{q}.{name}.weight"], sd[f"{q}.{name}.bias"] = _rand(rng, d), _rand(rng, d)
    return {prefix + k: v for k, v in sd.items()}


def _assert_trees_equal(got, want, at="tree"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), at
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{at}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), at
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{at}[{i}]")
    else:
        assert torch.is_tensor(got) and got.dtype == torch.float32 and got.is_contiguous(), at
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=at)


PORTERS = {
    "port_hf_clip_vision": (lambda: hf_clip_vision(5),
                            lambda m, sd: m.port_hf_clip_vision(sd, 2)),
    "port_openai_clip_vision-alpha": (lambda: openai_clip_vision(6),
                                      lambda m, sd: m.port_openai_clip_vision(sd, 2)),
    "port_openai_clip_vision-bare-keys": (
        lambda: openai_clip_vision(7, prefix="", alpha=False),
        lambda m, sd: m.port_openai_clip_vision(sd, 2, prefix="")),
}


@pytest.mark.parametrize("case", PORTERS)
def test_porter_equals_jax(case):
    make, call = PORTERS[case]
    sd = make()
    want, got = call(jclip, dict(sd)), call(clip, dict(sd))
    _assert_trees_equal(got, want)
    assert ("alpha_embed_w" in got) == case.endswith("-alpha")


@pytest.mark.parametrize("layout", ["hf", "openai"])
def test_patch_layout_equals_the_conv(layout):
    """An oracle independent of both porters: the checkpoint's conv."""
    if layout == "hf":
        sd = hf_clip_vision(8)
        tree, conv = clip.port_hf_clip_vision(sd, 2), sd[
            "vision_model.embeddings.patch_embedding.weight"]
    else:
        sd = openai_clip_vision(9)
        tree, conv = clip.port_openai_clip_vision(sd, 2), sd["visual.conv1.weight"]
    rng = np.random.default_rng(10)
    pixels = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32))
    got = clip._patches(pixels, 16) @ tree["patch_embed_w"]
    ref = F.conv2d(pixels.permute(0, 3, 1, 2), conv, stride=16).flatten(2).transpose(1, 2)
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    if layout == "openai":
        alpha = torch.from_numpy(rng.uniform(size=(2, 32, 32, 1)).astype(np.float32))
        got = clip._patches(alpha, 16) @ tree["alpha_embed_w"]
        ref = F.conv2d(alpha.permute(0, 3, 1, 2), sd["visual.conv1_alpha.weight"], stride=16)
        ref = ref.flatten(2).transpose(1, 2)
        assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_ported_tower_equals_jax_forward():
    """A ported openai-layout tower (AlphaCLIP's, alpha conv included)
    through both packages' forward."""
    sd = openai_clip_vision(11)
    jcfg, cfg = jclip.ClipVisionConfig(**GEOM), clip.ClipVisionConfig(**GEOM)
    rng = np.random.default_rng(12)
    pixels = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    alpha = np.ones((2, 32, 32, 1), np.float32)
    want = jclip.clip_visual_forward(jclip.port_openai_clip_vision(sd, 2), jnp.asarray(pixels),
                                     jcfg, alpha=jnp.asarray(alpha))
    got = clip.clip_visual_forward(clip.port_openai_clip_vision(sd, 2),
                                   torch.from_numpy(pixels), cfg, alpha=torch.from_numpy(alpha))
    ref = np.asarray(want["x_norm_patchtokens"])
    assert np.abs(got["x_norm_patchtokens"].numpy() - ref).max() <= 1e-5 * max(
        1.0, np.abs(ref).max())


# ------------------------------------------------------------- masks, bridge


def test_boxes_to_pixel_masks_equal_jax():
    boxes = np.asarray([[[0, 0, 16, 16], [3.7, 5.2, 10.9, 4.1], [-1, -1, -1, -1]],
                        [[20, 20, 40, 40], [-5, 2, 8, 8], [31.5, 0, 1, 32]],
                        [[0, 0, 32, 32], [10, 10, 0, 0], [2, 3, -1, 4]]], np.float32)
    for size in (32, 2):
        b = boxes if size == 32 else boxes / 16
        want = np.asarray(jrp.boxes_to_pixel_masks(jnp.asarray(b), size))
        got = rp.boxes_to_pixel_masks(torch.from_numpy(b), size)
        assert got.dtype == torch.float32 and got.shape == (3, 3, size, size)
        np.testing.assert_array_equal(got.numpy(), want)
    masks = rp.boxes_to_pixel_masks(torch.from_numpy(boxes), 32)
    assert masks[0, 2].sum() == 0  # a dummy box masks nothing
    assert masks[0, 0].sum() == 16 * 16  # the end is exclusive
    assert masks[1, 1].sum() == 3 * 8  # clamped at 0: columns 0..2


def test_bridge_checks_the_structure():
    jparams, _ = _tower()
    cfg = clip.ClipVisionConfig(**GEOM)
    with pytest.raises(ValueError, match="blocks"):
        bridge.clip_vision_from_jax(dict(jparams, blocks=jparams["blocks"][:1]), cfg)
    with pytest.raises(ValueError, match="keys"):
        bridge.clip_vision_from_jax({k: v for k, v in jparams.items() if k != "proj"}, cfg)
    blk = {k: v for k, v in jparams["blocks"][0].items() if k != "fc2"}
    with pytest.raises(ValueError, match="block"):
        bridge.clip_vision_from_jax(dict(jparams, blocks=[blk, blk]), cfg)


def test_init_has_the_tree_of_jax_and_of_the_template():
    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)

    jcfg, cfg = jclip.ClipVisionConfig(**GEOM), clip.ClipVisionConfig(**GEOM)
    gen = torch.Generator().manual_seed(0)
    tree = clip.init_clip_vision(cfg, gen)
    tree["alpha_embed_w"] = clip.init_alpha_embed(cfg, gen)
    want = jclip.init_clip_vision(jax.random.PRNGKey(0), jcfg)
    want["alpha_embed_w"] = jclip.init_alpha_embed(jax.random.PRNGKey(1), jcfg)
    assert shapes(tree) == shapes(want) == shapes(clip.param_template(cfg, cfg.num_tokens,
                                                                      alpha=True))
    # the distributions' scales: LNs at 1 and 0, the position table at 0.01
    assert torch.equal(tree["ln_pre"]["scale"], torch.ones(64))
    assert abs(tree["pos_embed"].std().item() - 0.01) < 0.003


# ------------------------------------------------------------ from_config

SHIPPED = ["decap_B16", "decap_B16_resize", "decap_B32", "INViTE_B16_1layer",
           "INViTE_B16_1layer_bigResize", "alphaclip_B16_CLS", "denseclip_B16_seg_40patches",
           "viecap", "viecap_b16_14patches", "viecap_b16_37patches", "meacap_invlm",
           "meacap_invlm_b16_14patches", "meacap_invlm_b16_37patches"]
TINY_DECAP = {"n_layer": 1, "n_head": 2, "n_embd": 32}
LM_GEOM = dict(vocab_size=263, n_positions=128, n_embd=32, n_layer=1, n_head=2)
# one config of each JAX branch is also built in JAX
JAX_TOO = {"INViTE_B16_1layer_bigResize", "alphaclip_B16_CLS", "denseclip_B16_seg_40patches"}


def _zero_towers(monkeypatch):
    """Both packages' `init_clip_vision` give zeros of the tree they would
    draw: the builders' branches, geometry and options are under test here,
    the draws are held at a small width above, and a full-width draw takes
    seconds (JAX compiles it)."""
    jinit = jclip.init_clip_vision
    monkeypatch.setattr(jclip, "init_clip_vision", lambda key, cfg: jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype), jax.eval_shape(lambda k: jinit(k, cfg), key)))
    monkeypatch.setattr(clip, "init_clip_vision", lambda cfg, gen, device="cpu":
                        jax.tree_util.tree_map(lambda t: torch.zeros(t.shape, device=device),
                                               clip.param_template(cfg, cfg.num_tokens)))


def _shipped(name, **extra):
    with open(os.path.join(REPO, "configs", f"{name}.k.yaml")) as f:
        config = yaml.safe_load(f)
    return dict(config, crop_dim=32, decap_arch=TINY_DECAP, **extra)


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_clip_config_builds_as_in_jax(name, monkeypatch):
    """The port builds each at full width (32 px, GPT-2 base shrunk); one
    of each JAX branch also in JAX, whose tower, options and extraction it
    must have."""
    monkeypatch.setattr(gpt2, "GPT2_BASE_CONFIG", gpt2.GPT2Config(**LM_GEOM))
    _zero_towers(monkeypatch)
    config = _shipped(name)
    patchioner._check_config(config)
    pm = Patchioner.from_config(config, allow_missing_weights=True, random_bank_size=64,
                                device="cpu")
    cfg = pm.vit_cfg
    assert isinstance(cfg, clip.ClipVisionConfig) and cfg.img_size == 32
    assert (cfg.width, cfg.depth, cfg.heads, cfg.proj_dim) == (768, 12, 12, 512)
    assert cfg.patch_size == (32 if "B32" in name or name in ("viecap", "meacap_invlm") else 16)
    assert pm.extract_heads == 16 and pm.num_global_tokens == 1 and pm.extract_scale == 0.125
    assert not pm.supports_fused_trace_path()
    assert pm.diag_last_layers == (1 if name.startswith("INViTE") else 0)
    if "viecap" in config:
        assert pm.bank is None and pm.viecap.cfg.clip_hidden_size == 512
        if "meacap" not in config["viecap"]:  # the copied CLIP-space entity embeddings
            assert pm.viecap.texts_embeddings.shape == (80, 512)
            assert pm.viecap.texts_embeddings.std().item() > 0.01
        return
    assert pm.bank.num_real == 64 and pm.bank.rows.shape[1] == 512
    if name not in JAX_TOO:
        return
    jm = JaxPatchioner.from_config(config, allow_missing_weights=True, random_bank_size=64)
    assert pm.backbone_type == jm.backbone_type
    assert (pm.diag_last_layers, pm.skip_ln_post) == (jm.diag_last_layers, jm.skip_ln_post)
    assert (pm.extract_heads, pm.num_global_tokens, pm.extract_scale) == (
        jm.extract_heads, jm.num_global_tokens, jm.extract_scale)
    jcfg = jm.vit_cfg
    assert (cfg.img_size, cfg.patch_size, cfg.width, cfg.depth, cfg.heads, cfg.proj_dim,
            cfg.ln_eps) == (jcfg.img_size, jcfg.patch_size, jcfg.width, jcfg.depth,
                            jcfg.heads, jcfg.proj_dim, jcfg.ln_eps)
    assert ("alpha_embed_w" in pm.vit_params) == ("alpha_embed_w" in jm.vit_params)


@pytest.mark.parametrize("extra", [
    {"use_open_clip": True, "dino_model": "ViT-L/14"},
    {"dino_model": "vit_large_patch14_clip_224.openai"},
    {"invite_config": {"name": "ViT-L/14"}},
    {"alphaclip_config": {"name": "ViT-L/14", "embed_dim": 640}},
])
def test_clip_vit_l_and_a_projection_width_follow_the_jax_branch(extra):
    config = _shipped("decap_B16", **extra)
    cfg, _, _, _ = patchioner._clip_geometry(config, patchioner._backbone_type(config),
                                             torch.float32)
    assert (cfg.width, cfg.depth, cfg.heads, cfg.patch_size) == (1024, 24, 16, 14)
    assert cfg.proj_dim == extra.get("alphaclip_config", {}).get("embed_dim", 768)


def test_a_dinov2_model_takes_precedence_over_the_clip_keys():
    config = {"dino_model": "dinov2_vits14_reg", "crop_dim": 28, "prefix_size": 384,
              "support_memory_size": 0, "decap_arch": TINY_DECAP, "dino_geometry": {"depth": 1},
              "alphaclip_config": {"name": "ViT-B/16"}, "denseclip_config": "missing",
              "use_open_clip": True, "invite_config": {"name": "ViT-B/16"},
              "regionclip_config": {"checkpoint": "missing.pth"}}
    pm = Patchioner.from_config(config, allow_missing_weights=True, device="cpu")
    jm = JaxPatchioner.from_config(config, allow_missing_weights=True)
    assert pm.backbone_type == jm.backbone_type == "DINO"
    assert pm.extract_heads == pm.vit_cfg.extract_heads


# RegionCLIP, ProxyCLIP and DINO.txt are the port's backbones; each is
# refused with a key the port does not take
@pytest.mark.parametrize("extra", [
    {"dino_model": "RN50_regionclip", "regionclip_config": {"embed_dim": 1024},
     "encoder_w8a8": True},
    {"dino_model": None, "proxyclip_clipmodel": "ViT-B/16", "proxyclip_vfm": "dino",
     "attention_type": "kkv"},
    {"dino_model": "dinov2_vitl14_reg4_dinotxt_tet1280d20h24l", "calculate_argmax_text": True},
    {"dino_model": "resnet50"},
    {"attention_type": "kkv"},
    {"encoder_w8a8": True},
    {"calculate_argmax_text": True},
])
def test_what_the_port_still_refuses(extra):
    with pytest.raises(NotImplementedError):
        Patchioner.from_config(_shipped("decap_B16", **extra), allow_missing_weights=True,
                               random_bank_size=8, device="cpu")


def test_missing_clip_weights_need_the_explicit_opt_in():
    with pytest.raises(FileNotFoundError):
        Patchioner.from_config(_shipped("decap_B32", clip_weights="missing.pt"),
                               random_bank_size=8, device="cpu")


def test_clip_weights_are_read_through_the_hf_porter(tmp_path, monkeypatch):
    """A transformers-layout `clip_weights` file at a small geometry (the
    builder's ViT-B size shrunk) is read into the JAX porter's tree; a
    file of another depth raises at load."""
    small = dict(width=64, depth=2, heads=4, proj_dim=48)
    monkeypatch.setattr(patchioner, "_clip_size", lambda large: dict(small))
    sd = hf_clip_vision(30)
    path = str(tmp_path / "vit-b16-hf.pt")
    torch.save(sd, path)
    config = _shipped("decap_B16", clip_weights=path, prefix_size=48)
    pm = Patchioner.from_config(config, allow_missing_weights=True, random_bank_size=8,
                                device="cpu")
    want = jclip.port_hf_clip_vision(sd, 2)
    flat = jax.tree_util.tree_leaves_with_path(want)
    got = pm.vit_params
    for path_, leaf in flat:
        node = got
        for k in path_:
            node = node[k.key if hasattr(k, "key") else k.idx]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert set(pm.load_seconds) == {"read", "port", "upload"}
    small["depth"] = 3
    with pytest.raises(ValueError, match="depth 3"):
        Patchioner.from_config(config, allow_missing_weights=True, random_bank_size=8,
                               device="cpu")


@pytest.mark.parametrize("name", ["denseclip_segmentation_vitb16",
                                  "denseclip_segmentation_vitb16_long_ctx"])
def test_denseclip_geometry_copy_equals_its_yaml(name):
    with open(os.path.join(REPO, "patchioner_tpu", "data", "denseclip_configs",
                           f"{name}.yaml")) as f:
        want = yaml.safe_load(f)
    with open(os.path.join(patchioner.DENSECLIP_DIR, f"{name}.json")) as f:
        assert json.load(f) == want


def test_chip_smoke_clip_configs_are_the_shipped_files():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert len(smoke.CLIP_CONFIGS) == 8
    for name, config in smoke.CLIP_CONFIGS.items():
        with open(os.path.join(REPO, "configs", f"{name}.k.yaml")) as f:
            assert config == yaml.safe_load(f), name


# the CLIP-space entity embeddings and the Visual Genome vocabulary, copied
# from the JAX package's data folder
VENDORED = ["coco_embeddings_ViT-B16_with_ensemble.pickle", "coco_embeddings_ViT-B32.pickle",
            "coco_embeddings_ViT-B32_with_ensemble.pickle", "open_image_embeddings_ViT-B32.pickle",
            "open_image_embeddings_ViT-B32_with_ensemble.pickle", "vg_embeddings_ViT-B32.pickle",
            "vg_embeddings_ViT-B32_with_ensemble.pickle", "vgoi_embeddings_ViT-B32.pickle",
            "vgoi_embeddings_ViT-B32_with_ensemble.pickle",
            "all_objects_attributes_relationships.pickle"]


@pytest.mark.parametrize("name", VENDORED)
def test_vendored_vocabulary_file_is_the_jax_package_file(name):
    import filecmp

    from patchioner_tpu_torch.models import viecap

    assert filecmp.cmp(os.path.join(viecap.VOCAB_DIR, name),
                       os.path.join(REPO, "patchioner_tpu", "data", "viecap_vocabulary", name),
                       shallow=False)
