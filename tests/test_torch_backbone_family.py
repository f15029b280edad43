"""The rest of the backbone family through the port's `from_config`, against
the JAX package's on the same files, on the CPU in f32: RegionCLIP's RN50
at full width (a detection checkpoint, a 64 px crop), ProxyCLIP B/16 with
DINOv2 B/14-reg at full widths (56 px, mosaic images whose proxy affinity
puts real weight off its diagonal) and DINO.txt's ViT-L/14-reg (two
blocks, the goldens' reduced geometry: 140 px, a 256-row bank of DINO.txt's
2048-wide rows), each with a small DeCap file and an HDF5 bank. The
projected prefix within 1e-4 * max(1, max|ref|), captions string for
string (whole image, boxes, traces; DINO.txt's fused paths too); the
missing-file errors both packages raise; ViT-L's geometry; kernel C's
plain version at D = 1024 against the Pallas kernel in interpret mode."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from patchioner_tpu.models import vit as jvit
from patchioner_tpu.models.patchioner import Patchioner as JaxPatchioner
from patchioner_tpu.ops import mlp as jmlp
from patchioner_tpu_torch.io import memory_bank
from patchioner_tpu_torch.models import clip, patchioner, resnet_clip, vit
from patchioner_tpu_torch.models.patchioner import Patchioner
from patchioner_tpu_torch.ops import mlp
from test_torch_checkpoints import decap_sd, hub_dinov2
from test_torch_clip import openai_clip_vision
from test_torch_proxyclip import off_diagonal_mass
from test_torch_resnet_clip import resnet_sd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANK_ROWS = 256
DECAP = {"n_layer": 2, "n_head": 4, "n_embd": 128, "vocab_size": 1000}
BOXES = {64: [[[0, 0, 32, 32], [16, 16, 40, 40]], [[8, 8, 48, 48], [0, 0, 64, 20]]],
         56: [[[0, 0, 28, 28], [14, 14, 42, 42]], [[0, 0, 56, 56], [28, 0, 28, 56]]],
         140: [[[0, 0, 70, 70], [30, 40, 100, 90]], [[14, 14, 112, 112], [0, 0, 140, 28]]]}
TRACES = [[{"x": 0.1, "y": 0.2}, {"x": 0.5, "y": 0.5}, {"x": 0.9, "y": 0.3}],
          [(0.3, 0.7), (0.35, 0.75), (0.8, 0.9)]]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bank(path, width, seed):
    emb = np.random.default_rng(seed).standard_normal((BANK_ROWS, width)).astype(np.float32)
    memory_bank.save_bank(path, "coco_captions", memory_bank.MemoryBank(
        emb, [f"a caption {i}" for i in range(BANK_ROWS)]))


def _dino_pos(sd, key, d, seed):
    """The DINOv2 checkpoints' 37 x 37 stored position grid."""
    sd[key] = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (1, 1 + 37 * 37, d)).astype(np.float32) * 0.02)
    return sd


def _regionclip(tmp):
    """RN50 at full width in a detection checkpoint (`model`, detectron's
    `backbone.`), its pool grid the 64 px crop's."""
    sd = resnet_sd(30, layers=(3, 4, 6, 3), width=64, out=1024, tokens=5, prefix="backbone.")
    torch.save({"model": sd, "iteration": 1}, tmp / "regionclip.pth")
    torch.save(decap_sd(31, 1024), tmp / "decap_1024.pt")
    _bank(str(tmp / "bank_1024.h5"), 1024, 32)
    return {"dino_model": "RN50_regionclip", "crop_dim": 64, "resize_dim": 64,
            "prefix_size": 1024, "support_memory_size": BANK_ROWS, "normalize": False,
            "projection_type": "coco", "memory_bank_path": str(tmp / "bank_1024.h5"),
            "decap_weights": str(tmp / "decap_1024.pt"), "decap_arch": DECAP,
            "regionclip_config": {"checkpoint": str(tmp / "regionclip.pth"), "embed_dim": 1024,
                                  "patch_size": 32}}


def _proxyclip(tmp):
    """ProxyCLIP B/16 (the openai layout, 224 px) with DINOv2 B/14-reg."""
    torch.save(openai_clip_vision(33, alpha=False, d=768, depth=12, p=16, grid=14, proj=512),
               tmp / "clip_b16.pt")
    torch.save(_dino_pos(hub_dinov2(34, depth=12, d=768), "pos_embed", 768, 35),
               tmp / "dinov2_vitb14_reg.pth")
    torch.save(decap_sd(36, 512), tmp / "decap_512.pt")
    _bank(str(tmp / "bank_512.h5"), 512, 37)
    return {"proxyclip_clipmodel": "ViT-B/16", "proxyclip_vfm": "dinov2", "crop_dim": 56,
            "resize_dim": 56, "prefix_size": 512, "support_memory_size": BANK_ROWS,
            "normalize": False, "projection_type": "coco",
            "memory_bank_path": str(tmp / "bank_512.h5"),
            "clip_weights": str(tmp / "clip_b16.pt"),
            "dino_weights": str(tmp / "dinov2_vitb14_reg.pth"),
            "decap_weights": str(tmp / "decap_512.pt"), "decap_arch": DECAP}


def _dinotxt(tmp):
    """A DINO.txt checkpoint, its ViT-L/14-reg backbone (two blocks) under
    `visual_model.backbone.model.`; the bank's 2048-wide rows are read
    [:, 1024:]."""
    hub = _dino_pos(hub_dinov2(38, depth=2, d=1024), "pos_embed", 1024, 39)
    torch.save({f"visual_model.backbone.model.{k}": v for k, v in hub.items()},
               tmp / "dinotxt.pth")
    torch.save(decap_sd(40, 1024), tmp / "decap_dinotxt.pt")
    _bank(str(tmp / "bank_2048.h5"), 2048, 41)
    return {"dino_model": "dinov2_vitl14_reg4_dinotxt_tet1280d20h24l", "crop_dim": 140,
            "dino_geometry": {"depth": 2}, "prefix_size": 1024,
            "support_memory_size": BANK_ROWS, "normalize": True, "projection_type": "coco",
            "memory_bank_path": str(tmp / "bank_2048.h5"), "dino_weights": str(tmp / "dinotxt.pth"),
            "decap_weights": str(tmp / "decap_dinotxt.pt"), "decap_arch": DECAP}


BACKBONES = {"RegionCLIP": _regionclip, "ProxyCLIP": _proxyclip, "DINO.txt": _dinotxt}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Each backbone's (config, JAX model, port model), built on first use
    from the same files."""
    tmp = tmp_path_factory.mktemp("backbones")

    class Pairs(dict):
        def __missing__(self, name):
            config = BACKBONES[name](tmp)
            self[name] = (config, JaxPatchioner.from_config(config, dtype=jnp.float32),
                          Patchioner.from_config(config, device="cpu"))
            return self[name]

    return Pairs()


def _imgs(crop, mosaic=False):
    """Two seeded uint8 images; a mosaic is 2 x 2 flat colours with a
    little noise, whose like patches give the proxy affinity weight off
    its diagonal (noise keeps the diagonal alone)."""
    rng = np.random.default_rng(crop)
    if not mosaic:
        return rng.integers(0, 256, (2, crop, crop, 3), dtype=np.uint8)
    cell = -(-crop // 2)
    tiles = np.repeat(np.repeat(rng.integers(0, 256, (2, 2, 2, 3)), cell, 1), cell, 2)
    return np.clip(tiles[:, :crop, :crop] + rng.integers(-20, 21, (2, crop, crop, 3)), 0,
                   255).astype(np.uint8)


@pytest.mark.parametrize("name", BACKBONES)
def test_from_config_picks_the_backbone_jax_picks(models, name):
    config, jm, pm = models[name]
    kind = {"DINO.txt": "DINO"}.get(name, name)
    assert pm.backbone_type == jm.backbone_type == kind
    assert (pm.patch_size, pm.crop_dim) == (jm.patch_size, jm.crop_dim)
    assert pm.supports_fused_trace_path() == (name == "DINO.txt")
    assert pm.bank.num_real == BANK_ROWS and pm.bank.rows.shape[1] == config["prefix_size"]
    np.testing.assert_array_equal(pm.bank.rows.numpy(),
                                  np.asarray(jm.bank.rows)[:BANK_ROWS])
    if name == "DINO.txt":
        assert (pm.vit_cfg.embed_dim, pm.vit_cfg.num_heads, pm.vit_cfg.num_registers,
                pm.vit_cfg.depth) == (1024, 16, 4, 2)


@pytest.mark.parametrize("name", BACKBONES)
def test_prefix_equals_jax(models, name):
    """The encoder's tokens and the projected prefix of the whole image
    (RegionCLIP and DINO.txt: the CLS token; ProxyCLIP: the patch mean,
    on images where every row of the affinity puts at least 10% of its
    weight off the diagonal)."""
    config, jm, pm = models[name]
    imgs = _imgs(pm.crop_dim, mosaic=name == "ProxyCLIP")
    if name == "ProxyCLIP":
        mass = off_diagonal_mass(pm.vit_params["vfm"], pm._pixels(imgs), pm.vit_cfg)
        assert mass.min() >= 0.1
    jenc, penc = jm.encode_images(imgs), pm.encode_images(imgs)
    keys = ["x_norm_patchtokens"] + (["x_norm_clstoken"] if name != "ProxyCLIP" else [])
    for key in keys:
        ref = np.asarray(jenc[key])
        np.testing.assert_allclose(penc[key].numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(ref).max()))
    if name == "ProxyCLIP":
        assert set(penc) == set(jenc) == {"x_norm_patchtokens"}
    whole = keys[-1]
    if name == "ProxyCLIP":
        jf, pf = jnp.mean(jenc[whole], axis=1), penc[whole].mean(dim=1)
    else:
        jf, pf = jenc[whole], penc[whole]
    want = np.asarray(jm.project_features(jf))
    got = pm.project_features(pf).numpy()
    assert got.shape == want.shape == (2, config["prefix_size"])
    assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("name", BACKBONES)
def test_forward_captions_equal_jax(models, name):
    _, jm, pm = models[name]
    imgs = _imgs(pm.crop_dim, mosaic=name == "ProxyCLIP")
    flags = dict(get_cls_capt=name != "ProxyCLIP", get_avg_patch_capt=name == "ProxyCLIP",
                 bboxes=np.asarray(BOXES[pm.crop_dim], np.float32), traces=TRACES,
                 compute_scores=True)
    want, got = jm.forward(imgs, **flags), pm.forward(imgs, **flags)
    assert sorted(got) == sorted(want)
    for key in want:
        if key.endswith("_scores"):
            np.testing.assert_allclose(np.asarray(got[key], np.float64),
                                       np.asarray(want[key], np.float64), rtol=1e-4)
        else:
            assert got[key] == want[key], key
    if name == "ProxyCLIP":
        for m in (jm, pm):
            with pytest.raises(ValueError, match="patch tokens only"):
                m.forward(imgs, get_cls_capt=True)


def test_dinotxt_fused_paths_equal_jax(models):
    _, jm, pm = models["DINO.txt"]
    imgs = _imgs(140)
    rng = np.random.default_rng(42)
    pts, valid = rng.uniform(0, 1, (2, 8, 2)).astype(np.float32), np.ones((2, 8), np.float32)
    boxes = np.asarray(BOXES[140], np.float32)
    assert (pm.caption_traces_fused(imgs, pts, valid, use_attention_tracing=True)
            == jm.caption_traces_fused(imgs, pts, valid, use_attention_tracing=True))
    assert pm.caption_bboxes_fused(imgs, boxes) == jm.caption_bboxes_fused(imgs, boxes)
    assert pm.caption_images_fused(imgs) == jm.caption_images_fused(imgs)


def test_regionclip_feature_compatibility_equals_jax(models):
    _, jm, pm = models["RegionCLIP"]
    pixels = np.random.default_rng(43).standard_normal((2, 64, 64, 3)).astype(np.float32)
    want, got = jm.analyze_feature_compatibility(pixels), pm.analyze_feature_compatibility(pixels)
    assert sorted(got) == sorted(want) == ["layer3", "layer4"]
    for layer in want:
        assert sorted(got[layer]) == sorted(want[layer])
        for key, value in want[layer].items():
            if isinstance(value, float):
                assert got[layer][key] == pytest.approx(value, rel=1e-4, abs=1e-6), key
            else:
                assert got[layer][key] == value, key
    assert pm.analyze_feature_compatibility(pixels, analyze_layers=False).keys() == {"layer4"}


@pytest.mark.parametrize("name", BACKBONES)
def test_a_missing_file_raises_as_in_jax(models, name, tmp_path):
    """The backbone's weights missing: FileNotFoundError from both packages' `from_config`
    without `allow_missing_weights`; seeded random weights with it."""
    config = dict(models[name][0])
    if name == "RegionCLIP":
        config["regionclip_config"] = dict(config["regionclip_config"],
                                           checkpoint=str(tmp_path / "missing.pth"))
    else:
        config["dino_weights"] = str(tmp_path / "missing.pth")
    for build in (lambda: JaxPatchioner.from_config(config, dtype=jnp.float32),
                  lambda: Patchioner.from_config(config, device="cpu")):
        with pytest.raises(FileNotFoundError):
            build()
    if name != "ProxyCLIP":  # full-width random towers are the slow part
        pm = Patchioner.from_config(config, allow_missing_weights=True, device="cpu")
        assert pm.backbone_type == models[name][2].backbone_type


def test_a_checkpoint_that_disagrees_with_the_config_raises_at_load(models, tmp_path):
    """The fixture's detection checkpoint with a 512-wide `c_proj`."""
    config, _, _ = models["RegionCLIP"]
    sd = torch.load(config["regionclip_config"]["checkpoint"], weights_only=True)["model"]
    sd["backbone.attnpool.c_proj.weight"] = sd["backbone.attnpool.c_proj.weight"][:512]
    sd["backbone.attnpool.c_proj.bias"] = sd["backbone.attnpool.c_proj.bias"][:512]
    path = tmp_path / "rn.pth"
    torch.save({"model": sd}, path)
    with pytest.raises(ValueError, match="output_dim 1024"):
        Patchioner.from_config(dict(config, regionclip_config=dict(
            config["regionclip_config"], checkpoint=str(path))), device="cpu")


def test_vit_l_geometry_equals_jax():
    """dinov2_vitl14_reg: D = 1024, 24 blocks, 16 heads of 64, 4 registers,
    extraction 16 heads at 0.125 over 5 global tokens, hidden 4096."""
    got, want = vit.config_for("dinov2_vitl14_reg"), jvit.config_for("dinov2_vitl14_reg")
    for field in ("img_size", "patch_size", "embed_dim", "depth", "num_heads", "num_registers",
                  "extract_heads", "extract_scale", "pos_grid", "ffn", "ffn_hidden",
                  "num_global_tokens", "num_tokens"):
        assert getattr(got, field) == getattr(want, field), field
    assert (got.embed_dim, got.depth, got.num_heads, got.ffn_hidden) == (1024, 24, 16, 4096)
    assert patchioner._MAX_EMBED_DIM["mlp"] >= got.embed_dim


@pytest.mark.parametrize("gelu_approx", [False, True])
def test_ln_mlp_plain_matches_pallas_at_vit_l_width(gelu_approx):
    """Kernel C's plain version at D = 1024, H = 4096 (the width its f32
    CUDA body was widened to) against the Pallas kernel in interpret mode,
    at 16 rows."""
    rng = np.random.default_rng(45)
    d, h = 1024, 4096

    def arr(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    args = (arr(1, 16, d), 1 + arr(d, scale=0.1), arr(d, scale=0.1), arr(d, h, scale=d ** -0.5),
            arr(h, scale=0.1), arr(h, d, scale=h ** -0.5), arr(d, scale=0.1), 1 + arr(d, scale=0.1))
    got = mlp.fused_ln_mlp(*map(torch.from_numpy, args), eps=1e-6, gelu_approx=gelu_approx)
    want = jmlp.fused_ln_mlp(*map(jnp.asarray, args), eps=1e-6, gelu_approx=gelu_approx,
                             block_q=16, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_chip_smoke_backbone_configs_are_the_shipped_files():
    from test_torch_checkpoints import _chip_smoke_module

    smoke = _chip_smoke_module()
    shipped = {"regionclip_resnet50_p32_512.k.yaml": smoke.REGIONCLIP_CONFIG,
               "proxyclip_b16_dinov2.k.yaml": smoke.PROXYCLIP_CONFIGS["proxyclip_b16_dinov2"],
               "proxyclip_b16.k.yaml": smoke.PROXYCLIP_CONFIGS["proxyclip_b16"],
               "dinotxt.yaml": smoke.DINOTXT_CONFIG}
    for name, config in shipped.items():
        with open(os.path.join(REPO, "configs", name)) as f:
            assert config == yaml.safe_load(f), name


def test_chip_smoke_writes_the_backbone_layouts_the_port_reads():
    """Phase 14 writes its RegionCLIP and CLIP files from the port's own
    trees; each must port back to the tree it came from."""
    from test_torch_checkpoints import _assert_trees_equal, _chip_smoke_module

    smoke = _chip_smoke_module()
    gen = torch.Generator().manual_seed(46)
    cfg = resnet_clip.ResNetClipConfig(layers=(1, 2, 1, 1), width=16, output_dim=24, heads=4,
                                       img_size=64)
    tree = resnet_clip.init_resnet_clip(cfg, gen)
    sd = {"visual." + k[len("backbone."):]: v
          for k, v in smoke.regionclip_state_dict(tree).items()}
    _assert_trees_equal(resnet_clip.port_clip_resnet(sd, cfg),
                        jax.tree_util.tree_map(lambda t: t.numpy(), tree))
    ccfg = clip.ClipVisionConfig(img_size=32, patch_size=16, width=64, depth=2, heads=4,
                                 proj_dim=48)
    ctree = clip.init_clip_vision(ccfg, gen)
    _assert_trees_equal(clip.port_openai_clip_vision(smoke.clip_vision_state_dict(ctree), 2),
                        jax.tree_util.tree_map(lambda t: t.numpy(), ctree))
