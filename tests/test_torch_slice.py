"""The port's flagship trace-caption slice end to end on the CPU: against
the JAX entry step, behind `patchioner_tpu.serve.CaptionServer`, its config
surface, and its independence from JAX."""

import importlib.util
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from patchioner_tpu.models import decap as jdecap
from patchioner_tpu.models import gpt2 as jgpt2
from patchioner_tpu.models import talk2dino as jt2d
from patchioner_tpu.models import vit as jvit
from patchioner_tpu.ops import memory_projection as jmp
from patchioner_tpu.serve import CaptionServer
from patchioner_tpu_torch import entry
from patchioner_tpu_torch import serve
from patchioner_tpu_torch.io import bridge
from patchioner_tpu_torch.models import gpt2, patchioner, talk2dino, vit
from patchioner_tpu_torch.models.patchioner import Patchioner
from patchioner_tpu_torch.ops import memory_projection as mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIT_GEOM = dict(img_size=56, patch_size=14, embed_dim=128, depth=2, num_heads=2,
                num_registers=4, extract_heads=4, pos_grid=4)
GPT_GEOM = dict(vocab_size=1000, n_positions=64, n_embd=128, n_layer=2, n_head=4)


@pytest.fixture(scope="module")
def jax_slice():
    sys.path.insert(0, REPO)
    import __graft_entry__ as ge

    jcfg = jvit.ViTConfig(**VIT_GEOM)
    jg = jgpt2.GPT2Config(**GPT_GEOM)
    vparams = jvit.init_vit(jax.random.PRNGKey(1), jcfg)
    dec = jdecap.init_decap(jax.random.PRNGKey(2), jg, prefix_size=128)
    rows = np.random.default_rng(3).standard_normal((200, 128)).astype(np.float32)
    bank = jmp.prepare_bank(jnp.asarray(rows), block_m=128)
    pixels, pts, valid = ge.example_inputs(batch=3, img=56, n_pts=16, seed=4)
    state = ge.make_state(vparams, dec, bank)
    prefix = ge.make_prefix_step(jcfg, False, bank.num_real)(state, pixels, pts, valid)
    tokens, scores = ge.make_caption_step(jcfg, jg, False, bank.num_real)(
        state, pixels, pts, valid)
    port_state = entry.make_state(bridge.vit_from_jax(vparams, vit.ViTConfig(**VIT_GEOM)),
                                  bridge.decap_from_jax(dec), bridge.bank_from_jax(bank))
    return dict(prefix=np.asarray(prefix), tokens=np.asarray(tokens),
                scores=np.asarray(scores), state=port_state, num_real=bank.num_real)


def test_caption_step_matches_jax_entry_at_f32(jax_slice):
    cfg, gcfg = vit.ViTConfig(**VIT_GEOM), gpt2.GPT2Config(**GPT_GEOM)
    inputs = entry.example_inputs(batch=3, img=56, n_pts=16, seed=4, device="cpu")
    prefix = entry.make_prefix_step(cfg, jax_slice["num_real"])(jax_slice["state"], *inputs)
    ref = jax_slice["prefix"]
    # the gate __graft_entry__ uses for sharded-vs-single prefixes
    assert np.max(np.abs(prefix.numpy() - ref)) <= 1e-4 * max(1.0, np.max(np.abs(ref)))
    tokens, scores = entry.make_caption_step(cfg, gcfg, jax_slice["num_real"])(
        jax_slice["state"], *inputs)
    np.testing.assert_array_equal(tokens.numpy(), jax_slice["tokens"])
    np.testing.assert_allclose(scores.numpy(), jax_slice["scores"], rtol=1e-4)


def test_talk2dino_inversion_matches_jax():
    rng = np.random.default_rng(5)
    t2d = {"linear": {"w": rng.standard_normal((64, 128)).astype(np.float32),
                      "b": rng.standard_normal(128).astype(np.float32)}}
    jinv = jt2d.build_inversion(t2d)
    inv = talk2dino.build_inversion(t2d)
    np.testing.assert_allclose(inv["A_pinv"].numpy(), np.asarray(jinv["A_pinv"]),
                               rtol=1e-5, atol=1e-6)
    feats = rng.standard_normal((3, 128)).astype(np.float32)
    want = jt2d.revert_transformation(jnp.asarray(feats), jinv)
    got = talk2dino.revert_transformation(torch.from_numpy(feats),
                                          bridge.inversion_from_jax(jinv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_prefix_step_applies_the_inversion_when_the_state_has_one(jax_slice):
    cfg = vit.ViTConfig(**VIT_GEOM)
    rng = np.random.default_rng(6)
    inv = talk2dino.build_inversion(
        {"linear": {"w": rng.standard_normal((64, 128)), "b": rng.standard_normal(128)}})
    inputs = entry.example_inputs(batch=3, img=56, n_pts=16, seed=4, device="cpu")
    step = entry.make_prefix_step(cfg, jax_slice["num_real"])
    plain = step(jax_slice["state"], *inputs)
    inverted = step(dict(jax_slice["state"], inversion=inv), *inputs)
    assert inverted.shape == (3, 64)
    torch.testing.assert_close(inverted, talk2dino.revert_transformation(plain, inv))


SERVER_CONFIG = {
    "dino_model": "dinov2_vitb14_reg", "crop_dim": 140, "prefix_size": 768,
    "support_memory_size": 591753, "normalize": True, "attention_type": "qkv",
    "decap_weights": "weights/decap/missing.pt",
}


def test_port_model_answers_through_caption_server():
    model = Patchioner.from_config(SERVER_CONFIG, allow_missing_weights=True,
                                   random_bank_size=256, device="cpu")
    assert model.supports_fused_trace_path() and model.crop_dim == 140
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (5, 140, 140, 3), dtype=np.uint8)
    traces = [rng.uniform(0, 1, (int(rng.integers(2, 10)), 2)).tolist() for _ in range(5)]
    with CaptionServer(model, max_batch=4, max_delay_ms=50.0) as server:
        caps = [f.result(timeout=300)
                for f in [server.submit(im, tr) for im, tr in zip(imgs, traces)]]
    assert all(isinstance(c, str) for c in caps)
    # padding rows and co-batched neighbours do not change a caption
    pts = np.zeros((1, 64, 2), np.float32)
    pts[0, : len(traces[4])] = traces[4]
    valid = (np.arange(64) < len(traces[4])).astype(np.float32)[None]
    assert model.caption_traces_fused(imgs[4:5], pts, valid) == [caps[4]]


def _chip_smoke_module():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_config_is_configs_mlp_k_yaml():
    with open(os.path.join(REPO, "configs", "mlp.k.yaml")) as f:
        assert _chip_smoke_module().FLAGSHIP_CONFIG == yaml.safe_load(f)


@pytest.mark.parametrize("path", ["mlp.k.yaml", "mlp.k.tpu-serving.yaml"])
def test_shipped_flagship_configs_build(path):
    model = Patchioner.from_config(os.path.join(REPO, "configs", path),
                                   allow_missing_weights=True, random_bank_size=8,
                                   device="cpu")
    assert model.vit_cfg.num_tokens == 1374 and model.bank.num_real == 8


def test_chip_smoke_viecap_config_is_configs_mlp_viecap_k_yaml():
    with open(os.path.join(REPO, "configs", "mlp.viecap.k.yaml")) as f:
        assert _chip_smoke_module().VIECAP_CONFIG == yaml.safe_load(f)


def test_chip_smoke_meacap_config_is_configs_mlp_meacap_k_yaml():
    with open(os.path.join(REPO, "configs", "mlp.meacap.k.yaml")) as f:
        assert _chip_smoke_module().MEACAP_CONFIG == yaml.safe_load(f)


def test_shipped_viecap_config_builds():
    """configs/mlp.viecap.k.yaml at full width: the ViT-B/14-reg encoder,
    no support memory, a VieCap with the 8-layer mapping network, GPT-2
    base in f32 and the COCO entities with their vendored embeddings."""
    model = Patchioner.from_config(os.path.join(REPO, "configs", "mlp.viecap.k.yaml"),
                                   allow_missing_weights=True, device="cpu")
    vc = model.viecap
    assert model.bank is None and not model.supports_fused_trace_path()
    assert model.vit_cfg.num_tokens == 1374 and vc.gpt2_cfg == gpt2.GPT2_BASE_CONFIG
    assert (vc.cfg.num_layers, vc.cfg.clip_hidden_size, vc.cfg.threshold) == (8, 768, 0.4)
    assert vc.gpt2_params["wte"].shape == (50257, 768) and len(vc.gpt2_params["blocks"]) == 12
    assert vc.mapping_params["linear"]["w"].shape == (768, 7680)
    assert len(vc.entities) == 80 and vc.texts_embeddings.shape == (80, 768)
    assert vc.cfg.using_hard_prompt and vc.cfg.soft_prompt_first and vc.cfg.using_greedy_search


# a DINOv2 `dino_model` wins over every other backbone key, as in the JAX
# package's `from_config`, so the other backbones' cases name theirs; each
# backbone the port takes is refused with a key it does not
@pytest.mark.parametrize("extra", [
    {"dino_model": "RN50_regionclip", "regionclip_config": {"config": "RN50"},
     "attention_type": "kkv"},
    {"viecap": {"hard_prompt_pad_multiple": 8}},
    {"dino_model": "dinov2_vitl14_reg4_dinotxt_tet1280d20h24l", "softmax_f32": False},
    {"attention_type": "kkv"}, {"dino_model": "dinov2_vitl14_reg", "encoder_w8a8": True},
    {"dino_model": None, "proxyclip_clipmodel": "ViT-B/16", "calculate_argmax_text": True},
    {"calculate_argmax_text": True},
    {"encoder_w8a8": True}, {"softmax_f32": False},
    {"dino_model": "resnet50"}, {"an_unknown_key": 1},
])
def test_keys_outside_the_subset_raise(extra):
    with pytest.raises(NotImplementedError):
        Patchioner.from_config(dict(SERVER_CONFIG, **extra),
                               allow_missing_weights=True, random_bank_size=8,
                               device="cpu")


CLIP_CONFIGS = ["decap_B16.k.yaml", "decap_B16_resize.k.yaml", "decap_B32.k.yaml",
                "INViTE_B16_1layer.k.yaml", "INViTE_B16_1layer_bigResize.k.yaml",
                "alphaclip_B16_CLS.k.yaml", "denseclip_B16_seg_40patches.k.yaml",
                "viecap.k.yaml", "viecap_b16_14patches.k.yaml", "viecap_b16_37patches.k.yaml",
                "meacap_invlm.k.yaml", "meacap_invlm_b16_14patches.k.yaml",
                "meacap_invlm_b16_37patches.k.yaml"]


# the backbone `_backbone_type` picks for each shipped config outside the
# DINOv2 and CLIP ones
OTHER_BACKBONES = {"regionclip_resnet50_p32_512.k.yaml": "RegionCLIP",
                   "proxyclip_b16.k.yaml": "ProxyCLIP", "proxyclip_b16_dinov2.k.yaml": "ProxyCLIP",
                   "dinotxt.yaml": "DINO"}


@pytest.mark.parametrize("path", ["mlp.k.yaml", "mlp.k.tpu-serving.yaml", "mlp.viecap.k.yaml",
                                  "mlp_noise.k.yaml", "mlp.meacap.k.yaml", *CLIP_CONFIGS,
                                  *OTHER_BACKBONES])
def test_the_port_takes_all_twenty_two_shipped_configs(path):
    """Every shipped config's keys are the port's: on DINOv2 the flagship
    and its int8 serving twin, ViECap, the noisy DeCap (`kkv_attention`,
    ignored), MeaCap and DINO.txt (ViT-L); on the CLIP tower DeCap (OpenAI
    CLIP B/16 and B/32, INViTE, AlphaCLIP, DenseCLIP), ViECap and MeaCap;
    RegionCLIP's ResNet and ProxyCLIP. Each builds on the CPU here or in
    test_torch_meacap.py, test_torch_checkpoints.py, test_torch_clip.py and
    test_torch_backbone_family.py."""
    with open(os.path.join(REPO, "configs", path)) as f:
        config = yaml.safe_load(f)
    patchioner._check_config(config)
    assert ("kkv_attention" in config) == (path == "mlp_noise.k.yaml")
    assert ("meacap" in (config.get("viecap") or {})) == ("meacap" in path)
    kind = patchioner._backbone_type(config)
    if path in OTHER_BACKBONES:
        assert kind == OTHER_BACKBONES[path]
    else:
        assert (kind == "DINO") == (path not in CLIP_CONFIGS)


def test_missing_weights_need_the_explicit_opt_in():
    with pytest.raises(FileNotFoundError):
        Patchioner.from_config(SERVER_CONFIG, random_bank_size=8, device="cpu")


_NO_JAX = """
import sys
import numpy as np
from patchioner_tpu_torch.models.patchioner import Patchioner
from patchioner_tpu_torch.serve import CaptionServer
cfg = {"dino_model": "dinov2_vits14_reg", "crop_dim": 28, "prefix_size": 64,
       "support_memory_size": 16, "dino_geometry": {"embed_dim": 64, "depth": 1,
       "num_heads": 1, "extract_heads": 1}, "decap_arch": {"n_layer": 1, "n_embd": 64, "n_head": 1,
       "vocab_size": 49408}}
m = Patchioner.from_config(cfg, allow_missing_weights=True, device="cpu")
caps = m.caption_traces_fused(np.zeros((2, 28, 28, 3), np.uint8),
                              np.full((2, 4, 2), 0.5, np.float32), np.ones((2, 4), np.float32))
assert len(caps) == 2
boxes = np.asarray([[[0, 0, 14, 14], [-1, -1, -1, -1]]] * 2, np.float32)
assert len(m.caption_bboxes_fused(np.zeros((2, 28, 28, 3), np.uint8), boxes)) == 2
assert len(m.caption_region_sets_fused(np.zeros((2, 28, 28, 3), np.uint8), boxes)) == 2
assert len(m.caption_images_fused(np.zeros((2, 28, 28, 3), np.uint8),
                                  caption_from="avg_self_attn")) == 2
with CaptionServer(m, max_batch=2) as server:
    server.warmup(cls=True, bbox=True, region_set=True)
    assert all(isinstance(c, str) for c in server.caption(
        np.zeros((3, 28, 28, 3), np.uint8), [[(0.5, 0.5)]] * 3, timeout=60))
    assert len(server.submit(np.zeros((28, 28, 3), np.uint8),
                             bboxes=[(0, 0, 0.5, 0.5)] * 3).result(timeout=60)) == 3
from patchioner_tpu_torch.models import gpt2
gpt2.GPT2_BASE_CONFIG = gpt2.GPT2Config(n_layer=1, n_embd=64, n_head=1, vocab_size=1000,
                                        n_positions=128)
# no ViT-B/16 vgoi entity embeddings are vendored: 64-wide ones are drawn
v = Patchioner.from_config(dict(cfg, support_memory_size=0, clip_model_name="ViT-B/16", viecap={
    "clip_hidden_size": 64, "using_hard_prompt": True, "using_greedy_search": True}),
    allow_missing_weights=True, device="cpu")
out = v.forward(np.zeros((2, 28, 28, 3), np.uint8), traces=[[(0.5, 0.5)]] * 2)
assert len(out["cls_capt"]) == len(out["trace_capts"]) == 2
with CaptionServer(v, max_batch=2) as server:
    assert isinstance(server.submit(np.zeros((28, 28, 3), np.uint8)).result(timeout=120), str)
mea = Patchioner.from_config(dict(cfg, support_memory_size=0, viecap={
    "clip_hidden_size": 64, "using_hard_prompt": True, "using_greedy_search": True,
    "meacap": {"memory_caption_num": 3}}), allow_missing_weights=True, device="cpu")
assert len(mea.forward(np.zeros((2, 28, 28, 3), np.uint8))["cls_capt"]) == 2
cc = Patchioner.from_config(dict(cfg, support_memory_size=0, dino_geometry={"depth": 1},
                                 clipcap={"prefix_length": 2, "entry_length": 4}),
                            allow_missing_weights=True, device="cpu")
assert len(cc.forward(np.zeros((2, 28, 28, 3), np.uint8))["cls_capt"]) == 2
print("jax loaded:", any(k == "jax" or k.startswith("jax.") for k in sys.modules))
print("reference loaded:", sorted(k for k in sys.modules if k.split(".")[0] == "patchioner_tpu"))
"""


def test_port_runs_end_to_end_without_jax():
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "jax loaded: False" in proc.stdout
    assert "reference loaded: []" in proc.stdout


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(alone, tmp_path):
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:  # a directory holding chip_smoke.py and nothing else
        shutil.copy(script, tmp_path)
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_vit_l_is_refused_until_kernel_c_takes_d_1024():
    """The rule the name states: a ViT is refused while kernel C cannot
    take its width. C's f32 body takes D <= 1024, so both ViT-L variants
    build (16 heads of 64, hidden 4096), and a wider MLP encoder (D =
    1056) is refused."""
    for variant, regs in (("dinov2_vitl14", 0), ("dinov2_vitl14_reg", 4)):
        m = Patchioner.from_config(dict(SERVER_CONFIG, dino_model=variant, prefix_size=1024,
                                        dino_geometry={"depth": 1}),
                                   allow_missing_weights=True, random_bank_size=8, device="cpu")
        assert (m.vit_cfg.embed_dim, m.vit_cfg.num_heads, m.vit_cfg.num_registers,
                m.vit_cfg.ffn_hidden) == (1024, 16, regs, 4096)
    with pytest.raises(NotImplementedError, match="kernel C"):
        Patchioner.from_config(dict(SERVER_CONFIG, dino_model="dinov2_vitl14_reg",
                                    dino_geometry={"embed_dim": 1056}),
                               allow_missing_weights=True, random_bank_size=8, device="cpu")


_NO_CARD = """
from patchioner_tpu_torch import entry
from patchioner_tpu_torch.models.patchioner import Patchioner
cfg = {"dino_model": "dinov2_vits14_reg", "crop_dim": 28, "prefix_size": 64,
       "support_memory_size": 16}
for call in (lambda: Patchioner.from_config(cfg, allow_missing_weights=True),
             lambda: entry.example_inputs(1, img=28)):
    try:
        call()
    except RuntimeError as e:
        print("raised:", e)
    else:
        print("ran without a card")
"""


def test_entry_points_default_to_the_card_and_raise_without_one():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", _NO_CARD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("raised:") == 2 and "device='cpu'" in proc.stdout
    assert "ran without a card" not in proc.stdout


# every attention configuration the port accepts, through from_config at the
# reduced geometry of the JAX slice above (bridged weights, layerscale near
# 1 so that the attention half moves the residual stream)
SLICE_CONFIGS = [
    {"attn_impl": "fusedqkv", "gelu_approx": True},
    {"attn_impl": "fusedqkv", "proj_fused": True},
    {"attn_impl": "fusedqkv_proj"},
    {"attn_impl": "flash"},
    {"attn_impl": "flash1p"},
    {"attn_impl": "flash_builtin"},
]
TINY_CONFIG = {
    "dino_model": "dinov2_vitb14_reg", "crop_dim": 56, "prefix_size": 128,
    "support_memory_size": 200, "normalize": True,
    "dino_geometry": {k: VIT_GEOM[k] for k in ("embed_dim", "depth", "num_heads",
                                               "extract_heads", "pos_grid")},
}


@pytest.fixture(scope="module")
def jax_weights():
    sys.path.insert(0, REPO)
    import __graft_entry__ as ge

    vparams = jvit.init_vit(jax.random.PRNGKey(7), jvit.ViTConfig(**VIT_GEOM))
    ls = np.random.default_rng(8).uniform(0.5, 1.5, (2, 2, 128)).astype(np.float32)
    vparams["blocks"] = [dict(b, ls1=jnp.asarray(ls[i, 0]), ls2=jnp.asarray(ls[i, 1]))
                         for i, b in enumerate(vparams["blocks"])]
    dec = jdecap.init_decap(jax.random.PRNGKey(9), jgpt2.GPT2Config(**GPT_GEOM),
                            prefix_size=128)
    rows = np.random.default_rng(10).standard_normal((200, 128)).astype(np.float32)
    return ge, vparams, dec, jmp.prepare_bank(jnp.asarray(rows), block_m=128)


def _serves(model):
    rng = np.random.default_rng(12)
    imgs = rng.integers(0, 256, (3, 56, 56, 3), dtype=np.uint8)
    traces = [rng.uniform(0, 1, (5, 2)).tolist() for _ in range(3)]
    with serve.CaptionServer(model, max_batch=4, max_delay_ms=50.0) as server:
        caps = server.caption(imgs, traces, timeout=120)
    assert len(caps) == 3 and all(isinstance(c, str) for c in caps)


@pytest.mark.parametrize("opts", SLICE_CONFIGS, ids=lambda o: "-".join(
    f"{k}={v}" for k, v in o.items()))
def test_each_attention_config_is_token_exact_and_serves(opts, jax_weights):
    from jax.experimental.pallas import tpu as pltpu

    ge, vparams, dec, bank = jax_weights
    jcfg, jg = jvit.ViTConfig(**VIT_GEOM, **opts), jgpt2.GPT2Config(**GPT_GEOM)
    inputs = ge.example_inputs(batch=3, img=56, n_pts=16, seed=11)
    with pltpu.force_tpu_interpret_mode():
        want, _ = ge.make_caption_step(jcfg, jg, False, bank.num_real)(
            ge.make_state(vparams, dec, bank), *inputs)

    built = Patchioner.from_config(dict(TINY_CONFIG, **opts), allow_missing_weights=True,
                                   random_bank_size=8, device="cpu")
    cfg = built.vit_cfg
    assert (cfg.attn_impl, cfg.proj_fused, cfg.gelu_approx) == (
        opts["attn_impl"], opts.get("proj_fused", False), opts.get("gelu_approx", False))
    gcfg = gpt2.GPT2Config(**GPT_GEOM)
    model = Patchioner(vit_cfg=cfg, vit_params=bridge.vit_from_jax(vparams, cfg),
                       gpt2_cfg=gcfg, decoder=bridge.decap_from_jax(dec),
                       bank=bridge.bank_from_jax(bank), config=built.config,
                       device="cpu")
    step = entry.make_caption_step(cfg, gcfg, bank.num_real)
    tokens, _ = step(model.state(), *entry.example_inputs(batch=3, img=56, n_pts=16,
                                                          seed=11, device="cpu"))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want))
    _serves(model)


# ViT-g (kernel G, and F under fusedqkv_proj) and the int8 support memory
# (kernel H) through from_config, at a geometry shrunk from the giant's:
# D = 384 in six heads of 64 (JAX's fused-qkv kernels take head pairs),
# SwiGLU hidden 1024, two layers; f32 on both sides
GIANT_GEOM = dict(img_size=56, embed_dim=384, depth=2, num_heads=6, num_registers=4,
                  extract_heads=6, pos_grid=4, ffn="swiglu")
TINY_GIANT_CONFIG = {
    "dino_model": "dinov2_vitg14_reg", "crop_dim": 56, "prefix_size": 384,
    "support_memory_size": 200, "normalize": True, "attn_impl": "fusedqkv",
    "mlp_fused": True,
    "dino_geometry": {k: GIANT_GEOM[k] for k in ("embed_dim", "depth", "num_heads",
                                                 "extract_heads", "pos_grid")},
}


@pytest.mark.parametrize("attn_impl", ["fusedqkv", "fusedqkv_proj"])
def test_giant_from_config_is_token_exact_and_serves(attn_impl):
    from jax.experimental.pallas import tpu as pltpu

    sys.path.insert(0, REPO)
    import __graft_entry__ as ge

    jcfg = jvit.ViTConfig(**GIANT_GEOM, attn_impl=attn_impl, mlp_fused=True)
    assert jcfg.ffn_hidden == 1024
    vparams = jvit.init_vit(jax.random.PRNGKey(13), jcfg)
    ls = np.random.default_rng(14).uniform(0.5, 1.5, (2, 2, 384)).astype(np.float32)
    vparams["blocks"] = [dict(b, ls1=jnp.asarray(ls[i, 0]), ls2=jnp.asarray(ls[i, 1]))
                         for i, b in enumerate(vparams["blocks"])]
    jg = jgpt2.GPT2Config(**GPT_GEOM)
    dec = jdecap.init_decap(jax.random.PRNGKey(15), jg, prefix_size=384)
    rows = np.random.default_rng(16).standard_normal((200, 384)).astype(np.float32)
    bank = jmp.prepare_bank(jnp.asarray(rows), block_m=128)
    inputs = ge.example_inputs(batch=3, img=56, n_pts=16, seed=17)
    with pltpu.force_tpu_interpret_mode():  # the encoder's Pallas kernels
        want, _ = ge.make_caption_step(jcfg, jg, False, bank.num_real)(
            ge.make_state(vparams, dec, bank), *inputs)

    built = Patchioner.from_config(dict(TINY_GIANT_CONFIG, attn_impl=attn_impl),
                                   allow_missing_weights=True, random_bank_size=8,
                                   device="cpu")
    cfg = built.vit_cfg
    assert (cfg.ffn, cfg.embed_dim, cfg.ffn_hidden, cfg.attn_impl) == (
        "swiglu", 384, 1024, attn_impl)
    assert built.bank.rows.shape == (8, 384)
    gcfg = gpt2.GPT2Config(**GPT_GEOM)
    model = Patchioner(vit_cfg=cfg, vit_params=bridge.vit_from_jax(vparams, cfg),
                       gpt2_cfg=gcfg, decoder=bridge.decap_from_jax(dec),
                       bank=bridge.bank_from_jax(bank), config=built.config,
                       device="cpu")
    tokens, _ = entry.make_caption_step(cfg, gcfg, bank.num_real)(
        model.state(), *entry.example_inputs(batch=3, img=56, n_pts=16, seed=17,
                                             device="cpu"))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want))
    _serves(model)


def test_int8_bank_from_config_is_token_exact_and_serves(jax_weights):
    from patchioner_tpu.ops import region_pooling as jrp

    ge, vparams, dec, _ = jax_weights
    jcfg, jg = jvit.ViTConfig(**VIT_GEOM), jgpt2.GPT2Config(**GPT_GEOM)
    rows = np.random.default_rng(18).standard_normal((200, 128)).astype(np.float32)
    qbank = jmp.quantize_bank(jnp.asarray(rows))
    pixels, pts, valid = ge.example_inputs(batch=3, img=56, n_pts=16, seed=19)
    # the JAX trace step with the int8 kernel in interpret mode in place of
    # its CPU fallback, which renormalises the dequantized rows (ROADMAP
    # section 3); the kernel is what the reference runs on the TPU
    outs = jvit.vit_forward(vparams, pixels, jcfg)
    attn, _ = jvit.process_self_attention(
        outs["qkv_last"], num_heads=jcfg.extract_heads,
        num_global_tokens=jcfg.num_global_tokens, scale=jcfg.extract_scale)
    feats = jrp.trace_pool(outs["x_norm_patchtokens"],
                           jrp.traces_to_grid(pts, valid, jcfg.grid_size), attn)
    prefix = jmp.memory_project_int8(feats, qbank, normalize=True, interpret=True)
    want, _ = jdecap.greedy_decode(dec, prefix, jg)

    built = Patchioner.from_config(dict(TINY_CONFIG, memory_bank_int8=True),
                                   allow_missing_weights=True, random_bank_size=8,
                                   device="cpu")
    assert isinstance(built.bank, mp.QuantizedBank) and built.bank.rows.dtype == torch.int8
    assert "bank_scale" in built.state()
    cfg, gcfg = built.vit_cfg, gpt2.GPT2Config(**GPT_GEOM)
    model = Patchioner(vit_cfg=cfg, vit_params=bridge.vit_from_jax(vparams, cfg),
                       gpt2_cfg=gcfg, decoder=bridge.decap_from_jax(dec),
                       bank=bridge.bank_from_jax(qbank), config=built.config,
                       device="cpu")
    before = (mp.memory_project_int8.launches, mp.memory_project_streamed.launches)
    tokens, _ = entry.make_caption_step(cfg, gcfg, qbank.num_real)(
        model.state(), *entry.example_inputs(batch=3, img=56, n_pts=16, seed=19,
                                             device="cpu"))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want))
    assert (mp.memory_project_int8.launches, mp.memory_project_streamed.launches) == before
    _serves(model)


def test_chip_smoke_giant_config_is_the_flagship_with_vitg():
    mod = _chip_smoke_module()
    assert mod.GIANT_CONFIG == dict(mod.FLAGSHIP_CONFIG, dino_model="dinov2_vitg14_reg",
                                    prefix_size=1536)
