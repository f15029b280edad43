"""The port's box, whole-image and region-set caption paths against the JAX
package's fused ones, on the same bridged weights in f32 on the CPU: a JAX
`Patchioner` built as in `tests/test_patchioner.py` (56 px crop, 2 layers,
D = 128, a 200-row bank; layerscale drawn near 1 so that the encoder moves
the tokens), carried into the port through `io.bridge`. Caption strings
must be identical for every variant `tests/test_patchioner.py` exercises."""

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
from patchioner_tpu_torch import entry
from patchioner_tpu_torch.io import bridge
from patchioner_tpu_torch.models import gpt2, vit
from patchioner_tpu_torch.models.patchioner import Patchioner
from patchioner_tpu_torch.ops import memory_projection as mp

VIT_GEOM = dict(img_size=56, patch_size=14, embed_dim=128, depth=2, num_heads=4,
                num_registers=4, extract_heads=4, pos_grid=4)
GPT_GEOM = dict(vocab_size=49408, n_layer=2, n_head=4, n_embd=128)


def _port(jm, bank=None) -> Patchioner:
    cfg = vit.ViTConfig(**VIT_GEOM)
    return Patchioner(vit_cfg=cfg, vit_params=bridge.vit_from_jax(jm.vit_params, cfg),
                      gpt2_cfg=gpt2.GPT2Config(**GPT_GEOM),
                      decoder=bridge.decap_from_jax(jm.decoder),
                      bank=bridge.bank_from_jax(bank or jm.bank), normalize=True,
                      device="cpu")


@pytest.fixture(scope="module")
def models():
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    jcfg, jg = jvit.ViTConfig(**VIT_GEOM), jgpt2.GPT2Config(**GPT_GEOM)
    vparams = jvit.init_vit(k1, jcfg)
    ls = np.random.default_rng(1).uniform(0.5, 1.5, (2, 2, 128)).astype(np.float32)
    vparams["blocks"] = [dict(b, ls1=jnp.asarray(ls[i, 0]), ls2=jnp.asarray(ls[i, 1]))
                         for i, b in enumerate(vparams["blocks"])]
    jm = JaxPatchioner(vit_cfg=jcfg, vit_params=vparams, gpt2_cfg=jg,
                       decoder=jdecap.init_decap(k2, jg, prefix_size=128),
                       bank=jmp.prepare_bank(jax.random.normal(k3, (200, 128))),
                       bank_texts=[f"caption {i}" for i in range(200)], normalize=True)
    return jm, _port(jm)


@pytest.fixture(scope="module")
def imgs():
    return np.random.default_rng(0).standard_normal((2, 56, 56, 3)).astype(np.float32)


# tests/test_patchioner.py:297-300, and a [-1] * 4 dummy: a zero feature and
# a NaN prefix under normalize in both packages
BOXES = np.asarray([[[0, 0, 28, 28], [14, 14, 56, 56], [0, 0, 1, 1]],
                    [[7, 7, 42, 42], [0, 0, 1, 1], [0, 0, 1, 1]]], np.float32)
BOXES_NEG = np.asarray([[[0, 0, 28, 28], [-1, -1, -1, -1]],
                        [[7, 7, 42, 42], [14, 0, 20, 50]]], np.float32)
BOX_VARIANTS = {
    "uniform": (BOXES, dict()),
    "gaussian_0.7": (BOXES, dict(gaussian_avg=True, gaussian_bbox_variance=0.7)),
    "attention_map": (BOXES, dict(use_attn_map_for_bboxes=True)),
    "uniform_neg_dummy": (BOXES_NEG, dict()),
    "attention_map_neg_dummy": (BOXES_NEG, dict(use_attn_map_for_bboxes=True)),
}


@pytest.mark.parametrize("variant", BOX_VARIANTS)
def test_box_captions_equal_jax(models, imgs, variant):
    jm, pm = models
    boxes, kw = BOX_VARIANTS[variant]
    got = pm.caption_bboxes_fused(imgs, boxes, **kw)
    assert len(got) == 2 and all(len(row) == boxes.shape[1] for row in got)
    assert got == jm.caption_bboxes_fused(imgs, boxes, **kw)


IMAGE_VARIANTS = {
    "cls": dict(),
    "avg_self_attn": dict(caption_from="avg_self_attn"),
    "patches_0.5": dict(caption_from="patches", gaussian_img_variance=0.5),
    "patches_100": dict(caption_from="patches", gaussian_img_variance=100.0),
    "patches_0": dict(caption_from="patches", gaussian_img_variance=0.0),
}


@pytest.mark.parametrize("variant", IMAGE_VARIANTS)
def test_image_captions_equal_jax(models, imgs, variant):
    jm, pm = models
    kw = IMAGE_VARIANTS[variant]
    got = pm.caption_images_fused(imgs, **kw)
    assert len(got) == 2 and got == jm.caption_images_fused(imgs, **kw)


def test_image_captions_refuse_an_unknown_source(models, imgs):
    with pytest.raises(ValueError, match="caption_from"):
        models[1].caption_images_fused(imgs, caption_from="nope")


# tests/test_patchioner.py:363-366: a set padded with a [-1] * 4 dummy
REGION_SETS = np.asarray([[[0, 0, 28, 28], [14, 14, 56, 56]],
                          [[7, 7, 42, 42], [-1, -1, -1, -1]]], np.float32)
REGION_SET_VARIANTS = {
    "uniform": dict(),
    "gaussian_0.7": dict(gaussian_avg=True, gaussian_bbox_variance=0.7),
}


@pytest.mark.parametrize("variant", REGION_SET_VARIANTS)
def test_region_set_captions_equal_jax(models, imgs, variant):
    jm, pm = models
    kw = REGION_SET_VARIANTS[variant]
    got = pm.caption_region_sets_fused(imgs, REGION_SETS, **kw)
    assert len(got) == 2 and got == jm.caption_region_sets_fused(imgs, REGION_SETS, **kw)


def test_trace_captions_still_equal_jax(models, imgs):
    jm, pm = models
    rng = np.random.default_rng(2)
    pts = rng.uniform(0, 1, (2, 8, 2)).astype(np.float32)
    valid = np.ones((2, 8), np.float32)
    for attn in (False, True):
        assert (pm.caption_traces_fused(imgs, pts, valid, use_attention_tracing=attn)
                == jm.caption_traces_fused(imgs, pts, valid, use_attention_tracing=attn))


@pytest.mark.parametrize("make", [entry.make_bbox_pool, entry.make_region_set_pool])
def test_dead_pool_parameters_do_nothing(models, imgs, make):
    # the modes' priority, attention > gaussian > uniform, leaves the other
    # modes' parameters dead, as the reference's compile-cache keys assume
    # (patchioner.py:1820-1828)
    pm = models[1]
    state, px = pm.state(), pm.pixels_to_device(imgs)
    boxes = torch.from_numpy(BOXES)

    def prefix(**kw):
        pool = make(pm.patch_size, **kw)
        return entry.make_prefix_step(pm.vit_cfg, pm.bank.num_real, pool=pool)(
            state, px, boxes)

    torch.testing.assert_close(prefix(gaussian_bbox_variance=0.1), prefix(),
                               rtol=0, atol=0)
    torch.testing.assert_close(prefix(use_attn_map=True, gaussian_avg=True,
                                      gaussian_bbox_variance=0.1),
                               prefix(use_attn_map=True), rtol=0, atol=0)


@pytest.mark.parametrize("use_attn_map", [False, True])
def test_int8_bank_box_prefix_matches_the_pallas_int8_kernel(models, imgs, use_attn_map):
    # the JAX CPU path renormalises the dequantized rows (ROADMAP section 3);
    # the reference's TPU kernel does not, and the port follows the kernel
    jm = models[0]
    rows = np.random.default_rng(3).standard_normal((200, 128)).astype(np.float32)
    qbank = jmp.quantize_bank(jnp.asarray(rows))
    jcfg = jm.vit_cfg
    outs = jvit.vit_forward(jm.vit_params, jnp.asarray(imgs), jcfg)
    attn = None
    if use_attn_map:
        attn, _ = jvit.process_self_attention(
            outs["qkv_last"], num_heads=jcfg.extract_heads,
            num_global_tokens=jcfg.num_global_tokens, scale=jcfg.extract_scale)
    feats = jrp.extract_bbox_features(outs["x_norm_patchtokens"], jnp.asarray(BOXES),
                                      patch_size=14, attention_map=attn)
    want = np.asarray(jmp.memory_project_int8(feats.reshape(-1, 128), qbank,
                                              normalize=True, interpret=True))

    pm = _port(jm, qbank)
    assert isinstance(pm.bank, mp.QuantizedBank)
    before = (mp.memory_project_int8.launches, mp.memory_project_streamed.launches)
    pool = entry.make_bbox_pool(pm.patch_size, use_attn_map=use_attn_map)
    got = entry.make_prefix_step(pm.vit_cfg, pm.bank.num_real, pool=pool)(
        pm.state(), pm.pixels_to_device(imgs), torch.from_numpy(BOXES))
    assert got.shape == (6, 128)
    assert np.max(np.abs(got.numpy() - want)) <= 1e-4 * max(1.0, np.max(np.abs(want)))
    assert (mp.memory_project_int8.launches, mp.memory_project_streamed.launches) == before
    tokens, _ = jdecap.greedy_decode(jm.decoder, jnp.asarray(want), jm.gpt2_cfg)
    want_caps = [jm.tokenizer.decode_caption(row) for row in np.asarray(tokens)]
    assert sum(pm.caption_bboxes_fused(imgs, BOXES, use_attn_map_for_bboxes=use_attn_map),
               []) == want_caps
