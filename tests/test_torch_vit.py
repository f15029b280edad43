"""Port's ViT encoder, attention extraction and trace pooling against the
JAX package (attn_impl='xla' on the CPU), with identical seeded weights
carried over by the bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchioner_tpu.models import vit as jvit
from patchioner_tpu.ops import region_pooling as jrp
from patchioner_tpu_torch.io import bridge
from patchioner_tpu_torch.models import vit
from patchioner_tpu_torch.ops import region_pooling as rp


def _rel_err(got, want):
    want = np.asarray(want)
    return np.max(np.abs(np.asarray(got) - want)) / max(1.0, np.max(np.abs(want)))


@pytest.mark.parametrize("img,pos_grid", [(56, 37), (140, 10)])
def test_vit_forward_matches_jax(img, pos_grid):
    # depth 2, D = 128, two heads of 64, four registers; 56 px resizes the
    # stored 37x37 pos-embed grid to 4x4, 140 px uses it as stored
    geom = dict(embed_dim=128, depth=2, num_heads=2, num_registers=4,
                extract_heads=4, pos_grid=pos_grid)
    jcfg = jvit.ViTConfig(img_size=img, **geom)
    params = jvit.init_vit(jax.random.PRNGKey(0), jcfg)
    # per-channel layerscale near 1 so the residual branches count
    ls = np.random.default_rng(1).uniform(0.5, 1.5, (2, 2, 128)).astype(np.float32)
    params["blocks"] = [dict(b, ls1=jnp.asarray(ls[i, 0]), ls2=jnp.asarray(ls[i, 1]))
                        for i, b in enumerate(params["blocks"])]
    pixels = np.random.default_rng(0).standard_normal((2, img, img, 3)).astype(np.float32)
    want = jvit.vit_forward(params, jnp.asarray(pixels), jcfg)
    cfg = vit.ViTConfig(img_size=img, **geom)
    got = vit.vit_forward(bridge.vit_from_jax(params, cfg), torch.from_numpy(pixels), cfg)
    # f32 both sides: summation order only, 12 products deep
    for key in ("x_norm_clstoken", "x_norm_regtokens", "x_norm_patchtokens", "qkv_last"):
        assert got[key].shape == want[key].shape, key
        assert _rel_err(got[key].numpy(), want[key]) < 1e-4, key


def test_interpolate_pos_embed_37_to_10_matches_jax_replica():
    pos = np.random.default_rng(1).standard_normal((1, 1 + 37 * 37, 32)).astype(np.float32)
    want = jvit.interpolate_pos_embed(jnp.asarray(pos), 37, 10)
    got = vit.interpolate_pos_embed(torch.from_numpy(pos), 37, 10)
    assert got.shape == (1, 101, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # offset 0 is the size=(dst, dst) call
    want0 = jvit.interpolate_pos_embed(jnp.asarray(pos), 37, 10, interpolate_offset=0)
    got0 = vit.interpolate_pos_embed(torch.from_numpy(pos), 37, 10, interpolate_offset=0)
    np.testing.assert_allclose(got0.numpy(), np.asarray(want0), rtol=1e-5, atol=1e-5)


def test_process_self_attention_keeps_the_16_head_quirk():
    # ViT-B width (12 true heads) extracted with 16 heads of 48, scale 0.125,
    # the mean over heads before the softmax; 5 global tokens + 4x4 patches
    qkv = np.random.default_rng(2).standard_normal((2, 21, 3 * 768)).astype(np.float32)
    want_attn, want_maps = jvit.process_self_attention(
        jnp.asarray(qkv), num_heads=16, num_global_tokens=5, scale=0.125)
    attn, maps = vit.process_self_attention(
        torch.from_numpy(qkv), num_heads=16, num_global_tokens=5, scale=0.125)
    assert maps.shape == (2, 16, 16)
    np.testing.assert_allclose(maps.numpy(), np.asarray(want_maps), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(attn.numpy(), np.asarray(want_attn), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(attn.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_traces_to_grid_edge_cases_match_jax():
    pts = np.array([[[0.0, 0.0], [1.0, 1.0], [1.0, 0.5], [0.999, 0.2],
                     [-0.01, 0.5], [0.5, 1.01], [0.3, 0.3], [0.3, 0.3]]], np.float32)
    valid = np.array([[1, 1, 1, 1, 1, 1, 1, 0]], np.float32)
    want = jrp.traces_to_grid(jnp.asarray(pts), jnp.asarray(valid), 4)
    got = rp.traces_to_grid(torch.from_numpy(pts), torch.from_numpy(valid), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    g = got.numpy()[0]
    assert g[3, 3] == 1 and g[2, 3] == 1      # x = 1.0 clamps into the last column
    assert g[1, 1] == 1                        # the invalid duplicate is dropped
    assert g.sum() == 5                        # two points outside [0, 1] dropped


@pytest.mark.parametrize("with_attn", [False, True])
def test_trace_pool_divides_by_the_full_grid(with_attn):
    rng = np.random.default_rng(3)
    tokens = rng.standard_normal((2, 16, 8)).astype(np.float32)
    grid = rng.integers(0, 3, (2, 4, 4)).astype(np.float32)
    attn = rng.uniform(0, 1, (2, 16)).astype(np.float32) if with_attn else None
    want = jrp.trace_pool(jnp.asarray(tokens), jnp.asarray(grid),
                          None if attn is None else jnp.asarray(attn))
    got = rp.trace_pool(torch.from_numpy(tokens), torch.from_numpy(grid),
                        None if attn is None else torch.from_numpy(attn))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# every attention configuration of the encoder: the attn_impl, proj_fused
# and gelu_approx keys that select the port's kernels B, E, F, J, K (and
# torch's fused attention for flash_builtin) against the JAX encoder with
# its Pallas kernels in interpret mode; JAX's own gate for these impls
# (tests/test_attention.py), f32 both sides
ENCODER_CONFIGS = [
    dict(attn_impl="fusedqkv", gelu_approx=True),
    dict(attn_impl="fusedqkv", proj_fused=True),
    dict(attn_impl="fusedqkv_proj"),
    dict(attn_impl="flash"),
    dict(attn_impl="flash1p"),
    dict(attn_impl="flash_builtin"),
]


@pytest.mark.parametrize("opts", ENCODER_CONFIGS, ids=lambda o: "-".join(
    f"{k}={v}" for k, v in o.items()))
def test_vit_forward_matches_jax_per_attention_config(opts):
    from jax.experimental.pallas import tpu as pltpu

    geom = dict(img_size=56, embed_dim=128, depth=2, num_heads=2, num_registers=4,
                extract_heads=4, pos_grid=4)
    jcfg = jvit.ViTConfig(**geom, **opts)
    params = jvit.init_vit(jax.random.PRNGKey(2), jcfg)
    ls = np.random.default_rng(3).uniform(0.5, 1.5, (2, 2, 128)).astype(np.float32)
    params["blocks"] = [dict(b, ls1=jnp.asarray(ls[i, 0]), ls2=jnp.asarray(ls[i, 1]))
                        for i, b in enumerate(params["blocks"])]
    pixels = np.random.default_rng(4).standard_normal((2, 56, 56, 3)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jvit.vit_forward(params, jnp.asarray(pixels), jcfg)
    cfg = vit.ViTConfig(**geom, **opts)
    got = vit.vit_forward(bridge.vit_from_jax(params, cfg), torch.from_numpy(pixels), cfg)
    for key in ("x_norm_patchtokens", "x_norm_clstoken", "qkv_last"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=5e-4, atol=5e-5, err_msg=key)


def test_proj_fused_outside_fusedqkv_warns_and_runs_the_plain_projection():
    geom = dict(img_size=28, embed_dim=128, depth=1, num_heads=2, num_registers=0,
                extract_heads=2, pos_grid=2)
    cfg = vit.ViTConfig(**geom, attn_impl="flash", proj_fused=True)
    params = vit.init_vit(cfg, torch.Generator().manual_seed(0))
    pixels = torch.randn(1, 28, 28, 3, generator=torch.Generator().manual_seed(1))
    with pytest.warns(UserWarning, match="proj_fused"):
        got = vit.vit_forward(params, pixels, cfg)
    want = vit.vit_forward(params, pixels, vit.ViTConfig(**geom, attn_impl="flash"))
    torch.testing.assert_close(got["x_prenorm"], want["x_prenorm"], rtol=0, atol=0)


def test_an_unknown_attn_impl_is_refused():
    with pytest.raises(ValueError, match="attn_impl"):
        vit.ViTConfig(attn_impl="flash2")


@pytest.mark.parametrize("geom", [dict(embed_dim=384), dict(embed_dim=192),
                                  dict(embed_dim=100), dict(embed_dim=384, mlp_ratio=3.0)],
                         ids=str)
def test_ffn_hidden_follows_the_reference_for_swiglu_and_mlp(geom):
    for ffn in ("swiglu", "mlp"):
        assert vit.ViTConfig(ffn=ffn, **geom).ffn_hidden == \
            jvit.ViTConfig(ffn=ffn, **geom).ffn_hidden
    # giant: 1536 * 4 * 2/3 rounded up to a multiple of 8
    assert vit.config_for("dinov2_vitg14_reg").ffn_hidden == 4096
    assert vit.config_for("dinov2_vitb14_reg").ffn_hidden == 3072


def test_swiglu_vit_forward_matches_jax_mlp_fused():
    # tests/test_mlp.py:292's giant geometry scaled down (D = 384, six heads
    # of 64, hidden 1024, two layers): the port's kernel G path against the
    # JAX encoder's fusedqkv + mlp_fused (its Pallas G) in interpret mode
    from jax.experimental.pallas import tpu as pltpu

    geom = dict(img_size=56, embed_dim=384, depth=2, num_heads=6, num_registers=4,
                extract_heads=6, pos_grid=4, ffn="swiglu", attn_impl="fusedqkv")
    jcfg = jvit.ViTConfig(**geom, mlp_fused=True)
    params = jvit.init_vit(jax.random.PRNGKey(5), jcfg)
    assert params["blocks"][0]["w12"]["w"].shape == (384, 2048)
    ls = np.random.default_rng(6).uniform(0.5, 1.5, (2, 2, 384)).astype(np.float32)
    params["blocks"] = [dict(b, ls1=jnp.asarray(ls[i, 0]), ls2=jnp.asarray(ls[i, 1]))
                        for i, b in enumerate(params["blocks"])]
    pixels = np.random.default_rng(7).standard_normal((2, 56, 56, 3)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jvit.vit_forward(params, jnp.asarray(pixels), jcfg)
    cfg = vit.ViTConfig(**geom)
    mine = vit.init_vit(cfg, torch.Generator().manual_seed(0))["blocks"][0]
    assert {k: tuple(mine[k]["w"].shape) for k in ("w12", "w3")} == {
        "w12": (384, 2048), "w3": (1024, 384)}
    got = vit.vit_forward(bridge.vit_from_jax(params, cfg), torch.from_numpy(pixels), cfg)
    for key in ("x_norm_patchtokens", "x_norm_clstoken", "qkv_last"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=5e-4, atol=5e-5, err_msg=key)
