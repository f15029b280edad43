"""The port's RegionCLIP ModifiedResNet (`models/resnet_clip.py`) against the
JAX package's, on the CPU in f32: the three spatial modes of
`resnet_spatial_forward` at the JAX tests' tiny geometry, the porter on
seeded state dicts in the openai and detectron layouts, the attention
pool's position embedding drawn anew for another grid, and the init's
tree."""

import io
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchioner_tpu.models import resnet_clip as jrn
from patchioner_tpu_torch.io import bridge
from patchioner_tpu_torch.models import resnet_clip as rn

# tests/test_resnet_clip.py's tiny geometry: one block a layer, 64 px
TINY = dict(layers=(1, 1, 1, 1), width=16, output_dim=24, heads=4, img_size=64)
MODES = {"attnpool": dict(), "c_proj": dict(use_attnpool_for_spatial_feats=False),
         "layer3": dict(use_layer3=True, res5_out=False)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def resnet_sd(seed, *, layers=TINY["layers"], width=TINY["width"], out=TINY["output_dim"],
              tokens=5, prefix="visual."):
    """A seeded openai-CLIP ModifiedResNet state dict under `prefix`: convs
    OIHW, batch-norm statistics away from the identity, the attention pool's
    projections and a position embedding of `tokens` rows."""
    rng = np.random.default_rng(seed)
    sd = {}

    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    def conv(name, co, ci, k):
        sd[f"{prefix}{name}.weight"] = rand(co, ci, k, k, scale=(ci * k * k) ** -0.5)

    def bn(name, c):
        sd[f"{prefix}{name}.weight"] = 1 + rand(c, scale=0.1)
        sd[f"{prefix}{name}.bias"] = rand(c, scale=0.1)
        sd[f"{prefix}{name}.running_mean"] = rand(c, scale=0.1)
        sd[f"{prefix}{name}.running_var"] = torch.from_numpy(
            rng.uniform(0.5, 1.5, c).astype(np.float32))
        sd[f"{prefix}{name}.num_batches_tracked"] = torch.tensor(0)

    def lin(name, co, ci):
        sd[f"{prefix}{name}.weight"] = rand(co, ci, scale=ci ** -0.5)
        sd[f"{prefix}{name}.bias"] = rand(co, scale=0.1)

    for i, (ci, co) in enumerate(((3, width // 2), (width // 2, width // 2),
                                  (width // 2, width)), 1):
        conv(f"conv{i}", co, ci, 3)
        bn(f"bn{i}", co)
    inplanes = width
    for li, n in enumerate(layers):
        planes = width * 2 ** li
        for bi in range(n):
            p = f"layer{li + 1}.{bi}"
            conv(f"{p}.conv1", planes, inplanes, 1)
            bn(f"{p}.bn1", planes)
            conv(f"{p}.conv2", planes, planes, 3)
            bn(f"{p}.bn2", planes)
            conv(f"{p}.conv3", planes * 4, planes, 1)
            bn(f"{p}.bn3", planes * 4)
            if (li and not bi) or inplanes != planes * 4:
                conv(f"{p}.downsample.0", planes * 4, inplanes, 1)
                bn(f"{p}.downsample.1", planes * 4)
            inplanes = planes * 4
    c = width * 32
    sd[f"{prefix}attnpool.positional_embedding"] = rand(tokens, c, scale=c ** -0.5)
    for name in ("q", "k", "v"):
        lin(f"attnpool.{name}_proj", c, c)
    lin("attnpool.c_proj", out, c)
    return sd


def _assert_trees_equal(got, want, at="tree"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), at
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{at}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), at
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{at}[{i}]")
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=at)


def _jax_tree(sd, prefix="visual."):
    return jrn.port_clip_resnet(sd, jrn.ResNetClipConfig(**TINY), prefix=prefix)


@pytest.mark.parametrize("mode", MODES)
def test_resnet_spatial_forward_equals_jax(mode):
    jtree = _jax_tree(resnet_sd(0))
    pixels = np.random.default_rng(1).standard_normal((2, 64, 64, 3)).astype(np.float32)
    want = jrn.resnet_spatial_forward(jtree, jnp.asarray(pixels), jrn.ResNetClipConfig(**TINY),
                                      **MODES[mode])
    got = rn.resnet_spatial_forward(bridge.resnet_clip_from_jax(jtree, rn.ResNetClipConfig(**TINY)),
                                    torch.from_numpy(pixels), rn.ResNetClipConfig(**TINY),
                                    **MODES[mode])
    assert set(got) == set(want)
    for key in want:
        ref = np.asarray(want[key])
        assert got[key].shape == ref.shape
        np.testing.assert_allclose(got[key].numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())
    # layer3: stride 16 (4 x 4 tokens), width * 16 channels, not projected
    assert got["x_norm_patchtokens"].shape == ((2, 16, 256) if mode == "layer3" else (2, 4, 24))


@pytest.mark.parametrize("layout", ["openai", "detectron"])
def test_port_clip_resnet_equals_jax(layout):
    """The openai layout under `visual.`, and a RegionCLIP detection
    checkpoint's backbone under detectron's `backbone.`, which both
    packages' `from_config` map to `visual.` before porting."""
    sd = resnet_sd(2, prefix="visual." if layout == "openai" else "backbone.")
    if layout == "detectron":
        sd = {"visual." + k[len("backbone."):]: v for k, v in sd.items()}
    got = rn.port_clip_resnet(sd, rn.ResNetClipConfig(**TINY))
    jtree = _jax_tree(sd)
    want = bridge.resnet_clip_from_jax(jtree, rn.ResNetClipConfig(**TINY))
    _assert_trees_equal(got, {k: jax.tree_util.tree_map(lambda t: t.numpy(), v)
                              for k, v in want.items()})
    # convolutions stay OIHW as stored; the bridge took JAX's HWIO there
    assert got["stem"]["conv1"].shape == (8, 3, 3, 3)
    np.testing.assert_array_equal(got["layers"][1][0]["down_conv"].numpy(),
                                  sd["visual.layer2.0.downsample.0.weight"].numpy())


def test_another_pool_grid_is_drawn_anew_from_a_cpu_generator():
    """A 224 px checkpoint's 50 pool tokens at another resolution: the
    embedding is dropped with the reference loader's warning and drawn
    N(0, 1/C) from a CPU generator seeded 0, whatever torch's global seed
    (JAX draws its own values)."""
    cfg = rn.ResNetClipConfig(**TINY)
    sd = resnet_sd(3, tokens=50)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        torch.manual_seed(1)
        a = rn.port_clip_resnet(sd, cfg)
        torch.manual_seed(2)
        b = rn.port_clip_resnet(sd, cfg)
        jtree = _jax_tree(sd)
    assert out.getvalue().count("attnpool pos-embed has 50 tokens") == 3
    assert "needs 5" in out.getvalue()
    pos = a["attnpool"]["pos_embed"]
    assert pos.shape == (cfg.num_tokens, 512) == np.asarray(jtree["attnpool"]["pos_embed"]).shape
    want = torch.randn(5, 512, generator=torch.Generator().manual_seed(0)) / 512 ** 0.5
    torch.testing.assert_close(pos, want, rtol=0, atol=0)
    torch.testing.assert_close(b["attnpool"]["pos_embed"], pos, rtol=0, atol=0)
    assert pos.device.type == "cpu"
    # nothing else of the file changes
    np.testing.assert_array_equal(a["attnpool"]["q"]["w"].numpy(),
                                  np.asarray(jtree["attnpool"]["q"]["w"]))


def test_init_has_the_tree_of_jax_and_of_the_template():
    cfg = rn.ResNetClipConfig()  # RN50
    tree = rn.init_resnet_clip(cfg, torch.Generator().manual_seed(0))
    jtree = jax.eval_shape(lambda k: jrn.init_resnet_clip(k, jrn.ResNetClipConfig()),
                           jax.random.PRNGKey(0))

    def shapes(t, conv_hwio=False):
        return jax.tree_util.tree_map_with_path(
            lambda kp, x: (tuple(x.shape[i] for i in (3, 2, 0, 1))
                           if conv_hwio and "conv" in jax.tree_util.keystr(kp)
                           else tuple(x.shape)), t)

    assert shapes(tree) == shapes(jtree, conv_hwio=True) == shapes(rn.param_template(cfg))
    assert tree["attnpool"]["pos_embed"].shape == (50, 2048)
    assert tree["attnpool"]["c"]["w"].shape == (2048, 1024)
    # N(0, 1 / fan_in) weights, identity batch norms, as JAX draws them
    w = tree["layers"][2][0]["conv2"]
    assert abs(w.std().item() * (256 * 9) ** 0.5 - 1) < 0.05
    assert torch.equal(tree["stem"]["bn1"]["var"], torch.ones(32))


def test_bf16_forward_rounds_as_the_jax_package():
    """Below f32 the weights are cast before the stem, so the batch norms
    run in bf16 too: the port's bf16 output is near the JAX package's."""
    jtree = _jax_tree(resnet_sd(4))
    pixels = np.random.default_rng(5).standard_normal((1, 64, 64, 3)).astype(np.float32)
    want = jrn.resnet_spatial_forward(jtree, jnp.asarray(pixels),
                                      jrn.ResNetClipConfig(**TINY, dtype=jnp.bfloat16))
    got = rn.resnet_spatial_forward(
        bridge.resnet_clip_from_jax(jtree, rn.ResNetClipConfig(**TINY)), torch.from_numpy(pixels),
        rn.ResNetClipConfig(**TINY, dtype=torch.bfloat16))
    for key in want:
        assert got[key].dtype == torch.bfloat16
        np.testing.assert_allclose(got[key].float().numpy(),
                                   np.asarray(want[key], np.float32), atol=3e-2)
