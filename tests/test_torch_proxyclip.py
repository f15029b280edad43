"""The port's ProxyCLIP (`models/proxyclip.py`) against the JAX package's,
on the CPU in f32: the proxy affinity, `proxyclip_forward` at batch 1 and
2 (its mean over the whole batch) on a grid that grows, one that stays
and one that shrinks (antialiased, as `jax.image.resize`), on mosaic
images whose affinity puts real weight off the diagonal, so that the
mixing of the value vectors is what is compared; the VFM's floored grid,
where the JAX package's reshape raises; the server pads no ProxyCLIP
batch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchioner_tpu.models import clip as jclip
from patchioner_tpu.models import proxyclip as jpc
from patchioner_tpu.models import vit as jvit
from patchioner_tpu_torch.io import bridge
from patchioner_tpu_torch.models import clip, decap, gpt2, proxyclip, vit
from patchioner_tpu_torch.models.patchioner import Patchioner
from patchioner_tpu_torch.ops import memory_projection as mp
from patchioner_tpu_torch.serve import CaptionServer

IMG = 56
VFM = dict(img_size=IMG, patch_size=14, embed_dim=64, depth=2, num_heads=4, num_registers=4,
           extract_heads=4, pos_grid=4)
# the CLIP tower's patch against the VFM's 4 x 4 grid at 56 px: 16 floors
# 56 to 48 (the grid grows 3 -> 4), 14 keeps it (4 -> 4, L/14's case), 8
# gives 7 x 7 and shrinks 7 -> 4
CLIP_PATCHES = {"floored, grows": 16, "equal grid": 14, "floored, shrinks": 8}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _towers(patch, seed=3):
    """(JAX config, JAX params, port config, port params) of a small
    ProxyCLIP: a 2-block CLIP tower stored at 32 px and a 2-block VFM."""
    cgeom = dict(img_size=32, patch_size=patch, width=64, depth=2, heads=4, proj_dim=48)
    jcfg = jpc.ProxyClipConfig(clip=jclip.ClipVisionConfig(**cgeom), vfm=jvit.ViTConfig(**VFM))
    pcfg = proxyclip.ProxyClipConfig(clip=clip.ClipVisionConfig(**cgeom), vfm=vit.ViTConfig(**VFM))
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    tree = {"clip": jclip.init_clip_vision(k1, jcfg.clip), "vfm": jvit.init_vit(k2, jcfg.vfm)}
    # layerscale near 1, so that the VFM's blocks move its features
    for blk in tree["vfm"]["blocks"]:
        blk["ls1"] = blk["ls2"] = jnp.ones_like(blk["ls1"])
    return jcfg, tree, pcfg, bridge.proxyclip_from_jax(tree, pcfg)


def mosaic(n, size, seed, blocks=2):
    """n normalised (size, size, 3) images of blocks x blocks flat colours
    with a little noise: patches of one block are alike, so the proxy
    affinity keeps real weight off its diagonal (on noise it keeps the
    diagonal alone)."""
    rng = np.random.default_rng(seed)
    cell = -(-size // blocks)
    tiles = np.repeat(np.repeat(rng.standard_normal((n, blocks, blocks, 3)), cell, 1), cell, 2)
    return (tiles[:, :size, :size] + 0.1 * rng.standard_normal((n, size, size, 3))).astype(
        np.float32)


def off_diagonal_mass(vfm_params, pixels, cfg) -> np.ndarray:
    """(B, N) weight of each row of the port's proxy affinity (held to
    JAX's by `test_proxy_affinity_equals_jax`) off its diagonal, from its
    VFM on `pixels`."""
    feats = vit.vit_forward(vfm_params, torch.as_tensor(pixels), cfg.vfm)["x_norm_patchtokens"]
    affinity = proxyclip.proxy_affinity(feats, cfg.beta, cfg.gamma)
    return 1.0 - torch.diagonal(affinity, dim1=-2, dim2=-1).numpy()


def test_proxy_affinity_equals_jax():
    feats = np.random.default_rng(0).standard_normal((2, 9, 8)).astype(np.float32)
    exn = jnp.asarray(feats) / jnp.linalg.norm(jnp.asarray(feats), axis=-1, keepdims=True)
    sim = jnp.einsum("bmd,bnd->bmn", exn, exn)
    sim = (sim - jnp.mean(sim) * 1.2) * 3.0
    want = np.asarray(jax.nn.softmax(jnp.where(sim < 0.0, -jnp.inf, sim), axis=-1))
    got = proxyclip.proxy_affinity(torch.from_numpy(feats), 1.2, 3.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.isfinite(got).all() and (got == 0).any()  # masked, never a NaN row


@pytest.mark.parametrize("geometry,batch", [
    ("floored, grows", 1), ("floored, grows", 2), ("equal grid", 1), ("equal grid", 2),
    ("floored, shrinks", 1)])
def test_proxyclip_forward_equals_jax(geometry, batch):
    """Every row of the affinity puts at least 10% of its weight off the
    diagonal, so a transposed affinity, mixing before resampling or
    another mask would show in the tokens."""
    jcfg, tree, pcfg, params = _towers(CLIP_PATCHES[geometry])
    pixels = mosaic(2, IMG, 4)[:batch]
    assert off_diagonal_mass(params["vfm"], pixels, pcfg).min() >= 0.1
    want = np.asarray(jpc.proxyclip_forward(tree["clip"], tree["vfm"], jnp.asarray(pixels),
                                            jcfg)["x_norm_patchtokens"])
    got = proxyclip.proxyclip_forward(params["clip"], params["vfm"], torch.from_numpy(pixels),
                                      pcfg)["x_norm_patchtokens"]
    assert got.dtype == torch.float32 and got.shape == want.shape == (batch, 16, 48)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("grids", [(32, 37), (18, 21), (16, 16), (3, 2)],
                         ids=["518 px B/16", "296 px B/16", "L/14", "shrinks"])
def test_resample_grid_equals_jax_image_resize(grids):
    """The last block's values onto the VFM grid: B/16 against a /14 VFM
    at the two shipped crops (32 -> 37, 18 -> 21), L/14's equal grid, and
    a shrinking one; (B, g, g, heads, hd) as JAX resizes them."""
    src, dst = grids
    v = np.random.default_rng(9).standard_normal((2, src, src, 3, 4)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(v), (2, dst, dst, 3, 4), method="bilinear"))
    got = proxyclip.resample_grid(torch.from_numpy(v).reshape(2, src * src, 12), dst)
    np.testing.assert_allclose(got.reshape(2, dst, dst, 3, 4).numpy(), want, rtol=1e-5,
                               atol=1e-5)


def test_the_mean_over_the_batch_couples_the_images():
    """A flat second image (its patches alike, their similarities near 1)
    raises the batch's mean similarity, which masks every off-diagonal
    affinity that the first image (noise) keeps alone, and so moves its
    features."""
    _, _, pcfg, params = _towers(14)
    pixels = np.random.default_rng(5).standard_normal((2, IMG, IMG, 3)).astype(np.float32)
    pixels[1] = 0.5
    alone_mass = off_diagonal_mass(params["vfm"], pixels[:1], pcfg)
    pair_mass = off_diagonal_mass(params["vfm"], pixels, pcfg)[:1]
    assert alone_mass.min() >= 0.1 and pair_mass.max() < 1e-3
    pixels = torch.from_numpy(pixels)
    pair = proxyclip.proxyclip_forward(params["clip"], params["vfm"], pixels, pcfg)
    alone = proxyclip.proxyclip_forward(params["clip"], params["vfm"], pixels[:1], pcfg)
    assert (pair["x_norm_patchtokens"][0] - alone["x_norm_patchtokens"][0]).abs().max() > 1e-4


def test_the_vfm_grid_is_floored_where_jax_raises():
    """60 px against the VFM's patch 14: the port embeds the top-left 56 px
    (a 4 x 4 grid), as the reference's strided conv does; the JAX
    package's reshape raises."""
    jcfg, tree, pcfg, params = _towers(16)
    pixels = mosaic(1, IMG + 4, 6)
    with pytest.raises(TypeError, match="reshape"):
        jpc.proxyclip_forward(tree["clip"], tree["vfm"], jnp.asarray(pixels), jcfg)
    got = proxyclip.proxyclip_forward(params["clip"], params["vfm"], torch.from_numpy(pixels),
                                      pcfg)["x_norm_patchtokens"]
    cut = proxyclip.proxyclip_forward(params["clip"], params["vfm"],
                                      torch.from_numpy(pixels[:, :IMG, :IMG].copy()),
                                      pcfg)["x_norm_patchtokens"]
    torch.testing.assert_close(got, cut, rtol=0, atol=0)


def test_the_server_pads_no_proxyclip_batch():
    """Three trace requests in one batch of max_batch 4: the port's server
    encodes the three images alone (the JAX server would add a copy of
    the first), so the captions equal `forward` on those three."""
    _, _, pcfg, params = _towers(14)
    gcfg = gpt2.GPT2Config(vocab_size=49408, n_layer=1, n_head=2, n_embd=32)
    gen = torch.Generator().manual_seed(7)
    dec = decap.init_decap(gcfg, 48, gen)
    dec = dec._replace(gpt2=dict(dec.gpt2, wte=dec.gpt2["wte"] * 10))
    model = Patchioner(vit_cfg=pcfg, vit_params=params, gpt2_cfg=gcfg, decoder=dec,
                       bank=mp.prepare_bank(torch.randn(64, 48, generator=gen)),
                       backbone_type="ProxyCLIP", device="cpu")
    assert model.mixes_batch and not model.supports_fused_trace_path()
    rng = np.random.default_rng(8)
    imgs = rng.integers(0, 256, (3, IMG, IMG, 3), dtype=np.uint8)
    traces = [rng.uniform(0, 1, (4, 2)).tolist() for _ in range(3)]
    want = model.forward(imgs, get_cls_capt=False, traces=traces)["trace_capts"]
    batches, forward = [], model.forward

    def recording(imgs, **kw):
        batches.append(len(imgs))
        return forward(imgs, **kw)

    model.forward = recording
    with CaptionServer(model, max_batch=4, max_delay_ms=500.0) as server:
        got = server.caption(imgs, traces, timeout=120)
    assert batches == [3] and got == want
    assert set(model.encode_images(imgs)) == {"x_norm_patchtokens"}
    with pytest.raises(ValueError, match="patch tokens only"):
        forward(imgs, get_cls_capt=True)
