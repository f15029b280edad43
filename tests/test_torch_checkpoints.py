"""The port's checkpoint and bank IO against the JAX package's, on the CPU.

State dicts are built from a seed with numpy in the published layouts
(torch.hub DINOv2, transformers Dinov2Model, transformers GPT2LMHeadModel,
DeCap, Talk2DINO's ProjectionLayer) and the same dict goes to the JAX
porting function and to the port's: the trees must be equal leaf for leaf
(the functions only reshape and transpose). The bank files (HDF5) and the
`.npz` parameter files that one package writes must load in the other.
The slice as a whole: the JAX and the port `Patchioner.from_config` load
the same files with `allow_missing_weights=False` at f32, and their trace
and box captions must be equal string for string, their prefixes within
1e-5 of max|ref|.
"""

import importlib.util
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from patchioner_tpu.io import checkpoints as jckpt
from patchioner_tpu.io import memory_bank as jmb
from patchioner_tpu.io import torch_port as jport
from patchioner_tpu.models import decap as jdecap
from patchioner_tpu.models import gpt2 as jgpt2
from patchioner_tpu.models import talk2dino as jt2d
from patchioner_tpu.models import vit as jvit
from patchioner_tpu.models.patchioner import Patchioner as JaxPatchioner
from patchioner_tpu.ops import region_pooling as jrp
from patchioner_tpu_torch import entry
from patchioner_tpu_torch.io import checkpoints, memory_bank, torch_port
from patchioner_tpu_torch.models import decap, gpt2, talk2dino, vit
from patchioner_tpu_torch.models.patchioner import Patchioner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, DEPTH, REGS, PATCH, GRID = 128, 2, 4, 14, 4
VOCAB, N_EMBD, N_LAYER, N_POS = 1000, 128, 2, 1024
CLIP = 64  # Talk2DINO's CLIP side: the decoder's prefix under the inversion


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _linear(sd, rng, name, out, fan_in, transposed=False):
    """An nn.Linear (out, in) weight, or GPT-2's Conv1D (in, out)."""
    shape = (fan_in, out) if transposed else (out, fan_in)
    sd[f"{name}.weight"] = _rand(rng, *shape, scale=fan_in ** -0.5)
    sd[f"{name}.bias"] = _rand(rng, out, scale=0.1)


def _ln(sd, rng, name, d):
    sd[f"{name}.weight"] = 1 + _rand(rng, d, scale=0.1)
    sd[f"{name}.bias"] = _rand(rng, d, scale=0.1)


def hub_dinov2(seed, *, depth=DEPTH, regs=REGS, ffn="mlp", layerscale=True, d=D):
    """A torch.hub DINOv2 state dict; layerscale drawn near 1 so that the
    blocks move the residual stream."""
    rng = np.random.default_rng(seed)
    sd = {"cls_token": _rand(rng, 1, 1, d, scale=0.02),
          "pos_embed": _rand(rng, 1, 1 + GRID * GRID, d, scale=0.02),
          "patch_embed.proj.weight": _rand(rng, d, 3, PATCH, PATCH,
                                           scale=(3 * PATCH * PATCH) ** -0.5),
          "patch_embed.proj.bias": _rand(rng, d, scale=0.1)}
    _ln(sd, rng, "norm", d)
    if regs:
        sd["register_tokens"] = _rand(rng, 1, regs, d, scale=0.02)
    for i in range(depth):
        p = f"blocks.{i}"
        _ln(sd, rng, f"{p}.norm1", d)
        _linear(sd, rng, f"{p}.attn.qkv", 3 * d, d)
        _linear(sd, rng, f"{p}.attn.proj", d, d)
        _ln(sd, rng, f"{p}.norm2", d)
        if ffn == "swiglu":
            _linear(sd, rng, f"{p}.mlp.w12", 2 * 2 * d, d)
            _linear(sd, rng, f"{p}.mlp.w3", d, 2 * d)
        else:
            _linear(sd, rng, f"{p}.mlp.fc1", 4 * d, d)
            _linear(sd, rng, f"{p}.mlp.fc2", d, 4 * d)
        if layerscale:
            sd[f"{p}.ls1.gamma"] = torch.from_numpy(rng.uniform(0.5, 1.5, d).astype(np.float32))
            sd[f"{p}.ls2.gamma"] = torch.from_numpy(rng.uniform(0.5, 1.5, d).astype(np.float32))
    return sd


def hf_dinov2(seed, *, ffn="mlp"):
    """A transformers Dinov2WithRegistersModel state dict."""
    rng = np.random.default_rng(seed)
    e = "embeddings"
    sd = {f"{e}.cls_token": _rand(rng, 1, 1, D, scale=0.02),
          f"{e}.position_embeddings": _rand(rng, 1, 1 + GRID * GRID, D, scale=0.02),
          f"{e}.register_tokens": _rand(rng, 1, REGS, D, scale=0.02),
          f"{e}.patch_embeddings.projection.weight": _rand(rng, D, 3, PATCH, PATCH),
          f"{e}.patch_embeddings.projection.bias": _rand(rng, D)}
    _ln(sd, rng, "layernorm", D)
    for i in range(DEPTH):
        p = f"encoder.layer.{i}"
        _ln(sd, rng, f"{p}.norm1", D)
        for k in ("query", "key", "value"):
            _linear(sd, rng, f"{p}.attention.attention.{k}", D, D)
        _linear(sd, rng, f"{p}.attention.output.dense", D, D)
        _ln(sd, rng, f"{p}.norm2", D)
        sd[f"{p}.layer_scale1.lambda1"] = _rand(rng, D)
        sd[f"{p}.layer_scale2.lambda1"] = _rand(rng, D)
        if ffn == "swiglu":
            _linear(sd, rng, f"{p}.mlp.weights_in", 4 * D, D)
            _linear(sd, rng, f"{p}.mlp.weights_out", D, 2 * D)
        else:
            _linear(sd, rng, f"{p}.mlp.fc1", 4 * D, D)
            _linear(sd, rng, f"{p}.mlp.fc2", D, 4 * D)
    return sd


def hf_gpt2(seed, *, prefix="", n_layer=N_LAYER, vocab=VOCAB):
    """A transformers GPT2LMHeadModel state dict under `prefix`; wte scaled
    up so that greedy decoding is not a string of near-ties."""
    rng = np.random.default_rng(seed)
    t = f"{prefix}transformer"
    sd = {f"{t}.wte.weight": _rand(rng, vocab, N_EMBD, scale=0.2),
          f"{t}.wpe.weight": _rand(rng, N_POS, N_EMBD, scale=0.02)}
    _ln(sd, rng, f"{t}.ln_f", N_EMBD)
    for i in range(n_layer):
        p = f"{t}.h.{i}"
        _ln(sd, rng, f"{p}.ln_1", N_EMBD)
        _linear(sd, rng, f"{p}.attn.c_attn", 3 * N_EMBD, N_EMBD, transposed=True)
        _linear(sd, rng, f"{p}.attn.c_proj", N_EMBD, N_EMBD, transposed=True)
        _ln(sd, rng, f"{p}.ln_2", N_EMBD)
        _linear(sd, rng, f"{p}.mlp.c_fc", 4 * N_EMBD, N_EMBD, transposed=True)
        _linear(sd, rng, f"{p}.mlp.c_proj", N_EMBD, 4 * N_EMBD, transposed=True)
    return sd


def decap_sd(seed, prefix_size, **kw):
    sd = hf_gpt2(seed, prefix="decoder.", **kw)
    _linear(sd, np.random.default_rng(seed + 1000), "clip_project.model.0", N_EMBD,
            prefix_size)
    return sd


def talk2dino_sd(seed, *, hidden=2, legacy=False):
    """Talk2DINO's ProjectionLayer, CLIP -> DINO (D)."""
    rng = np.random.default_rng(seed)
    sd = {}
    _linear(sd, rng, "linear_layer", D, CLIP)
    for i in range(hidden):
        _linear(sd, rng, "linear_layer2" if legacy and i == 0 else f"hidden_layers.{i}",
                D, D)
    return sd


def _assert_trees_equal(got, want, at="tree"):
    """The port's tree (torch) equals the JAX one (numpy) exactly."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), at
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{at}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), at
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{at}[{i}]")
    else:
        assert torch.is_tensor(got) and got.dtype == torch.float32, at
        assert got.is_contiguous(), at
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape, at
        np.testing.assert_array_equal(got.numpy(), want, err_msg=at)


PORTING_CASES = {
    "port_dinov2-mlp": (lambda: hub_dinov2(1), lambda m, sd: m.port_dinov2(sd, DEPTH, REGS)),
    "port_dinov2-swiglu-no-registers-no-layerscale": (
        lambda: hub_dinov2(2, regs=0, ffn="swiglu", layerscale=False),
        lambda m, sd: m.port_dinov2(sd, DEPTH, 0)),
    "port_hf_dinov2-mlp": (lambda: hf_dinov2(3), lambda m, sd: m.port_hf_dinov2(sd, DEPTH, REGS)),
    "port_hf_dinov2-swiglu": (lambda: hf_dinov2(4, ffn="swiglu"),
                              lambda m, sd: m.port_hf_dinov2(sd, DEPTH, REGS)),
    "port_hf_gpt2_lmhead": (lambda: hf_gpt2(5), lambda m, sd: m.port_hf_gpt2_lmhead(sd, N_LAYER)),
    "port_decap": (lambda: decap_sd(6, CLIP), lambda m, sd: m.port_decap(sd, n_layer=N_LAYER)),
    "port_talk2dino": (lambda: talk2dino_sd(7), lambda m, sd: m.port_talk2dino(sd)),
    "port_talk2dino-legacy-linear_layer2": (lambda: talk2dino_sd(8, legacy=True),
                                            lambda m, sd: m.port_talk2dino(sd)),
}


@pytest.mark.parametrize("case", PORTING_CASES)
def test_porting_function_equals_jax(case):
    make, call = PORTING_CASES[case]
    sd = make()
    want = call(jport, dict(sd))
    got = call(torch_port, dict(sd))
    _assert_trees_equal(got, want)
    if case.startswith("port_talk2dino"):
        assert len(got["hidden"]) == 2


def test_patch_layout_equals_the_conv():
    # an oracle independent of both porting functions: the hub conv itself
    sd = hub_dinov2(9)
    pixels = np.random.default_rng(10).standard_normal((2, 56, 56, 3)).astype(np.float32)
    tree = torch_port.port_dinov2(sd, DEPTH, REGS)
    got = vit.patch_embed(tree["patch_embed"], torch.from_numpy(pixels), PATCH)
    ref = F.conv2d(torch.from_numpy(pixels).permute(0, 3, 1, 2),
                   sd["patch_embed.proj.weight"], sd["patch_embed.proj.bias"], stride=PATCH)
    ref = ref.flatten(2).transpose(1, 2)
    assert got.shape == ref.shape == (2, GRID * GRID, D)
    assert (got - ref).abs().max().item() <= 1e-6 * ref.abs().max().item()


# --------------------------------------------------------------- bank files

NAMING = list(itertools.product([None, "ViT-B/16", "ViT-L/14"], [True, False],
                                [False, True], ["qkv", "kk"], [False, True],
                                [591753, 500000]))


@pytest.mark.parametrize("projection_type", ["coco", "vg", "msmarco", "blip", "vg-test",
                                             "online_texts", "my_corpus", "file"])
def test_bank_filename_equals_jax(projection_type, tmp_path):
    if projection_type == "file":  # a caption corpus path names its dataset
        projection_type = str(tmp_path / "vg_dense_train.json")
        open(projection_type, "w").close()
    for clip, t2d, linear, attn, open_clip, size in NAMING:
        kw = dict(use_talk2dino=t2d, linear_talk2dino=linear, talk2dino_attn_type=attn,
                  use_open_clip=open_clip)
        assert (memory_bank.bank_filename(projection_type, clip, size, **kw)
                == jmb.bank_filename(projection_type, clip, size, **kw))


def _bank_rows(n=12, d=16, seed=11):
    emb = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    emb[[2, 7]] = 0.0  # the reference's unfilled tail rows: dropped at load
    texts = [f"caption {i} é中" for i in range(n)]
    return emb, texts


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bank_written_by_one_package_loads_in_the_other(writer, tmp_path):
    emb, texts = _bank_rows()
    path = str(tmp_path / "bank.h5")
    if writer == "jax":
        jmb.save_bank(path, "vg_captions", jmb.MemoryBank(emb, texts))
    else:
        memory_bank.save_bank(path, "vg_captions", memory_bank.MemoryBank(emb, texts))
    keep = [i for i in range(len(texts)) if i not in (2, 7)]
    for dataset in ("vg_captions", None):  # None finds the pair itself
        got = (memory_bank if writer == "jax" else jmb).load_bank(path, dataset)
        want = (jmb if writer == "jax" else memory_bank).load_bank(path, dataset)
        np.testing.assert_array_equal(got.embeddings, want.embeddings)
        np.testing.assert_array_equal(got.embeddings, emb[keep])
        assert got.texts == want.texts == [texts[i] for i in keep]
        assert got.embeddings.dtype == np.float32 and len(got) == len(keep)


def test_bank_missing_and_miskeyed_files(tmp_path):
    import h5py

    assert memory_bank.load_bank(str(tmp_path / "absent.h5")) is None
    assert jmb.load_bank(str(tmp_path / "absent.h5")) is None
    path = str(tmp_path / "bank.h5")
    memory_bank.save_bank(path, "coco_captions", memory_bank.MemoryBank(*_bank_rows()))
    for mod in (memory_bank, jmb):
        with pytest.raises(KeyError, match="coco_captions-embeddings"):
            mod.load_bank(path, "vg_captions")
    not_a_bank = str(tmp_path / "other.h5")
    with h5py.File(not_a_bank, "w") as hf:
        hf.create_dataset("aux-embeddings", data=np.ones((2, 4), np.float32))
    for mod in (memory_bank, jmb):
        with pytest.raises(KeyError, match="aux-embeddings"):
            mod.load_bank(not_a_bank)


def test_bank_dinotxt_slice(tmp_path):
    emb, texts = _bank_rows(d=1024 + 32)
    path = str(tmp_path / "dinotxt.h5")
    jmb.save_bank(path, "coco_captions", jmb.MemoryBank(emb, texts))
    got = memory_bank.load_bank(path, "coco_captions", dinotxt_slice=True)
    want = jmb.load_bank(path, "coco_captions", dinotxt_slice=True)
    assert got.embeddings.shape == (10, 32)
    np.testing.assert_array_equal(got.embeddings, want.embeddings)
    assert got.texts == want.texts


def test_build_bank_and_caption_corpus_equal_jax(tmp_path):
    import json

    path = str(tmp_path / "captions.json")
    with open(path, "w") as f:
        json.dump({"annotations": [{"caption": f"a photo of {i}"} for i in range(30)]}, f)
    for kw in (dict(sample=True, seed=3), dict(sample=False)):
        assert (memory_bank.load_caption_corpus(path, 7, **kw)
                == jmb.load_caption_corpus(path, 7, **kw))
    texts = memory_bank.load_caption_corpus(path, 100)
    sd = talk2dino_sd(12)
    params = torch_port.port_talk2dino(sd)

    def encode(batch):  # a stand-in text tower: a seeded CLIP-wide embedding
        rng = np.random.default_rng(len(batch[0]))
        return talk2dino.project_clip_txt(
            params, torch.from_numpy(rng.standard_normal((len(batch), CLIP), np.float32)))

    got = memory_bank.build_bank(texts, encode, batch_size=8)
    want = jmb.build_bank(texts, lambda b: encode(b).numpy(), batch_size=8)
    np.testing.assert_array_equal(got.embeddings, want.embeddings)
    assert got.texts == want.texts == texts and got.embeddings.shape == (30, D)


# -------------------------------------------------------------- npz files


def test_npz_written_by_jax_loads_in_the_port(tmp_path):
    jcfg = jvit.ViTConfig(img_size=56, embed_dim=64, depth=2, num_heads=2,
                          num_registers=4, pos_grid=4)
    jg = jgpt2.GPT2Config(vocab_size=50, n_layer=1, n_head=2, n_embd=32)
    tree = {"vit": jvit.init_vit(jax.random.PRNGKey(0), jcfg),
            "decoder": jdecap.init_decap(jax.random.PRNGKey(1), jg, prefix_size=64)}
    path = str(tmp_path / "params")  # '.npz' appended by both
    jckpt.save_params_npz(path, tree)
    got = checkpoints.load_params_npz(path)
    _assert_trees_equal(got, {"vit": tree["vit"], "decoder": dict(tree["decoder"]._asdict())})
    assert checkpoints.load_params_npz(path + ".npz").keys() == got.keys()
    # np.savez keeps a bf16 array's bytes only: refused, not misread
    jckpt.save_params_npz(path, {"w": jnp.ones(3, jnp.bfloat16)})
    with pytest.raises(ValueError, match="bf16"):
        checkpoints.load_params_npz(path)


def test_npz_written_by_the_port_loads_in_jax(tmp_path):
    pcfg = vit.ViTConfig(img_size=56, embed_dim=64, depth=2, num_heads=2,
                         num_registers=4, pos_grid=4)
    tree = vit.init_vit(pcfg, torch.Generator().manual_seed(0))
    tree["blocks"][1]["ls1"] = tree["blocks"][1]["ls1"].bfloat16()  # widened exactly
    path = str(tmp_path / "vit.npz")
    checkpoints.save_params_npz(path, tree)
    jcfg = jvit.ViTConfig(img_size=56, embed_dim=64, depth=2, num_heads=2,
                          num_registers=4, pos_grid=4)
    template = jax.eval_shape(lambda k: jvit.init_vit(k, jcfg), jax.random.PRNGKey(0))
    loaded = jckpt.load_params_npz(path, template)
    tree["blocks"][1]["ls1"] = tree["blocks"][1]["ls1"].float()
    _assert_trees_equal(tree, jax.tree_util.tree_map(np.asarray, loaded))


# ---------------------------------------------------------------- Talk2DINO


@pytest.mark.parametrize("act", [None, "tanh", "relu", "sigmoid"])
def test_project_clip_txt_equals_jax(act):
    sd = talk2dino_sd(13, legacy=True)
    x = np.random.default_rng(14).standard_normal((5, CLIP)).astype(np.float32)
    want = np.asarray(jt2d.project_clip_txt(jport.port_talk2dino(dict(sd)), jnp.asarray(x), act))
    got = talk2dino.project_clip_txt(torch_port.port_talk2dino(dict(sd)),
                                     torch.from_numpy(x), act).numpy()
    assert got.shape == (5, D)
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


def test_inversion_from_a_loaded_talk2dino_equals_jax():
    sd = talk2dino_sd(15)
    want = jt2d.build_inversion(jport.port_talk2dino(dict(sd)))
    got = talk2dino.build_inversion(torch_port.port_talk2dino(dict(sd)))
    for k in ("A_pinv", "b"):
        ref = np.asarray(want[k])
        assert got[k].shape == ref.shape
        assert np.max(np.abs(got[k].numpy() - ref)) <= 1e-5 * np.max(np.abs(ref))
    assert got["A_pinv"].shape == (CLIP, D)


def test_talk2dino_config_equals_jax(tmp_path):
    path = tmp_path / "t2d.yaml"
    path.write_text("model:\n  act: tanh\n  hidden_layer: true\n  dino_embed_dim: 768\n")
    assert talk2dino.talk2dino_config_from_yaml(str(path)) == \
        jt2d.talk2dino_config_from_yaml(str(path))
    block = {"act": None, "clip_embed_dim": 768}
    assert talk2dino.talk2dino_config_from_yaml(block) == \
        jt2d.talk2dino_config_from_yaml(block)
    with pytest.raises(ValueError, match="activation"):
        talk2dino.talk2dino_config_from_yaml({"act": "gelu"})


# -------------------------------------------------------- the whole slice

BANK_ROWS = 200


def _config(**extra):
    return dict({
        "dino_model": "dinov2_vitb14_reg", "crop_dim": 56, "normalize": True,
        "support_memory_size": BANK_ROWS, "projection_type": "coco",
        "dino_geometry": {"embed_dim": D, "depth": DEPTH, "num_heads": 2,
                          "extract_heads": 4, "pos_grid": GRID},
        "decap_arch": {"n_layer": N_LAYER, "n_head": 4, "n_embd": N_EMBD,
                       "vocab_size": VOCAB},
    }, **extra)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Every file of the slice, written once: a hub `.pth` (wrapped in a
    `state_dict` key), the same weights as a JAX `.npz`, DeCap `.pt`s whose
    prefix mapper takes CLIP (64) and DINO (128) widths, a Talk2DINO
    `.pth`, and an HDF5 bank with two zero rows."""
    tmp = tmp_path_factory.mktemp("checkpoints")
    hub = hub_dinov2(20)
    out = {"pth": str(tmp / "dinov2_vitb14_reg.pth"), "npz": str(tmp / "dino.npz"),
           "decap_clip": str(tmp / "decap_clip.pt"), "decap_dino": str(tmp / "decap_dino.pt"),
           "t2d": str(tmp / "talk2dino.pth"), "bank": str(tmp / "bank.h5"),
           "memories": str(tmp / "memories")}
    torch.save({"state_dict": hub}, out["pth"])
    jckpt.save_params_npz(out["npz"], jport.port_dinov2(hub, DEPTH, REGS))
    torch.save(decap_sd(21, CLIP), out["decap_clip"])
    torch.save(decap_sd(22, D), out["decap_dino"])
    torch.save(talk2dino_sd(23), out["t2d"])
    emb = np.random.default_rng(24).standard_normal((BANK_ROWS, D)).astype(np.float32)
    emb[[5, 77]] = 0.0
    texts = [f"a caption {i}" for i in range(BANK_ROWS)]
    memory_bank.save_bank(out["bank"], "coco_captions", memory_bank.MemoryBank(emb, texts))
    name, dataset = memory_bank.bank_filename("coco", None, BANK_ROWS)
    jmb.save_bank(os.path.join(out["memories"], name), dataset, jmb.MemoryBank(emb, texts))
    out["texts"] = [t for i, t in enumerate(texts) if i not in (5, 77)]
    return out


def _slice_config(files, how):
    if how == "memory_bank_path, .pth, Talk2DINO":
        return _config(prefix_size=CLIP, dino_weights=files["pth"],
                       decap_weights=files["decap_clip"], talk2dino_weights=files["t2d"],
                       memory_bank_path=files["bank"])
    return _config(prefix_size=D, dino_weights=files["npz"],
                   decap_weights=files["decap_dino"])


@pytest.mark.parametrize("how", ["memory_bank_path, .pth, Talk2DINO",
                                 "IM2TXT_MEMORY_PATH, .npz"])
def test_loaded_slice_captions_equal_jax(files, how, monkeypatch):
    monkeypatch.setenv("IM2TXT_MEMORY_PATH", files["memories"])
    config = _slice_config(files, how)
    jm = JaxPatchioner.from_config(config, allow_missing_weights=False, dtype=jnp.float32)
    pm = Patchioner.from_config(config, allow_missing_weights=False, device="cpu")
    assert pm.bank_texts == jm.bank_texts == files["texts"]
    assert pm.bank.num_real == len(files["texts"]) and pm.bank.rows.shape[1] == D
    assert (pm.inversion is not None) == ("Talk2DINO" in how)
    assert set(pm.load_seconds) == {"read", "port", "upload"}

    rng = np.random.default_rng(25)
    imgs = rng.integers(0, 256, (2, 56, 56, 3), dtype=np.uint8)
    pts = rng.uniform(0, 1, (2, 8, 2)).astype(np.float32)
    valid = np.ones((2, 8), np.float32)
    boxes = np.asarray([[[0, 0, 28, 28], [14, 14, 42, 42]],
                        [[7, 7, 42, 42], [0, 0, 56, 20]]], np.float32)
    for attn in (False, True):
        assert (pm.caption_traces_fused(imgs, pts, valid, use_attention_tracing=attn)
                == jm.caption_traces_fused(imgs, pts, valid, use_attention_tracing=attn))
    assert pm.caption_bboxes_fused(imgs, boxes) == jm.caption_bboxes_fused(imgs, boxes)

    # the projected (and, with Talk2DINO, inverted) trace prefix
    pixels = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
    cfg = jm.vit_cfg
    outs = jvit.vit_forward(jm.vit_params, jnp.asarray(pixels), cfg)
    attn, _ = jvit.process_self_attention(
        outs["qkv_last"], num_heads=cfg.extract_heads,
        num_global_tokens=cfg.num_global_tokens, scale=cfg.extract_scale)
    feats = jrp.trace_pool(outs["x_norm_patchtokens"],
                           jrp.traces_to_grid(jnp.asarray(pts), jnp.asarray(valid),
                                              cfg.grid_size), attn)
    want = np.asarray(jm.project_features(feats))
    step = entry.make_prefix_step(pm.vit_cfg, pm.bank.num_real, use_attention=True,
                                  normalize=pm.normalize)
    got = step(pm.state(), torch.from_numpy(pixels), torch.from_numpy(pts),
               torch.from_numpy(valid)).numpy()
    assert got.shape == want.shape == (2, config["prefix_size"])
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


def test_inversion_sets_the_random_bank_width(files, tmp_path, monkeypatch):
    monkeypatch.setenv("IM2TXT_MEMORY_PATH", str(tmp_path))  # no bank file there
    config = _config(prefix_size=CLIP, dino_weights=files["pth"],
                     decap_weights=files["decap_clip"], talk2dino_weights=files["t2d"])
    pm = Patchioner.from_config(config, allow_missing_weights=True, random_bank_size=8,
                                device="cpu")
    jm = JaxPatchioner.from_config(config, allow_missing_weights=True, random_bank_size=8)
    assert pm.bank.rows.shape == (8, D) and jm.bank.rows.shape[1] == D
    assert pm.bank_texts == jm.bank_texts
    assert pm.inversion["A_pinv"].shape == (CLIP, D)
    prefix = entry.make_prefix_step(pm.vit_cfg, 8)(
        pm.state(), *entry.example_inputs(2, img=56, n_pts=4, device="cpu"))
    assert prefix.shape == (2, CLIP)


def test_a_decap_directory_is_not_ported(files, tmp_path):
    config = _config(prefix_size=D, dino_weights=files["pth"], decap_weights=str(tmp_path),
                     memory_bank_path=files["bank"])
    with pytest.raises(NotImplementedError, match="training slice"):
        Patchioner.from_config(config, device="cpu")


def _mismatch(files, tmp_path, kind):
    """A config and a file that disagree in one shape; the message's words."""
    if kind == "encoder depth":
        path = str(tmp_path / "deep.pth")
        torch.save(hub_dinov2(30, depth=DEPTH + 1), path)
        return dict(dino_weights=path), "3 entries.*depth 2"
    if kind == "encoder width":
        path = str(tmp_path / "narrow.pth")
        torch.save(hub_dinov2(31, d=64), path)
        return dict(dino_weights=path), r"\(588, 64\).*width 128.*\(588, 128\)"
    if kind == "registers":
        path = str(tmp_path / "no_regs.pth")
        torch.save(hub_dinov2(32, regs=0), path)
        return dict(dino_weights=path), "register_tokens"
    if kind == "heads":
        return dict(dino_geometry=dict(_config()["dino_geometry"], num_heads=3)), "3 heads"
    if kind == "vocabulary":
        return dict(decap_arch=dict(_config()["decap_arch"], vocab_size=VOCAB + 7)), \
            r"\['wte'\] is \(1000, 128\).*vocab_size 1007.*\(1007, 128\)"
    if kind == "decoder depth":
        return dict(decap_arch=dict(_config()["decap_arch"], n_layer=N_LAYER + 1)), \
            "2 entries.*n_layer 3"
    if kind == "prefix width":
        return dict(prefix_size=D + 8), r"\(128, 128\).*prefix_size 136.*\(136, 128\)"
    if kind == "bank width":
        path = str(tmp_path / "wide.h5")
        memory_bank.save_bank(path, "coco_captions",
                              memory_bank.MemoryBank(np.ones((4, D + 16), np.float32),
                                                     list("abcd")))
        return dict(memory_bank_path=path), "144 wide.*gives 128"
    assert kind == "talk2dino"
    return dict(talk2dino_weights=files["t2d"]), "CLIP 64 -> DINO 128.*prefix_size is 128"


@pytest.mark.parametrize("kind", ["encoder depth", "encoder width", "registers", "heads",
                                  "vocabulary", "decoder depth", "prefix width",
                                  "bank width", "talk2dino"])
def test_a_tree_that_disagrees_with_the_config_raises_at_load(files, tmp_path, kind):
    extra, words = _mismatch(files, tmp_path, kind)
    config = _config(**dict(dict(prefix_size=D, dino_weights=files["pth"],
                                 decap_weights=files["decap_dino"],
                                 memory_bank_path=files["bank"]), **extra))
    with pytest.raises(ValueError, match=words):
        Patchioner.from_config(config, device="cpu")


@pytest.mark.parametrize("missing", ["dino_weights", "decap_weights", "memory_bank_path"])
def test_a_missing_file_needs_the_explicit_opt_in(files, tmp_path, missing):
    config = _config(prefix_size=D, dino_weights=files["pth"],
                     decap_weights=files["decap_dino"], memory_bank_path=files["bank"])
    config[missing] = str(tmp_path / "absent.file")
    for build in (lambda: Patchioner.from_config(config, device="cpu"),
                  lambda: JaxPatchioner.from_config(config)):
        with pytest.raises(FileNotFoundError):
            build()
    # under the opt-in only the missing file is drawn at random
    pm = Patchioner.from_config(config, allow_missing_weights=True, random_bank_size=8,
                                device="cpu")
    loaded = Patchioner.from_config(dict(config, **{missing: files[{
        "dino_weights": "pth", "decap_weights": "decap_dino",
        "memory_bank_path": "bank"}[missing]]}), device="cpu")
    same = {"dino_weights": torch.equal(pm.vit_params["cls_token"],
                                        loaded.vit_params["cls_token"]),
            "decap_weights": torch.equal(pm.decoder.gpt2["wte"], loaded.decoder.gpt2["wte"]),
            "memory_bank_path": pm.bank.num_real == loaded.bank.num_real}
    assert [k for k, v in same.items() if not v] == [missing]


@pytest.mark.parametrize("geometry", [
    dict(), dict(num_registers=0, layerscale=False), dict(ffn="swiglu", depth=3)])
def test_param_templates_have_the_shapes_of_the_inits(geometry):
    # the load check compares a file's tree with these templates
    def shapes(tree):
        return [(p, tuple(t.shape)) for p, t in checkpoints._flatten(tree)]

    cfg = vit.ViTConfig(**dict(dict(img_size=56, embed_dim=D, depth=DEPTH, num_heads=2,
                                    pos_grid=GRID), **geometry))
    gen = torch.Generator().manual_seed(0)
    assert shapes(vit.param_template(cfg)) == shapes(vit.init_vit(cfg, gen))
    gcfg = gpt2.GPT2Config(vocab_size=VOCAB, n_layer=cfg.depth, n_head=4, n_embd=N_EMBD)
    assert shapes(gpt2.param_template(gcfg)) == shapes(gpt2.init_gpt2(gcfg, gen))
    assert all(t.device.type == "meta" for _, t in checkpoints._flatten(
        [vit.param_template(cfg), gpt2.param_template(gcfg)]))


def _chip_smoke_module():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_writes_the_layouts_the_port_reads():
    # the card phase writes its checkpoints from the port's own trees; each
    # must port back to the tree it came from
    cs = _chip_smoke_module()
    cfg = vit.ViTConfig(img_size=56, embed_dim=D, depth=DEPTH, num_heads=2, pos_grid=GRID)
    gen = torch.Generator().manual_seed(0)
    tree = vit.init_vit(cfg, gen)
    sd = cs.hub_state_dict(tree)
    assert sd["patch_embed.proj.weight"].shape == (D, 3, PATCH, PATCH)
    _assert_trees_equal(torch_port.port_dinov2(sd, DEPTH, REGS), tree)
    gcfg = gpt2.GPT2Config(vocab_size=VOCAB, n_layer=N_LAYER, n_head=4, n_embd=N_EMBD)
    dec = decap.init_decap(gcfg, CLIP, gen)
    ported = torch_port.port_decap(cs.decap_state_dict(dec), n_layer=N_LAYER)
    _assert_trees_equal(ported, dec._asdict())
    linear = {"w": torch.randn(CLIP, D, generator=gen), "b": torch.randn(D, generator=gen)}
    _assert_trees_equal(torch_port.port_talk2dino(cs.talk2dino_state_dict(linear)),
                        {"linear": linear, "hidden": []})
