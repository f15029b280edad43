"""The port's CLIP text tower and its callers against the JAX package's, on
the CPU, at a small geometry (width 128, depth 2, heads 2, context 13,
projection 128, the full 49,408-token vocabulary):

- `clip_text_forward` on the same bridged weights, with a cut row (EOT
  last), a row without EOT (position 0 pooled) and a row with two EOTs
  (the first pooled): within 1e-5 * max|ref| at f32 and 2e-2 * max|ref|
  in bf16;
- `port_openai_clip_text` under every space's key prefix and
  `port_hf_clip_text`: the trees equal the JAX package's leaf for leaf;
- the tower against a literal torch re-execution of the reference's
  `encode_text`;
- each of the five text spaces built from one written file in both
  packages: geometry, tokens and features equal within 1e-5; the HF export
  branch, the checkpoint unwrap, the unknown space, the seeded random
  geometries and the line that announces a random tower;
- the DINO.txt porters with and without text keys, nested one level, a
  broken text port, the visual port, and the space's patch-aligned half;
- `ClipScorer`, `pac_score`, `ref_pac_score` and `cached_image_features`
  within 1e-5 of the JAX package's;
- `chip_smoke.py`'s text files: each space's geometry, and the layout it
  writes ported back to the tree it came from; the new modules import
  neither JAX nor the JAX package.
"""

import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchioner_tpu.eval import pac_score as jpac
from patchioner_tpu.models import clip as jclip
from patchioner_tpu.models import dinotxt as jdinotxt
from patchioner_tpu.text import clip_bpe as jbpe
from patchioner_tpu.train import text_spaces as jts
from patchioner_tpu_torch.eval import pac_score
from patchioner_tpu_torch.io import bridge
from patchioner_tpu_torch.models import clip, dinotxt
from patchioner_tpu_torch.train import text_spaces

# head width 64, as `_geometry_from_sd` assumes
TINY = dict(width=128, depth=2, heads=2, context=13, proj=128, vocab=49408)
SPACE_PREFIXES = {"clip": "", "open_clip": "", "dinotxt": "text_model.",
                  "regionclip": "lang_encoder.", "denseclip": "text_encoder."}
TEXTS = ["a photo of a dog", "two cats sleeping on a red sofa in the sun",
         "a man riding a horse on the beach at dawn with a dog and a kite"]


def _cfg(module, dtype=None, **kw):
    g = dict(TINY, **kw)
    extra = {} if dtype is None else {"dtype": dtype}
    return module.ClipTextConfig(vocab_size=g["vocab"], context_length=g["context"],
                                 width=g["width"], depth=g["depth"], heads=g["heads"],
                                 proj_dim=g["proj"], **extra)


def tiny_openai_text_sd(prefix="", seed=0, **kw):
    """An openai/CLIP-layout text tower state dict (torch tensors) drawn
    from a numpy seed, LayerNorms away from their init."""
    g = dict(TINY, **kw)
    rng = np.random.default_rng(seed)

    def t(*s, scale=0.05, base=0.0):
        return torch.from_numpy((base + rng.standard_normal(s) * scale).astype(np.float32))

    w = g["width"]
    sd = {"token_embedding.weight": t(g["vocab"], w),
          "positional_embedding": t(g["context"], w),
          "ln_final.weight": t(w, base=1.0), "ln_final.bias": t(w),
          "text_projection": t(w, g["proj"])}
    for i in range(g["depth"]):
        p = f"transformer.resblocks.{i}"
        sd.update({
            f"{p}.ln_1.weight": t(w, base=1.0), f"{p}.ln_1.bias": t(w),
            f"{p}.attn.in_proj_weight": t(3 * w, w), f"{p}.attn.in_proj_bias": t(3 * w),
            f"{p}.attn.out_proj.weight": t(w, w), f"{p}.attn.out_proj.bias": t(w),
            f"{p}.ln_2.weight": t(w, base=1.0), f"{p}.ln_2.bias": t(w),
            f"{p}.mlp.c_fc.weight": t(4 * w, w), f"{p}.mlp.c_fc.bias": t(4 * w),
            f"{p}.mlp.c_proj.weight": t(w, 4 * w), f"{p}.mlp.c_proj.bias": t(w),
        })
    return {prefix + k: v for k, v in sd.items()}


def hf_text_sd(sd):
    """The same tower as a transformers CLIPTextModelWithProjection export."""
    w = sd["token_embedding.weight"].shape[1]
    out = {"text_model.embeddings.token_embedding.weight": sd["token_embedding.weight"],
           "text_model.embeddings.position_embedding.weight": sd["positional_embedding"],
           "text_model.final_layer_norm.weight": sd["ln_final.weight"],
           "text_model.final_layer_norm.bias": sd["ln_final.bias"],
           "text_projection.weight": sd["text_projection"].t().contiguous()}
    depth = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("transformer.resblocks."))
    for i in range(depth):
        a, h = f"transformer.resblocks.{i}", f"text_model.encoder.layers.{i}"
        for j, qkv in enumerate("qkv"):
            out[f"{h}.self_attn.{qkv}_proj.weight"] = sd[f"{a}.attn.in_proj_weight"][j * w:(j + 1) * w]
            out[f"{h}.self_attn.{qkv}_proj.bias"] = sd[f"{a}.attn.in_proj_bias"][j * w:(j + 1) * w]
        for src, dst in (("attn.out_proj", "self_attn.out_proj"), ("ln_1", "layer_norm1"),
                         ("ln_2", "layer_norm2"), ("mlp.c_fc", "mlp.fc1"),
                         ("mlp.c_proj", "mlp.fc2")):
            for leaf in ("weight", "bias"):
                out[f"{h}.{dst}.{leaf}"] = sd[f"{a}.{src}.{leaf}"]
    return out


def torch_reference_encode_text(sd, tokens, *, heads):
    """Literal re-execution of the reference CLIP-style encode_text
    (src/regionclip/clip_backbone.py:546-558; DenseCLIP's and DINO.txt's
    text towers run the same math)."""
    x = sd["token_embedding.weight"][tokens]
    t = x.shape[1]
    x = x + sd["positional_embedding"][:t]
    mask = torch.full((t, t), float("-inf")).triu_(1)
    depth = 1 + max(
        int(k.split(".")[2]) for k in sd
        if k.startswith("transformer.resblocks.")
    )
    for i in range(depth):
        p = f"transformer.resblocks.{i}"
        ln1 = torch.nn.functional.layer_norm(
            x, x.shape[-1:], sd[f"{p}.ln_1.weight"], sd[f"{p}.ln_1.bias"],
            eps=1e-5,
        )
        attn_out, _ = torch.nn.functional.multi_head_attention_forward(
            ln1.transpose(0, 1), ln1.transpose(0, 1), ln1.transpose(0, 1),
            x.shape[-1], heads,
            sd[f"{p}.attn.in_proj_weight"], sd[f"{p}.attn.in_proj_bias"],
            None, None, False, 0.0,
            sd[f"{p}.attn.out_proj.weight"], sd[f"{p}.attn.out_proj.bias"],
            need_weights=False, attn_mask=mask,
        )
        x = x + attn_out.transpose(0, 1)
        ln2 = torch.nn.functional.layer_norm(
            x, x.shape[-1:], sd[f"{p}.ln_2.weight"], sd[f"{p}.ln_2.bias"],
            eps=1e-5,
        )
        h = ln2 @ sd[f"{p}.mlp.c_fc.weight"].T + sd[f"{p}.mlp.c_fc.bias"]
        h = h * torch.sigmoid(1.702 * h)  # QuickGELU
        x = x + h @ sd[f"{p}.mlp.c_proj.weight"].T + sd[f"{p}.mlp.c_proj.bias"]
    x = torch.nn.functional.layer_norm(
        x, x.shape[-1:], sd["ln_final.weight"], sd["ln_final.bias"], eps=1e-5
    )
    eot = tokens.argmax(dim=-1)
    return x[torch.arange(x.shape[0]), eot] @ sd["text_projection"]


def _tokens():
    """Three tokenized captions (the last cut at 13, EOT kept last), a row
    without EOT and a row with two."""
    toks = jbpe.get_tokenizer().tokenize(TEXTS, TINY["context"])
    no_eot = np.where(toks[0] == 49407, 1000, toks[0])
    two = toks[1].copy()
    two[4] = 49407
    return np.concatenate([toks, no_eot[None], two[None]]).astype(np.int32)


def _assert_trees_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_trees_equal(g, w)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _rel(got, want):
    return float(np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_text_forward_equals_jax(dtype):
    jcfg = _cfg(jclip, getattr(jnp, dtype))
    cfg = _cfg(clip, getattr(torch, dtype))
    jparams = jclip.port_openai_clip_text(tiny_openai_text_sd(seed=1), TINY["depth"])
    params = bridge.clip_text_from_jax(jparams, cfg)
    toks = _tokens()
    assert toks[2, -1] == 49407 and not (toks[3] == 49407).any()
    assert list(clip.first_eot(torch.from_numpy(toks), 49407)[3:]) == [0, 4]
    want = np.asarray(jclip.clip_text_forward(jparams, jnp.asarray(toks), jcfg), np.float32)
    got = clip.clip_text_forward(params, torch.from_numpy(toks), cfg).float().numpy()
    assert got.shape == (5, TINY["proj"])
    assert _rel(got, want) <= (1e-5 if dtype == "float32" else 2e-2)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def test_text_init_has_the_tree_of_jax_and_of_the_template():
    cfg, jcfg = _cfg(clip), _cfg(jclip)
    tree = clip.init_clip_text(cfg, torch.Generator().manual_seed(0))
    want = jax.eval_shape(lambda k: jclip.init_clip_text(k, jcfg), jax.random.PRNGKey(0))
    assert _shapes(tree) == _shapes(want) == _shapes(clip.text_param_template(cfg))
    dtree = dinotxt.init_dinotxt_text(torch.Generator().manual_seed(0), cfg)
    jdtree = jax.eval_shape(lambda k: jdinotxt.init_dinotxt_text(k, jcfg), jax.random.PRNGKey(0))
    assert _shapes(dtree) == _shapes(jdtree) == _shapes(tree)
    assert _shapes(clip.text_param_template(dinotxt.DINOTXT_TEXT_CONFIG))["pos_embed"] == (77, 1280)


@pytest.mark.parametrize("prefix", sorted(set(SPACE_PREFIXES.values())))
def test_openai_text_porter_equals_jax(prefix):
    sd = tiny_openai_text_sd(prefix, seed=2)
    want = jclip.port_openai_clip_text(sd, TINY["depth"], prefix)
    _assert_trees_equal(clip.port_openai_clip_text(sd, TINY["depth"], prefix), want)
    with pytest.raises(KeyError, match="text_projection"):
        clip.port_openai_clip_text({k: v for k, v in sd.items() if "text_projection" not in k},
                                   TINY["depth"], prefix)


def test_hf_text_porter_equals_jax_and_the_openai_layout():
    sd = tiny_openai_text_sd(seed=3)
    hf = hf_text_sd(sd)
    got = clip.port_hf_clip_text(hf, TINY["depth"])
    _assert_trees_equal(got, jclip.port_hf_clip_text(hf, TINY["depth"]))
    _assert_trees_equal(got, {k: v for k, v in jclip.port_openai_clip_text(
        sd, TINY["depth"]).items()})


def test_tower_equals_the_literal_torch_reference():
    sd = tiny_openai_text_sd(seed=4)
    toks = torch.from_numpy(_tokens()[:3].astype(np.int64))
    want = torch_reference_encode_text(sd, toks, heads=TINY["heads"]).numpy()
    got = clip.clip_text_forward(clip.port_openai_clip_text(sd, TINY["depth"]), toks,
                                 _cfg(clip)).numpy()
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("name", text_spaces.TEXT_SPACE_NAMES)
def test_space_from_a_file_equals_jax(name, tmp_path):
    path = str(tmp_path / f"{name}.pth")
    torch.save(tiny_openai_text_sd(SPACE_PREFIXES[name], seed=5), path)
    want = jts.build_text_space(name, path)
    got = text_spaces.build_text_space(name, path, device="cpu")
    assert got.cfg == _cfg(clip) and want.cfg == _cfg(jclip)
    half = TINY["proj"] // 2
    assert got.prefix_size == want.prefix_size == (half if name == "dinotxt" else TINY["proj"])
    toks = got.tokenize(TEXTS)
    np.testing.assert_array_equal(toks, want.tokenize(TEXTS))
    feats = got.encode_tokens(toks).numpy()
    assert _rel(feats, np.asarray(want.encode_tokens(toks))) <= 1e-5
    bank = got.encode_texts_for_bank(TEXTS, batch_size=2)
    assert bank.shape == (3, TINY["proj"])
    assert _rel(bank, want.encode_texts_for_bank(TEXTS, batch_size=2)) <= 1e-5
    np.testing.assert_array_equal(got.encode_texts(TEXTS, batch_size=2),
                                  bank[:, half:] if name == "dinotxt" else bank)


def test_space_hf_export_unwrap_and_unknown(tmp_path):
    sd = tiny_openai_text_sd(seed=6)
    hf_path, wrapped = str(tmp_path / "hf.pth"), str(tmp_path / "wrapped.pth")
    torch.save(hf_text_sd(sd), hf_path)
    torch.save({"model": {"lang_encoder." + k: v for k, v in sd.items()}, "epoch": 3}, wrapped)
    toks = _tokens()[:3]
    for name, path in (("clip", hf_path), ("regionclip", wrapped)):
        got = text_spaces.build_text_space(name, path, device="cpu")
        want = jts.build_text_space(name, path)
        assert got.cfg == _cfg(clip)
        assert _rel(got.encode_tokens(toks).numpy(), np.asarray(want.encode_tokens(toks))) <= 1e-5
    with pytest.raises(ValueError, match="unknown text space"):
        text_spaces.build_text_space("bert", device="cpu")


def test_random_spaces_take_the_documented_geometry(capsys):
    want = {"clip": jclip.ClipTextConfig(), "open_clip": jclip.ClipTextConfig(),
            "dinotxt": jdinotxt.DINOTXT_TEXT_CONFIG,
            "regionclip": jclip.ClipTextConfig(proj_dim=1024),
            "denseclip": jts._denseclip_text_cfg("denseclip_segmentation_vitb16")}
    for name, cfg in want.items():
        got = text_spaces._random_geometry(name, "denseclip_segmentation_vitb16")
        assert dataclass_fields(got) == dataclass_fields(cfg), name
    assert text_spaces._random_geometry("denseclip", "denseclip_segmentation_vitb16") \
        .context_length == 13
    space = text_spaces.build_text_space("denseclip", "/nonexistent.pth", seed=3, device="cpu")
    assert "[!] text weights not found at /nonexistent.pth — seeded random denseclip encoder" \
        in capsys.readouterr().out
    assert space.tokenize(TEXTS[:1]).shape == (1, 13)
    feats = space.encode_texts(TEXTS[:1])
    assert feats.shape == (1, 512) and np.isfinite(feats).all()


def dataclass_fields(cfg):
    return {k: getattr(cfg, k) for k in ("vocab_size", "context_length", "width", "depth",
                                         "heads", "proj_dim", "ln_eps", "eot_token")}


def _dinov2_sd(prefix=""):
    """A tiny torch.hub DINOv2 state dict (width 64, 1 block, 4 registers)."""
    rng = np.random.default_rng(7)
    d, p = 64, 14

    def t(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.05)

    sd = {"cls_token": t(1, 1, d), "pos_embed": t(1, 17, d), "register_tokens": t(1, 4, d),
          "mask_token": t(1, d), "patch_embed.proj.weight": t(d, 3, p, p),
          "patch_embed.proj.bias": t(d), "norm.weight": t(d), "norm.bias": t(d)}
    for key, shape in (("norm1", (d,)), ("norm2", (d,))):
        sd[f"blocks.0.{key}.weight"], sd[f"blocks.0.{key}.bias"] = t(*shape), t(*shape)
    for key, (o, i) in (("attn.qkv", (3 * d, d)), ("attn.proj", (d, d)),
                        ("mlp.fc1", (4 * d, d)), ("mlp.fc2", (d, 4 * d))):
        sd[f"blocks.0.{key}.weight"], sd[f"blocks.0.{key}.bias"] = t(o, i), t(o)
    sd["blocks.0.ls1.gamma"], sd["blocks.0.ls2.gamma"] = t(d), t(d)
    return {prefix + k: v for k, v in sd.items()}


def test_dinotxt_ports_equal_jax(tmp_path):
    visual = _dinov2_sd("visual_model.backbone.model.")
    for text in (tiny_openai_text_sd("text_model.", seed=8),
                 tiny_openai_text_sd("text_model.backbone.", seed=8)):
        sd = visual | text
        want = jdinotxt.port_dinotxt(sd, visual_depth=1, text_depth=TINY["depth"])
        got = dinotxt.port_dinotxt(sd, visual_depth=1, text_depth=TINY["depth"])
        _assert_trees_equal(got["text"], want["text"])
        _assert_trees_equal(got["visual"], want["visual"])
    without = dinotxt.port_dinotxt(visual, visual_depth=1)
    assert without["text"] is None and jdinotxt.port_dinotxt(visual, visual_depth=1)["text"] is None
    _assert_trees_equal(dinotxt.port_dinotxt_visual(_dinov2_sd(), depth=1),
                        jdinotxt.port_dinotxt_visual(_dinov2_sd(), depth=1))
    broken = visual | {k: v for k, v in tiny_openai_text_sd("text_model.").items()
                       if "ln_final" not in k}
    for module in (dinotxt, jdinotxt):
        with pytest.raises(KeyError, match="ln_final"):
            module.port_dinotxt(broken, visual_depth=1, text_depth=TINY["depth"])
        with pytest.raises(KeyError, match="dinotxt visual port"):
            module.port_dinotxt_visual({"text_model.x": torch.zeros(1)})
    # the encoder's whole output, and the space's patch-aligned half
    text = dinotxt.port_dinotxt_text(tiny_openai_text_sd("text_model.", seed=8), TINY["depth"])
    cfg = _cfg(clip)
    full = dinotxt.DinotxtTextEncoder(text, cfg, device="cpu").encode_texts(TEXTS, batch_size=2)
    jfull = jdinotxt.DinotxtTextEncoder(jdinotxt.port_dinotxt_text(
        tiny_openai_text_sd("text_model.", seed=8), TINY["depth"]), _cfg(jclip)).encode_texts(
        TEXTS, batch_size=2)
    assert full.shape == (3, TINY["proj"]) and _rel(full, jfull) <= 1e-5
    path = str(tmp_path / "dinotxt.pth")
    torch.save(visual | tiny_openai_text_sd("text_model.", seed=8), path)
    space = text_spaces.build_text_space("dinotxt", path, device="cpu")
    np.testing.assert_array_equal(space.encode_texts(TEXTS, batch_size=2),
                                  full[:, TINY["proj"] // 2:])
    assert dinotxt.DINOTXT_TEXT_CONFIG == clip.ClipTextConfig(width=1280, depth=24, heads=20,
                                                              proj_dim=2048)
    np.testing.assert_array_equal(dinotxt.tokenize(TEXTS), jdinotxt.tokenize(TEXTS))


# ------------------------------------------------------------- CLIP-S / PAC-S

VISION = dict(img_size=32, patch_size=16, width=64, depth=1, heads=4, proj_dim=48)
TEXT = dict(context_length=77, width=64, depth=1, heads=2, proj_dim=48)


@pytest.fixture(scope="module")
def scorers():
    """(JAX ClipScorer, port ClipScorer) on the same weights: a one-block
    vision tower and a one-block text tower at context 77, both projecting
    to 48."""
    vcfg = jclip.ClipVisionConfig(**VISION)
    tcfg = jclip.ClipTextConfig(**TEXT)
    vparams = jax.jit(lambda k: jclip.init_clip_vision(k, vcfg))(jax.random.PRNGKey(0))
    tparams = jax.jit(lambda k: jclip.init_clip_text(k, tcfg))(jax.random.PRNGKey(1))
    port = pac_score.ClipScorer(
        bridge.clip_vision_from_jax(vparams, clip.ClipVisionConfig(**VISION)),
        bridge.clip_text_from_jax(tparams, clip.ClipTextConfig(**TEXT)),
        clip.ClipVisionConfig(**VISION), clip.ClipTextConfig(**TEXT), device="cpu")
    return jpac.ClipScorer(vparams, tparams, vcfg, tcfg), port


def test_clip_scorer_and_pac_scores_equal_jax(scorers, tmp_path):
    jax_scorer, port = scorers
    pixels = np.random.default_rng(9).standard_normal((3, 32, 32, 3)).astype(np.float32)
    img = port.encode_images(pixels, batch_size=2)
    assert img.shape == (3, 48) and _rel(img, jax_scorer.encode_images(pixels, batch_size=2)) <= 1e-5
    texts = port.encode_texts(TEXTS, batch_size=2, prompt=pac_score.PAC_PROMPT)
    assert pac_score.PAC_PROMPT == jpac.PAC_PROMPT
    assert _rel(texts, jax_scorer.encode_texts(TEXTS, batch_size=2,
                                               prompt=jpac.PAC_PROMPT)) <= 1e-5
    mean, per, cand, lengths = pac_score.pac_score(port, img, TEXTS)
    jmean, jper, jcand, jlengths = jpac.pac_score(jax_scorer, img, TEXTS)
    assert abs(mean - jmean) <= 1e-5 and np.abs(per - jper).max() <= 1e-5
    assert np.abs(cand - jcand).max() <= 1e-5 and lengths == jlengths
    assert pac_score.pac_score(None, img, TEXTS, candidate_features=texts)[0] == \
        pytest.approx(mean, abs=1e-6)
    refs = [["a dog", "a puppy on grass"], [], ["a man on a horse"]]
    rmean, rper = pac_score.ref_pac_score(port, refs, cand)
    jrmean, jrper = jpac.ref_pac_score(jax_scorer, refs, jcand)
    assert rper[1] == 0.0 and abs(rmean - jrmean) <= 1e-5 and np.abs(rper - jrper).max() <= 1e-5
    # the cache: features computed once, then read back for the same ids
    calls = []

    def load(ids):
        calls.append(list(ids))
        return pixels[[int(i) for i in ids]]

    cache = str(tmp_path / "feats.h5")
    first = pac_score.cached_image_features(port, [0, 1, 2], load, cache, batch_size=2)
    again = pac_score.cached_image_features(port, [2, 0], load, cache)
    assert calls == [["0", "1"], ["2"]]
    np.testing.assert_array_equal(again, first[[2, 0]])
    assert _rel(first, jpac.cached_image_features(jax_scorer, [0, 1, 2], load)) <= 1e-5


def test_scorer_and_dinotxt_encoder_run_on_the_card_unless_asked(scorers, monkeypatch):
    """Without `device=`, both take the card and raise when there is none;
    on the CPU the weights are cast there to f32."""
    _, port = scorers
    assert port.device == torch.device("cpu")
    assert port.text_params["token_embedding"].dtype == torch.float32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pac_score.ClipScorer(port.vision_params, port.text_params, port.vision_cfg,
                             port.text_cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dinotxt.DinotxtTextEncoder(port.text_params, port.text_cfg)
    bf16 = {k: v.to(torch.bfloat16) if torch.is_tensor(v) else v
            for k, v in port.text_params.items()}
    encoder = dinotxt.DinotxtTextEncoder(bf16, port.text_cfg, device="cpu")
    assert encoder.device == torch.device("cpu")
    assert encoder.params["token_embedding"].dtype == torch.float32


# ------------------------------------------------------------ chip_smoke.py

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_text_files_are_the_layouts_the_spaces_read(tmp_path):
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO,
                                                                            "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs._text_cfg("clip") == clip.ClipTextConfig()
    assert cs._text_cfg("dinotxt") == dinotxt.DINOTXT_TEXT_CONFIG
    assert cs._text_cfg("denseclip") == text_spaces._random_geometry(
        "denseclip", "denseclip_segmentation_vitb16")
    assert cs._text_cfg("regionclip") == text_spaces._random_geometry("regionclip", "")
    tree = clip.init_clip_text(_cfg(clip), torch.Generator().manual_seed(20))
    for name, (prefix, *_) in cs.TEXT_SPACES.items():
        assert prefix == text_spaces.CHECKPOINT_PREFIX[name]
        path = str(tmp_path / f"{name}.pt")
        torch.save(cs.text_state_dict(tree, prefix), path)
        space = text_spaces.build_text_space(name, path, device="cpu")
        assert space.cfg == _cfg(clip)
        _assert_trees_equal(space.params, tree)
    captions = cs._bank_captions(0, 100)
    assert len(set(captions)) == 100 and all(6 <= len(c.split()) <= 16 for c in captions)


def test_text_modules_import_neither_jax_nor_the_jax_package():
    mods = ["models.clip", "models.dinotxt", "eval.pac_score", "train.text_spaces",
            "train.extract_features"]
    code = ("import sys\n" + "".join(f"import patchioner_tpu_torch.{m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'patchioner_tpu'))\n"
              "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=dict(os.environ, PYTHONPATH=REPO))
