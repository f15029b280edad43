"""The port's ClipCap (`patchioner_tpu_torch.models.clipcap`) against the
JAX package's, on the CPU in f32 on the same weights (JAX inits, or numpy
seeded state dicts in the published layout) at the JAX tests' sizes: a
2-layer, 32-wide GPT-2 over 263 tokens, wte scaled by 20 so that steps are
not near-ties (by 4 for sampling, so that each step keeps many tokens).

- `nucleus_filter` exactly equal for top_p 0, 0.3, 0.8 and 0.99, on
  random logits and on logits with ties;
- the sampler's tokens equal JAX `_sample_tokens` given JAX's own Gumbel
  noise (`jax.random.gumbel` of the split keys), a NaN row taking the stop
  id;
- both mappers and `port_clipcap` on one state dict, leaf for leaf, and
  their outputs within 1e-5 of max(1, max|ref|);
- `ClipCap.forward` at top_p 0 equal to `generate_batched`; the scores
  1 / perplexity with the 1.0 fallback;
- the backbone-width rule, and `from_config` with a `clipcap` block,
  with and without a bank: `forward`'s trace, box and whole-image
  captions equal the JAX package's at top_p 0 on the same files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import patchioner_tpu.models.gpt2 as jgpt2
from patchioner_tpu.models import clipcap as jclipcap
from patchioner_tpu.models.patchioner import Patchioner as JaxPatchioner
from patchioner_tpu_torch.io import bridge
from patchioner_tpu_torch.models import clipcap, gpt2, patchioner, viecap
from patchioner_tpu_torch.models.patchioner import Patchioner
from test_clipcap import WordTokenizer, oracle_top_p
from test_torch_forward import LM_GEOM, _viecap_state_dict
from test_torch_viecap import _assert_trees_equal, _tree

D = LM_GEOM["n_embd"]


def _lm(wte_scale):
    cfg = jgpt2.GPT2Config(**LM_GEOM)
    params = jgpt2.init_gpt2(jax.random.PRNGKey(31), cfg)
    params = dict(params, wte=params["wte"] * wte_scale)
    return cfg, params, gpt2.GPT2Config(**LM_GEOM), bridge.to_torch(params)


@pytest.fixture(scope="module")
def lm():
    return _lm(20)


@pytest.fixture(scope="module")
def mild_lm():
    """wte scaled by 4 only: top_p 0.8 keeps ~170 of 263 tokens, so the
    noise picks among many."""
    return _lm(4)


def _tokenizers():
    """One WordTokenizer a package, '.' first (id 10)."""
    toks = WordTokenizer(), WordTokenizer()
    for tok in toks:
        tok.encode(".")
    return toks


# ------------------------------------------------------------ the filter


def _logits(kind):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 50)).astype(np.float32) * 3
    if kind == "ties":  # values on a grid of 0.5: many equal, some at the cut
        x = np.round(x * 2) / 2
        x[1] = 1.0  # a row of one value
        x[2, :10] = x[2].max()  # ten tied maxima
    return x


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("top_p", [0.0, 0.3, 0.8, 0.99])
def test_nucleus_filter_equals_jax(top_p, kind):
    x = _logits(kind)
    got = clipcap.nucleus_filter(torch.from_numpy(x), top_p).numpy()
    np.testing.assert_array_equal(got, np.asarray(jclipcap.nucleus_filter(jnp.asarray(x),
                                                                          top_p)))
    # the threshold form keeps a tie at the cut on both sides; it agrees
    # with the reference's scatter wherever no tie straddles the cut
    if kind == "random":
        np.testing.assert_array_equal(np.isinf(got), np.isinf(oracle_top_p(x, top_p)))
    assert np.isfinite(got).any(axis=-1).all()


# ------------------------------------------------------------ sampling


def _jax_noise(key, steps, b, v):
    keys = jax.random.split(key, steps)
    return np.stack([np.asarray(jax.random.gumbel(keys[t], (b, v), jnp.float32))
                     for t in range(steps)])


@pytest.mark.parametrize("top_p,temperature", [(0.8, 1.0), (0.3, 0.7)])
def test_sampler_tokens_equal_jax_given_its_noise(mild_lm, top_p, temperature):
    jcfg, jparams, pcfg, pparams = mild_lm
    rng = np.random.default_rng(2)
    prefix = rng.standard_normal((4, 3, D)).astype(np.float32)
    prefix[2] = np.nan  # its logits are NaN at every step: the stop id
    key, steps, stop_id = jax.random.PRNGKey(7), 12, 10
    want = np.asarray(jclipcap._sample_tokens(jparams, jnp.asarray(prefix), key, jcfg, steps,
                                              stop_id, top_p, temperature))
    noise = torch.from_numpy(_jax_noise(key, steps, 4, LM_GEOM["vocab_size"]))
    got = clipcap.sample_tokens(pparams, torch.from_numpy(prefix), noise, pcfg, stop_id,
                                top_p, temperature).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[2] == stop_id).all() and len(np.unique(got[[0, 1, 3]])) > 20


def test_gumbel_noise_has_the_gumbel_law():
    g = clipcap.gumbel_noise((200_000,), torch.Generator().manual_seed(0), "cpu")
    assert g.dtype == torch.float32 and torch.isfinite(g).all()
    assert abs(g.mean().item() - 0.5772) < 0.01 and abs(g.var().item() - np.pi ** 2 / 6) < 0.03


# ------------------------------------------------------------- mappers


def _clipcap_state_dict(kind, seed=40, width=128):
    """A ClipCap checkpoint: clip_project.* (the MLP's model.{0,2} or the
    transformer mapper) and gpt.*, numpy-seeded."""
    sd = {k: v for k, v in _viecap_state_dict(seed, clip_hidden=width).items()
          if k.startswith("gpt.")}
    if kind == "transformer":
        sd.update({"clip_project." + k[len("mapping_network."):]: v
                   for k, v in _viecap_state_dict(seed + 1, clip_hidden=width).items()
                   if k.startswith("mapping_network.")})
    else:
        rng = np.random.default_rng(seed + 2)
        hidden = D * 3 // 2
        for i, (fo, fi) in ((0, (hidden, width)), (2, (3 * D, hidden))):
            sd[f"clip_project.model.{i}.weight"] = torch.from_numpy(
                (rng.standard_normal((fo, fi)) * fi ** -0.5).astype(np.float32))
            sd[f"clip_project.model.{i}.bias"] = torch.from_numpy(
                (rng.standard_normal(fo) * 0.1).astype(np.float32))
    return sd


def _configs(**kw):
    return jclipcap.ClipCapConfig(**kw), clipcap.ClipCapConfig(**kw)


# the transformer mapper of `_viecap_state_dict`: 2 projected and 3 prefix
# tokens, 8 layers
MAPPERS = {"mlp": dict(prefix_length=3, mapping_type="mlp"),
           "transformer": dict(prefix_length=3, clip_length=2, mapping_type="transformer")}


@pytest.mark.parametrize("kind", MAPPERS)
def test_mappers_and_port_clipcap_equal_jax(kind, lm):
    jcfg, pcfg = _configs(**MAPPERS[kind])
    sd = _clipcap_state_dict(kind)
    want = jclipcap.port_clipcap(sd, jcfg, LM_GEOM["n_layer"])
    got = clipcap.port_clipcap(sd, pcfg, LM_GEOM["n_layer"])
    _assert_trees_equal(got, want)
    x = np.random.default_rng(3).standard_normal((3, 128)).astype(np.float32)
    jm = jclipcap.ClipCap(jcfg, lm[0], want["gpt2"], want["mapper"], None, prefix_size=128)
    pm = clipcap.ClipCap(pcfg, lm[2], got["gpt2"], got["mapper"], None, 128, "cpu")
    ref = np.asarray(jm._project(jnp.asarray(x)))
    out = pm.project(x).numpy()
    assert out.shape == ref.shape == (3, 3, D)
    assert np.max(np.abs(out - ref)) <= 1e-5 * max(1.0, np.max(np.abs(ref)))
    if kind == "mlp":  # and the init: shapes and U(+-1/sqrt(fan_in)) bounds
        init = clipcap.init_mlp_mapper(128, 3, D, torch.Generator().manual_seed(0), "cpu")
        jax.tree_util.tree_map(lambda g, w: np.testing.assert_equal(g.shape, w.shape), init,
                               jclipcap.init_mlp_mapper(jax.random.PRNGKey(0), 128, 3, D))
        assert init["fc1"]["b"].abs().max() <= 128 ** -0.5
        assert init["fc2"]["w"].abs().max() <= (3 * D // 2) ** -0.5


def _models(lm, **kw):
    jcfg_lm, jparams, pcfg_lm, pparams = lm
    jcfg, pcfg = _configs(**dict(dict(prefix_length=3, entry_length=10), **kw))
    mapper = jclipcap.init_mlp_mapper(jax.random.PRNGKey(4), 16, 3, D)
    jtok, ptok = _tokenizers()
    return (jclipcap.ClipCap(jcfg, jcfg_lm, jparams, mapper, jtok, prefix_size=16),
            clipcap.ClipCap(pcfg, pcfg_lm, pparams, _tree(mapper), ptok, 16, "cpu"))


def test_forward_at_top_p_zero_equals_generate_batched(lm):
    ref, port = _models(lm, top_p=0.0)
    feats = np.random.default_rng(5).standard_normal((3, 16)).astype(np.float32) * 3
    got = port.forward(feats)
    prefix = port.project(feats)
    assert got == port.forward(feats)  # the noise moves on, the argmax does not
    assert got == clipcap.generate_batched(port.gpt2_params, prefix, port.gpt2_cfg,
                                           port.tokenizer, port.noise(3), top_p=0.0)
    assert got == jclipcap.generate_batched(ref.gpt2_params, jnp.asarray(prefix.numpy()),
                                            ref.gpt2_cfg, ref.tokenizer, entry_length=10,
                                            top_p=0.0)
    assert got == ref.forward(feats) and all(c.endswith(".") for c in got)


def test_forward_samples_and_advances_its_generator(lm):
    _, port = _models(lm, top_p=0.99, temperature=2.0)
    feats = np.random.default_rng(6).standard_normal((4, 16)).astype(np.float32)
    first, second = port.forward(feats), port.forward(feats)
    assert first != second  # a new draw each call
    assert port.to("cpu").forward(feats) == first  # a copy starts from the seed


def test_scores_are_inverse_perplexity_with_the_fallback(lm):
    ref, port = _models(lm)
    for tok in (ref.tokenizer, port.tokenizer):
        tok.encode("dog cat car tree")
    sents = ["dog cat car tree", "cat"]
    got, want = port.compute_perplexity_scores(sents), ref.compute_perplexity_scores(sents)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    ppl = viecap.sentence_perplexity(port.gpt2_params, port.gpt2_cfg,
                                     port.tokenizer.encode(sents[0]))
    assert got[0] == pytest.approx(1 / ppl) and got[1] == want[1] == 1.0  # one token: NaN

    class Refusing:
        def encode(self, text):
            raise ValueError(text)

    port.tokenizer = Refusing()
    assert port.compute_perplexity_scores(["anything"]) == [1.0]


@pytest.mark.parametrize("dino_model,width", [
    ("dinov2_vits14", 384), ("dinov2_vits14_reg", 384), ("dinov2_vitb14_reg", 768),
    ("dinov2_vitl14", 1024), ("dinov2_vitg14_reg", 1536), ("dinotxt_vitl14", 512)])
def test_the_mapper_takes_the_backbone_width(dino_model, width):
    assert clipcap.feature_width(dino_model, 512) == width


# ------------------------------------------------------------ from_config


@pytest.fixture
def tiny_base(monkeypatch):
    monkeypatch.setattr(jgpt2, "GPT2_BASE_CONFIG", jgpt2.GPT2Config(**LM_GEOM))
    monkeypatch.setattr(gpt2, "GPT2_BASE_CONFIG", gpt2.GPT2Config(**LM_GEOM))


@pytest.fixture(scope="module")
def clipcap_pt(tmp_path_factory):
    path = tmp_path_factory.mktemp("clipcap") / "clipcap.pt"
    torch.save(_clipcap_state_dict("mlp", width=384), path)
    return str(path)


def _config(pt, bank):
    """ViT-S/14-reg (the mapper takes its 384) at 140 px, 1 layer, and an
    MLP ClipCap at top_p 0."""
    return {"dino_model": "dinov2_vits14_reg", "crop_dim": 140, "prefix_size": 384,
            "normalize": True, "support_memory_size": 16 if bank else 0,
            "dino_geometry": {"depth": 1, "pos_grid": 10},
            "decap_arch": {"n_layer": 1, "n_head": 2, "n_embd": 64, "vocab_size": 1000},
            "clipcap": {"weight_path": pt, "prefix_length": 3, "top_p": 0.0,
                        "entry_length": 8}}


TRACES = [[(0.1, 0.2), (0.5, 0.5), (0.9, 0.3)], [(0.3, 0.7)]]
BOXES = np.asarray([[[0, 0, 70, 70], [28, 28, 100, 90]],
                    [[14, 14, 112, 112], [0, 0, 1, 1]]], np.float32)


@pytest.mark.parametrize("bank", [False, True])
def test_loaded_clipcap_captions_equal_jax(clipcap_pt, tiny_base, bank):
    config = _config(clipcap_pt, bank)
    jtok, ptok = _tokenizers()
    jm = JaxPatchioner.from_config(config, allow_missing_weights=True, dtype=jnp.float32,
                                   gpt2_tokenizer=jtok)
    pm = Patchioner.from_config(config, allow_missing_weights=True, random_bank_size=16,
                                device="cpu", gpt2_tokenizer=ptok)
    assert (pm.bank is not None) == bank and not pm.supports_fused_trace_path()
    assert pm.clipcap.prefix_size == jm.clipcap.prefix_size == 384
    np.testing.assert_array_equal(pm.clipcap.mapper_params["fc1"]["w"].numpy(),
                                  np.asarray(jm.clipcap.mapper_params["fc1"]["w"]))
    pm.vit_params = bridge.vit_from_jax(jm.vit_params, pm.vit_cfg)
    imgs = np.random.default_rng(8).integers(0, 256, (2, 140, 140, 3), dtype=np.uint8)
    flags = dict(get_cls_capt=True, traces=TRACES, bboxes=BOXES, compute_scores=True)
    got, want = pm.forward(imgs, **flags), jm.forward(imgs, **flags)
    assert sorted(got) == sorted(want) == ["bbox_capts", "bbox_scores", "cls_capt",
                                           "cls_capt_scores", "trace_capts"]
    for key in want:
        if key.endswith("scores"):
            np.testing.assert_allclose(np.asarray(got[key], float),
                                       np.asarray(want[key], float), rtol=1e-4)
        else:
            assert got[key] == want[key], key
    assert len(set(got["cls_capt"] + got["trace_capts"])) > 1


def test_clipcap_weights_missing_disagreeing_or_a_directory(clipcap_pt, tiny_base, tmp_path):
    block = _config(str(tmp_path / "nope.pt"), False)["clipcap"]
    with pytest.raises(FileNotFoundError, match="nope.pt"):
        patchioner._build_clipcap(block, "dinov2_vits14_reg", 384, torch.Generator(), False,
                                  WordTokenizer(), torch.device("cpu"), patchioner._Clock())
    # a directory of the JAX package's mapper training (Orbax) is refused
    from patchioner_tpu.io.checkpoints import CheckpointManager

    CheckpointManager(str(tmp_path)).save(1, {"params": {"w": jnp.ones(3)}, "step": 1})
    with pytest.raises(NotImplementedError, match="Orbax"):
        Patchioner.from_config(_config(str(tmp_path), False), allow_missing_weights=True,
                               device="cpu", gpt2_tokenizer=WordTokenizer())
    torch.save(_clipcap_state_dict("mlp", width=128), tmp_path / "narrow.pt")
    with pytest.raises(ValueError, match="clipcap.weight_path"):
        Patchioner.from_config(_config(str(tmp_path / "narrow.pt"), False),
                               allow_missing_weights=True, device="cpu",
                               gpt2_tokenizer=WordTokenizer())
    # the transformer mapper from random weights, and a to() that keeps it
    cfg = _config(None, False)
    cfg["clipcap"] = {"mapping_type": "transformer", "prefix_length": 3, "clip_length": 2,
                      "num_layers": 1}
    m = Patchioner.from_config(cfg, allow_missing_weights=True, device="cpu",
                               gpt2_tokenizer=WordTokenizer())
    assert m.clipcap.mapper_params["linear"]["w"].shape == (384, 2 * D)
    moved = m.to("cpu")
    assert isinstance(moved.clipcap, clipcap.ClipCap) and moved.clipcap is not m.clipcap
    assert len(moved.clipcap.mapper_params["layers"]) == 1
