"""The port's ViECap (`patchioner_tpu_torch.models.viecap`) against the JAX
package's, on the CPU in f32, on the same weights (JAX inits or numpy
seeded state dicts, carried over through `io.bridge`) and inputs made from
numpy seeds, at the JAX tests' sizes (GPT-2 of 2 layers, 32 wide,
vocabulary 263):

- the mapping network within 1e-5 * max(1, max|ref|), and
  `port_mapping_network` leaf for leaf on one state dict;
- entity retrieval at, just above and just below its threshold, with ties;
- greedy, beam (per image and batched), contrastive search and the
  perplexity: tokens equal, and strings equal through the JAX tests'
  `WordTokenizer` and through a synthetic byte-level BPE vocabulary;
  perplexities within 1e-5 relative;
- a constructed tie case (every logit tied with another, or all zero),
  where `torch.topk` promises no order: the port must pick as JAX does;
- the goldens `tests/goldens/viecap_search_modes.json` and
  `viecap_end_to_end.json`, reproduced on bridged weights;
- `VieCap.forward` end to end in each prompt layout and search.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchioner_tpu.models import gpt2 as jgpt2
from patchioner_tpu.models import viecap as jviecap
from patchioner_tpu_torch.io import bridge
from patchioner_tpu_torch.models import gpt2, viecap
from test_viecap import DualEOSTokenizer, WordTokenizer

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
GEOM = dict(vocab_size=263, n_positions=128, n_embd=32, n_layer=2, n_head=2)


def _tree(tree):
    """A JAX tree as tensors, None leaves (bias-free linears) kept."""
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v) for v in tree]
    return None if tree is None else torch.from_numpy(np.array(tree))


def _word_tokenizer():
    tok = WordTokenizer()
    for w in [".", "dog", "cat", "car", "a", "the", "in", "on"]:
        tok.encode(w)
    return tok


@pytest.fixture(scope="module")
def bpe_tokenizer(tmp_path_factory):
    """Both packages' GPT-2 BPE over one synthetic 263-token vocabulary (256
    bytes, <|endoftext|> and 6 merges), so every id a 263-row GPT-2 emits
    decodes."""
    from tokenizers import ByteLevelBPETokenizer

    from patchioner_tpu.text import gpt2_bpe as jbpe
    from patchioner_tpu_torch.text import gpt2_bpe

    tok = ByteLevelBPETokenizer()
    tok.train_from_iterator(["there are dog, cat in image."] * 20, vocab_size=263,
                            min_frequency=1, special_tokens=["<|endoftext|>"])
    d = str(tmp_path_factory.mktemp("bpe263"))
    tok.save_model(d)
    files = (os.path.join(d, "vocab.json"), os.path.join(d, "merges.txt"))
    port, ref = gpt2_bpe.Gpt2Tokenizer.from_files(*files), jbpe.Gpt2Tokenizer.from_files(*files)
    assert port.vocab_size == 263
    return port, ref


@pytest.fixture(scope="module")
def lm():
    """A JAX GPT-2 (the goldens' init) and the same weights in the port."""
    cfg = jgpt2.GPT2Config(**GEOM)
    params = jgpt2.init_gpt2(jax.random.PRNGKey(11), cfg)
    return cfg, params, gpt2.GPT2Config(**GEOM), bridge.to_torch(params)


@pytest.fixture(scope="module")
def sharp_lm():
    """Another GPT-2 with wte scaled by 20, so that its logits are far
    apart and the searches take many different tokens, and 512 positions:
    a byte-level caption of random bytes re-encodes (for its perplexity)
    with U+FFFD for every broken byte, three tokens each."""
    geom = dict(GEOM, n_positions=512)
    cfg = jgpt2.GPT2Config(**geom)
    params = jgpt2.init_gpt2(jax.random.PRNGKey(12), cfg)
    params = dict(params, wte=params["wte"] * 20)
    return cfg, params, gpt2.GPT2Config(**geom), bridge.to_torch(params)


def _embeds(seed, b=3, t=5):
    return np.random.default_rng(seed).standard_normal((b, t, 32)).astype(np.float32)


# ------------------------------------------------------- mapping network


VCFGS = {
    "tiny": dict(continuous_prompt_length=3, clip_project_length=2, clip_hidden_size=16,
                 num_layers=2, num_heads=2),
    "wide heads": dict(continuous_prompt_length=4, clip_project_length=5, clip_hidden_size=24,
                       num_layers=1, num_heads=4, mlp_ratio=3.0),
}


def _cfgs(**kw):
    return jviecap.ViecapConfig(**kw), viecap.ViecapConfig(**kw)


@pytest.mark.parametrize("name", VCFGS)
def test_mapping_network_equals_jax(name):
    jcfg, pcfg = _cfgs(**VCFGS[name])
    params = jviecap.init_mapping_network(jax.random.PRNGKey(3), jcfg, 32)
    # layer norms away from the identity, so that they are exercised
    rng = np.random.default_rng(4)
    for layer in params["layers"]:
        for key in ("norm1", "norm2"):
            layer[key] = {"scale": jnp.asarray(1 + 0.2 * rng.standard_normal(32), jnp.float32),
                          "bias": jnp.asarray(0.1 * rng.standard_normal(32), jnp.float32)}
    x = rng.standard_normal((3, jcfg.clip_hidden_size)).astype(np.float32)
    want = np.asarray(jviecap.mapping_network_forward(params, jnp.asarray(x), jcfg, 32))
    got = viecap.mapping_network_forward(_tree(params), torch.from_numpy(x), pcfg, 32).numpy()
    assert got.shape == want.shape == (3, jcfg.continuous_prompt_length, 32)
    assert np.max(np.abs(got - want)) <= 1e-5 * max(1.0, np.max(np.abs(want)))


def _mapping_state_dict(seed, cfg, d=32):
    """A torch MappingNetwork state dict (ClipCap.py:122-155), numpy-seeded."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    p = "mapping_network."
    sd = {f"{p}linear.weight": t(cfg.clip_project_length * d, cfg.clip_hidden_size),
          f"{p}linear.bias": t(cfg.clip_project_length * d),
          f"{p}prefix_const": t(cfg.continuous_prompt_length, d)}
    hidden = int(d * cfg.mlp_ratio)
    for i in range(cfg.num_layers):
        q = f"{p}transformer.layers.{i}"
        for norm in ("norm1", "norm2"):
            sd[f"{q}.{norm}.weight"], sd[f"{q}.{norm}.bias"] = t(d), t(d)
        sd[f"{q}.attn.to_queries.weight"] = t(d, d)
        sd[f"{q}.attn.to_keys_values.weight"] = t(2 * d, d)
        sd[f"{q}.attn.project.weight"], sd[f"{q}.attn.project.bias"] = t(d, d), t(d)
        sd[f"{q}.mlp.fc1.weight"], sd[f"{q}.mlp.fc1.bias"] = t(hidden, d), t(hidden)
        sd[f"{q}.mlp.fc2.weight"], sd[f"{q}.mlp.fc2.bias"] = t(d, hidden), t(d)
    return sd


def _assert_trees_equal(got, want, at="tree"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), at
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{at}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), at
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{at}[{i}]")
    elif want is None:
        assert got is None, at
    else:
        assert got.dtype == torch.float32 and got.is_contiguous(), at
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=at)


@pytest.mark.parametrize("name", VCFGS)
def test_port_mapping_network_equals_jax_leaf_for_leaf(name):
    jcfg, pcfg = _cfgs(**VCFGS[name])
    sd = _mapping_state_dict(5, jcfg)
    want = jviecap.port_mapping_network(sd, num_layers=jcfg.num_layers)
    got = viecap.port_mapping_network(sd, num_layers=pcfg.num_layers)
    _assert_trees_equal(got, want)
    x = np.random.default_rng(6).standard_normal((2, jcfg.clip_hidden_size)).astype(np.float32)
    ref = np.asarray(jviecap.mapping_network_forward(
        jax.tree_util.tree_map(jnp.asarray, want), jnp.asarray(x), jcfg, 32))
    out = viecap.mapping_network_forward(got, torch.from_numpy(x), pcfg, 32).numpy()
    assert np.max(np.abs(out - ref)) <= 1e-5 * max(1.0, np.max(np.abs(ref)))


def test_init_mapping_network_has_the_template_and_jax_shapes():
    jcfg, pcfg = _cfgs(**VCFGS["wide heads"])
    got = viecap.init_mapping_network(pcfg, 32, torch.Generator().manual_seed(0))
    want = jviecap.init_mapping_network(jax.random.PRNGKey(0), jcfg, 32)
    template = viecap.mapping_template(pcfg, 32)
    for tree in (want, template):
        jax.tree_util.tree_map(
            lambda g, w: None if w is None else np.testing.assert_equal(
                tuple(g.shape), tuple(w.shape)),
            got, tree, is_leaf=lambda x: x is None)
    bound = 1 / np.sqrt(pcfg.clip_hidden_size)
    assert got["linear"]["w"].abs().max() <= bound and got["layers"][0]["to_queries"]["b"] is None


# -------------------------------------------------------- entity retrieval


def test_retrieval_at_and_around_its_threshold():
    # f's first row is as similar to each of the four (orthonormal)
    # entities, so their softmax probabilities are exactly 1/4 in both
    # packages, and the retrieval ties them: lowest index first
    t = np.eye(4, 8, dtype=np.float32)
    f = np.zeros((2, 8), np.float32)
    f[0, :4] = 1.0
    f[1, [1, 3]] = 1.0, 3.0
    ents = ["e0", "e1", "e2", "e3"]
    for thr in (np.nextafter(np.float32(0.25), 0), 0.25,
                np.nextafter(np.float32(0.25), 1), 0.2, 0.3, 0.0):
        kw = dict(top_k=3, threshold=float(thr), temperature=0.5)
        got = viecap.retrieve_entities(torch.from_numpy(f), torch.from_numpy(t), ents, **kw)
        want = jviecap.retrieve_entities(jnp.asarray(f), jnp.asarray(t), ents, **kw)
        assert got == want, thr
    at = viecap.retrieve_entities(torch.from_numpy(f), torch.from_numpy(t), ents, top_k=3,
                                  threshold=0.25, temperature=0.5)
    assert at[0] == ["e0", "e1", "e2"]


@pytest.mark.parametrize("seed", [0, 1])
def test_retrieval_equals_jax_on_random_vocabularies(seed):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((5, 16)).astype(np.float32)
    t = rng.standard_normal((40, 16)).astype(np.float32)
    ents = [f"entity{i}" for i in range(40)]
    kw = dict(top_k=3, temperature=0.1)
    probs = np.asarray(jax.nn.softmax(
        (f / np.linalg.norm(f, axis=-1, keepdims=True))
        @ (t / np.linalg.norm(t, axis=-1, keepdims=True)).T / 0.1, axis=-1))
    # thresholds just around retrieved probabilities, and the config's
    for thr in sorted(np.sort(probs, axis=-1)[:, -3:].ravel())[::3]:
        for x in (thr * (1 - 1e-3), thr * (1 + 1e-3)):
            got = viecap.retrieve_entities(torch.from_numpy(f), torch.from_numpy(t), ents,
                                           threshold=float(x), **kw)
            assert got == jviecap.retrieve_entities(jnp.asarray(f), jnp.asarray(t), ents,
                                                    threshold=float(x), **kw)
    assert viecap.compose_discrete_prompt([]) == jviecap.compose_discrete_prompt([])
    assert (viecap.compose_discrete_prompt(["dog", "cat"])
            == jviecap.compose_discrete_prompt(["dog", "cat"]) == "There are dog, cat in image.")


ENTITY_FILES = {"coco_entities": "coco_categories.json",
                "vinvl_vgoi_entities": "vgcocooiobjects_v1_class2ind.json",
                "open_image_entities": "oidv7-class-descriptions-boxable.csv",
                "vinvl_vg_entities": "VG-SGG-dicts-vgoi6-clipped.json"}


@pytest.mark.parametrize("name", ENTITY_FILES)
def test_vendored_vocabularies_load_as_in_jax(name):
    got = viecap.load_entities_text(name, os.path.join(viecap.VOCAB_DIR, ENTITY_FILES[name]))
    want = jviecap.load_entities_text(name, os.path.join(jviecap.VOCAB_DIR, ENTITY_FILES[name]))
    assert got == want and len(got) > 50
    single = viecap.load_entities_text(name, os.path.join(viecap.VOCAB_DIR, ENTITY_FILES[name]),
                                       all_entities=False)
    assert single == jviecap.load_entities_text(
        name, os.path.join(jviecap.VOCAB_DIR, ENTITY_FILES[name]), all_entities=False)


def test_the_vendored_t2d_embeddings_are_the_jax_package_files():
    name = "coco_embeddings_ViT-B16_t2d__with_ensemble.pickle"
    with open(os.path.join(viecap.VOCAB_DIR, name), "rb") as f:
        got = pickle.load(f)
    with open(os.path.join(jviecap.VOCAB_DIR, name), "rb") as f:
        want = pickle.load(f)
    assert tuple(got.shape) == (80, 768)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_visual_genome_vocabulary_and_a_missing_file(tmp_path):
    path = tmp_path / "vg.pickle"
    with open(path, "wb") as f:
        pickle.dump({"objects": {"joint": {"Zebra ", "apple", "tall tree"}}}, f)
    got = viecap.load_entities_text("visual_genome_entities", str(path))
    assert got == jviecap.load_entities_text("visual_genome_entities", str(path))
    with pytest.raises(FileNotFoundError, match="nope.json"):
        viecap.load_entities_text("coco_entities", str(tmp_path / "nope.json"))


def test_build_entity_embeddings_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    table = {}

    def encode_fn(texts):
        return np.stack([table.setdefault(t, rng.standard_normal(16).astype(np.float32))
                         for t in texts])

    w = rng.standard_normal((16, 8)).astype(np.float32)
    ents = ["dog", "cat", "pizza slice", "traffic light", "zebra"]
    for project in (None, lambda e: np.asarray(e) @ w):
        out = tmp_path / "emb.pickle"
        got = viecap.build_entity_embeddings(ents, encode_fn, project_fn=project,
                                             batch_entities=2, out_path=str(out))
        want = jviecap.build_entity_embeddings(ents, encode_fn, project_fn=project,
                                               batch_entities=3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        with open(out, "rb") as f:
            np.testing.assert_array_equal(pickle.load(f), got)


# ---------------------------------------------------------------- search


@pytest.mark.parametrize("which", ["lm", "sharp_lm"])
@pytest.mark.parametrize("seed", [0, 1])
def test_search_tokens_equal_jax(which, seed, request):
    jcfg, jparams, pcfg, pparams = request.getfixturevalue(which)
    e = _embeds(seed)
    je, pe = jnp.asarray(e), torch.from_numpy(e)
    np.testing.assert_array_equal(
        viecap.greedy_tokens(pparams, pe, pcfg, 10).numpy(),
        np.asarray(jviecap._greedy_tokens(jparams, je, jcfg, 10)))
    eos = (13, 27)
    got = viecap.beam_tokens(pparams, pe, torch.tensor(eos), pcfg, 8, 4)
    want = jviecap._beam_tokens_batched(jparams, je, jnp.asarray(eos), jcfg, 8, 4)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5)
    np.testing.assert_array_equal(
        viecap.contrastive_tokens(pparams, pe, pcfg, 10, 8, 0.3).numpy(),
        np.asarray(jviecap._contrastive_tokens(jparams, je, jcfg, 10, 8, 0.3)))


@pytest.mark.parametrize("tokenizer", ["words", "dual eos", "bpe"])
def test_search_strings_equal_jax(sharp_lm, bpe_tokenizer, tokenizer):
    jcfg, jparams, pcfg, pparams = sharp_lm
    if tokenizer == "bpe":
        ptok, jtok = bpe_tokenizer
    elif tokenizer == "dual eos":
        ptok, jtok = DualEOSTokenizer(40), DualEOSTokenizer(40)
        for tok in (ptok, jtok):
            for w in [".", "dog"]:
                tok.encode(w)
    else:
        ptok, jtok = _word_tokenizer(), _word_tokenizer()
    e = _embeds(7)
    je, pe = jnp.asarray(e), torch.from_numpy(e)
    assert (viecap.greedy_search(pparams, pe, pcfg, ptok, max_len=12)
            == jviecap.greedy_search(jparams, je, jcfg, jtok, max_len=12))
    for i in range(2):
        assert (viecap.beam_search(pparams, pe[i:i + 1], pcfg, ptok, beam_width=3, max_len=8)
                == jviecap.beam_search(jparams, je[i:i + 1], jcfg, jtok, beam_width=3,
                                       max_len=8))
    batched = viecap.beam_search_batched(pparams, pe, pcfg, ptok, beam_width=3, max_len=8)
    assert batched == jviecap.beam_search_batched(jparams, je, jcfg, jtok, beam_width=3,
                                                  max_len=8)
    assert batched == [viecap.beam_search(pparams, pe[i:i + 1], pcfg, ptok, beam_width=3,
                                          max_len=8)[0] for i in range(len(e))]
    assert (viecap.contrastive_search(pparams, pe, pcfg, ptok, alpha=0.3, top_k=8, max_len=12)
            == jviecap.contrastive_search(jparams, je, jcfg, jtok, alpha=0.3, top_k=8,
                                          max_len=12))


@pytest.mark.parametrize("ties", ["zero logits", "paired wte rows"])
def test_ties_pick_as_jax_does(lm, ties):
    """Every logit tied: `torch.topk` would pick any of the tied tokens;
    the port must take the lower index first, as `jax.lax.top_k` does."""
    jcfg, jparams, pcfg, _ = lm
    wte = np.asarray(jparams["wte"])
    if ties == "zero logits":
        wte = np.zeros_like(wte)
    else:  # rows 2i and 2i + 1 equal: each logit has a twin
        wte = np.repeat(wte[::2] * 10, 2, axis=0)[: wte.shape[0]]
    jparams = dict(jparams, wte=jnp.asarray(wte))
    pparams = dict(bridge.to_torch(jparams))
    e = _embeds(9, b=2)
    je, pe = jnp.asarray(e), torch.from_numpy(e)
    eos = (13, 27)
    got = viecap.beam_tokens(pparams, pe, torch.tensor(eos), pcfg, 6, 5)
    want = jviecap._beam_tokens_batched(jparams, je, jnp.asarray(eos), jcfg, 6, 5)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(
        viecap.contrastive_tokens(pparams, pe, pcfg, 6, 8, 0.3).numpy(),
        np.asarray(jviecap._contrastive_tokens(jparams, je, jcfg, 6, 8, 0.3)))
    np.testing.assert_array_equal(viecap.greedy_tokens(pparams, pe, pcfg, 6).numpy(),
                                  np.asarray(jviecap._greedy_tokens(jparams, je, jcfg, 6)))
    if ties == "zero logits":  # every beam copies beam 0 and takes tokens 0..W-1 last
        assert got[0][0, :, -1].tolist() == [0, 1, 2, 3, 4]


def test_perplexity_equals_jax(sharp_lm, bpe_tokenizer):
    jcfg, jparams, pcfg, pparams = sharp_lm
    ptok, _ = bpe_tokenizer
    for text in ["there are dog, cat in image.", "a dog.", "an image of a cat, a dog and a car"]:
        ids = ptok.encode(text)
        got = viecap.sentence_perplexity(pparams, pcfg, ids)
        want = jviecap.sentence_perplexity(jparams, jcfg, ids)
        assert got == pytest.approx(want, rel=1e-5)
    for ids in ([], [5]):
        assert np.isnan(viecap.sentence_perplexity(pparams, pcfg, ids))


# --------------------------------------------------------------- goldens


def test_golden_search_modes_reproduced(lm):
    _, _, pcfg, pparams = lm
    e = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 4, 32)).astype(np.float32))
    got = {"greedy": viecap.greedy_search(pparams, e, pcfg, _word_tokenizer(), max_len=8),
           "beam": viecap.beam_search(pparams, e[:1], pcfg, _word_tokenizer(), beam_width=3,
                                      max_len=8),
           "contrastive": viecap.contrastive_search(pparams, e, pcfg, _word_tokenizer(),
                                                    alpha=0.3, top_k=8, max_len=8)}
    with open(os.path.join(GOLDENS, "viecap_search_modes.json")) as f:
        assert got == json.load(f)


def test_golden_end_to_end_reproduced(lm):
    _, _, pcfg, pparams = lm
    jcfg, cfg = _cfgs(continuous_prompt_length=3, clip_project_length=2, clip_hidden_size=16,
                      num_layers=1, num_heads=2, using_hard_prompt=True,
                      using_greedy_search=True, top_k=2, threshold=0.0, max_len=6)
    mapping = _tree(jviecap.init_mapping_network(jax.random.PRNGKey(5), jcfg, 32))
    rng = np.random.default_rng(4)
    model = viecap.VieCap(cfg, pcfg, pparams, mapping, ["dog", "cat", "car"],
                          rng.standard_normal((3, 16)).astype(np.float32), _word_tokenizer(),
                          "cpu")
    sents, ppl = model.forward(rng.standard_normal((2, 16)).astype(np.float32),
                               compute_scores=True)
    with open(os.path.join(GOLDENS, "viecap_end_to_end.json")) as f:
        assert {"sentences": sents, "ppl": [round(float(p), 5) for p in ppl]} == json.load(f)


# ------------------------------------------------------------- the model


LAYOUTS = {
    "hard first, greedy": dict(using_hard_prompt=True, using_greedy_search=True),
    "soft first, greedy": dict(using_hard_prompt=True, soft_prompt_first=True,
                               using_greedy_search=True),
    "only hard, beam": dict(using_hard_prompt=True, only_hard_prompt=True, beam_width=3),
    "soft only, beam": dict(beam_width=2),
    "soft first, beam": dict(using_hard_prompt=True, soft_prompt_first=True, beam_width=3),
}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_viecap_forward_equals_jax(sharp_lm, bpe_tokenizer, layout):
    jcfg_lm, jparams, pcfg, pparams = sharp_lm
    kw = dict(continuous_prompt_length=3, clip_project_length=2, clip_hidden_size=16,
              num_layers=2, num_heads=2, top_k=3, threshold=0.1, temperature=0.2, max_len=10,
              **LAYOUTS[layout])
    jcfg, cfg = _cfgs(**kw)
    jmap = jviecap.init_mapping_network(jax.random.PRNGKey(8), jcfg, 32)
    rng = np.random.default_rng(10)
    ents = ["dog", "cat", "car", "tree", "person", "boat"]
    emb = rng.standard_normal((6, 16)).astype(np.float32)
    feats = rng.standard_normal((3, 16)).astype(np.float32) * 3
    ptok, jtok = bpe_tokenizer
    ref = jviecap.VieCap(jcfg, jcfg_lm, jparams, jmap, ents, emb, jtok)
    port = viecap.VieCap(cfg, pcfg, pparams, _tree(jmap), ents, emb, ptok, "cpu")
    if cfg.using_hard_prompt:
        f = torch.from_numpy(feats)
        assert (port._hard_prompt_token_rows(f / f.norm(dim=-1, keepdim=True))
                == ref._hard_prompt_token_rows(jnp.asarray(
                    feats / np.linalg.norm(feats, axis=-1, keepdims=True))))
    sents, ppl = port.forward(feats, compute_scores=True)
    want, want_ppl = ref.forward(feats, compute_scores=True)
    assert sents == want
    np.testing.assert_allclose(ppl, want_ppl, rtol=1e-5)
