"""The port's MeaCap (`patchioner_tpu_torch.models.meacap`,
`meacap_concepts`) against the JAX package's, on the CPU in f32.

- the concept merge equals `patchioner_tpu.models.meacap_concepts` stage
  by stage on the stubbed scene graphs and sentence embeddings of
  `tests/test_meacap_concepts.py`: its quirk cases and its 8 fuzz seeds
  (that file's oracle, the reference's parse_tool.py, is not in the
  repository; the JAX module is the oracle here);
- memory retrieval: ties on duplicated memory rows give the lower index
  first, and the indices equal JAX's on random memories;
- `build_memory` / `load_memory`: each package reads the other's files;
- `hf_concept_extractor` with stub `transformers` and
  `sentence_transformers` modules in `sys.modules`, and the ImportError
  without them;
- `MeaCap.forward` gives the JAX hard prompts and sentences, greedy and
  beam, on a 2-layer, 32-wide GPT-2 over 263 tokens (wte scaled by 20);
- `Patchioner.to` and `VieCap.to` keep a MeaCap; `configs/mlp.meacap.k.yaml`
  builds; a loaded MeaCap model's `forward` captions equal the JAX one's.
"""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import patchioner_tpu.models.gpt2 as jgpt2
from patchioner_tpu.models import meacap as jmeacap
from patchioner_tpu.models import meacap_concepts as jmc
from patchioner_tpu.models import viecap as jviecap
from patchioner_tpu.models.patchioner import Patchioner as JaxPatchioner
from patchioner_tpu_torch.io import bridge
from patchioner_tpu_torch.models import gpt2, meacap, meacap_concepts as mc, patchioner, viecap
from patchioner_tpu_torch.models.patchioner import Patchioner
from test_meacap_concepts import _CAPTIONS, _GRAPHS, _GROUPS, _StubWTE, _random_case
from test_torch_forward import LM_GEOM, _viecap_config, _viecap_state_dict
from test_torch_viecap import WordTokenizer, _tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ the concepts


def _stages(module, graphs, captions, model):
    """Every stage's output of one package's merge, on fresh graphs (the
    merge folds nodes in place)."""
    td, ad = {}, {}
    ents, counts, graph = module.build_graph_dict(graphs, td, ad)
    out = {"entities": ents, "counts": list(counts.items()), "graph": graph,
           "type_dict": td, "attribute_dict": ad}
    if ents:
        surv, sub, kept, rep = module.merge_graph_entities(model.encode(ents), ents, counts,
                                                           graph)
        out.update(survivors=list(surv.items()), subgraph=sub, kept=kept, representative=rep)
        ordered, concepts = module.order_and_attach(sub, rep, captions)
        out.update(ordered=list(ordered.items()), ordered_concepts=concepts)
    out["concepts"] = module.concepts_from_graphs(graphs, model.encode, captions)
    return out


QUIRKS = {
    # every segment arity, a 1-field segment among others (dropped), digits
    # spelled out, merges through the representative map, attributes attached
    "the stub graphs": (_GRAPHS, _CAPTIONS, _GROUPS),
    # every entity once: no survivor, no concept
    "no survivor": (["( cat , sit , mat )", "( dog , run )"], ["a cat", "a dog"],
                    [{"cat": 0.0}, {"dog": 0.0}, {"mat": 0.0}]),
    # position 0 counts as absent; the attribute of count 3 attached
    "start of the caption": (["( zebra , run )"] * 3,
                             ["zebra runs fast", "zebra at dawn", "the zebra"],
                             [{"zebra": 0.0}]),
    # one graph of one bare object, and the >3-field relation's fact key
    "bare object, long relation": (["( kite )", "( kid , sits , next to , kite ) , ( kite , is , 2 )",
                                    "( kite , red )", "( kid , hold , kite )"],
                                   ["a red kite", "the kid and a kite", "kite", "kid kite"],
                                   [{"kid": 0.0}, {"kite": 0.0}]),
}


@pytest.mark.parametrize("case", QUIRKS)
def test_concept_stages_equal_jax_on_the_quirk_cases(case):
    graphs, captions, groups = QUIRKS[case]
    model = _StubWTE(groups)
    got = _stages(mc, graphs, captions, model)
    assert got == _stages(jmc, graphs, captions, model)
    if case == "the stub graphs":
        assert "lit candle" in got["concepts"] and "noise" not in got["entities"]
        assert got["graph"]["candle"]["Attribute"]["two"] == 1
    if case == "start of the caption":
        assert got["concepts"] == ["run zebra"]


def test_graph_segments_single_string_and_bad_type():
    messy = ["(a ,b) ,( c , is:d )", "( lone )"]
    assert mc.split_graph_segments(messy) == jmc.split_graph_segments(messy)
    one = "( dog , runs , park )"
    assert mc.split_graph_segments(one) == mc.split_graph_segments([one])
    with pytest.raises(ValueError):
        mc.split_graph_segments(42)


@pytest.mark.parametrize("seed", range(8))
def test_concepts_equal_jax_on_the_fuzz_seeds(seed):
    rng = np.random.default_rng(seed)
    for _ in range(8):
        graphs, captions, model = _random_case(rng)
        assert _stages(mc, graphs, captions, model) == _stages(jmc, graphs, captions, model)


def test_build_concept_extractor_equals_jax():
    model = _StubWTE(_GROUPS)
    calls = []

    def parse_fn(captions):
        calls.append(list(captions))
        return _GRAPHS[: len(captions)]

    got = meacap.build_concept_extractor(parse_fn, model.encode)(_CAPTIONS, image_embeds=None)
    assert got == jmeacap.build_concept_extractor(parse_fn, model.encode)(_CAPTIONS)
    assert calls == [list(_CAPTIONS)] * 2 and 0 < len(got) <= 4


# ------------------------------------------------------------- retrieval


def test_retrieval_ties_go_to_the_lower_index():
    rng = np.random.default_rng(0)
    mem = rng.standard_normal((20, 16)).astype(np.float32)
    mem[[7, 12]] = mem[3]  # three equal rows
    mem[15] = mem[9] * 4.0  # the same direction
    f = np.stack([mem[3] * 2.0, mem[9], rng.standard_normal(16).astype(np.float32)])
    got = meacap.retrieve_memory_captions(torch.from_numpy(f), torch.from_numpy(mem), 4)
    want = jmeacap.retrieve_memory_captions(jnp.asarray(f), jnp.asarray(mem), 4)
    np.testing.assert_array_equal(got, want)
    assert got[0, :3].tolist() == [3, 7, 12] and got[1, :2].tolist() == [9, 15]
    mem = rng.standard_normal((500, 32)).astype(np.float32)
    f = rng.standard_normal((6, 32)).astype(np.float32)
    np.testing.assert_array_equal(
        meacap.retrieve_memory_captions(torch.from_numpy(f), torch.from_numpy(mem), 5),
        jmeacap.retrieve_memory_captions(jnp.asarray(f), jnp.asarray(mem), 5))


def test_frequency_extractor_equals_jax():
    caps = ["a dog runs in the park", "the dog chases a ball in the park",
            "a brown dog with a ball", "Two BALLS, one dog; a park!"]
    for k in (1, 2, 4, 10):
        assert (meacap.frequency_concept_extractor(caps, max_concepts=k)
                == jmeacap.frequency_concept_extractor(caps, max_concepts=k))
    assert meacap.frequency_concept_extractor(caps)[0] == "dog"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_memory_files_are_read_across_packages(writer, tmp_path):
    rng = np.random.default_rng(1)
    caps = [f"caption number {i}" for i in range(7)]
    table = rng.standard_normal((7, 12)).astype(np.float32)
    index = {c: i for i, c in enumerate(caps)}

    def clip_fn(texts):
        return table[[index[t] for t in texts]]

    def wte_fn(texts):
        return table[[index[t] for t in texts], :4] * 3.0

    w = np.eye(12, 6, dtype=np.float32) * 2.0
    build = (jmeacap.MeaCap if writer == "jax" else meacap.MeaCap).build_memory
    emb = build(caps, clip_fn, str(tmp_path / "memory" / "m"), project_fn=lambda e: e @ w,
                wte_encode_fn=wte_fn, batch_size=3)
    np.testing.assert_allclose(emb, table @ w, rtol=1e-6)
    pcaps, pemb = meacap.MeaCap.load_memory(str(tmp_path), "m")
    jcaps, jemb = jmeacap.MeaCap.load_memory(str(tmp_path), "m")
    assert pcaps == jcaps == caps and pemb.dtype == torch.float32
    np.testing.assert_array_equal(pemb.numpy(), jemb)
    wte = torch.load(tmp_path / "memory" / "m" / "memory_wte_embeddings.pt").numpy()
    np.testing.assert_allclose(np.linalg.norm(wte, axis=-1), 1.0, atol=1e-5)


# ------------------------------------------------- the flan-T5 extractor


def _stub_hf_modules(graph_of):
    """`transformers` and `sentence_transformers` stand-ins: the parser
    returns, for each prompt, "Generate Scene Graph: " + its caption's graph
    unspaced; the encoder is the stub's sentence embedding."""
    seen = {}

    class Tok:
        pad_token_id = 0

        @classmethod
        def from_pretrained(cls, path, local_files_only):
            assert local_files_only and path == "parser-dir"
            return cls()

        def __call__(self, prompts, **kw):
            seen["prompts"] = list(prompts)
            n = len(prompts)
            return {"input_ids": torch.arange(n)[:, None], "attention_mask": torch.ones(n, 1)}

        def batch_decode(self, out, **kw):
            return ["Generate Scene Graph: " + graph_of[p[len("Generate Scene Graph: "):]]
                    .replace(" ", "") for p in (seen["prompts"][int(i)] for i in out[:, 0])]

    class Parser:
        @classmethod
        def from_pretrained(cls, path, local_files_only):
            return cls()

        def eval(self):
            return self

        def to(self, device):
            return self

        def generate(self, input_ids, **kw):
            return input_ids

    model = _StubWTE(_GROUPS)

    class Encoder:
        def __init__(self, path, device):
            assert path == "sbert-dir"

        def encode(self, texts, convert_to_numpy):
            return model.encode(texts) * 2.0

    return {"transformers": types.SimpleNamespace(AutoTokenizer=Tok,
                                                  AutoModelForSeq2SeqLM=Parser),
            "sentence_transformers": types.SimpleNamespace(SentenceTransformer=Encoder)}


def test_hf_concept_extractor_with_stub_modules(monkeypatch):
    graph_of = dict(zip(_CAPTIONS, _GRAPHS))
    for name, mod in _stub_hf_modules(graph_of).items():
        monkeypatch.setitem(sys.modules, name, mod)
    got = meacap.hf_concept_extractor("parser-dir", "sbert-dir")(_CAPTIONS)
    assert got == jmeacap.hf_concept_extractor("parser-dir", "sbert-dir")(_CAPTIONS)
    model = _StubWTE(_GROUPS)
    assert got == mc.concepts_from_graphs(_GRAPHS, model.encode, _CAPTIONS) and got
    monkeypatch.setitem(sys.modules, "sentence_transformers", None)
    with pytest.raises(ImportError):
        meacap.hf_concept_extractor("parser-dir", "sbert-dir")
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError):
        meacap.hf_concept_extractor("parser-dir", "sbert-dir")


# ------------------------------------------------------------- the model


WORDS = ["dog", "cat", "park", "ball", "tree", "kite", "beach", "car"]


def _memory(n=40, width=16, seed=2):
    rng = np.random.default_rng(seed)
    # the row number keeps each caption apart (the extractor reads no digits)
    caps = [" ".join(["a"] + [WORDS[j] for j in rng.integers(0, len(WORDS), 3)] + [str(i)])
            for i in range(n)]
    return caps, rng.standard_normal((n, width)).astype(np.float32)


def _models(search):
    lm_cfg = jgpt2.GPT2Config(**LM_GEOM)
    lm = jgpt2.init_gpt2(jax.random.PRNGKey(41), lm_cfg)
    lm = dict(lm, wte=lm["wte"] * 20)
    kw = dict(continuous_prompt_length=3, clip_project_length=2, clip_hidden_size=16,
              num_layers=1, num_heads=2, using_hard_prompt=True, soft_prompt_first=True,
              using_greedy_search=search == "greedy", beam_width=3, max_len=8)
    jcfg, pcfg = jviecap.ViecapConfig(**kw), viecap.ViecapConfig(**kw)
    mapping = jviecap.init_mapping_network(jax.random.PRNGKey(42), jcfg, LM_GEOM["n_embd"])
    caps, emb = _memory()
    ref = jmeacap.MeaCap(jcfg, lm_cfg, lm, mapping, caps, emb, WordTokenizer(),
                         memory_caption_num=4)
    port = meacap.MeaCap(pcfg, gpt2.GPT2Config(**LM_GEOM), bridge.to_torch(lm), _tree(mapping),
                         caps, emb, WordTokenizer(), "cpu", memory_caption_num=4)
    return ref, port


@pytest.mark.parametrize("search", ["greedy", "beam"])
def test_meacap_forward_equals_jax(search):
    ref, port = _models(search)
    feats = np.random.default_rng(3).standard_normal((3, 16)).astype(np.float32) * 2
    f = feats / np.linalg.norm(feats, axis=-1, keepdims=True)
    idx = meacap.retrieve_memory_captions(torch.from_numpy(f), port.memory_clip_embeddings, 4)
    np.testing.assert_array_equal(idx, jmeacap.retrieve_memory_captions(
        jnp.asarray(f), ref.memory_clip_embeddings, 4))
    rows = port._hard_prompt_token_rows(torch.from_numpy(f))
    assert rows == ref._hard_prompt_token_rows(jnp.asarray(f)) and rows[0] != rows[1]
    sents, ppl = port.forward(feats, compute_scores=True)
    want, want_ppl = ref.forward(feats, compute_scores=True)
    assert sents == want
    np.testing.assert_allclose(ppl, want_ppl, rtol=1e-5)


def test_the_extractor_sees_its_own_image_row():
    _, port = _models("greedy")
    seen = []

    def extractor(captions, image_embeds=None):
        seen.append(image_embeds)
        return ["dog"]

    port.concept_extractor = extractor
    f = torch.from_numpy(np.random.default_rng(4).standard_normal((3, 16)).astype(np.float32))
    rows = port._hard_prompt_token_rows(f)
    assert len(rows) == 3 and all(torch.equal(s, f[i]) for i, s in enumerate(seen))


def test_to_keeps_meacap_and_clipcap():
    _, port = _models("beam")
    moved = port.to("cpu")
    assert isinstance(moved, meacap.MeaCap) and moved.memory_captions == port.memory_captions
    assert moved.memory_caption_num == 4 and moved.concept_extractor is port.concept_extractor
    assert torch.equal(moved.memory_clip_embeddings, port.memory_clip_embeddings)
    config = {"dino_model": "dinov2_vits14_reg", "crop_dim": 28, "prefix_size": 384,
              "support_memory_size": 0, "dino_geometry": {"depth": 1},
              "decap_arch": {"n_layer": 1, "n_head": 1, "n_embd": 64, "vocab_size": 1000},
              "clipcap": {"prefix_length": 2, "num_layers": 1}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gpt2, "GPT2_BASE_CONFIG", gpt2.GPT2Config(
            n_layer=1, n_embd=64, n_head=1, vocab_size=300, n_positions=64))
        model = Patchioner.from_config(config, allow_missing_weights=True, device="cpu",
                                       gpt2_tokenizer=WordTokenizer())
    model.viecap = port
    moved = model.to("cpu")
    assert isinstance(moved.viecap, meacap.MeaCap) and moved.clipcap is not None
    assert not moved.supports_fused_trace_path()
    assert not patchioner.uses_fallback_tokenizer(moved)
    moved.clipcap.tokenizer = patchioner._FallbackWordTokenizer()
    assert patchioner.uses_fallback_tokenizer(moved)


# ------------------------------------------------------------ from_config


def test_shipped_meacap_config_builds(monkeypatch):
    """configs/mlp.meacap.k.yaml at full width: no memory on this machine,
    so 64 synthetic captions and seeded rows under the opt-in; without it
    FileNotFoundError."""
    path = os.path.join(REPO, "configs", "mlp.meacap.k.yaml")
    with open(path) as f:
        patchioner._check_config(yaml.safe_load(f))
    model = Patchioner.from_config(path, allow_missing_weights=True, device="cpu",
                                   gpt2_tokenizer=WordTokenizer())
    mc_ = model.viecap
    assert isinstance(mc_, meacap.MeaCap) and model.bank is None
    assert mc_.memory_clip_embeddings.shape == (64, 768) and mc_.memory_caption_num == 5
    assert mc_.cfg.using_greedy_search and mc_.entities == []
    assert mc_.concept_extractor is meacap.frequency_concept_extractor


@pytest.fixture
def tiny_base(monkeypatch):
    monkeypatch.setattr(jgpt2, "GPT2_BASE_CONFIG", jgpt2.GPT2Config(**LM_GEOM))
    monkeypatch.setattr(gpt2, "GPT2_BASE_CONFIG", gpt2.GPT2Config(**LM_GEOM))


def test_loaded_meacap_captions_equal_jax(tiny_base, tmp_path):
    torch.save(_viecap_state_dict(50), tmp_path / "viecap.pt")
    caps, emb = _memory(n=60, width=128, seed=5)
    meacap.MeaCap.build_memory(caps, lambda t: emb[[caps.index(c) for c in t]],
                               str(tmp_path / "memory" / "mem"))
    files = {"pt": str(tmp_path / "viecap.pt"), "files": str(tmp_path / "nofiles")}
    config = _viecap_config(files, meacap={"memory_caption_num": 3, "memory_id": "mem",
                                           "memory_base_path": str(tmp_path)})
    jm = JaxPatchioner.from_config(config, allow_missing_weights=True, dtype=jnp.float32,
                                   gpt2_tokenizer=WordTokenizer())
    pm = Patchioner.from_config(config, allow_missing_weights=True, device="cpu",
                                gpt2_tokenizer=WordTokenizer())
    assert isinstance(pm.viecap, meacap.MeaCap) and pm.viecap.memory_captions == caps
    np.testing.assert_array_equal(pm.viecap.memory_clip_embeddings.numpy(), emb)
    pm.vit_params = bridge.vit_from_jax(jm.vit_params, pm.vit_cfg)
    imgs = np.random.default_rng(6).integers(0, 256, (2, 56, 56, 3), dtype=np.uint8)
    flags = dict(get_cls_capt=True, traces=[[(0.2, 0.3), (0.6, 0.6)], [(0.5, 0.1)]],
                 bboxes=np.asarray([[[0, 0, 28, 28]], [[14, 7, 40, 40]]], np.float32))
    got, want = pm.forward(imgs, **flags), jm.forward(imgs, **flags)
    assert got == want and sorted(got) == ["bbox_capts", "cls_capt", "trace_capts"]
    # a memory that is absent, or that disagrees with the config
    block = dict(config["viecap"], meacap={"memory_id": "absent",
                                           "memory_base_path": str(tmp_path)})
    with pytest.raises(FileNotFoundError, match="absent"):
        patchioner._build_viecap_family(block, None, torch.Generator(), False,
                                        WordTokenizer(), torch.device("cpu"),
                                        patchioner._Clock())
    meacap.MeaCap.build_memory(caps, lambda t: np.ones((len(t), 64), np.float32),
                               str(tmp_path / "memory" / "narrow"))
    block["meacap"]["memory_id"] = "narrow"
    with pytest.raises(ValueError, match="MeaCap memory"):
        patchioner._build_viecap_family(block, None, torch.Generator(), True,
                                        WordTokenizer(), torch.device("cpu"),
                                        patchioner._Clock())
