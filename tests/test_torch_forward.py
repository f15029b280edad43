"""The port's generic caption path (`Patchioner.forward`, `caption_tokens`,
`encode_images`, `project_features`) and a DINOv2 + ViECap model against
the JAX package's, on the CPU in f32 on the same bridged weights: a
56 px, 2-layer, 128-wide DINOv2 (layerscale drawn near 1), a 2-layer DeCap
decoder, and a ViECap of a 2-layer, 32-wide GPT-2 over a 263-token
vocabulary with the JAX tests' `WordTokenizer`.

- every ported flag of `forward` gives the JAX outputs, key for key and
  string for string (scores within 1e-4 relative), for a ViECap model, for DeCap without a bank and for
  DeCap over a bank, the cleaning, per-head and n-best flags among them;
- the port's `CaptionServer` serves a ViECap model through `forward` for
  each request kind, as the JAX server does;
- `from_config` loads a ViECap `.pt` written in the published layout
  (`mapping_network.*`, `gpt.*`) and an entity vocabulary under
  `files_path`, and its captions for a trace, a box, a box set and the whole
  image equal the JAX package's on the same files (GPT-2 base shrunk to the
  tiny one in both packages by setting their `GPT2_BASE_CONFIG`);
- the GPT-2 tokenizer resolution and its whitespace fallback.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import patchioner_tpu.models.gpt2 as jgpt2
from patchioner_tpu.models import decap as jdecap
from patchioner_tpu.models import patchioner as jpatchioner
from patchioner_tpu.models import viecap as jviecap
from patchioner_tpu.models import vit as jvit
from patchioner_tpu.io.checkpoints import CheckpointManager as JaxCheckpointManager
from patchioner_tpu.models.patchioner import Patchioner as JaxPatchioner
from patchioner_tpu.ops import memory_projection as jmp
from patchioner_tpu.serve import CaptionServer as JaxServer
from patchioner_tpu_torch.io import bridge
from patchioner_tpu_torch.models import gpt2, patchioner, viecap, vit
from patchioner_tpu_torch.models.patchioner import Patchioner
from patchioner_tpu_torch.serve import CaptionServer
from test_viecap import WordTokenizer

VIT_GEOM = dict(img_size=56, patch_size=14, embed_dim=128, depth=2, num_heads=4,
                num_registers=4, extract_heads=4, pos_grid=4)
DECAP_GEOM = dict(vocab_size=49408, n_layer=2, n_head=4, n_embd=128)
LM_GEOM = dict(vocab_size=263, n_positions=128, n_embd=32, n_layer=2, n_head=2)
VCFG = dict(continuous_prompt_length=3, clip_project_length=2, clip_hidden_size=128,
            num_layers=2, num_heads=2, top_k=3, threshold=0.05, temperature=0.05,
            using_hard_prompt=True, soft_prompt_first=True, using_greedy_search=True,
            max_len=8)
ENTITIES = ["dog", "cat", "car", "tree", "person", "boat", "kite", "bus"]


def _tree(tree):
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v) for v in tree]
    return None if tree is None else torch.from_numpy(np.array(tree))


def _jax_viecap(vcfg=VCFG, beam=False):
    """A JAX VieCap and the port's twin on the same weights."""
    kw = dict(vcfg, using_greedy_search=not beam, beam_width=3)
    jcfg, pcfg = jviecap.ViecapConfig(**kw), viecap.ViecapConfig(**kw)
    lm_cfg = jgpt2.GPT2Config(**LM_GEOM)
    lm = jgpt2.init_gpt2(jax.random.PRNGKey(21), lm_cfg)
    lm = dict(lm, wte=lm["wte"] * 20)
    mapping = jviecap.init_mapping_network(jax.random.PRNGKey(22), jcfg, 32)
    emb = np.random.default_rng(23).standard_normal((len(ENTITIES), 128)).astype(np.float32)
    ref = jviecap.VieCap(jcfg, lm_cfg, lm, mapping, ENTITIES, emb, WordTokenizer())
    port = viecap.VieCap(pcfg, gpt2.GPT2Config(**LM_GEOM), bridge.to_torch(lm), _tree(mapping),
                         ENTITIES, emb, WordTokenizer(), "cpu")
    return ref, port


def _models(kind):
    """(JAX Patchioner, port Patchioner) of one decoder kind: 'viecap',
    'viecap beam', 'decap' (no bank) or 'decap bank'."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    jcfg, jg = jvit.ViTConfig(**VIT_GEOM), jgpt2.GPT2Config(**DECAP_GEOM)
    vparams = jvit.init_vit(k1, jcfg)
    ls = np.random.default_rng(1).uniform(0.5, 1.5, (2, 2, 128)).astype(np.float32)
    vparams["blocks"] = [dict(b, ls1=jnp.asarray(ls[i, 0]), ls2=jnp.asarray(ls[i, 1]))
                         for i, b in enumerate(vparams["blocks"])]
    dec = jdecap.init_decap(k2, jg, prefix_size=128)
    dec = dec._replace(gpt2=dict(dec.gpt2, wte=dec.gpt2["wte"] * 10))
    bank = (jmp.prepare_bank(jax.random.normal(k3, (200, 128))) if kind == "decap bank"
            else None)
    jv, pv = _jax_viecap(beam=kind == "viecap beam") if "viecap" in kind else (None, None)
    jm = JaxPatchioner(vit_cfg=jcfg, vit_params=vparams, gpt2_cfg=jg, decoder=dec, bank=bank,
                       bank_texts=None, normalize=True, viecap=jv)
    pm = Patchioner(vit_cfg=vit.ViTConfig(**VIT_GEOM),
                    vit_params=bridge.vit_from_jax(vparams, vit.ViTConfig(**VIT_GEOM)),
                    gpt2_cfg=gpt2.GPT2Config(**DECAP_GEOM), decoder=bridge.decap_from_jax(dec),
                    bank=None if bank is None else bridge.bank_from_jax(bank),
                    normalize=True, device="cpu", viecap=pv)
    return jm, pm


@pytest.fixture(scope="module")
def imgs():
    return np.random.default_rng(0).integers(0, 256, (2, 56, 56, 3), dtype=np.uint8)


BOXES = np.asarray([[[0, 0, 28, 28], [14, 14, 42, 42], [0, 0, 1, 1]],
                    [[7, 7, 42, 42], [0, 0, 56, 20], [30, 2, 20, 50]]], np.float32)
SETS = np.asarray([[[0, 0, 28, 28], [14, 14, 42, 42]],
                   [[7, 7, 42, 42], [-1, -1, -1, -1]]], np.float32)
TRACES = [[{"x": 0.1, "y": 0.2}, {"x": 0.5, "y": 0.5}, {"x": 0.9, "y": 0.3}],
          [(0.3, 0.7), (0.35, 0.75)]]
FLAGS = {
    "cls": dict(get_cls_capt=True),
    "cls, scores": dict(get_cls_capt=True, compute_scores=True),
    "avg_self_attn, avg_patch": dict(get_cls_capt=False, get_avg_self_attn_capt=True,
                                     get_avg_patch_capt=True, gaussian_img_variance=0.5),
    "patches, registers, scores": dict(get_cls_capt=False, get_patch_capts=True,
                                       get_register_capts=True, compute_scores=True),
    "boxes": dict(get_cls_capt=False, bboxes=BOXES),
    "boxes gaussian, scores": dict(get_cls_capt=False, bboxes=BOXES, gaussian_avg=True,
                                   gaussian_bbox_variance=0.7, compute_scores=True),
    "boxes attention map": dict(get_cls_capt=False, bboxes=BOXES,
                                use_attn_map_for_bboxes=True),
    "box sets": dict(get_cls_capt=False, bboxes=SETS, get_controllable_capts=True),
    "box sets gaussian": dict(get_cls_capt=False, bboxes=SETS, get_controllable_capts=True,
                              gaussian_avg=True),
    "traces": dict(get_cls_capt=False, traces=TRACES),
    "traces attention": dict(get_cls_capt=True, traces=TRACES, use_attention_tracing=True),
}
KINDS = ["viecap", "viecap beam", "decap", "decap bank"]


@pytest.fixture(scope="module")
def models():
    return {kind: _models(kind) for kind in KINDS}


def _equal(got, want, at):
    """Outputs equal: strings exactly, scores within 1e-4 relative (a DeCap
    score is exp of the sum of 30 f32 log-probabilities, a ViECap score a
    perplexity: each summand's ~1e-6 error adds up)."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), at
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{at}[{i}]")
    elif isinstance(want, str):
        assert got == want, at
    else:
        assert got == pytest.approx(float(want), rel=1e-4, nan_ok=True), at


# the beam search is held on three flag sets; the other kinds on them all
CASES = [(kind, flags) for kind in KINDS for flags in FLAGS
         if kind != "viecap beam" or flags in ("cls, scores", "boxes", "traces")]


@pytest.mark.parametrize("kind,flags", CASES)
def test_forward_equals_jax(models, imgs, kind, flags):
    jm, pm = models[kind]
    got, want = pm.forward(imgs, **FLAGS[flags]), jm.forward(imgs, **FLAGS[flags])
    assert sorted(got) == sorted(want)
    for key in want:
        _equal(got[key], want[key], key)


# the three flags this test once showed refused: each is ported now and
# gives the JAX outputs (tests/test_torch_forward_modes.py covers the rest)
@pytest.mark.parametrize("flag", [dict(cleaning_type="orthogonal_projection"),
                                  dict(get_attn_heads_capt=True),
                                  dict(return_n_best_sims=3, bboxes=BOXES)])
def test_flags_not_ported_raise(models, imgs, flag):
    jm, pm = models["decap bank"]
    kw = dict(flag, get_patch_capts="cleaning_type" in flag, compute_scores=True)
    got, want = pm.forward(imgs, **kw), jm.forward(imgs, **kw)
    assert sorted(got) == sorted(want)
    assert {"cleaning_type": "patch_tokens_capts", "get_attn_heads_capt": "attn_heads_capts",
            "return_n_best_sims": "bbox_sims"}[next(iter(flag))] in want
    for key in want:
        _equal(got[key], want[key], key)


def test_encode_and_project_equal_jax(models, imgs):
    jm, pm = models["decap bank"]
    enc, want = pm.encode_images(imgs), jm.encode_images(imgs)
    for key in ("x_norm_clstoken", "x_norm_patchtokens", "x_norm_regtokens", "self_attn",
                "self_attn_maps"):
        ref = np.asarray(want[key])
        assert np.max(np.abs(enc[key].numpy() - ref)) <= 1e-5 * max(1.0, np.max(np.abs(ref)))
    feats = enc["x_norm_clstoken"]
    for project in (True, False):
        ref = np.asarray(jm.project_features(jnp.asarray(feats.numpy()), project=project))
        got = pm.project_features(feats, project=project).numpy()
        assert np.max(np.abs(got - ref)) <= 1e-5 * max(1.0, np.max(np.abs(ref)))
    assert pm.supports_fused_trace_path() and not models["viecap"][1].supports_fused_trace_path()
    assert not models["decap"][1].supports_fused_trace_path()
    with pytest.raises(ValueError, match="forward"):
        models["viecap"][1].caption_images_fused(imgs)


def test_server_serves_a_viecap_model_through_forward(models, imgs):
    jm, pm = models["viecap"]
    rng = np.random.default_rng(5)
    traces = [rng.uniform(0, 1, (int(rng.integers(1, 6)), 2)).tolist() for _ in range(3)]
    boxes = [[(0.1, 0.1, 0.5, 0.6)], [(0.0, 0.0, 1.0, 1.0), (0.2, 0.3, 0.9, 0.8)],
             [(0.5, 0.5, 0.7, 0.9)] * 3]
    results = {}
    for name, server_cls, model in (("port", CaptionServer, pm), ("jax", JaxServer, jm)):
        with server_cls(model, max_batch=4, max_delay_ms=50.0, max_boxes=4) as server:
            server.warmup(trace=True, cls=True, bbox=True, region_set=True, buckets=[4])
            futs = [server.submit(imgs[i % 2], trace=tr) for i, tr in enumerate(traces)]
            futs += [server.submit(imgs[i % 2], bboxes=b) for i, b in enumerate(boxes)]
            futs += [server.submit(imgs[i % 2], bboxes=b, region_set=True)
                     for i, b in enumerate(boxes)]
            futs += [server.submit(imgs[i]) for i in range(2)]
            results[name] = [f.result(timeout=300) for f in futs]
            snap = server.snapshot()
        if name == "port":
            assert snap["decode_captures"] == snap["decode_replays"] == 0
            assert snap["completed"] == len(futs) and snap["errors"] == 0
    assert results["port"] == results["jax"]
    assert [len(c) for c in results["port"][3:6]] == [1, 2, 3]


# ------------------------------------------------------------ from_config


N_LAYER, N_EMBD, VOCAB = LM_GEOM["n_layer"], LM_GEOM["n_embd"], LM_GEOM["vocab_size"]


def _viecap_state_dict(seed, clip_hidden=128, layers=8, gpt_layers=N_LAYER):
    """A ViECap checkpoint: `mapping_network.*` (ClipCap.py:122-155) and the
    GPT-2 under `gpt.` in GPT2LMHeadModel naming, numpy-seeded; the config
    block has no depth key, so the mapping network has the default 8 layers."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=0.1):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    d, p = N_EMBD, "mapping_network."
    sd = {f"{p}linear.weight": t(2 * d, clip_hidden), f"{p}linear.bias": t(2 * d),
          f"{p}prefix_const": t(3, d, scale=1.0)}
    for i in range(layers):
        q = f"{p}transformer.layers.{i}"
        for norm in ("norm1", "norm2"):
            sd[f"{q}.{norm}.weight"], sd[f"{q}.{norm}.bias"] = 1 + t(d), t(d)
        sd[f"{q}.attn.to_queries.weight"] = t(d, d)
        sd[f"{q}.attn.to_keys_values.weight"] = t(2 * d, d)
        sd[f"{q}.attn.project.weight"], sd[f"{q}.attn.project.bias"] = t(d, d), t(d)
        sd[f"{q}.mlp.fc1.weight"], sd[f"{q}.mlp.fc1.bias"] = t(2 * d, d), t(2 * d)
        sd[f"{q}.mlp.fc2.weight"], sd[f"{q}.mlp.fc2.bias"] = t(d, 2 * d), t(d)
    g = "gpt.transformer"
    sd[f"{g}.wte.weight"], sd[f"{g}.wpe.weight"] = t(VOCAB, d, scale=2.0), t(128, d, scale=0.02)
    sd[f"{g}.ln_f.weight"], sd[f"{g}.ln_f.bias"] = 1 + t(d), t(d)
    for i in range(gpt_layers):
        h = f"{g}.h.{i}"
        for ln in ("ln_1", "ln_2"):
            sd[f"{h}.{ln}.weight"], sd[f"{h}.{ln}.bias"] = 1 + t(d), t(d)
        for name, fi, fo in (("attn.c_attn", d, 3 * d), ("attn.c_proj", d, d),
                             ("mlp.c_fc", d, 4 * d), ("mlp.c_proj", 4 * d, d)):
            sd[f"{h}.{name}.weight"], sd[f"{h}.{name}.bias"] = t(fi, fo), t(fo)
    return sd


@pytest.fixture
def tiny_base(monkeypatch):
    """GPT-2 base shrunk to the tiny GPT-2 in both packages."""
    monkeypatch.setattr(jgpt2, "GPT2_BASE_CONFIG", jgpt2.GPT2Config(**LM_GEOM))
    monkeypatch.setattr(gpt2, "GPT2_BASE_CONFIG", gpt2.GPT2Config(**LM_GEOM))


@pytest.fixture(scope="module")
def viecap_files(tmp_path_factory):
    """A ViECap `.pt` and a `files_path` whose annotations/vocabulary holds
    the COCO categories and a 128-wide `_t2d_` embedding pickle."""
    tmp = tmp_path_factory.mktemp("viecap")
    torch.save(_viecap_state_dict(30), tmp / "viecap.pt")
    vocab = tmp / "files" / "annotations" / "vocabulary"
    vocab.mkdir(parents=True)
    with open(os.path.join(viecap.VOCAB_DIR, "coco_categories.json")) as f:
        cats = json.load(f)
    with open(vocab / "coco_categories.json", "w") as f:
        json.dump(cats, f)
    emb = torch.from_numpy(np.random.default_rng(31).standard_normal((80, 128)).astype(
        np.float32))
    with open(vocab / "coco_embeddings_ViT-B16_t2d__with_ensemble.pickle", "wb") as f:
        pickle.dump(emb, f)
    return {"pt": str(tmp / "viecap.pt"), "files": str(tmp / "files"), "dir": tmp}


def _viecap_config(files, **viecap_extra):
    """configs/mlp.viecap.k.yaml at the tiny geometry, on the files."""
    return {
        "prefix_size": 128, "support_memory_size": 0, "dino_model": "dinov2_vitb14_reg",
        "normalize": False, "use_talk2dino_project": False, "clip_model_name": "ViT-B/16",
        "crop_dim": 56,
        "dino_geometry": {"embed_dim": 128, "depth": 2, "num_heads": 4, "extract_heads": 4,
                          "pos_grid": 4},
        "decap_arch": {"n_layer": 2, "n_head": 4, "n_embd": 128},
        "viecap": dict({"clip_hidden_size": 128, "suffix": "ViT-B16_t2d_",
                        "temperature": 0.01, "top_k": 3, "threshold": 0.02,
                        "name_of_entities_text": "coco_entities", "prompt_ensemble": True,
                        "weight_path": files["pt"], "files_path": files["files"],
                        "using_hard_prompt": True, "soft_prompt_first": True,
                        "using_greedy_search": True, "beam_width": 5,
                        "continuous_prompt_length": 3, "clip_project_length": 2},
                       **viecap_extra),
    }


def test_loaded_viecap_captions_equal_jax(viecap_files, tiny_base, imgs):
    config = _viecap_config(viecap_files)
    jm = JaxPatchioner.from_config(config, allow_missing_weights=True, dtype=jnp.float32,
                                   gpt2_tokenizer=WordTokenizer())
    pm = Patchioner.from_config(config, allow_missing_weights=True, device="cpu",
                                gpt2_tokenizer=WordTokenizer())
    assert pm.bank is None and not pm.supports_fused_trace_path()
    assert pm.viecap.entities == jm.viecap.entities and len(pm.viecap.entities) == 80
    assert "upload" in pm.load_seconds and "read" in pm.load_seconds
    # the loaded files: the trees equal the JAX ones
    sd = torch.load(viecap_files["pt"], weights_only=True)
    np.testing.assert_array_equal(pm.viecap.gpt2_params["wte"].numpy(),
                                  sd["gpt.transformer.wte.weight"].numpy())
    np.testing.assert_array_equal(pm.viecap.mapping_params["linear"]["w"].numpy(),
                                  np.asarray(jm.viecap.mapping_params["linear"]["w"]))
    # the DINOv2 and DeCap are random under allow_missing_weights: carry the
    # JAX draws over so that the encoders agree
    pm.vit_params = bridge.vit_from_jax(jm.vit_params, pm.vit_cfg)
    for flags in (dict(traces=TRACES), dict(bboxes=BOXES), dict(bboxes=SETS,
                                                                get_controllable_capts=True),
                  dict(get_cls_capt=True, compute_scores=True)):
        flags = dict(dict(get_cls_capt=False), **flags)
        got, want = pm.forward(imgs, **flags), jm.forward(imgs, **flags)
        assert sorted(got) == sorted(want)
        for key in want:
            _equal(got[key], want[key], key)


def _mismatch(files, kind):
    sd = {"clip width": lambda: _viecap_state_dict(30, clip_hidden=64),
          "mapping depth": lambda: _viecap_state_dict(30, layers=3),
          "gpt depth": lambda: _viecap_state_dict(30, gpt_layers=1)}[kind]()
    path = str(files["dir"] / f"mismatch_{kind.replace(' ', '_')}.pt")
    torch.save(sd, path)
    return _viecap_config(dict(files, pt=path))


@pytest.mark.parametrize("kind", ["clip width", "mapping depth", "gpt depth"])
def test_a_viecap_file_that_disagrees_with_the_config_raises(viecap_files, tiny_base, kind):
    with pytest.raises(ValueError, match="viecap.weight_path"):
        Patchioner.from_config(_mismatch(viecap_files, kind), allow_missing_weights=True,
                               device="cpu", gpt2_tokenizer=WordTokenizer())


def test_viecap_files_missing_directory_and_mapping_only(viecap_files, tiny_base, tmp_path):
    missing = _viecap_config(dict(viecap_files, pt=str(tmp_path / "nope.pt")))["viecap"]
    with pytest.raises(FileNotFoundError, match="nope.pt"):
        patchioner._build_viecap_family(missing, None, torch.Generator(), False,
                                        WordTokenizer(), torch.device("cpu"),
                                        patchioner._Clock())
    # a directory of the JAX package's mapper training (Orbax) is refused
    orbax = tmp_path / "orbax"
    JaxCheckpointManager(str(orbax)).save(1, {"params": {"w": jnp.ones(3)}, "step": 1})
    with pytest.raises(NotImplementedError, match="Orbax"):
        Patchioner.from_config(_viecap_config(dict(viecap_files, pt=str(orbax))),
                               allow_missing_weights=True, device="cpu",
                               gpt2_tokenizer=WordTokenizer())
    # a file with the mapping network alone takes a random GPT-2, only
    # under allow_missing_weights
    sd = {k: v for k, v in _viecap_state_dict(30).items() if not k.startswith("gpt.")}
    torch.save(sd, tmp_path / "mapping.pt")
    m = Patchioner.from_config(_viecap_config(dict(viecap_files, pt=str(tmp_path / "mapping.pt"))),
                               allow_missing_weights=True, device="cpu",
                               gpt2_tokenizer=WordTokenizer())
    assert m.viecap.gpt2_params["wte"].shape == (VOCAB, N_EMBD)
    # entity embeddings (128 wide) of another width than clip_hidden_size
    torch.save(_viecap_state_dict(30, clip_hidden=64), tmp_path / "clip64.pt")
    with pytest.raises(ValueError, match="entity embeddings"):
        Patchioner.from_config(_viecap_config(dict(viecap_files, pt=str(tmp_path / "clip64.pt")),
                                              clip_hidden_size=64),
                               allow_missing_weights=True, device="cpu",
                               gpt2_tokenizer=WordTokenizer())


def test_the_vendored_vocabulary_is_read_without_files_path(tiny_base, monkeypatch):
    """No files_path: the port's own data folder, whose t2d embeddings are
    768 wide; no weight file: random weights under the opt-in. The Visual
    Genome vocabulary is vendored too (as in the JAX package's folder); its
    t2d embeddings are not, so they are drawn."""
    monkeypatch.delenv("GPT2_BPE_DIR", raising=False)
    config = {"prefix_size": 128, "support_memory_size": 0,
              "dino_model": "dinov2_vits14_reg", "crop_dim": 28,
              "dino_geometry": {"embed_dim": 64, "depth": 1, "num_heads": 1,
                                "extract_heads": 1},
              "decap_arch": {"n_layer": 1, "n_head": 1, "n_embd": 64},
              "viecap": {"clip_hidden_size": 768, "suffix": "ViT-B16_t2d_",
                         "name_of_entities_text": "coco_entities", "prompt_ensemble": True}}
    m = Patchioner.from_config(config, allow_missing_weights=True, device="cpu",
                               gpt2_tokenizer=WordTokenizer())
    assert m.viecap.texts_embeddings.shape == (80, 768)
    with open(os.path.join(viecap.VOCAB_DIR,
                           "coco_embeddings_ViT-B16_t2d__with_ensemble.pickle"), "rb") as f:
        np.testing.assert_array_equal(m.viecap.texts_embeddings.numpy(),
                                      np.asarray(pickle.load(f)))
    vg = Patchioner.from_config(dict(config, viecap=dict(
        config["viecap"], name_of_entities_text="visual_genome_entities")),
        allow_missing_weights=True, device="cpu", gpt2_tokenizer=WordTokenizer())
    want = jviecap.load_entities_text(
        "visual_genome_entities", os.path.join(jviecap.VOCAB_DIR,
                                               "all_objects_attributes_relationships.pickle"))
    assert vg.viecap.entities == want and len(want) > 1000
    assert vg.viecap.texts_embeddings.shape == (len(want), 768)


# ------------------------------------------------------------- tokenizers


def test_fallback_tokenizer_equals_jax():
    port, ref = patchioner._FallbackWordTokenizer(), jpatchioner._FallbackWordTokenizer()
    for text in ["There are dog, cat in image.", "a dog .", "  two  spaces ", "There are"]:
        assert port.encode(text) == ref.encode(text)
    ids = port.encode("a new word") + [3, 999]
    assert ref.encode("a new word") == ids[:-2]
    assert port.decode(ids) == ref.decode(ids) and port.pad_token_id == ref.pad_token_id == 0


def test_tokenizer_resolution(tmp_path, monkeypatch):
    from tokenizers import ByteLevelBPETokenizer

    from patchioner_tpu_torch.text import gpt2_bpe

    monkeypatch.delenv("GPT2_BPE_DIR", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    with pytest.raises(FileNotFoundError, match="GPT2_BPE_DIR"):
        patchioner._get_gpt2_tokenizer(False)
    with pytest.warns(UserWarning, match="fallback"):
        assert isinstance(patchioner._get_gpt2_tokenizer(True),
                          patchioner._FallbackWordTokenizer)
    tok = ByteLevelBPETokenizer()
    tok.train_from_iterator(["there are dog in image."] * 10, vocab_size=270, min_frequency=1,
                            special_tokens=["<|endoftext|>"])
    tok.save_model(str(tmp_path))
    monkeypatch.setenv("GPT2_BPE_DIR", str(tmp_path))
    assert isinstance(patchioner._get_gpt2_tokenizer(False), gpt2_bpe.Gpt2Tokenizer)


def test_fallback_tokenizer_is_detected(models):
    pm = models["viecap"][1]
    assert not patchioner.uses_fallback_tokenizer(pm)
    pm_fallback = type("M", (), {"viecap": type("V", (), {
        "tokenizer": patchioner._FallbackWordTokenizer()})()})()
    assert patchioner.uses_fallback_tokenizer(pm_fallback)
    assert not patchioner.uses_fallback_tokenizer(models["decap"][1])
