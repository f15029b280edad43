"""The port's prefix-mapper training (`train/prefix_train.py`,
`train/prefix_cli.py`) against the JAX package's, on the CPU.

The same numpy-seeded inputs and bridged params (ViECap's mapping network,
None biases included, and ClipCap's MLP mapper, on a small frozen GPT-2):
`noise_injection` on the same standard-normal draw; `prefix_loss` with
and without a hard prompt, full and chunked, loss, accuracy and every
mapper gradient, none reaching GPT-2; three steps of each mapper against
JAX's step under optax's adamw (weight decay 0). Then the CLI for
`viecap` and `clipcap`: it trains, resumes, and its directory serves
through `Patchioner.from_config`.

Tolerances (f32 on both sides, only the order of f32 sums differs), as
tests/test_torch_train.py states them: losses 1e-5 * max(1, |JAX|);
gradient leaves 1e-4 * max(1e-3, max |JAX leaf|); the mapper after the
steps 1e-5 * max(1, max |JAX leaf|).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import patchioner_tpu.models.gpt2 as jgpt2
from patchioner_tpu.models import clipcap as jclipcap
from patchioner_tpu.models import viecap as jviecap
from patchioner_tpu.train import prefix_train as jpt
from patchioner_tpu_torch.io import bridge, checkpoints
from patchioner_tpu_torch.models import clipcap, gpt2, viecap
from patchioner_tpu_torch.models.patchioner import Patchioner
from patchioner_tpu_torch.train import decoder_train as dt, prefix_cli, prefix_train as pt
from test_torch_train import _close, _leaves_close, _np

LM_GEOM = dict(vocab_size=101, n_positions=64, n_embd=32, n_layer=2, n_head=2)
FEAT, T = 16, 9


@pytest.fixture(scope="module")
def lm():
    return jgpt2.init_gpt2(jax.random.PRNGKey(5), jgpt2.GPT2Config(**LM_GEOM))


def _mappers():
    """(name, JAX params, JAX fn, port fn) for each mapper family."""
    vcfg = jviecap.ViecapConfig(clip_hidden_size=FEAT, num_layers=2, clip_project_length=3,
                                continuous_prompt_length=4)
    pcfg = viecap.ViecapConfig(clip_hidden_size=FEAT, num_layers=2, clip_project_length=3,
                               continuous_prompt_length=4)
    d = LM_GEOM["n_embd"]
    return [
        ("viecap", jviecap.init_mapping_network(jax.random.PRNGKey(6), vcfg, d),
         lambda p, f: jviecap.mapping_network_forward(p, f, vcfg, d),
         lambda p, f: viecap.mapping_network_forward(p, f, pcfg, d)),
        ("clipcap", jclipcap.init_mlp_mapper(jax.random.PRNGKey(7), FEAT, 3, d),
         lambda p, f: jclipcap.mlp_mapper_forward(p, f, 3, d),
         lambda p, f: clipcap.mlp_mapper_forward(p, f, 3, d)),
    ]


MAPPERS = ["viecap", "clipcap"]


def _mapper(name):
    return next(m for m in _mappers() if m[0] == name)[1:]


def _batch(seed, b=4):
    """Features, GPT-2 ids with 0-padded tails and their mask, in which one
    genuine id 0 scores."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, LM_GEOM["vocab_size"], (b, T)).astype(np.int32)
    mask = np.ones((b, T), np.float32)
    for i in range(b):
        cut = int(rng.integers(3, T + 1))
        toks[i, cut:], mask[i, cut:] = 0, 0.0
    toks[0, 1] = 0  # a genuine id 0 ('!' in GPT-2's vocabulary) under mask 1
    return _np(seed + 1, b, FEAT), toks, mask


def test_noise_injection_matches_jax():
    feats, key = _np(1, 5, FEAT), jax.random.PRNGKey(2)
    want = np.asarray(jpt.noise_injection(jnp.asarray(feats), key, 0.016))
    draw = np.array(jax.random.normal(key, feats.shape, jnp.float32))
    got = pt.noise_injection(torch.from_numpy(feats), 0.016, noise=torch.from_numpy(draw))
    assert np.max(np.abs(got.numpy() - want)) <= 1e-5 * np.max(np.abs(want))
    assert torch.equal(pt.noise_injection(torch.from_numpy(feats), 0.0), torch.from_numpy(feats))


@pytest.mark.parametrize("loss_chunk", [0, 4])
@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("name", MAPPERS)
def test_prefix_loss_matches_jax(lm, name, hard, loss_chunk):
    jmap, jfn, pfn = _mapper(name)
    feats, toks, mask = _batch(10)
    hard_toks = np.random.default_rng(11).integers(1, 101, (4, 3)).astype(np.int32) \
        if hard else None

    def jloss(p):
        return jpt.prefix_loss(p, jfn, lm, jnp.asarray(feats), jnp.asarray(toks),
                               jnp.asarray(mask), jgpt2.GPT2Config(**LM_GEOM),
                               hard_tokens=None if hard_toks is None else jnp.asarray(hard_toks),
                               loss_chunk=loss_chunk)

    (want, wacc), jgrads = jax.value_and_grad(jloss, has_aux=True)(jmap)
    mapper, lm_t = bridge.to_torch(jmap), bridge.to_torch(lm)
    for _, leaf in checkpoints.flatten_tree(mapper):
        leaf.requires_grad_(True)
    hard_t = None if hard_toks is None else torch.from_numpy(hard_toks)
    loss, acc = pt.prefix_loss(mapper, pfn, lm_t, torch.from_numpy(feats),
                               torch.from_numpy(toks), torch.from_numpy(mask),
                               gpt2.GPT2Config(**LM_GEOM), hard_tokens=hard_t,
                               loss_chunk=loss_chunk)
    loss.backward()
    _close(loss, want)
    _close(acc, wacc)
    _leaves_close(mapper, jgrads, grads=True)
    assert all(leaf.grad is None for _, leaf in checkpoints.flatten_tree(lm_t))


@pytest.mark.parametrize("name", MAPPERS)
def test_three_prefix_steps_match_jax(lm, name):
    """Three updates under prefix_cli's optimizer (optax.adamw, weight
    decay 0, a 1-step warmup), ViECap's noise on the same draws; the
    GPT-2 stays as it was."""
    jmap, jfn, pfn = _mapper(name)
    cfg = dict(lr=1e-3, warmup_steps=1, total_steps=10,
               noise_variance=0.016 if name == "viecap" else 0.0, loss_chunk=4)
    sched = optax.join_schedules([optax.linear_schedule(0.0, 1e-3, 1),
                                  optax.linear_schedule(1e-3, 0.0, 9)], [1])
    tx = optax.adamw(sched, weight_decay=0.0)
    jstep = jpt.make_prefix_train_step(jfn, jgpt2.GPT2Config(**LM_GEOM),
                                       jpt.PrefixTrainConfig(**cfg), tx)
    jstate = tx.init(jmap)
    mapper, lm_t = bridge.to_torch(jmap), bridge.to_torch(lm)
    state = dt.AdamW(dt.linear_warmup_decay(1e-3, 1, 10), 0.0).init(mapper)
    pstep = pt.make_prefix_train_step(pfn, gpt2.GPT2Config(**LM_GEOM),
                                      pt.PrefixTrainConfig(**cfg))
    wte = lm_t["wte"].clone()
    for i in range(3):
        feats, toks, mask = _batch(20 + i)
        key = jax.random.PRNGKey(30 + i)
        draw = np.array(jax.random.normal(key, feats.shape, jnp.float32))
        jmap, jstate, jm = jstep(jmap, jstate, lm, jnp.asarray(feats), jnp.asarray(toks),
                                 jnp.asarray(mask), key)
        mapper, state, m = pstep(mapper, state, lm_t, torch.from_numpy(feats),
                                 torch.from_numpy(toks), torch.from_numpy(mask),
                                 noise=torch.from_numpy(draw))
        _close(m["loss"], jm["loss"])
        _close(m["acc"], jm["acc"])
    _leaves_close(mapper, jmap)
    assert torch.equal(lm_t["wte"], wte) and not lm_t["wte"].requires_grad


# ------------------------------------------------------------------- CLI

CLI_LM = dict(vocab_size=101, n_positions=1024, n_embd=32, n_layer=1, n_head=2)
WIDTH = 384  # ViT-S/14's width: the features of a DINOv2 + mapper model


@pytest.fixture
def tiny_base(monkeypatch):
    monkeypatch.setattr(gpt2, "GPT2_BASE_CONFIG", gpt2.GPT2Config(**CLI_LM))


def _corpus(tmp_path, n=16):
    anns = [{"image_id": i, "caption": f"a photo of thing {i} on a table"} for i in range(n)]
    p = tmp_path / "caps.json"
    p.write_text(json.dumps({"annotations": anns}))
    fp = tmp_path / "feats.npy"
    np.save(fp, _np(60, n, WIDTH))
    return str(p), str(fp)


def _cli(model, p, fp, out, *extra):
    prefix_cli.main(["--model", model, "--data", p, "--features", fp, "--out_dir", str(out),
                     "--epochs", "1", "--bs", "8", "--n_layer", "1", "--n_head", "2",
                     "--n_embd", "32", "--vocab_size", "101", "--max_seq_len", "12",
                     "--allow_random", "--device", "cpu", *extra])


def _model_config(**block):
    return {"dino_model": "dinov2_vits14_reg", "crop_dim": 56, "prefix_size": WIDTH,
            "normalize": True, "support_memory_size": 0,
            "dino_geometry": {"depth": 1, "pos_grid": 4},
            "decap_arch": {"n_layer": 1, "n_head": 2, "n_embd": 32, "vocab_size": 101},
            **block}


def _captions(model):
    imgs = np.random.default_rng(3).integers(0, 256, (2, 56, 56, 3), dtype=np.uint8)
    caps = model.forward(imgs, get_cls_capt=True)["cls_capt"]
    assert len(caps) == 2 and all(isinstance(c, str) for c in caps)


def test_viecap_cli_trains_resumes_and_serves(tmp_path, tiny_base):
    p, fp = _corpus(tmp_path)
    out = tmp_path / "viecap_ckpt"
    _cli("viecap", p, fp, out, "--num_layers", "2", "--limit_steps", "1")
    assert (out / "train_log.csv").exists()
    assert json.load(open(out / "mapper_meta.json"))["model"] == "viecap"
    mgr = checkpoints.CheckpointManager(str(out))
    assert mgr.latest_step() == 1
    _cli("viecap", p, fp, out, "--num_layers", "2", "--limit_steps", "2", "--resume")
    assert mgr.latest_step() == 2 and mgr.restore()["opt_state"]["count"] == 2
    trained = mgr.restore()["params"]
    assert trained["layers"][0]["to_queries"]["b"] is None
    # no ViT-B/16 vgoi entity embeddings are vendored: WIDTH-wide ones are drawn
    m = Patchioner.from_config(
        _model_config(clip_model_name="ViT-B/16",
                      viecap={"weight_path": str(out), "clip_hidden_size": WIDTH,
                              "using_greedy_search": True}),
        allow_missing_weights=True, device="cpu")
    assert torch.equal(m.viecap.mapping_params["linear"]["w"], trained["linear"]["w"])
    assert len(m.viecap.mapping_params["layers"]) == 2
    _captions(m)


def test_clipcap_cli_trains_and_serves(tmp_path, tiny_base):
    p, fp = _corpus(tmp_path)
    out = tmp_path / "clipcap_ckpt"
    _cli("clipcap", p, fp, out, "--prefix_length", "3", "--noise", "0.0",
         "--limit_steps", "1", "--loss_chunk", "4")
    trained = checkpoints.CheckpointManager(str(out)).restore()["params"]
    assert set(trained) == {"fc1", "fc2"}
    block = {"weight_path": str(out), "prefix_length": 3, "entry_length": 8}
    m = Patchioner.from_config(_model_config(clipcap=block), allow_missing_weights=True,
                               device="cpu")
    assert torch.equal(m.clipcap.mapper_params["fc1"]["w"], trained["fc1"]["w"])
    _captions(m)
    # a directory of the other family, and a transformer config, refused
    vdir = tmp_path / "viecap_ckpt"
    _cli("viecap", p, fp, vdir, "--num_layers", "1", "--limit_steps", "1")
    with pytest.raises(ValueError, match="clipcap.weight_path"):
        Patchioner.from_config(_model_config(clipcap=dict(block, weight_path=str(vdir))),
                               allow_missing_weights=True, device="cpu")
    with pytest.raises(ValueError, match="mapping_type"):
        Patchioner.from_config(_model_config(clipcap=dict(block, mapping_type="transformer")),
                               allow_missing_weights=True, device="cpu")
    with pytest.raises(SystemExit):
        prefix_cli.main(["--model", "clipcap", "--data", p, "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="item 13"):
        prefix_cli.main(["--model", "clipcap", "--data", p, "--features", fp, "--dp", "2"])
