"""The port's decoder training (`patchioner_tpu_torch/train/`) against the
JAX package's, on the CPU.

The same bridged parameters and numpy-seeded inputs go through the JAX
functions and their ports: the smoothed and the chunked CE, `decap_loss`
and `decap_loss_packed` (losses and every gradient leaf),
`prepare_features` with a bank and noise on the same standard-normal
draw, optax's learning rate step for step, three optimizer steps with and
without `grad_clip`, the accumulating steps (against JAX's and against one
big batch), `data` and `packing`; then the CLIs, the train directories and
`from_config`.

Tolerances (f32 on both sides, only the order of f32 sums differs):
- losses and accuracies: |port - JAX| <= 1e-5 * max(1, |JAX|);
- a gradient leaf: max |port - JAX| <= 1e-4 * max(1e-3, max |JAX leaf|);
  the gradients pass through up to two GPT-2 layers and a 101-way
  softmax, each a few ulps apart, and the floor keeps a leaf whose
  gradient is ~0 (the wpe rows no position reads) from asking for a
  relative match of rounding noise;
- the params after the steps: max |port - JAX| <= 1e-5 * max(1, max |JAX
  leaf|), the parameters' own scale: Adam divides each gradient by its
  own magnitude, so the rounding noise of a gradient near 0 moves its
  update by a share of the learning rate (1e-3 here), not of the
  gradient;
- the learning rate: equal to optax's to 1e-7 relative (both f32);
- the CLIs' `train_log.csv`: losses and accuracies within 2e-5, one unit
  of the 5 decimals the log keeps plus the f32 noise.
"""

import json
import os
import random
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from patchioner_tpu.io.checkpoints import CheckpointManager as JaxCheckpointManager
from patchioner_tpu.models import decap as jdecap
from patchioner_tpu.models import gpt2 as jgpt2
from patchioner_tpu.train import cli as jcli
from patchioner_tpu.train import data as jdata
from patchioner_tpu.train import decoder_train as jdt
from patchioner_tpu.train import packing as jpacking
from patchioner_tpu_torch.io import bridge, checkpoints
from patchioner_tpu_torch.models import decap, gpt2
from patchioner_tpu_torch.ops import memory_projection as memproj
from patchioner_tpu_torch.train import cli, data, decoder_train as dt, packing

GEOM = dict(vocab_size=101, n_positions=64, n_embd=32, n_layer=2, n_head=2)
PREFIX = 16
LOSS_TOL, GRAD_TOL, GRAD_FLOOR, PARAM_TOL = 1e-5, 1e-4, 1e-3, 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfgs():
    return jgpt2.GPT2Config(**GEOM), gpt2.GPT2Config(**GEOM)


@pytest.fixture(scope="module")
def jparams():
    return jdecap.init_decap(jax.random.PRNGKey(0), jgpt2.GPT2Config(**GEOM), PREFIX)


def _port(jp):
    """A fresh port copy of the JAX params, every leaf requiring grad."""
    p = bridge.decap_from_jax(jp)
    for _, leaf in checkpoints.flatten_tree(p):
        leaf.requires_grad_(True)
    return p


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tokens(seed, b, t, zero_tail=True):
    """(B, T) ids in 1..V-1 with 0-padded tails of varied length."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, GEOM["vocab_size"], (b, t))
    if zero_tail:
        for i in range(b):
            toks[i, rng.integers(2, t + 1):] = 0
    return toks.astype(np.int32)


def _close(got, want, tol=LOSS_TOL):
    got, want = float(got.detach() if torch.is_tensor(got) else got), float(want)
    assert abs(float(got) - want) <= tol * max(1.0, abs(want)), (float(got), want)


def _leaves_close(port_tree, jax_tree, grads=False):
    """Every leaf of a port tree (its .grad when `grads`) against the JAX
    tree's leaf of the same path, under the gradients' or the params'
    gate."""
    want = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(jax_tree)[0]}
    got = dict(checkpoints.flatten_tree(port_tree))
    assert got.keys() == want.keys()
    for name, leaf in got.items():
        g = (leaf.grad if grads else leaf).detach().numpy()
        w = want[name]
        assert g.shape == w.shape, name
        err = np.max(np.abs(g - w))
        bound = (GRAD_TOL * max(GRAD_FLOOR, np.max(np.abs(w))) if grads
                 else PARAM_TOL * max(1.0, np.max(np.abs(w))))
        assert err <= bound, (name, err, np.max(np.abs(w)))


def test_smoothed_ce_matches_jax():
    logits, targets = _np(1, 3, 7, 101), _tokens(2, 3, 7)
    want, jgrad = jax.value_and_grad(lambda x: jdt._smoothed_ce(x, jnp.asarray(targets), 0.1)[0])(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    loss, mask = dt._smoothed_ce(x, torch.from_numpy(targets), 0.1)
    loss.backward()
    _close(loss, want)
    assert torch.equal(mask, torch.from_numpy((targets != 0).astype(np.float32)))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=0,
                               atol=GRAD_TOL * np.abs(np.asarray(jgrad)).max())


@pytest.mark.parametrize("explicit_mask", [False, True])
def test_chunked_ce_matches_jax(explicit_mask):
    """T = 7 in chunks of 3 (a ragged last chunk); the explicit mask scores
    a genuine id 0."""
    hidden, wte, targets = _np(3, 3, 7, 32), _np(4, 101, 32) * 0.3, _tokens(5, 3, 7)
    mask = (np.random.default_rng(6).random((3, 7)) < 0.8).astype(np.float32) \
        if explicit_mask else None

    def jloss(h, w):
        return jdt._smoothed_ce_chunked(h, w, jnp.asarray(targets), 0.1, 3,
                                        mask=None if mask is None else jnp.asarray(mask))

    (want, wacc), (gh, gw) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(hidden), jnp.asarray(wte))
    h = torch.from_numpy(hidden).requires_grad_(True)
    w = torch.from_numpy(wte).requires_grad_(True)
    loss, acc = dt._smoothed_ce_chunked(h, w, torch.from_numpy(targets), 0.1, 3,
                                        mask=None if mask is None else torch.from_numpy(mask))
    loss.backward()
    _close(loss, want)
    _close(acc, wacc)
    for got, ref in ((h.grad, gh), (w.grad, gw)):
        ref = np.asarray(ref)
        assert np.max(np.abs(got.numpy() - ref)) <= GRAD_TOL * np.max(np.abs(ref))


@pytest.mark.parametrize("loss_chunk", [0, 3])
def test_decap_loss_matches_jax(jparams, loss_chunk):
    jcfg, cfg = _cfgs()
    feats, toks = _np(7, 4, PREFIX), _tokens(8, 4, 9)

    def jloss(p):
        return jdt.decap_loss(p, jnp.asarray(feats), jnp.asarray(toks), jcfg,
                              loss_chunk=loss_chunk)

    (want, wacc), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    params = _port(jparams)
    loss, acc = dt.decap_loss(params, torch.from_numpy(feats), torch.from_numpy(toks), cfg,
                              loss_chunk=loss_chunk)
    loss.backward()
    _close(loss, want)
    _close(acc, wacc)
    _leaves_close(params, jgrads, grads=True)


def _pack(seed=9, n=12, t=8, row_len=16):
    """A packed batch of n EOT-terminated captions of lengths 2..t, its
    token ids then folded into the small vocabulary (1..V-1)."""
    rng = np.random.default_rng(seed)
    toks = np.zeros((n, t), np.int32)
    for i in range(n):
        l = int(rng.integers(2, t + 1))
        toks[i, : l - 1] = rng.integers(1, GEOM["vocab_size"], l - 1)
        toks[i, l - 1] = 49407  # EOT, which caption_lengths reads
    pack = packing.pack_captions(toks, row_len, feature_indices=rng.permutation(n),
                                 order=rng.permutation(n))
    fold = lambda a: np.where(a != 0, a % (GEOM["vocab_size"] - 1) + 1, 0).astype(np.int32)
    return pack._replace(input_tokens=fold(pack.input_tokens), targets=fold(pack.targets)), toks


@pytest.mark.parametrize("loss_chunk", [0, 5])
def test_decap_loss_packed_matches_jax(jparams, loss_chunk):
    jcfg, cfg = _cfgs()
    pack, _ = _pack()
    r, s = pack.seg_feature_idx.shape
    seg_feats = _np(10, r, s, PREFIX)
    jpack = jpacking.PackedBatch(*map(jnp.asarray, pack))

    def jloss(p):
        return jdt.decap_loss_packed(p, jnp.asarray(seg_feats), jpack, jcfg,
                                     loss_chunk=loss_chunk)

    (want, wacc), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    params = _port(jparams)
    loss, acc = dt.decap_loss_packed(params, torch.from_numpy(seg_feats),
                                     dt.pack_to_device(pack, "cpu"), cfg, loss_chunk=loss_chunk)
    loss.backward()
    _close(loss, want)
    _close(acc, wacc)
    _leaves_close(params, jgrads, grads=True)


@pytest.mark.parametrize("with_bank", [False, True])
def test_prepare_features_matches_jax(with_bank):
    """The projection (256-row bank, normalize=True), L2 normalize, CapDec
    noise on the draw jax.random.normal gave, re-normalize."""
    feats, bank = _np(11, 5, PREFIX), _np(12, 256, PREFIX)
    key = jax.random.PRNGKey(3)
    want = jdt.prepare_features(jnp.asarray(feats), key=key, gaussian_noise=0.05,
                                bank=jnp.asarray(bank) if with_bank else None)
    draw = np.array(jax.random.normal(key, feats.shape, jnp.float32))
    got = dt.prepare_features(
        torch.from_numpy(feats), gaussian_noise=0.05, noise=torch.from_numpy(draw),
        bank=memproj.prepare_bank(torch.from_numpy(bank)) if with_bank else None)
    want = np.asarray(want)
    assert np.max(np.abs(got.numpy() - want)) <= LOSS_TOL * np.max(np.abs(want))


@pytest.mark.parametrize("lr,warmup,total", [(1e-3, 4, 11), (2e-5, 1000, 100_000),
                                             (1e-5, 0, 7), (3e-4, 5, 3)])
def test_learning_rate_matches_optax(lr, warmup, total):
    sched = optax.join_schedules(
        [optax.linear_schedule(0.0, lr, warmup),
         optax.linear_schedule(lr, 0.0, max(total - warmup, 1))], [warmup])
    port = dt.linear_warmup_decay(lr, warmup, total)
    for count in list(range(0, 20)) + [warmup - 1, warmup, warmup + 1, total, total + 5]:
        if count < 0:
            continue
        want = float(sched(count))
        assert abs(port(count) - want) <= 1e-7 * max(abs(want), 1e-12), (count, port(count), want)


def _train_inputs(accum, seed=13, b=4, t=9):
    shape = (accum, b) if accum > 1 else (b,)
    return _np(seed, *shape, PREFIX), _tokens(seed + 1, int(np.prod(shape)), t).reshape(*shape, t)


@pytest.mark.parametrize("grad_clip", [None, 0.05])
@pytest.mark.parametrize("accum", [1, 2])
def test_three_steps_match_jax(jparams, grad_clip, accum):
    """Three optimizer updates (lr 1e-3 after a 1-step warmup: the first
    update has lr 0), with the chunked loss under accumulation; the clip
    bound sits below the gradients' norm, so it scales them."""
    jcfg, cfg = _cfgs()
    tcfg = dict(lr=1e-3, warmup_steps=1, total_steps=10, grad_clip=grad_clip,
                grad_accum=accum, loss_chunk=4 if accum > 1 else 0)
    tx = jdt.make_optimizer(jdt.TrainConfig(**tcfg))
    jstep = jdt.make_train_step(jcfg, jdt.TrainConfig(**tcfg), tx)
    jp, jstate = jparams, tx.init(jparams)
    params = bridge.decap_from_jax(jparams)
    ptcfg = dt.TrainConfig(**tcfg)
    pstate = dt.make_optimizer(ptcfg).init(params)
    pstep = dt.make_train_step(cfg, ptcfg)
    for i in range(3):
        feats, toks = _train_inputs(accum, seed=20 + i)
        jp, jstate, jm = jstep(jp, jstate, jnp.asarray(feats), jnp.asarray(toks),
                               jax.random.PRNGKey(i))
        params, pstate, pm = pstep(params, pstate, torch.from_numpy(feats),
                                   torch.from_numpy(toks))
        _close(pm["loss"], jm["loss"])
        _close(pm["acc"], jm["acc"])
    _leaves_close(params, jp)


def test_accumulating_step_equals_one_big_batch(jparams):
    """grad_accum 2 over (2, 4) micro-batches gives the plain step's update
    on the (8,) batch."""
    _, cfg = _cfgs()
    feats, toks = _train_inputs(2, seed=30)
    out = []
    for accum, f, t in ((2, feats, toks), (1, feats.reshape(8, PREFIX), toks.reshape(8, -1))):
        tcfg = dt.TrainConfig(lr=1e-3, warmup_steps=0, total_steps=10, grad_accum=accum)
        params = bridge.decap_from_jax(jparams)
        state = dt.make_optimizer(tcfg).init(params)
        params, state, m = dt.make_train_step(cfg, tcfg)(params, state, torch.from_numpy(f),
                                                          torch.from_numpy(t))
        out.append((params, m))
    (pa, ma), (pb, mb) = out
    _close(ma["loss"], mb["loss"])
    _close(ma["acc"], mb["acc"])
    want = {k: v.detach().numpy() for k, v in checkpoints.flatten_tree(pb)}
    for k, v in checkpoints.flatten_tree(pa):
        assert np.max(np.abs(v.detach().numpy() - want[k])) <= \
            PARAM_TOL * max(1.0, np.max(np.abs(want[k]))), k


@pytest.mark.parametrize("accum", [1, 2])
def test_packed_steps_match_jax(jparams, accum):
    """Two updates of the packed step, noise on: the JAX step draws from its
    key, the port takes the same draws."""
    jcfg, cfg = _cfgs()
    tcfg = dict(lr=1e-3, warmup_steps=0, total_steps=10, gaussian_noise=0.1,
                grad_accum=accum, loss_chunk=5)
    tx = jdt.make_optimizer(jdt.TrainConfig(**tcfg))
    jstep = jdt.make_packed_train_step(jcfg, jdt.TrainConfig(**tcfg), tx)
    pack, toks = _pack(n=16)
    rows = (pack.targets.shape[0] // accum) * accum
    pack = packing.PackedBatch(*(cli.microbatch(a[:rows], accum) for a in pack))
    feats = _np(31, len(toks), PREFIX)
    jp, jstate = jparams, tx.init(jparams)
    params = bridge.decap_from_jax(jparams)
    ptcfg = dt.TrainConfig(**tcfg)
    pstate = dt.make_optimizer(ptcfg).init(params)
    pstep = dt.make_packed_train_step(cfg, ptcfg)
    r, s = pack.seg_feature_idx.shape[-2:]
    for i in range(2):
        key = jax.random.PRNGKey(40 + i)
        keys = jax.random.split(key, accum) if accum > 1 else [key]
        draw = np.stack([np.asarray(jax.random.normal(k, (r * s, PREFIX), jnp.float32))
                         for k in keys])
        jp, jstate, jm = jstep(jp, jstate, jnp.asarray(feats),
                               jpacking.PackedBatch(*map(jnp.asarray, pack)), key)
        params, pstate, pm = pstep(params, pstate, torch.from_numpy(feats),
                                   dt.pack_to_device(pack, "cpu"),
                                   noise=torch.from_numpy(draw if accum > 1 else draw[0]))
        _close(pm["loss"], jm["loss"])
        _close(pm["acc"], jm["acc"])
    _leaves_close(params, jp)


def test_data_and_packing_equal_jax():
    caps = [f"a photo of {w} number {i}" for i, w in
            enumerate(["dog", "cat", "small bird", "red car!"] * 6)]
    caps[3] = " ".join(["zebra"] * 30)  # raw-sliced: no EOT
    ids = [i // 3 for i in range(len(caps))]
    jds = jdata.CaptionDataset(caps, ids, max_len=12)
    ds = data.CaptionDataset(caps, ids, max_len=12)
    np.testing.assert_array_equal(ds.tokens, jds.tokens)
    np.testing.assert_array_equal(data.caption_lengths(ds.tokens),
                                  jdata.caption_lengths(jds.tokens))
    np.testing.assert_array_equal(ds.mix_indices(random.Random(0)),
                                  jds.mix_indices(random.Random(0)))
    for kw in ({}, {"num_shards": 3, "shard_index": 1}, {"shuffle": False,
                                                        "drop_remainder": False}):
        for a, b in zip(data.batch_iterator(len(caps), 5, seed=4, **kw),
                        jdata.batch_iterator(len(caps), 5, seed=4, **kw), strict=True):
            np.testing.assert_array_equal(a, b)
    mix = ds.mix_indices(random.Random(1))
    order = np.random.default_rng(2).permutation(len(caps))
    for seg in (None, 3):
        got = packing.pack_captions(ds.tokens, 16, feature_indices=mix, order=order,
                                    max_segments=seg)
        want = jpacking.pack_captions(jds.tokens, 16, feature_indices=mix, order=order,
                                      max_segments=seg)
        for a, b in zip(got, want, strict=True):
            np.testing.assert_array_equal(a, b)
        assert packing.packing_efficiency(got) == jpacking.packing_efficiency(want)
    with pytest.raises(ValueError, match="does not fit"):
        packing.pack_captions(ds.tokens, 4)


def test_train_modules_import_neither_jax_nor_the_jax_package():
    mods = ["data", "packing", "decoder_train", "prefix_train", "cli", "prefix_cli",
            "text_spaces", "extract_features"]
    code = ("import sys\n" + "".join(f"import patchioner_tpu_torch.train.{m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'optax', 'orbax', 'patchioner_tpu'))\n"
              "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=dict(os.environ, PYTHONPATH=REPO))


# ------------------------------------------------------------------ CLIs

CLI_GEOM = ["--n_layer", "2", "--n_head", "2", "--n_embd", "32", "--vocab_size", "50257",
            "--prefix_size", "16", "--max_seq_len", "12"]


def _corpus(tmp_path, n=24, dim=16):
    anns = [{"image_id": i // 3, "caption": f"caption number {i} about a dog"}
            for i in range(n)]
    p = tmp_path / "captions.json"
    p.write_text(json.dumps({"annotations": anns}))
    fp = tmp_path / "features.npy"
    np.save(fp, _np(50, n, dim))
    return str(p), str(fp)


def _log(path):
    return np.loadtxt(path, delimiter=",", ndmin=2)


def _cli_init(monkeypatch):
    """The port CLI's init_decap replaced by the JAX CLI's own init,
    bridged: both runs start from the same params."""
    jcfg = jgpt2.GPT2Config(vocab_size=50257, n_layer=2, n_head=2, n_embd=32)
    init = jdecap.init_decap(jax.random.PRNGKey(0), jcfg, 16)
    monkeypatch.setattr(cli, "init_decap",
                        lambda cfg, prefix, gen, device: bridge.decap_from_jax(init, device))


@pytest.mark.parametrize("n,extra", [(24, ["--mix_captions"]), (48, ["--pack_len", "16"])],
                         ids=["plain", "packed"])
def test_cli_log_matches_jax_cli(tmp_path, monkeypatch, n, extra):
    """Both CLIs from the same init on the same corpus, noise 0, two epochs
    of 3 steps (packed: 2 captions a row, --bs counts rows): the logged
    losses and accuracies agree."""
    _cli_init(monkeypatch)
    p, fp = _corpus(tmp_path, n)
    argv = ["--data", p, "--features", fp, "--epochs", "2", "--bs", "8", "--lr", "1e-3",
            "--warmup", "1", *CLI_GEOM, *extra]
    jcli.main(argv + ["--out_dir", str(tmp_path / "jax")])
    cli.main(argv + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    want, got = _log(tmp_path / "jax" / "train_log.csv"), _log(tmp_path / "port" / "train_log.csv")
    assert want.shape == got.shape == (2, 5)
    np.testing.assert_array_equal(got[:, :2], want[:, :2])  # epoch, step
    np.testing.assert_allclose(got[:, 2:4], want[:, 2:4], rtol=0, atol=2e-5)
    assert checkpoints.CheckpointManager(str(tmp_path / "port")).latest_step() == got[-1, 1]


def test_cli_trains_resumes_and_completes(tmp_path, monkeypatch):
    """Grad accumulation, chunked loss, CapDec noise and --im_proj over an
    HDF5 bank; a resume continues from the saved step, and a resume after
    the run's end trains no further epoch."""
    from patchioner_tpu_torch.io import memory_bank

    p, fp = _corpus(tmp_path)
    bank = str(tmp_path / "bank.h5")
    memory_bank.save_bank(bank, "coco_captions", memory_bank.MemoryBank(
        _np(51, 256, 16), [f"text {i}" for i in range(256)]))
    out = tmp_path / "ckpt"
    argv = ["--data", p, "--features", fp, "--out_dir", str(out), "--epochs", "2",
            "--bs", "8", *CLI_GEOM, "--gaussian_noise", "0.01", "--grad_accum", "2",
            "--loss_chunk", "4", "--im_proj", "--bank", bank, "--device", "cpu"]
    cli.main(argv + ["--limit_steps", "2"])
    mgr = checkpoints.CheckpointManager(str(out))
    assert mgr.latest_step() == 2
    cli.main(argv + ["--resume", "--limit_steps", "4"])
    assert mgr.latest_step() == 4
    state = mgr.restore()
    assert state["step"] == 4 and state["opt_state"]["count"] == 4
    # step 4 rounds down to epoch 1, whose 3 steps end the run at 7
    cli.main(argv + ["--resume"])
    assert mgr.latest_step() == 7
    lines = len(_log(out / "train_log.csv"))
    cli.main(argv + ["--resume"])
    assert mgr.latest_step() == 7 and len(_log(out / "train_log.csv")) == lines
    assert sorted(os.listdir(out)) == ["2", "4", "7", "train_log.csv"]


def test_checkpoint_manager_keeps_three_and_skips_old_steps(tmp_path):
    mgr = checkpoints.CheckpointManager(str(tmp_path), max_to_keep=3)
    params = {"w": torch.arange(3.0)}
    for step in (1, 2, 3, 5):
        assert mgr.save(step, {"params": params, "step": step})
    assert not mgr.save(5, {"params": params, "step": 5})
    assert not mgr.save(4, {"params": params, "step": 4})
    assert sorted(os.listdir(tmp_path)) == ["2", "3", "5"]  # no temporary left
    assert mgr.latest_step() == 5 and mgr.restore(3)["step"] == 3
    live = {"w": torch.zeros(3)}
    checkpoints.restore_into(live, mgr.restore()["params"])
    assert torch.equal(live["w"], params["w"])
    with pytest.raises(ValueError, match="checkpoint"):
        checkpoints.restore_into({"w": torch.zeros(4)}, mgr.restore()["params"])


def test_cli_refuses_what_the_port_lacks(tmp_path):
    """The mesh is refused; a run without features or a tower, an unknown
    text space and a Talk2DINO path naming no file stop before training."""
    p, fp = _corpus(tmp_path)
    base = ["--data", p, "--out_dir", str(tmp_path / "o"), "--device", "cpu", *CLI_GEOM]
    for extra, match in ((["--features", fp, "--dp", "2"], "item 13"),
                         (["--features", fp, "--mp", "2"], "item 13")):
        with pytest.raises(NotImplementedError, match=match):
            cli.main(base + extra)
    with pytest.raises(SystemExit):
        cli.main(base)
    with pytest.raises(SystemExit):
        cli.main(base + ["--encode_on_the_fly", "--text_encoder", "bert"])
    with pytest.raises(FileNotFoundError, match="t.pth"):
        cli.main(base + ["--encode_on_the_fly", "--talk2dino_weights",
                         str(tmp_path / "t.pth")])
    assert not (tmp_path / "o").exists()


# -------------------------------------------------- train dir -> from_config

DINO = {"embed_dim": 64, "depth": 1, "num_heads": 2, "extract_heads": 4, "pos_grid": 4}


def _model_config(decap_weights, prefix=64, **extra):
    return dict({"dino_model": "dinov2_vitb14_reg", "crop_dim": 56, "normalize": True,
                 "support_memory_size": 0, "prefix_size": prefix, "dino_geometry": DINO,
                 "decap_arch": {"n_layer": 2, "n_head": 2, "n_embd": 32,
                                "vocab_size": 50257},
                 "decap_weights": decap_weights}, **extra)


def test_train_dir_serves_through_from_config(tmp_path):
    """The decoder the CLI trained, loaded through `decap_weights: <dir>`,
    captions as the same params held in memory do."""
    from patchioner_tpu_torch.models.patchioner import Patchioner

    p, fp = _corpus(tmp_path, dim=64)  # the encoder's width: no bank
    out = tmp_path / "ckpt"
    cli.main(["--data", p, "--features", fp, "--out_dir", str(out), "--epochs", "1",
              "--bs", "8", "--lr", "1e-2", "--warmup", "0", *CLI_GEOM, "--device", "cpu"])
    trained = checkpoints.CheckpointManager(str(out)).restore()["params"]
    served = Patchioner.from_config(_model_config(str(out)), allow_missing_weights=True,
                                    device="cpu")
    ref = Patchioner.from_config(_model_config(None), allow_missing_weights=True,
                                 device="cpu")
    ref = Patchioner(vit_cfg=ref.vit_cfg, vit_params=ref.vit_params, gpt2_cfg=ref.gpt2_cfg,
                     decoder=decap.DecapParams(**trained), config=ref.config, device="cpu")
    for k, v in checkpoints.flatten_tree(served.decoder):
        assert torch.equal(v, dict(checkpoints.flatten_tree(ref.decoder))[k]), k
    imgs = np.random.default_rng(3).integers(0, 256, (2, 56, 56, 3), dtype=np.uint8)
    got = served.forward(imgs, get_cls_capt=True)["cls_capt"]
    want = ref.forward(imgs, get_cls_capt=True)["cls_capt"]
    assert got == want and all(isinstance(c, str) for c in got)


def test_mismatched_and_orbax_train_dirs_refused(tmp_path):
    from patchioner_tpu_torch.models.patchioner import Patchioner

    p, fp = _corpus(tmp_path)
    out = tmp_path / "ckpt"
    cli.main(["--data", p, "--features", fp, "--out_dir", str(out), "--epochs", "1",
              "--bs", "8", "--limit_steps", "1", *CLI_GEOM, "--device", "cpu"])
    with pytest.raises(ValueError, match="decap_weights=.*prefix_size 768"):
        Patchioner.from_config(_model_config(str(out), prefix=768),
                               allow_missing_weights=True, device="cpu")
    wrong = _model_config(str(out), prefix=16)
    wrong["decap_arch"] = dict(wrong["decap_arch"], n_layer=3)
    with pytest.raises(ValueError, match="decap_weights="):
        Patchioner.from_config(wrong, allow_missing_weights=True, device="cpu")
    orbax = tmp_path / "orbax"
    JaxCheckpointManager(str(orbax)).save(1, {"params": {"w": jnp.ones(3)}, "step": 1})
    with pytest.raises(NotImplementedError, match="Orbax"):
        Patchioner.from_config(_model_config(str(orbax)), allow_missing_weights=True,
                               device="cpu")
    with pytest.raises(FileNotFoundError):
        checkpoints.load_decap_from_train_dir(str(tmp_path / "empty"),
                                              gpt2.GPT2Config(**GEOM), 16)
