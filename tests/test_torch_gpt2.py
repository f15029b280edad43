"""The port's GPT-2 passes (`patchioner_tpu_torch/models/gpt2.py`) against
the JAX package's: the same bridged weights and numpy-seeded inputs through
`gpt2_hidden`, `gpt2_hidden_packed`, `gpt2_forward`, `gpt2_prefill`,
`gpt2_candidates_step` and `commit_candidate`, and the port's own
identities between them.

Tolerance: max |port - JAX| <= tol * max |JAX|, 1e-5 at float32, where
only the order of f32 sums differs, and 2e-2 at bfloat16, where the two
frameworks may round a product on either side of a bf16 boundary (2^-8
relative) a few times over two layers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import jax

from patchioner_tpu.models import gpt2 as jgpt2
from patchioner_tpu_torch.io import bridge
from patchioner_tpu_torch.models import gpt2

GEOM = dict(vocab_size=1000, n_positions=64, n_embd=128, n_layer=2, n_head=4)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = list(TOL)


def _cfgs(dtype):
    return (jgpt2.GPT2Config(**GEOM, dtype=getattr(jnp, dtype)),
            gpt2.GPT2Config(**GEOM, dtype=getattr(torch, dtype)))


@pytest.fixture(scope="module")
def weights():
    jparams = jgpt2.init_gpt2(jax.random.PRNGKey(0), jgpt2.GPT2Config(**GEOM))
    # LN away from its identity init, so that its parameters are exercised
    rng = np.random.default_rng(1)
    for p in [b[k] for b in jparams["blocks"] for k in ("ln_1", "ln_2")] + [jparams["ln_f"]]:
        p["scale"] = jnp.asarray(rng.uniform(0.5, 1.5, 128).astype(np.float32))
        p["bias"] = jnp.asarray(rng.normal(0, 0.1, 128).astype(np.float32))
    return jparams, bridge.to_torch(jparams)


def _embeds(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, dtype):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.max(np.abs(got - want)) <= TOL[dtype] * np.max(np.abs(want))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pos_offset", [0, 5])
def test_gpt2_hidden_matches_jax(weights, dtype, pos_offset):
    jparams, params = weights
    jcfg, cfg = _cfgs(dtype)
    x = _embeds(2, 3, 7, 128)
    want = jgpt2.gpt2_hidden(jparams, jnp.asarray(x), jcfg, pos_offset)
    got = gpt2.gpt2_hidden(params, torch.from_numpy(x), cfg, pos_offset)
    assert got.dtype == cfg.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gpt2_hidden_packed_matches_jax(weights, dtype):
    jparams, params = weights
    jcfg, cfg = _cfgs(dtype)
    x = _embeds(3, 2, 9, 128)
    # row 0: two segments and two padding slots; row 1: one segment, no pad
    seg = np.array([[1, 1, 1, 1, 2, 2, 2, 0, 0], [1] * 9], np.int32)
    pos = np.array([[0, 1, 2, 3, 0, 1, 2, 0, 0], list(range(9))], np.int32)
    want = jgpt2.gpt2_hidden_packed(jparams, jnp.asarray(x), jnp.asarray(seg),
                                    jnp.asarray(pos), jcfg)
    got = gpt2.gpt2_hidden_packed(params, torch.from_numpy(x), torch.from_numpy(seg).long(),
                                  torch.from_numpy(pos).long(), cfg)
    _close(got, want, dtype)


def test_gpt2_hidden_packed_segments_see_what_they_see_alone(weights):
    _, params = weights
    cfg = gpt2.GPT2Config(**GEOM)
    x = torch.from_numpy(_embeds(4, 1, 7, 128))
    seg = torch.tensor([[1, 1, 1, 2, 2, 2, 2]])
    pos = torch.tensor([[0, 1, 2, 0, 1, 2, 3]])
    packed = gpt2.gpt2_hidden_packed(params, x, seg, pos, cfg)
    alone = [gpt2.gpt2_hidden(params, x[:, :3], cfg), gpt2.gpt2_hidden(params, x[:, 3:], cfg)]
    torch.testing.assert_close(packed, torch.cat(alone, 1), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gpt2_forward_matches_jax(weights, dtype):
    jparams, params = weights
    jcfg, cfg = _cfgs(dtype)
    x = _embeds(5, 2, 6, 128)
    want = jgpt2.gpt2_forward(jparams, jnp.asarray(x), jcfg)
    got = gpt2.gpt2_forward(params, torch.from_numpy(x), cfg)
    assert got.dtype == torch.float32 and got.shape == (2, 6, GEOM["vocab_size"])
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("return_hidden", [False, True])
def test_gpt2_prefill_matches_jax(weights, dtype, return_hidden):
    jparams, params = weights
    jcfg, cfg = _cfgs(dtype)
    x = _embeds(6, 3, 5, 128)
    want = jgpt2.gpt2_prefill(jparams, jnp.asarray(x), jcfg, 12, return_hidden=return_hidden)
    got = gpt2.gpt2_prefill(params, torch.from_numpy(x), cfg, 12, return_hidden=return_hidden)
    assert len(got) == len(want) == 2 + return_hidden
    _close(got[0], want[0], dtype)
    cache, jcache = got[1], want[1]
    assert cache.length == int(jcache.length) == 5
    assert cache.k.shape == (2, 3, 4, 12, 32) and cache.k.dtype == cfg.dtype
    for a, b in ((cache.k, jcache.k), (cache.v, jcache.v)):
        _close(a, b, dtype)
        assert not a[:, :, :, 5:].any()  # positions past the prompt stay empty
    if return_hidden:
        assert got[2].dtype == torch.float32
        _close(got[2], want[2], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gpt2_candidates_step_and_commit_match_jax(weights, dtype):
    jparams, params = weights
    jcfg, cfg = _cfgs(dtype)
    prompt, cands = _embeds(7, 2, 4, 128), _embeds(8, 2, 3, 128)
    _, jcache = jgpt2.gpt2_prefill(jparams, jnp.asarray(prompt), jcfg, 8)
    _, cache = gpt2.gpt2_prefill(params, torch.from_numpy(prompt), cfg, 8)
    want = jgpt2.gpt2_candidates_step(jparams, jnp.asarray(cands), jcache, jcfg)
    got = gpt2.gpt2_candidates_step(params, torch.from_numpy(cands), cache, cfg)
    for g, w in zip(got, want):
        _close(g, w, dtype)
    assert got[0].dtype == got[1].dtype == torch.float32
    assert got[2].shape == (2, 2, 3, 4, 32)
    select = np.array([2, 0], np.int32)
    jcommitted = jgpt2.commit_candidate(jcache, want[2], want[3], jnp.asarray(select))
    committed = gpt2.commit_candidate(cache, got[2], got[3], torch.from_numpy(select).long())
    assert committed.length == int(jcommitted.length) == 5
    _close(committed.k, jcommitted.k, dtype)
    _close(committed.v, jcommitted.v, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_then_step_gives_the_forward_logits(weights, dtype):
    _, params = weights
    cfg = gpt2.GPT2Config(**GEOM, dtype=getattr(torch, dtype))
    x = torch.from_numpy(_embeds(9, 2, 6, 128))
    want = gpt2.gpt2_forward(params, x, cfg)
    logits, cache = gpt2.gpt2_prefill(params, x[:, :4], cfg, 8)
    _close(logits, want[:, 3].numpy(), dtype)
    cast = gpt2._cast(params, cfg.dtype)  # gpt2_step takes the tree cast
    for t in (4, 5):
        logits, cache = gpt2.gpt2_step(cast, x[:, t], cache, cfg)
        _close(logits, want[:, t].numpy(), dtype)
    assert cache.length == 6


@pytest.mark.parametrize("dtype", DTYPES)
def test_candidates_then_commit_is_a_step_on_the_chosen_token(weights, dtype):
    _, params = weights
    cfg = gpt2.GPT2Config(**GEOM, dtype=getattr(torch, dtype))
    prompt = torch.from_numpy(_embeds(10, 2, 3, 128))
    cands = torch.from_numpy(_embeds(11, 2, 4, 128))
    select = torch.tensor([3, 1])
    _, shared = gpt2.gpt2_prefill(params, prompt, cfg, 6)
    _, stepped = gpt2.gpt2_prefill(params, prompt, cfg, 6)
    logits, _, cand_k, cand_v = gpt2.gpt2_candidates_step(params, cands, shared, cfg)
    assert shared.length == 3 and not shared.k[:, :, :, 3:].any()  # read, never written
    committed = gpt2.commit_candidate(shared, cand_k, cand_v, select)
    chosen = cands[torch.arange(2), select]
    want, stepped = gpt2.gpt2_step(gpt2._cast(params, cfg.dtype), chosen, stepped, cfg)
    _close(logits[torch.arange(2), select], want.numpy(), dtype)
    assert committed.length == stepped.length == 4
    _close(committed.k, stepped.k.float().numpy(), dtype)
    _close(committed.v, stepped.v.float().numpy(), dtype)
