"""Port's KV-cached GPT-2 step and DeCap greedy decode against the JAX
package: same weights through the bridge, same prefix, f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchioner_tpu.models import decap as jdecap
from patchioner_tpu.models import gpt2 as jgpt2
from patchioner_tpu_torch.io import bridge
from patchioner_tpu_torch.models import decap, gpt2

GEOM = dict(vocab_size=1000, n_positions=64, n_embd=128, n_layer=2, n_head=4)


def _decoder(seed):
    params = jdecap.init_decap(jax.random.PRNGKey(seed), jgpt2.GPT2Config(**GEOM),
                               prefix_size=96)
    return params, bridge.decap_from_jax(params)


def test_gpt2_step_logits_and_cache_match_jax():
    jparams, params = _decoder(0)
    emb = np.random.default_rng(0).standard_normal((3, 128)).astype(np.float32)
    jcfg, cfg = jgpt2.GPT2Config(**GEOM), gpt2.GPT2Config(**GEOM)
    jcache = jgpt2.init_kv_cache(jcfg, 3, 8)
    cache = gpt2.init_kv_cache(cfg, 3, 8)
    for _ in range(3):  # three steps: the cache carries positions 0..2
        jlogits, jcache = jgpt2.gpt2_step(jparams.gpt2, jnp.asarray(emb), jcache, jcfg)
        logits, cache = gpt2.gpt2_step(params.gpt2, torch.from_numpy(emb), cache, cfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=1e-5, atol=1e-5)
    assert cache.length == int(jcache.length) == 3
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_decode_is_token_exact_with_jax(seed):
    jparams, params = _decoder(seed)
    prefix = np.random.default_rng(seed).standard_normal((4, 96)).astype(np.float32)
    jtok, jscore = jdecap.greedy_decode(jparams, jnp.asarray(prefix),
                                        jgpt2.GPT2Config(**GEOM))
    tok, score = decap.greedy_decode(params, torch.from_numpy(prefix),
                                     gpt2.GPT2Config(**GEOM))
    assert tok.shape == (4, decap.ENTRY_LENGTH)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), rtol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_decoder_is_token_exact_with_the_eager_loop_and_jax(seed):
    jparams, params = _decoder(seed)
    prefix = np.random.default_rng(seed + 2).standard_normal((5, 96)).astype(np.float32)
    cfg = gpt2.GPT2Config(**GEOM)
    jtok, jscore = jdecap.greedy_decode(jparams, jnp.asarray(prefix),
                                        jgpt2.GPT2Config(**GEOM))
    eager = decap.greedy_decode(params, torch.from_numpy(prefix), cfg)
    tok, score = decap.GreedyDecoder(params, cfg)(torch.from_numpy(prefix))
    # on CPU tensors the object runs the eager loop: the same bits
    torch.testing.assert_close((tok, score), eager, rtol=0, atol=0)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), rtol=1e-4)


def test_greedy_decoder_casts_its_weights_once(monkeypatch):
    from patchioner_tpu_torch.models import vit

    _, params = _decoder(2)
    cfg = gpt2.GPT2Config(**GEOM, dtype=torch.bfloat16)
    decoder = decap.GreedyDecoder(params, cfg, n_steps=6)
    leaves = [decoder.params.gpt2["wte"], decoder.params.gpt2["wpe"],
              *(t for blk in decoder.params.gpt2["blocks"] for p in blk.values()
                for t in ([p["scale"], p["bias"]] if "scale" in p else
                          [q[k] for q in p.values() for k in ("w", "b")]))]
    assert len(leaves) == 2 + GEOM["n_layer"] * 12
    assert all(t.dtype == torch.bfloat16 for t in leaves)
    assert decoder.params.clip_project["w"].dtype == torch.float32
    prefix = torch.from_numpy(
        np.random.default_rng(3).standard_normal((2, 96)).astype(np.float32))
    want = decap.greedy_decode(params, prefix, cfg, 6)

    def no_cast(*args, **kw):
        raise AssertionError("the decoder cast its weights again")

    monkeypatch.setattr(vit, "cast_params", no_cast)
    for _ in range(2):
        torch.testing.assert_close(decoder(prefix), want, rtol=0, atol=0)
    assert (decoder.captures, decoder.replays) == (0, 0)  # no graph on the CPU


def test_caption_step_decodes_alike_with_and_without_the_decoder_object():
    from patchioner_tpu_torch import entry
    from patchioner_tpu_torch.models import vit
    from patchioner_tpu_torch.ops import memory_projection as mp

    vcfg = vit.ViTConfig(img_size=56, embed_dim=96, depth=1, num_heads=2,
                         num_registers=4, extract_heads=4, pos_grid=4)
    cfg = gpt2.GPT2Config(**GEOM)
    gen = torch.Generator().manual_seed(3)
    _, params = _decoder(3)
    state = entry.make_state(vit.init_vit(vcfg, gen), params,
                             mp.prepare_bank(torch.randn(64, 96, generator=gen)))
    inputs = entry.example_inputs(batch=3, img=56, n_pts=8, seed=4, device="cpu")
    step = entry.make_caption_step(vcfg, cfg, 64)
    want = step(state, *inputs)
    decoder = decap.GreedyDecoder(params, cfg)
    got = step(dict(state, decode=decoder), *inputs)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="steps"):
        entry.make_caption_step(vcfg, cfg, 64, n_steps=5)(dict(state, decode=decoder),
                                                          *inputs)
