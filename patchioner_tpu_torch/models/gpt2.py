"""GPT-2 language model in PyTorch, with a static KV cache.

Twin of `patchioner_tpu/models/gpt2.py`: `GPT2Config`,
`DECAP_DECODER_CONFIG`, `GPT2_BASE_CONFIG`, `init_gpt2`, `KVCache`, `init_kv_cache`, the
decode step `gpt2_step`, the full-sequence passes `gpt2_hidden`,
`gpt2_hidden_packed`, `gpt2_forward` and `gpt2_prefill`, and the shared-
cache candidate step `gpt2_candidates_step` with `commit_candidate`.
Parameters are a nested dict in the JAX package's layout (dense weights
(in, out)). Plain PyTorch: GPT-2 has no kernel in the reference either.

Dtypes follow the JAX functions: each casts the float32 leaves of
`params` to `cfg.dtype` itself, except `gpt2_step`, whose callers (the
DeCap decode) cast the tree once and pass it in `cfg.dtype`. Unlike the
JAX functions, which return a new cache, `gpt2_step` and
`commit_candidate` write the new key and value into the cache in place
(a decode never needs the old cache again), and `KVCache.length` is a
Python int, so every shape and index of a decode is fixed on the host and
the decode can be captured as one CUDA graph.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

__all__ = ["GPT2Config", "DECAP_DECODER_CONFIG", "GPT2_BASE_CONFIG", "init_gpt2", "param_template", "KVCache",
           "init_kv_cache", "gpt2_step", "gpt2_hidden", "gpt2_hidden_packed",
           "gpt2_forward", "gpt2_prefill", "gpt2_candidates_step", "commit_candidate"]


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    ln_eps: float = 1e-5
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


# DeCap's decoder (reference decoder_config.pkl): 4 layers, 4 heads, 768 wide
DECAP_DECODER_CONFIG = GPT2Config(n_layer=4, n_head=4, n_embd=768)
# the full GPT-2 base that ViECap decodes with, in f32
GPT2_BASE_CONFIG = GPT2Config()


def init_gpt2(cfg: GPT2Config, generator: torch.Generator, device="cpu") -> dict:
    """HF GPT2LMHeadModel's init distribution (init_gpt2): N(0, 0.02), the
    residual output projections N(0, 0.02 / sqrt(2 n_layer))."""
    d = cfg.n_embd
    resid_std = 0.02 / (2 * cfg.n_layer) ** 0.5

    def dense(fi, fo, std=0.02):
        return {"w": torch.randn(fi, fo, generator=generator, device=device) * std,
                "b": torch.zeros(fo, device=device)}

    def ln():
        return {"scale": torch.ones(d, device=device),
                "bias": torch.zeros(d, device=device)}

    def randn(*shape):
        return torch.randn(*shape, generator=generator, device=device) * 0.02

    params = {"wte": randn(cfg.vocab_size, d), "wpe": randn(cfg.n_positions, d),
              "ln_f": ln(), "blocks": []}
    for _ in range(cfg.n_layer):
        params["blocks"].append({
            "ln_1": ln(),
            "attn": {"c_attn": dense(d, 3 * d), "c_proj": dense(d, d, resid_std)},
            "ln_2": ln(),
            "mlp": {"c_fc": dense(d, 4 * d), "c_proj": dense(4 * d, d, resid_std)},
        })
    return params


def param_template(cfg: GPT2Config) -> dict:
    """`init_gpt2`'s tree as empty meta tensors of its shapes, for checking
    a loaded tree against the config."""
    d = cfg.n_embd

    def empty(*shape):
        return torch.empty(shape, device="meta")

    def dense(fi, fo):
        return {"w": empty(fi, fo), "b": empty(fo)}

    def ln():
        return {"scale": empty(d), "bias": empty(d)}

    return {"wte": empty(cfg.vocab_size, d), "wpe": empty(cfg.n_positions, d),
            "ln_f": ln(),
            "blocks": [{"ln_1": ln(), "attn": {"c_attn": dense(d, 3 * d), "c_proj": dense(d, d)},
                        "ln_2": ln(), "mlp": {"c_fc": dense(d, 4 * d), "c_proj": dense(4 * d, d)}}
                       for _ in range(cfg.n_layer)]}


class KVCache(NamedTuple):
    k: torch.Tensor  # (L, B, H, T_max, hd)
    v: torch.Tensor  # (L, B, H, T_max, hd)
    length: int      # number of valid positions


def init_kv_cache(cfg: GPT2Config, batch: int, max_len: int,
                  device="cpu") -> KVCache:
    shape = (cfg.n_layer, batch, cfg.n_head, max_len, cfg.head_dim)
    return KVCache(torch.zeros(shape, device=device, dtype=cfg.dtype),
                   torch.zeros(shape, device=device, dtype=cfg.dtype), 0)


def _cast(tree, dtype: torch.dtype):
    """The float32 leaves of a nested dict / list in `dtype`, the others as
    they are (the JAX functions' cast)."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast(v, dtype) for v in tree)
    return tree.to(dtype) if tree.dtype == torch.float32 else tree


def _ln(x, p, eps):
    # f32 statistics whatever the activations' type. The f32 product and
    # sum promote a bf16 scale and bias exactly inside their own kernels:
    # casting them first would add two copy launches a LN (18 a decode step)
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def _dense(x, p):
    return torch.matmul(x, p["w"]) + p["b"]


def _mlp_residual(x, blk, eps):
    """x + the block's MLP (HF's tanh "gelu_new") of LN_2(x)."""
    h = _ln(x, blk["ln_2"], eps)
    return x + _dense(F.gelu(_dense(h, blk["mlp"]["c_fc"]), approximate="tanh"),
                      blk["mlp"]["c_proj"])


def _split_heads(x, n_head):
    """(B, T, D) -> (B, H, T, hd)."""
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head).transpose(1, 2)


def _merge_heads(x):
    """(B, H, T, hd) -> (B, T, H * hd)."""
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def _attn_full(q, k, v, scale, mask=None):
    """Full-sequence attention with f32 logits; `mask` (broadcastable to
    (B, H, Tq, Tk), True = attend) replaces the causal mask. A row with no
    key to attend to sees only -1e30 logits and averages every value, as
    in the reference."""
    t, s = q.shape[-2], k.shape[-2]
    logits = torch.einsum("bhqd,bhkd->bhqk", q * scale, k).float()
    if mask is None:
        mask = torch.ones(t, s, dtype=torch.bool, device=q.device).tril(s - t)
    logits = logits.masked_fill(~mask, -1e30)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)


def _blocks(params: dict, x: torch.Tensor, cfg: GPT2Config, mask=None,
            cache: KVCache | None = None) -> torch.Tensor:
    """The transformer trunk: blocks + final LN over (B, T, D) with the
    positions already added and `params` in cfg.dtype. With `cache`, each
    layer's keys and values are written at its positions 0..T-1."""
    scale = 1.0 / math.sqrt(cfg.head_dim)
    t = x.shape[1]
    for li, blk in enumerate(params["blocks"]):
        h = _ln(x, blk["ln_1"], cfg.ln_eps)
        q, k, v = (_split_heads(u, cfg.n_head) for u in
                   _dense(h, blk["attn"]["c_attn"]).split(cfg.n_embd, dim=-1))
        if cache is not None:
            cache.k[li, :, :, :t] = k.to(cache.k.dtype)
            cache.v[li, :, :, :t] = v.to(cache.v.dtype)
        a = _attn_full(q, k, v, scale, mask)
        x = x + _dense(_merge_heads(a), blk["attn"]["c_proj"])
        x = _mlp_residual(x, blk, cfg.ln_eps)
    return _ln(x, params["ln_f"], cfg.ln_eps)


def gpt2_hidden(params: dict, embeds: torch.Tensor, cfg: GPT2Config,
                pos_offset: int = 0) -> torch.Tensor:
    """Causal forward of (B, T, D) input embeddings at positions
    pos_offset.. -> post-ln_f hidden states (B, T, D) in cfg.dtype."""
    params = _cast(params, cfg.dtype)
    t = embeds.shape[1]
    x = embeds.to(cfg.dtype) + params["wpe"][pos_offset:pos_offset + t]
    return _blocks(params, x, cfg)


def gpt2_hidden_packed(params: dict, embeds: torch.Tensor, segment_ids: torch.Tensor,
                       pos_ids: torch.Tensor, cfg: GPT2Config) -> torch.Tensor:
    """Packed rows (several captions back to back) -> post-ln_f hidden
    states (B, L, D). Position q attends to k iff k <= q and
    segment_ids[q] == segment_ids[k] != 0, and positions are per segment
    (`wpe[pos_ids]`); padding (segment id 0) attends to nothing."""
    params = _cast(params, cfg.dtype)
    t = embeds.shape[1]
    x = embeds.to(cfg.dtype) + params["wpe"][pos_ids]
    causal = torch.ones(t, t, dtype=torch.bool, device=embeds.device).tril()
    seg_ok = ((segment_ids[:, :, None] == segment_ids[:, None, :])
              & (segment_ids[:, None, :] != 0))
    return _blocks(params, x, cfg, mask=(causal & seg_ok)[:, None])


def gpt2_forward(params: dict, embeds: torch.Tensor, cfg: GPT2Config,
                 pos_offset: int = 0) -> torch.Tensor:
    """Full-sequence forward -> f32 logits (B, T, V) through the tied wte
    (HF `GPT2LMHeadModel(inputs_embeds=...)`)."""
    params = _cast(params, cfg.dtype)
    x = gpt2_hidden(params, embeds, cfg, pos_offset)
    return torch.matmul(x, params["wte"].T).float()


def gpt2_prefill(params: dict, embeds: torch.Tensor, cfg: GPT2Config, max_len: int,
                 return_hidden: bool = False):
    """Causal prefill of a (B, T, D) prompt -> f32 last-position logits
    (B, V) and a cache of capacity `max_len` primed at positions 0..T-1
    (`length` T); with `return_hidden` also the post-ln_f hidden states
    (B, T, D) in f32."""
    params = _cast(params, cfg.dtype)
    b, t, _ = embeds.shape
    cache = init_kv_cache(cfg, b, max_len, device=embeds.device)
    x = embeds.to(cfg.dtype) + params["wpe"][:t]
    x = _blocks(params, x, cfg, cache=cache)
    logits = torch.matmul(x[:, -1], params["wte"].T).float()
    cache = KVCache(cache.k, cache.v, t)
    if return_hidden:
        return logits, cache, x.float()
    return logits, cache


def gpt2_step(params: dict, embed: torch.Tensor, cache: KVCache,
              cfg: GPT2Config) -> tuple[torch.Tensor, KVCache]:
    """One decode step: (B, D) embedding at position cache.length -> f32
    logits (B, V) and the cache advanced by one position. `params` must
    already be in cfg.dtype."""
    b, d = embed.shape
    idx = cache.length
    nh, hd = cfg.n_head, cfg.head_dim
    x = (embed.to(cfg.dtype) + params["wpe"][idx])[:, None, :]  # (B, 1, D)
    scale = 1.0 / math.sqrt(hd)
    max_len = cache.k.shape[-2]
    pos_ok = torch.arange(max_len, device=embed.device) <= idx
    for li, blk in enumerate(params["blocks"]):
        h = _ln(x, blk["ln_1"], cfg.ln_eps)
        qkv = _dense(h, blk["attn"]["c_attn"])  # (B, 1, 3D)
        q, k, v = qkv.reshape(b, 3, nh, hd).unbind(1)  # each (B, H, hd)
        cache.k[li, :, :, idx] = k.to(cache.k.dtype)
        cache.v[li, :, :, idx] = v.to(cache.v.dtype)
        logits = torch.einsum("bhd,bhtd->bht", q * scale,
                              cache.k[li].to(q.dtype)).float()
        logits = logits.masked_fill(~pos_ok, -1e30)
        w = torch.softmax(logits, dim=-1).to(x.dtype)
        a = torch.einsum("bht,bhtd->bhd", w, cache.v[li].to(x.dtype))
        x = x + _dense(a.reshape(b, 1, d), blk["attn"]["c_proj"])
        x = _mlp_residual(x, blk, cfg.ln_eps)
    x = _ln(x, params["ln_f"], cfg.ln_eps)
    logits = torch.matmul(x[:, 0], params["wte"].T).float()
    return logits, KVCache(cache.k, cache.v, idx + 1)


def gpt2_candidates_step(params: dict, embeds: torch.Tensor, cache: KVCache,
                         cfg: GPT2Config):
    """K candidate next tokens a sequence against the SHARED cache: (B, K, D)
    embeddings at position cache.length -> f32 logits (B, K, V), f32
    post-ln_f hidden (B, K, D) and each candidate's keys and values
    (L, B, K, H, hd). Each candidate attends to the cache's positions
    before cache.length and to itself; the cache is read, never copied or
    written (`commit_candidate` writes the chosen one)."""
    params = _cast(params, cfg.dtype)
    b, kk, d = embeds.shape
    idx = cache.length
    nh, hd = cfg.n_head, cfg.head_dim
    x = embeds.to(cfg.dtype) + params["wpe"][idx]
    scale = 1.0 / math.sqrt(hd)
    past_ok = torch.arange(cache.k.shape[-2], device=embeds.device) < idx
    cand_k, cand_v = [], []
    for li, blk in enumerate(params["blocks"]):
        h = _ln(x, blk["ln_1"], cfg.ln_eps)
        q, k, v = (u.reshape(b, kk, nh, hd) for u in
                   _dense(h, blk["attn"]["c_attn"]).split(d, dim=-1))
        cand_k.append(k)
        cand_v.append(v)
        past = torch.einsum("bkhd,bhtd->bkht", q * scale,
                            cache.k[li].to(q.dtype)).float()
        past = past.masked_fill(~past_ok, -1e30)
        own = (q * scale * k).sum(-1).float()
        w = torch.softmax(torch.cat([past, own[..., None]], dim=-1), dim=-1).to(x.dtype)
        a = (torch.einsum("bkht,bhtd->bkhd", w[..., :-1], cache.v[li].to(x.dtype))
             + w[..., -1:] * v)
        x = x + _dense(a.reshape(b, kk, d), blk["attn"]["c_proj"])
        x = _mlp_residual(x, blk, cfg.ln_eps)
    x = _ln(x, params["ln_f"], cfg.ln_eps)
    logits = torch.matmul(x, params["wte"].T).float()
    return logits, x.float(), torch.stack(cand_k), torch.stack(cand_v)


def commit_candidate(cache: KVCache, cand_k: torch.Tensor, cand_v: torch.Tensor,
                     select: torch.Tensor) -> KVCache:
    """Write candidate `select` (B,) of each sequence's keys and values at
    position cache.length, in place; the cache advanced by one position."""
    rows = torch.arange(select.shape[0], device=select.device)
    idx = cache.length
    cache.k[:, :, :, idx] = cand_k[:, rows, select].to(cache.k.dtype)
    cache.v[:, :, :, idx] = cand_v[:, rows, select].to(cache.v.dtype)
    return KVCache(cache.k, cache.v, idx + 1)
