"""CLIP ViT vision and text towers in PyTorch.

Twin of `patchioner_tpu/models/clip.py`. The vision half: the config
(`ClipVisionConfig`), `clip_visual_forward` with every option the
backbone family needs (`skip_last_layers`; `diag_last_layers`, INViTE's
diagonal-only attention; `alpha`, AlphaCLIP's one-channel conv added to
the patch embedding; `skip_ln_post`, OpenCLIP's projection of the tokens
before `ln_post`; the stored position grid resized bicubic to a larger
one), the porters of the transformers layout (`port_hf_clip_vision`) and
of the openai/CLIP layout (`port_openai_clip_vision`, with AlphaCLIP's
`conv1_alpha`), and seeded random init (`init_clip_vision`,
`init_alpha_embed`). The text half: `ClipTextConfig`, `clip_text_forward`
(the causal tower, pooled at the first EOT token and projected), the
porters of the openai/CLIP layout under any key prefix
(`port_openai_clip_text`: OpenAI CLIP, open_clip, RegionCLIP, DenseCLIP
and DINO.txt store their text towers so) and of the transformers layout
(`port_hf_clip_text`), and `init_clip_text`. Parameters are a nested dict
of tensors in the JAX package's layout (dense weights stored (in, out));
`io.bridge` converts a JAX tree.

Both towers run as plain PyTorch, as the JAX package runs them as plain
XLA (no Pallas kernel), in the JAX package's order of operations: weights
cast once when the config's type is below f32, LN with f32 statistics (eps
1e-5) whatever the activation type, q scaled by head_dim^-0.5 before
q k^T, the logits cast to f32 (the text tower's causal mask fills -1e30
there) for the softmax and the weights cast back, the quick-GELU MLP.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import torch

from patchioner_tpu_torch.io.torch_port import _linear, _ln as _port_ln, _patch_conv_to_dense, _t
from patchioner_tpu_torch.models import vit

__all__ = ["ClipVisionConfig", "ClipTextConfig", "clip_visual_forward",
           "clip_text_forward", "port_hf_clip_vision", "port_openai_clip_vision",
           "port_openai_clip_text", "port_hf_clip_text", "init_clip_vision",
           "init_clip_text", "init_alpha_embed", "param_template", "text_param_template"]


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    img_size: int = 224
    patch_size: int = 16
    width: int = 768
    depth: int = 12
    heads: int = 12
    proj_dim: int = 512
    ln_eps: float = 1e-5
    dtype: torch.dtype = torch.float32

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_tokens(self) -> int:
        return 1 + self.grid_size ** 2


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    depth: int = 12
    heads: int = 8
    proj_dim: int = 512
    ln_eps: float = 1e-5
    eot_token: int = 49407
    dtype: torch.dtype = torch.float32


def _ln(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    """LayerNorm with f32 statistics whatever the activation type, the
    result in the activation type (`clip.py:76`)."""
    xs = x.float()
    mu = xs.mean(dim=-1, keepdim=True)
    var = (xs - mu).square().mean(dim=-1, keepdim=True)
    y = (xs - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def _dense(x: torch.Tensor, p: dict) -> torch.Tensor:
    return torch.matmul(x, p["w"]) + p["b"]


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _resblock(x: torch.Tensor, blk: dict, heads: int, eps: float,
              diag_attn: bool = False,
              causal_mask: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One residual block; (x, the block's fused qkv). Under `diag_attn`
    every token attends to itself alone, so the attention output is its
    value vector; a (T, T) bool `causal_mask` keeps the logits where it is
    True and sets the others to -1e30 in f32 (`clip.py:107-136`)."""
    b, t, d = x.shape
    hd = d // heads
    qkv = _dense(_ln(x, blk["ln_1"], eps), blk["qkv"])  # fused (D, 3D)
    if diag_attn:
        a = qkv[..., 2 * d:]
    else:
        q, k, v = qkv.reshape(b, t, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
        logits = torch.matmul(q * hd ** -0.5, k.transpose(-1, -2)).float()
        if causal_mask is not None:
            logits = logits.masked_fill(~causal_mask, -1e30)
        w = torch.softmax(logits, dim=-1).to(x.dtype)
        a = torch.matmul(w, v).transpose(1, 2).reshape(b, t, d)
    x = x + _dense(a, blk["out_proj"])
    h = _ln(x, blk["ln_2"], eps)
    x = x + _dense(_quick_gelu(_dense(h, blk["fc1"])), blk["fc2"])
    return x, qkv


def _patches(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, G * G, P * P * C): each patch row-major, channel
    last, the order the porters lay the patch conv out in."""
    b, hh, _, c = x.shape
    g = hh // p
    return x.reshape(b, g, p, g, p, c).permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p * p * c)


def clip_visual_forward(params: dict, pixels: torch.Tensor, cfg: ClipVisionConfig,
                        skip_last_layers: int = 0, diag_last_layers: int = 0,
                        alpha: Optional[torch.Tensor] = None,
                        skip_ln_post: bool = False) -> dict:
    """(B, H, W, 3) normalised NHWC pixels -> x_norm_clstoken (B, P),
    x_norm_patchtokens (B, G * G, P) (projected to `proj_dim`),
    tokens_preproj (B, T, D) and qkv_last (B, T, 3D), the last block's
    fused qkv. `alpha` (B, H, W, 1) is AlphaCLIP's region mask
    (`clip.py:142-208`)."""
    b, hh, _, _ = pixels.shape
    g = hh // cfg.patch_size
    params = vit.cast_params(params, cfg.dtype)
    x = torch.matmul(_patches(pixels.to(cfg.dtype), cfg.patch_size), params["patch_embed_w"])
    if alpha is not None:
        x = x + torch.matmul(_patches(alpha.to(cfg.dtype), cfg.patch_size),
                             params["alpha_embed_w"])
    cls = params["class_embedding"].expand(b, 1, cfg.width)
    pos = params["pos_embed"]
    if pos.shape[1] != 1 + g * g:
        # a checkpoint stores its pretraining grid; a larger runtime grid
        # takes it resized bicubic with size=(g, g), no dinov2 offset
        src = int(round((pos.shape[1] - 1) ** 0.5))
        pos = vit.interpolate_pos_embed(pos, src, g, interpolate_offset=0.0)
    x = torch.cat([cls, x], dim=1) + pos
    x = _ln(x, params["ln_pre"], cfg.ln_eps)
    depth = len(params["blocks"]) - skip_last_layers
    qkv = None
    for i, blk in enumerate(params["blocks"][:depth]):
        x, qkv = _resblock(x, blk, cfg.heads, cfg.ln_eps,
                           diag_attn=i >= depth - diag_last_layers)
    if not skip_ln_post:
        x = _ln(x, params["ln_post"], cfg.ln_eps)
    proj = torch.matmul(x, params["proj"])
    return {"x_norm_clstoken": proj[:, 0], "x_norm_patchtokens": proj[:, 1:],
            "tokens_preproj": x, "qkv_last": qkv}


def first_eot(tokens: torch.Tensor, eot: int) -> torch.Tensor:
    """(B,) index of each row's first `eot` token, 0 for a row without one,
    as `argmax(tokens == eot)` gives it in JAX; the least index of a match,
    so that no tie rule of `torch.argmax` can change it."""
    t = tokens.shape[-1]
    pos = torch.arange(t, device=tokens.device).expand_as(tokens)
    idx = torch.where(tokens == eot, pos, t).amin(dim=-1)
    return torch.where(idx == t, 0, idx)


def clip_text_forward(params: dict, tokens: torch.Tensor, cfg: ClipTextConfig) -> torch.Tensor:
    """(B, T) int token ids, T <= the context -> (B, proj_dim): the causal
    tower, `ln_final`, the row at the first EOT, the text projection
    (`clip.py:211-230`)."""
    b, t = tokens.shape
    params = vit.cast_params(params, cfg.dtype)
    tokens = tokens.to(device=params["token_embedding"].device, dtype=torch.int64)
    x = params["token_embedding"][tokens] + params["pos_embed"][:t]
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    for blk in params["blocks"]:
        x, _ = _resblock(x, blk, cfg.heads, cfg.ln_eps, causal_mask=causal)
    x = _ln(x, params["ln_final"], cfg.ln_eps)
    pooled = x[torch.arange(b, device=x.device), first_eot(tokens, cfg.eot_token)]
    return torch.matmul(pooled, params["text_projection"])


# -------------------------------------------------------------------- port


def _block(ln_1: dict, qkv: dict, out_proj: dict, ln_2: dict, fc1: dict, fc2: dict) -> dict:
    return {"ln_1": ln_1, "qkv": qkv, "out_proj": out_proj, "ln_2": ln_2, "fc1": fc1,
            "fc2": fc2}


def _hf_block(sd: Mapping, p: str) -> dict:
    """A transformers CLIPEncoderLayer: q, k and v fused into one qkv."""
    att = f"{p}.self_attn"
    return _block(
        _port_ln(sd, f"{p}.layer_norm1"),
        {"w": torch.cat([_t(sd[f"{att}.{k}_proj.weight"]) for k in "qkv"]).t().contiguous(),
         "b": torch.cat([_t(sd[f"{att}.{k}_proj.bias"]) for k in "qkv"])},
        _linear(sd, f"{att}.out_proj"), _port_ln(sd, f"{p}.layer_norm2"),
        _linear(sd, f"{p}.mlp.fc1"), _linear(sd, f"{p}.mlp.fc2"))


def _openai_block(sd: Mapping, q: str) -> dict:
    """An openai/CLIP ResidualAttentionBlock: attn.in_proj_* is the qkv."""
    return _block(
        _port_ln(sd, f"{q}.ln_1"),
        {"w": _t(sd[f"{q}.attn.in_proj_weight"]).t().contiguous(),
         "b": _t(sd[f"{q}.attn.in_proj_bias"])},
        _linear(sd, f"{q}.attn.out_proj"), _port_ln(sd, f"{q}.ln_2"),
        _linear(sd, f"{q}.mlp.c_fc"), _linear(sd, f"{q}.mlp.c_proj"))


def port_hf_clip_vision(sd: Mapping, depth: int) -> dict:
    """A transformers CLIPModel / CLIPVisionModelWithProjection state dict
    (`vision_model.*` and `visual_projection`): q, k and v fused into one
    qkv (`clip.py:274`)."""
    v = "vision_model"
    blocks = [_hf_block(sd, f"{v}.encoder.layers.{i}") for i in range(depth)]
    return {
        "patch_embed_w": _patch_conv_to_dense(_t(sd[f"{v}.embeddings.patch_embedding.weight"])),
        "class_embedding": _t(sd[f"{v}.embeddings.class_embedding"]).reshape(1, 1, -1),
        "pos_embed": _t(sd[f"{v}.embeddings.position_embedding.weight"])[None],
        "ln_pre": _port_ln(sd, f"{v}.pre_layrnorm"),
        "blocks": blocks,
        "ln_post": _port_ln(sd, f"{v}.post_layernorm"),
        "proj": _t(sd["visual_projection.weight"]).t().contiguous(),
    }


def port_openai_clip_vision(sd: Mapping, depth: int, prefix: str = "visual.") -> dict:
    """An openai/CLIP-layout visual tower under `prefix` (the layout of
    AlphaCLIP, INViTE, OpenCLIP and DenseCLIP checkpoints): conv1,
    class_embedding, positional_embedding, ln_pre / ln_post, proj (stored
    (D, proj) already), transformer.resblocks.N with attn.in_proj_* and
    mlp.c_fc / c_proj; AlphaCLIP's conv1_alpha when present
    (`clip.py:444`)."""

    def g(key):
        return _t(sd[prefix + key])

    params = {
        "patch_embed_w": _patch_conv_to_dense(g("conv1.weight")),
        "class_embedding": g("class_embedding").reshape(1, 1, -1),
        "pos_embed": g("positional_embedding")[None],
        "ln_pre": _port_ln(sd, f"{prefix}ln_pre"),
        "ln_post": _port_ln(sd, f"{prefix}ln_post"),
        "proj": g("proj"),
        "blocks": [],
    }
    if prefix + "conv1_alpha.weight" in sd:
        params["alpha_embed_w"] = _patch_conv_to_dense(g("conv1_alpha.weight"))
    for i in range(depth):
        params["blocks"].append(_openai_block(sd, f"{prefix}transformer.resblocks.{i}"))
    return params


def port_openai_clip_text(sd: Mapping, depth: int, prefix: str = "") -> dict:
    """An openai/CLIP-layout text tower under `prefix` (token_embedding,
    positional_embedding, transformer.resblocks.N, ln_final and
    text_projection, stored (D, proj) already): the layout of OpenAI CLIP
    and open_clip (no prefix), RegionCLIP ('lang_encoder.'), DenseCLIP
    ('text_encoder.') and DINO.txt ('text_model.'). KeyError naming the
    missing keys when the layout differs (`clip.py:302`)."""
    if prefix:
        sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    missing = [k for k in ("token_embedding.weight", "positional_embedding",
                           "ln_final.weight", "text_projection") if k not in sd]
    if missing:
        raise KeyError(f"openai-clip text port (prefix={prefix!r}): missing {missing}; "
                       f"got e.g. {sorted(sd)[:5]}")
    return {
        "token_embedding": _t(sd["token_embedding.weight"]),
        "pos_embed": _t(sd["positional_embedding"]),
        "ln_final": _port_ln(sd, "ln_final"),
        "text_projection": _t(sd["text_projection"]),
        "blocks": [_openai_block(sd, f"transformer.resblocks.{i}") for i in range(depth)],
    }


def port_hf_clip_text(sd: Mapping, depth: int) -> dict:
    """A transformers CLIPTextModelWithProjection / CLIPModel state dict
    (`text_model.*` and `text_projection`, an `nn.Linear` (proj, D), so
    transposed), q, k and v fused into one qkv (`clip.py:354`)."""
    e = "text_model.embeddings"
    return {
        "token_embedding": _t(sd[f"{e}.token_embedding.weight"]),
        "pos_embed": _t(sd[f"{e}.position_embedding.weight"]),
        "blocks": [_hf_block(sd, f"text_model.encoder.layers.{i}") for i in range(depth)],
        "ln_final": _port_ln(sd, "text_model.final_layer_norm"),
        "text_projection": _t(sd["text_projection.weight"]).t().contiguous(),
    }


# -------------------------------------------------------------------- init


def _ln_leaf(d: int, make) -> dict:
    return {"scale": make("scale", d), "bias": make("bias", d)}


def _blocks(d: int, depth: int, make) -> list:
    def dense(fan_in, fan_out):
        return {"w": make("w", fan_in, fan_out), "b": make("b", fan_out)}

    return [_block(_ln_leaf(d, make), dense(d, 3 * d), dense(d, d), _ln_leaf(d, make),
                   dense(d, 4 * d), dense(4 * d, d)) for _ in range(depth)]


def _tree(cfg: ClipVisionConfig, make, pos_tokens: int) -> dict:
    """The tower's tree with each leaf `make(kind, *shape)`; kind is one of
    'w' (a dense weight, fan-in first), 'b', 'scale', 'bias', 'patch',
    'cls', 'pos', 'proj'."""
    d = cfg.width
    return {
        "patch_embed_w": make("patch", cfg.patch_size ** 2 * 3, d),
        "class_embedding": make("cls", 1, 1, d),
        "pos_embed": make("pos", 1, pos_tokens, d),
        "ln_pre": _ln_leaf(d, make),
        "ln_post": _ln_leaf(d, make),
        "proj": make("proj", d, cfg.proj_dim),
        "blocks": _blocks(d, cfg.depth, make),
    }


def _text_tree(cfg: ClipTextConfig, make) -> dict:
    """The text tower's tree, leaves made as `_tree` makes them ('tok' the
    token embedding)."""
    d = cfg.width
    return {
        "token_embedding": make("tok", cfg.vocab_size, d),
        "pos_embed": make("pos", cfg.context_length, d),
        "ln_final": _ln_leaf(d, make),
        "text_projection": make("proj", d, cfg.proj_dim),
        "blocks": _blocks(d, cfg.depth, make),
    }


def _random_leaf(generator: torch.Generator, device):
    """`make` of the JAX inits' distributions: dense weights and
    projections N(0, 1 / fan_in), position embeddings N(0, 0.01^2), the
    other embeddings N(0, 0.02^2), zero biases, unit LN scales."""

    def make(kind, *shape):
        if kind in ("b", "bias"):
            return torch.zeros(shape, device=device)
        if kind == "scale":
            return torch.ones(shape, device=device)
        x = torch.randn(shape, generator=generator, device=device)
        if kind in ("w", "proj"):
            return x / math.sqrt(shape[0])
        return x * (0.01 if kind == "pos" else 0.02)

    return make


def init_clip_vision(cfg: ClipVisionConfig, generator: torch.Generator, device="cpu") -> dict:
    """Seeded random f32 weights with `init_clip_vision`'s layout and
    distributions (`clip.py:370`); the position grid is the config's."""
    return _tree(cfg, _random_leaf(generator, device), cfg.num_tokens)


def init_clip_text(cfg: ClipTextConfig, generator: torch.Generator, device="cpu") -> dict:
    """Seeded random f32 weights with `init_clip_text`'s layout and
    distributions (`clip.py:409`), drawn from `generator`."""
    return _text_tree(cfg, _random_leaf(generator, device))


def init_alpha_embed(cfg: ClipVisionConfig, generator: torch.Generator,
                     device="cpu") -> torch.Tensor:
    """AlphaCLIP's alpha conv, (P * P, width), drawn when a checkpoint lacks
    `conv1_alpha` (`clip.py:498`)."""
    return torch.randn(cfg.patch_size ** 2, cfg.width, generator=generator,
                       device=device) * 0.02


def param_template(cfg: ClipVisionConfig, pos_tokens: int, alpha: bool = False) -> dict:
    """`init_clip_vision`'s tree as empty meta tensors, for checking a
    loaded tree against the config; `pos_tokens` is the stored position
    grid's tokens (a checkpoint's pretraining grid), `alpha` adds
    `alpha_embed_w`."""
    tree = _tree(cfg, lambda kind, *shape: torch.empty(shape, device="meta"), pos_tokens)
    if alpha:
        tree["alpha_embed_w"] = torch.empty(cfg.patch_size ** 2, cfg.width, device="meta")
    return tree


def text_param_template(cfg: ClipTextConfig) -> dict:
    """`init_clip_text`'s tree as empty meta tensors, for checking a loaded
    text tower against its config."""
    return _text_tree(cfg, lambda kind, *shape: torch.empty(shape, device="meta"))
