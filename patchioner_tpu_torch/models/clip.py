"""CLIP ViT vision tower in PyTorch.

Twin of the vision half of `patchioner_tpu/models/clip.py`: the config
(`ClipVisionConfig`), `clip_visual_forward` with every option the
backbone family needs (`skip_last_layers`; `diag_last_layers`, INViTE's
diagonal-only attention; `alpha`, AlphaCLIP's one-channel conv added to
the patch embedding; `skip_ln_post`, OpenCLIP's projection of the tokens
before `ln_post`; the stored position grid resized bicubic to a larger
one), the porters of the transformers layout (`port_hf_clip_vision`) and
of the openai/CLIP layout (`port_openai_clip_vision`, with AlphaCLIP's
`conv1_alpha`), and seeded random init (`init_clip_vision`,
`init_alpha_embed`). Parameters are a nested dict of tensors in the JAX
package's layout (dense weights stored (in, out)); `io.bridge` converts a
JAX tree.

The tower runs as plain PyTorch, as the JAX package runs it as plain XLA
(no Pallas kernel), in the JAX package's order of operations: LN with f32
statistics (eps 1e-5) whatever the activation type, q scaled by
head_dim^-0.5 before q k^T, the logits cast to f32 for the softmax and the
weights cast back, the quick-GELU MLP.

The text half (`clip_text_forward`, `port_openai_clip_text`,
`port_hf_clip_text`, `init_clip_text`) is not ported yet: ROADMAP queue 1
item 11.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import torch

from patchioner_tpu_torch.io.torch_port import _linear, _ln as _port_ln, _patch_conv_to_dense, _t
from patchioner_tpu_torch.models import vit

__all__ = ["ClipVisionConfig", "clip_visual_forward", "port_hf_clip_vision",
           "port_openai_clip_vision", "init_clip_vision", "init_alpha_embed",
           "param_template"]


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
              diag_attn: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """One residual block; (x, the block's fused qkv). Under `diag_attn`
    every token attends to itself alone, so the attention output is its
    value vector (`clip.py:107-136`)."""
    b, t, d = x.shape
    hd = d // heads
    qkv = _dense(_ln(x, blk["ln_1"], eps), blk["qkv"])  # fused (D, 3D)
    if diag_attn:
        a = qkv[..., 2 * d:]
    else:
        q, k, v = qkv.reshape(b, t, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
        logits = torch.matmul(q * hd ** -0.5, k.transpose(-1, -2)).float()
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


# -------------------------------------------------------------------- port


def _block(ln_1: dict, qkv: dict, out_proj: dict, ln_2: dict, fc1: dict, fc2: dict) -> dict:
    return {"ln_1": ln_1, "qkv": qkv, "out_proj": out_proj, "ln_2": ln_2, "fc1": fc1,
            "fc2": fc2}


def port_hf_clip_vision(sd: Mapping, depth: int) -> dict:
    """A transformers CLIPModel / CLIPVisionModelWithProjection state dict
    (`vision_model.*` and `visual_projection`): q, k and v fused into one
    qkv (`clip.py:274`)."""
    v = "vision_model"
    blocks = []
    for i in range(depth):
        p = f"{v}.encoder.layers.{i}"
        att = f"{p}.self_attn"
        blocks.append(_block(
            _port_ln(sd, f"{p}.layer_norm1"),
            {"w": torch.cat([_t(sd[f"{att}.{k}_proj.weight"]) for k in "qkv"]).t().contiguous(),
             "b": torch.cat([_t(sd[f"{att}.{k}_proj.bias"]) for k in "qkv"])},
            _linear(sd, f"{att}.out_proj"), _port_ln(sd, f"{p}.layer_norm2"),
            _linear(sd, f"{p}.mlp.fc1"), _linear(sd, f"{p}.mlp.fc2")))
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
        q = f"{prefix}transformer.resblocks.{i}"
        params["blocks"].append(_block(
            _port_ln(sd, f"{q}.ln_1"),
            {"w": _t(sd[f"{q}.attn.in_proj_weight"]).t().contiguous(),
             "b": _t(sd[f"{q}.attn.in_proj_bias"])},
            _linear(sd, f"{q}.attn.out_proj"), _port_ln(sd, f"{q}.ln_2"),
            _linear(sd, f"{q}.mlp.c_fc"), _linear(sd, f"{q}.mlp.c_proj")))
    return params


# -------------------------------------------------------------------- init


def _tree(cfg: ClipVisionConfig, make, pos_tokens: int) -> dict:
    """The tower's tree with each leaf `make(kind, *shape)`; kind is one of
    'w' (a dense weight, fan-in first), 'b', 'scale', 'bias', 'patch',
    'cls', 'pos', 'proj'."""
    d = cfg.width

    def dense(fan_in, fan_out):
        return {"w": make("w", fan_in, fan_out), "b": make("b", fan_out)}

    def ln():
        return {"scale": make("scale", d), "bias": make("bias", d)}

    return {
        "patch_embed_w": make("patch", cfg.patch_size ** 2 * 3, d),
        "class_embedding": make("cls", 1, 1, d),
        "pos_embed": make("pos", 1, pos_tokens, d),
        "ln_pre": ln(),
        "ln_post": ln(),
        "proj": make("proj", d, cfg.proj_dim),
        "blocks": [_block(ln(), dense(d, 3 * d), dense(d, d), ln(), dense(d, 4 * d),
                          dense(4 * d, d)) for _ in range(cfg.depth)],
    }


def init_clip_vision(cfg: ClipVisionConfig, generator: torch.Generator, device="cpu") -> dict:
    """Seeded random f32 weights with `init_clip_vision`'s layout and
    distributions (`clip.py:370`); the position grid is the config's."""

    def make(kind, *shape):
        if kind in ("b", "bias"):
            return torch.zeros(shape, device=device)
        if kind == "scale":
            return torch.ones(shape, device=device)
        x = torch.randn(shape, generator=generator, device=device)
        if kind in ("w", "proj"):
            return x / math.sqrt(shape[0])
        return x * (0.01 if kind == "pos" else 0.02)

    return _tree(cfg, make, cfg.num_tokens)


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
