"""CLIP ModifiedResNet, RegionCLIP's backbone, in PyTorch.

Twin of `patchioner_tpu/models/resnet_clip.py` (reference
src/regionclip/clip_backbone.py:14-300): a 3-conv stem with an average
pool, anti-aliased strided bottlenecks (an average pool before the
stride-2 conv3 and on the identity branch), frozen batch norms
(`x * scale + (b - mean * scale)`, eps 1e-5), and a QKV attention pool
whose query token is the spatial mean. `resnet_spatial_forward` emits
RegionCLIP's `forward_return_spatial_feats` as a DINOv2-style dict: the
attention pool's CLS token and its projected local features (or layer4's
features through `c_proj` alone, or raw layer3 features), both
L2-normalized. The effective patch is 32, layer4's stride.

Plain PyTorch, as the JAX package runs it as plain XLA (no Pallas
kernel): the convolutions are `F.conv2d` in torch's own layouts, NCHW
activations and OIHW weights as a state dict stores them (`io.bridge`
transposes the JAX package's HWIO), with the symmetric (k - 1) // 2
padding of the reference, not XLA's SAME. Linear weights are stored
(in, out) as everywhere in the port. Below f32 every weight is cast to the
compute type before the stem, as in the JAX package, so the batch norms
run in that type too. On the card, an f32 convolution takes TF32 unless
`torch.backends.cudnn.allow_tf32` is False.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch
import torch.nn.functional as F

from patchioner_tpu_torch.io.torch_port import _t
from patchioner_tpu_torch.models import vit

__all__ = ["ResNetClipConfig", "resnet_spatial_forward", "init_resnet_clip",
           "port_clip_resnet", "param_template"]


@dataclasses.dataclass(frozen=True)
class ResNetClipConfig:
    layers: tuple = (3, 4, 6, 3)  # RN50
    width: int = 64
    output_dim: int = 1024
    heads: int = 32
    img_size: int = 224
    bn_eps: float = 1e-5
    dtype: torch.dtype = torch.float32

    @property
    def embed_dim(self) -> int:
        return self.width * 32  # layer4's channels

    @property
    def patch_size(self) -> int:
        return 32  # layer4's stride (src/model.py:453-457)

    @property
    def grid_size(self) -> int:
        return self.img_size // 32

    @property
    def num_tokens(self) -> int:
        """The attention pool's tokens: the mean, then the grid."""
        return 1 + self.grid_size ** 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    return F.conv2d(x, w, stride=stride, padding=(w.shape[-1] - 1) // 2)


def _frozen_bn(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    scale = p["w"] / torch.sqrt(p["var"] + eps)
    shift = p["b"] - p["mean"] * scale
    return x * scale[:, None, None] + shift[:, None, None]


def _bottleneck(x: torch.Tensor, p: dict, stride: int, eps: float) -> torch.Tensor:
    out = F.relu(_frozen_bn(_conv(x, p["conv1"]), p["bn1"], eps))
    out = F.relu(_frozen_bn(_conv(out, p["conv2"]), p["bn2"], eps))
    if stride > 1:
        out = F.avg_pool2d(out, stride)
    out = _frozen_bn(_conv(out, p["conv3"]), p["bn3"], eps)
    identity = x
    if "down_conv" in p:
        if stride > 1:
            identity = F.avg_pool2d(identity, stride)
        identity = _frozen_bn(_conv(identity, p["down_conv"]), p["down_bn"], eps)
    return F.relu(out + identity)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H * W, C), row-major (h, w) as the JAX package's
    NHWC reshape orders them."""
    return x.flatten(2).transpose(1, 2)


def _dense(x: torch.Tensor, p: dict) -> torch.Tensor:
    return torch.matmul(x, p["w"]) + p["b"]


def _attnpool(x: torch.Tensor, p: dict, heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The QKV attention pool (clip_backbone.py:73-110): tokens [mean, HW]
    plus the position embedding, one attention step with separate q, k, v,
    q scaled by hd^-0.5, the logits softmaxed in f32 and the weights cast
    back; (the mean token's output (B, out), the grid's (B, HW, out))."""
    tokens = _tokens(x)
    b, _, c = tokens.shape
    tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1) + p["pos_embed"]
    n, hd = tokens.shape[1], c // heads

    def split(t):
        return t.reshape(b, n, heads, hd).transpose(1, 2)

    q, k, v = (split(_dense(tokens, p[name])) for name in "qkv")
    logits = torch.matmul(q * hd ** -0.5, k.transpose(-1, -2)).float()
    w = torch.softmax(logits, dim=-1).to(x.dtype)
    out = _dense(torch.matmul(w, v).transpose(1, 2).reshape(b, n, c), p["c"])
    return out[:, 0], out[:, 1:]


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def resnet_spatial_forward(params: dict, pixels: torch.Tensor, cfg: ResNetClipConfig,
                           use_attnpool_for_spatial_feats: bool = True,
                           use_layer3: bool = False, res5_out: bool = True) -> dict:
    """(B, H, W, 3) NHWC pixels -> {'x_norm_clstoken' (B, out),
    'x_norm_patchtokens'}, both L2-normalized, as
    `forward_return_spatial_feats` (clip_backbone.py:243-300) gives them.

    The reference's precedence: with `res5_out` (res5 among the outputs,
    the shipped RegionCLIP config) the spatial features are layer4's
    attention-pool outputs, or layer4's features through `c_proj` alone
    without `use_attnpool_for_spatial_feats`, and `use_layer3` does
    nothing; without it they are raw layer3 features (stride 16, width * 16
    channels, not projected), whatever `use_layer3` says. The CLS token is
    always the attention pool's."""
    del use_layer3  # no effect either way (clip_backbone.py:265-283)
    eps = cfg.bn_eps
    params = vit.cast_params(params, cfg.dtype)
    x = pixels.to(cfg.dtype).permute(0, 3, 1, 2).contiguous()
    stem = params["stem"]
    for i in (1, 2, 3):
        x = F.relu(_frozen_bn(_conv(x, stem[f"conv{i}"], stride=2 if i == 1 else 1),
                              stem[f"bn{i}"], eps))
    x = F.avg_pool2d(x, 2)
    x3 = None
    for li, blocks in enumerate(params["layers"]):
        for bi, blk in enumerate(blocks):
            x = _bottleneck(x, blk, 2 if li and not bi else 1, eps)
        if li == 2:
            x3 = x  # layer3's output, stride 16

    cls_tok, local = _attnpool(x, params["attnpool"], cfg.heads)
    if not res5_out:
        local = _tokens(x3)
    elif not use_attnpool_for_spatial_feats:
        local = _dense(_tokens(x), params["attnpool"]["c"])
    return {"x_norm_clstoken": _unit(cls_tok), "x_norm_patchtokens": _unit(local)}


# -------------------------------------------------------------------- init


def _tree(cfg: ResNetClipConfig, make) -> dict:
    """The backbone's tree with each leaf `make(kind, *shape)`; kind is
    'conv' (OIHW), 'w' (a dense weight, fan-in first), 'b', 'bn_w', 'bn_b',
    'mean', 'var' or 'pos'."""

    def conv(ci, co, k):
        return make("conv", co, ci, k, k)

    def bn(c):
        return {"w": make("bn_w", c), "b": make("bn_b", c), "mean": make("mean", c),
                "var": make("var", c)}

    def lin(ci, co):
        return {"w": make("w", ci, co), "b": make("b", co)}

    w = cfg.width
    tree = {"stem": {"conv1": conv(3, w // 2, 3), "bn1": bn(w // 2),
                     "conv2": conv(w // 2, w // 2, 3), "bn2": bn(w // 2),
                     "conv3": conv(w // 2, w, 3), "bn3": bn(w)},
            "layers": []}
    inplanes = w
    for li, n_blocks in enumerate(cfg.layers):
        planes = w * 2 ** li
        blocks = []
        for bi in range(n_blocks):
            blk = {"conv1": conv(inplanes, planes, 1), "bn1": bn(planes),
                   "conv2": conv(planes, planes, 3), "bn2": bn(planes),
                   "conv3": conv(planes, planes * 4, 1), "bn3": bn(planes * 4)}
            if (li and not bi) or inplanes != planes * 4:
                blk["down_conv"] = conv(inplanes, planes * 4, 1)
                blk["down_bn"] = bn(planes * 4)
            blocks.append(blk)
            inplanes = planes * 4
        tree["layers"].append(blocks)
    c = cfg.embed_dim
    tree["attnpool"] = {"pos_embed": make("pos", cfg.num_tokens, c), "q": lin(c, c),
                        "k": lin(c, c), "v": lin(c, c), "c": lin(c, cfg.output_dim)}
    return tree


def init_resnet_clip(cfg: ResNetClipConfig, generator: torch.Generator,
                     device="cpu") -> dict:
    """Seeded random f32 weights with `init_resnet_clip`'s layout and
    distributions (`resnet_clip.py:193`): convolutions and dense weights
    N(0, 1 / fan_in), the position embedding N(0, 1 / C), zero biases,
    identity batch norms."""

    def make(kind, *shape):
        if kind in ("b", "bn_b", "mean"):
            return torch.zeros(shape, device=device)
        if kind in ("bn_w", "var"):
            return torch.ones(shape, device=device)
        x = torch.randn(shape, generator=generator, device=device)
        fan_in = math.prod(shape[1:]) if kind == "conv" else shape[-1] if kind == "pos" \
            else shape[0]
        return x / math.sqrt(fan_in)

    return _tree(cfg, make)


def param_template(cfg: ResNetClipConfig) -> dict:
    """`init_resnet_clip`'s tree as empty meta tensors, for checking a
    loaded tree against the config."""
    return _tree(cfg, lambda kind, *shape: torch.empty(shape, device="meta"))


# -------------------------------------------------------------------- port


def port_clip_resnet(sd: Mapping, cfg: ResNetClipConfig, prefix: str = "visual.") -> dict:
    """An openai-CLIP / RegionCLIP ModifiedResNet state dict under `prefix`
    (`resnet_clip.py:264`; a RegionCLIP detection checkpoint's detectron
    'backbone.' prefix is the caller's to map, src/regionclip/loader.py:92-100)
    as f32 CPU tensors, convolutions OIHW as stored.

    An attention-pool position embedding of another grid than the config's
    (a 224 px checkpoint's 50 tokens at the shipped 512 px, which needs
    257) is dropped with a warning and drawn anew, N(0, 1 / C), as the
    reference's loader lets the model re-initialize it
    (src/regionclip/loader.py:186-197); the draw comes from a CPU generator
    seeded 0, so that one file gives one model on any device. The JAX package draws it from its own PRNGKey(0), so the
    two packages' values differ there."""

    def g(key):
        return _t(sd[prefix + key])

    def bn(name):
        return {"w": g(f"{name}.weight"), "b": g(f"{name}.bias"),
                "mean": g(f"{name}.running_mean"), "var": g(f"{name}.running_var")}

    def lin(name):
        return {"w": g(f"{name}.weight").t().contiguous(), "b": g(f"{name}.bias")}

    params = {"stem": {f"{kind}{i}": (g(f"conv{i}.weight") if kind == "conv" else bn(f"bn{i}"))
                       for i in (1, 2, 3) for kind in ("conv", "bn")},
              "layers": []}
    for li, n_blocks in enumerate(cfg.layers):
        blocks = []
        for bi in range(n_blocks):
            p = f"layer{li + 1}.{bi}"
            blk = {f"{kind}{i}": (g(f"{p}.conv{i}.weight") if kind == "conv"
                                  else bn(f"{p}.bn{i}"))
                   for i in (1, 2, 3) for kind in ("conv", "bn")}
            if prefix + f"{p}.downsample.0.weight" in sd:
                blk["down_conv"] = g(f"{p}.downsample.0.weight")
                blk["down_bn"] = bn(f"{p}.downsample.1")
            blocks.append(blk)
        params["layers"].append(blocks)
    pos = g("attnpool.positional_embedding")
    if pos.shape[0] != cfg.num_tokens:
        print(f"Warning: attnpool pos-embed has {pos.shape[0]} tokens, config resolution "
              f"{cfg.img_size} needs {cfg.num_tokens} — re-initializing it (reference "
              "loader behavior)")
        gen = torch.Generator().manual_seed(0)
        pos = torch.randn(cfg.num_tokens, pos.shape[1], generator=gen) / math.sqrt(pos.shape[1])
    params["attnpool"] = {"pos_embed": pos, "q": lin("attnpool.q_proj"),
                          "k": lin("attnpool.k_proj"), "v": lin("attnpool.v_proj"),
                          "c": lin("attnpool.c_proj")}
    return params
