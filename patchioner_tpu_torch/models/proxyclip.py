"""ProxyCLIP: a CLIP tower whose last attention is a DINO proxy affinity,
in PyTorch.

Twin of `patchioner_tpu/models/proxyclip.py` (reference
src/proxyclip/proxyclip.py:6-86 and the open_clip fork's visual forward,
open_clip_proxy/transformer.py:503-588):

1. a frozen vision foundation model (the port's DINOv2 `vit_forward`, so
   kernels A, B and C on the card) gives patch features, whose pairwise
   cosine similarity is shifted by the mean over the whole batch times
   `beta`, scaled by `gamma`, its negatives set to -inf, and softmaxed
   into the affinity (:560-578). The mean couples the images of a batch:
   an image's features depend on its batchmates, as in the reference;
2. the CLIP trunk runs every block but the last (the stored position
   grid resized bicubic with dinov2's 0.1 offset, :540-558); the last
   block's value vectors are resampled bilinearly (half-pixel centres)
   from the CLIP grid onto the VFM's and mixed by the affinity, then
   `out_proj`: no residual, no MLP, the class token dropped (:526-531,
   :580-586). Both grids are floored to whole patches, the VFM's too
   (296 px gives 21 x 21 patches of 14), where the JAX package's reshape
   raises;
3. `ln_post` and `proj` over the patch tokens, L2-normalized, in f32.

The CLIP half is plain PyTorch (`models/clip.py`'s helpers), as the JAX
package runs it as plain XLA.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from patchioner_tpu_torch.models import clip as clip_mod
from patchioner_tpu_torch.models import vit as vit_mod

__all__ = ["ProxyClipConfig", "proxyclip_forward", "proxy_affinity", "resample_grid"]


@dataclasses.dataclass(frozen=True)
class ProxyClipConfig:
    clip: clip_mod.ClipVisionConfig = dataclasses.field(
        default_factory=clip_mod.ClipVisionConfig)
    vfm: vit_mod.ViTConfig = dataclasses.field(
        default_factory=lambda: vit_mod.config_for("dinov2_vitb14_reg"))
    beta: float = 1.2
    gamma: float = 3.0

    # the geometry is the VFM's (reference src/model.py:193-196)
    @property
    def patch_size(self) -> int:
        return self.vfm.patch_size

    @property
    def img_size(self) -> int:
        return self.vfm.img_size

    @property
    def grid_size(self) -> int:
        return self.vfm.grid_size

    @property
    def dtype(self) -> torch.dtype:
        return self.vfm.dtype


def proxy_affinity(feats: torch.Tensor, beta: float, gamma: float) -> torch.Tensor:
    """(B, N, D) VFM patch features -> (B, N, N) f32 affinity: unit rows,
    their dot products in the features' type taken to f32, minus the mean
    over every image of the batch times `beta`, times `gamma`, negatives
    -inf, softmaxed (transformer.py:570-578). The diagonal stays finite."""
    unit = feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
    sim = torch.matmul(unit, unit.transpose(-1, -2)).float()
    sim = (sim - sim.mean() * beta) * gamma
    return torch.softmax(sim.masked_fill(sim < 0.0, float("-inf")), dim=-1)


def resample_grid(v: torch.Tensor, side: int) -> torch.Tensor:
    """(B, G * G, C) tokens of a G x G grid -> (B, side * side, C),
    resampled bilinearly per channel as `jax.image.resize` does it:
    half-pixel centres, antialiased when the grid shrinks."""
    b, n, c = v.shape
    g = int(round(n ** 0.5))
    if g == side:
        return v
    v = v.reshape(b, g, g, c).permute(0, 3, 1, 2)
    v = F.interpolate(v, size=(side, side), mode="bilinear", align_corners=False,
                      antialias=g > side)
    return v.permute(0, 2, 3, 1).reshape(b, side * side, c)


def proxyclip_forward(clip_params: dict, vfm_params: dict, pixels: torch.Tensor,
                      cfg: ProxyClipConfig) -> dict:
    """(B, H, W, 3) normalised NHWC pixels -> {'x_norm_patchtokens' (B,
    G * G, proj)}, G the VFM's grid: unit rows in f32, patch tokens only."""
    ccfg = cfg.clip
    b, hh = pixels.shape[:2]
    # the VFM's grid is floored as well (296 px against patch 14: 21 x 21),
    # where the JAX package's reshape raises
    gv = hh // cfg.vfm.patch_size
    side = gv * cfg.vfm.patch_size
    affinity = proxy_affinity(vit_mod.vit_forward(vfm_params, pixels[:, :side, :side], cfg.vfm)
                              ["x_norm_patchtokens"], cfg.beta, cfg.gamma)

    # the CLIP trunk: the strided patch conv floors the grid, dropping the
    # bottom and right remainder (518 and 296 px against patch 16)
    p = ccfg.patch_size
    gc = hh // p
    params = vit_mod.cast_params(clip_params, ccfg.dtype)
    x = pixels[:, :gc * p, :gc * p].to(ccfg.dtype)
    x = torch.matmul(clip_mod._patches(x, p), params["patch_embed_w"])
    x = torch.cat([params["class_embedding"].expand(b, 1, ccfg.width), x], dim=1)
    x = x + vit_mod.interpolate_pos_embed(params["pos_embed"], ccfg.grid_size, gc)
    x = clip_mod._ln(x, params["ln_pre"], ccfg.ln_eps)
    for blk in params["blocks"][:-1]:
        x, _ = clip_mod._resblock(x, blk, ccfg.heads, ccfg.ln_eps)

    # the last layer: its value vectors resampled onto the VFM grid, mixed
    # by the affinity, out_proj; no residual, no MLP, no class token
    blk = params["blocks"][-1]
    qkv = clip_mod._dense(clip_mod._ln(x, blk["ln_1"], ccfg.ln_eps), blk["qkv"])
    v = resample_grid(qkv[:, 1:, 2 * ccfg.width:], gv)
    out = clip_mod._dense(torch.matmul(affinity.to(v.dtype), v), blk["out_proj"])
    out = torch.matmul(clip_mod._ln(out, params["ln_post"], ccfg.ln_eps), params["proj"])
    out = out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)
    return {"x_norm_patchtokens": out.float()}
