"""Patch-grid region pooling: every spatial query (trace, box, box set,
whole image) as a weighted sum over the square grid of patch tokens.

Twins of `patchioner_tpu/ops/region_pooling.py` (reference semantics:
src/bbox_utils.py:8-109,158-168, src/model.py:45-94,1049-1054). Plain
PyTorch: none of these reaches a kernel of the reference. The semantics
the JAX module pins hold here too:

* boxes are pixel `[x1, y1, w, h]`; grid coordinates are `floor(v / patch)`
  and box ends are inclusive, so a box spans `w_grid + 1` columns;
* Gaussian box weights run `linspace(-1, 1, span)` over each axis's span,
  clipped at the grid edge;
* attention box weights normalise the attention map in place, so a later
  box that overlaps an earlier one sees the values it normalised;
* trace pooling divides by the full grid size, not by the weights' sum;
* AlphaCLIP's pixel masks floor and clamp a box's corners and end it
  exclusively; a dummy box (negative coordinate sum) masks nothing.

`ctx_cleaner` removes the global context from patch embeddings (the
reference's cleaning, `forward(cleaning_type=...)`).

Where the JAX module takes a PRNG key (`even_center="random"`), these take
a `torch.Generator`; they cannot reproduce JAX's draws.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "bboxes_to_grid",
    "bbox_weight_maps",
    "extract_bbox_features",
    "extract_bbox_features_single",
    "compute_region_means",
    "traces_to_grid",
    "trace_pool",
    "boxes_to_pixel_masks",
    "ctx_cleaner",
]


def bboxes_to_grid(bboxes: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Pixel `[x1, y1, w, h]` boxes -> int32 grid coordinates, floor-divided
    (a dummy `[-1] * 4` box keeps a negative sum). Twin of
    `region_pooling.py:48`."""
    return torch.floor(bboxes.float() / patch_size).to(torch.int32)


def _box_inside_mask(grid_boxes: torch.Tensor, grid_size: int) -> torch.Tensor:
    """(..., 4) int grid boxes -> (..., G, G) bool inside-box masks, both
    ends inclusive. Twin of `region_pooling.py:58`."""
    x1, y1 = grid_boxes[..., 0], grid_boxes[..., 1]
    x2, y2 = x1 + grid_boxes[..., 2], y1 + grid_boxes[..., 3]
    idx = torch.arange(grid_size, dtype=torch.int32, device=grid_boxes.device)
    in_y = (idx >= y1[..., None]) & (idx <= y2[..., None])
    in_x = (idx >= x1[..., None]) & (idx <= x2[..., None])
    return in_y[..., :, None] & in_x[..., None, :]


def _coin(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Fair coin flips of `shape` drawn from `generator`, on `device`."""
    if generator is None:
        raise ValueError("even_center='random' requires a torch.Generator")
    return (torch.rand(shape, generator=generator, device=generator.device) < 0.5).to(device)


def _center(start, span, even_center: str, generator) -> torch.Tensor:
    """The central patch of a span: the middle one of an odd span; of an
    even span's two, the lower, the higher, or a fair coin's pick."""
    lo = start + span // 2 - 1
    hi = start + span // 2
    if even_center == "low":
        even = lo
    elif even_center == "high":
        even = hi
    else:
        even = torch.where(_coin(span.shape, generator, span.device), hi, lo)
    return torch.where(span % 2 == 1, start + (span - 1) // 2, even)


def _gaussian_box_weights(grid_boxes: torch.Tensor, grid_size: int, variance: float, *,
                          even_center: str = "low",
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Per-box Gaussian weight maps over the full grid, each summing to 1;
    variance 0 gives a one-hot map at the box's central patch (the two axes
    pick independently). Twin of `region_pooling.py:71`."""
    x1, y1 = grid_boxes[..., 0], grid_boxes[..., 1]
    # the span stops at the grid edge (region_pooling.py:88-94)
    wspan = torch.minimum(grid_boxes[..., 2] + 1, grid_size - x1)
    hspan = torch.minimum(grid_boxes[..., 3] + 1, grid_size - y1)
    coords = torch.arange(grid_size, dtype=torch.float32, device=grid_boxes.device)

    if variance == 0:
        cy = _center(y1, hspan, even_center, generator)
        cx = _center(x1, wspan, even_center, generator)
        return ((coords[:, None] == cy[..., None, None]).float()
                * (coords[None, :] == cx[..., None, None]).float())

    def norm_coord(start, span):
        # linspace(-1, 1, span) at offset (coord - start); a span of 1 is -1
        off = coords - start[..., None].float()
        denom = torch.clamp(span[..., None].float() - 1.0, min=1.0)
        return torch.where(span[..., None] == 1, -1.0, -1.0 + 2.0 * off / denom)

    yn, xn = norm_coord(y1, hspan), norm_coord(x1, wspan)
    dist = yn[..., :, None] ** 2 + xn[..., None, :] ** 2
    w = torch.exp(-dist / variance) * _box_inside_mask(grid_boxes, grid_size)
    return w / torch.clamp(w.sum(dim=(-2, -1), keepdim=True), min=1e-30)


def _uniform_box_weights(grid_boxes: torch.Tensor, grid_size: int) -> torch.Tensor:
    """Twin of `region_pooling.py:141`: the inside mask over its area."""
    inside = _box_inside_mask(grid_boxes, grid_size).float()
    return inside / torch.clamp(inside.sum(dim=(-2, -1), keepdim=True), min=1.0)


def _attention_box_weights(grid_boxes: torch.Tensor, attention_map: torch.Tensor):
    """(B, NB, 4) grid boxes x (B, G, G) attention -> (B, NB, G, G) weights
    and the attention as the boxes left it. The boxes run in order and each
    normalises the attention inside it in place, as the reference does
    (src/bbox_utils.py:46-52); an empty box gives a zero map, not 0/0.
    Twin of `region_pooling.py:147`."""
    grid_size = attention_map.shape[-1]
    attn = attention_map.float()
    weights = []
    for k in range(grid_boxes.shape[1]):
        inside = _box_inside_mask(grid_boxes[:, k], grid_size).float()
        s = (attn * inside).sum(dim=(-2, -1), keepdim=True)
        safe = torch.where(s > 0, s, torch.ones_like(s))
        weights.append(attn * inside / safe)
        attn = torch.where(inside > 0, attn / safe, attn)
    return torch.stack(weights, dim=1), attn


def bbox_weight_maps(bboxes: torch.Tensor, grid_size: int, patch_size: int, *,
                     gaussian_avg: bool = False, gaussian_bbox_variance: float = 0.5,
                     attention_map: Optional[torch.Tensor] = None,
                     even_center: str = "low",
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(B, NB, 4) pixel boxes -> (B, NB, G, G) weight maps; the mode is the
    attention map's when one is given, else Gaussian when `gaussian_avg`,
    else uniform (the reference's priority). Twin of
    `region_pooling.py:185`."""
    gb = bboxes_to_grid(bboxes, patch_size)
    if attention_map is not None:
        w, _ = _attention_box_weights(gb, attention_map.reshape(-1, grid_size, grid_size))
        return w
    if gaussian_avg:
        return _gaussian_box_weights(gb, grid_size, gaussian_bbox_variance,
                                     even_center=even_center, generator=generator)
    return _uniform_box_weights(gb, grid_size)


def extract_bbox_features(patch_tokens: torch.Tensor, bboxes: torch.Tensor, *,
                          patch_size: int, **weight_kw) -> torch.Tensor:
    """Per-box weighted patch means, (B, G*G, D) x (B, NB, 4) -> (B, NB, D)
    f32; `weight_kw` as `bbox_weight_maps`. Twin of
    `region_pooling.py:216`."""
    b, n, d = patch_tokens.shape
    g = int(round(n ** 0.5))
    w = bbox_weight_maps(bboxes, g, patch_size, **weight_kw)
    return torch.einsum("bkp,bpd->bkd", w.reshape(b, -1, n), patch_tokens.float())


def extract_bbox_features_single(patch_tokens: torch.Tensor, bboxes: torch.Tensor, *,
                                 patch_size: int, **weight_kw) -> torch.Tensor:
    """One feature per image from the union of its boxes, (B, G*G, D) x
    (B, NB, 4) -> (B, D) f32: the boxes' maps summed, dummy boxes (grid
    coordinates summing below 0) skipped, the sum renormalised to 1. Twin
    of `region_pooling.py:252`."""
    b, n, d = patch_tokens.shape
    g = int(round(n ** 0.5))
    valid = (bboxes_to_grid(bboxes, patch_size).sum(dim=-1) >= 0).float()
    w = bbox_weight_maps(bboxes, g, patch_size, **weight_kw)
    total = torch.einsum("bk,bkyx->byx", valid, w)
    total = total / torch.clamp(total.sum(dim=(-2, -1), keepdim=True), min=1e-30)
    return torch.einsum("bp,bpd->bd", total.reshape(b, n), patch_tokens.float())


def compute_region_means(patch_tokens: torch.Tensor, variance: float, *,
                         even_center: str = "low",
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Whole-image weighted patch mean, (B, G*G, D) -> (B, D) f32: variance
    0 is the central patch, variance >= 100 the uniform mean, else one
    Gaussian over `linspace(-1, 1, G)` on both axes. `torch.linspace`
    differs from XLA's by an ulp on some entries, so the weights do too
    (PERF.md). Twin of `region_pooling.py:291`."""
    b, n, d = patch_tokens.shape
    g = int(round(n ** 0.5))
    dev = patch_tokens.device
    variance = float(variance)
    if variance == 0.0:
        lo, hi = g // 2 - 1, g // 2
        if g % 2 == 1:
            cy = cx = torch.full((b,), g // 2, device=dev)
        elif even_center == "low":
            cy = cx = torch.full((b,), lo, device=dev)
        elif even_center == "high":
            cy = cx = torch.full((b,), hi, device=dev)
        else:
            cy = torch.where(_coin((b,), generator, dev), hi, lo)
            cx = torch.where(_coin((b,), generator, dev), hi, lo)
        idx = torch.arange(g, device=dev)
        w = ((idx[:, None] == cy[:, None, None]).float()
             * (idx[None, :] == cx[:, None, None]).float())
    elif variance >= 100.0:
        w = torch.full((b, g, g), 1.0 / (g * g), device=dev)
    else:
        coords = torch.linspace(-1.0, 1.0, g, device=dev)
        w = torch.exp(-(coords[:, None] ** 2 + coords[None, :] ** 2) / variance)
        w = (w / w.sum()).expand(b, g, g)
    return torch.einsum("bp,bpd->bd", w.reshape(b, n), patch_tokens.float())


def traces_to_grid(points: torch.Tensor, valid: torch.Tensor,
                   grid_size: int) -> torch.Tensor:
    """(B, P, 2) normalised (x, y) points + (B, P) valid mask -> (B, G, G)
    f32 hit counts. Points outside [0, 1] are dropped; indices clamp to the
    last patch (x = 1.0 lands in column G - 1). Twin of
    `region_pooling.py:339`."""
    x, y = points[..., 0], points[..., 1]
    keep = (x >= 0) & (x <= 1) & (y >= 0) & (y <= 1) & (valid > 0)
    g = grid_size
    gx = torch.floor(x * g).to(torch.int64).clamp(0, g - 1)
    gy = torch.floor(y * g).to(torch.int64).clamp(0, g - 1)
    flat = gy * g + gx
    grids = torch.zeros(points.shape[0], g * g, device=points.device,
                        dtype=torch.float32)
    grids.scatter_add_(1, flat, keep.to(torch.float32))
    return grids.reshape(-1, g, g)


def trace_pool(patch_tokens: torch.Tensor, trace_grid: torch.Tensor,
               self_attn: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, G*G, D) tokens x (B, G, G) weights -> (B, D) f32, divided by the
    full grid size G*G, not by the weights' sum (the reference's `.mean`
    over all patches). Twin of `region_pooling.py:372`."""
    b, n, d = patch_tokens.shape
    g = trace_grid.shape[-1]
    w = trace_grid.reshape(b, g * g).float()
    if self_attn is not None:
        w = w * self_attn.reshape(b, g * g).float()
    return torch.einsum("bp,bpd->bd", w, patch_tokens.float()) / (g * g)


def boxes_to_pixel_masks(bboxes: torch.Tensor, size: int) -> torch.Tensor:
    """(..., 4) `[x1, y1, w, h]` boxes -> (..., size, size) f32 binary
    masks, AlphaCLIP's region conditioning: start floor(x1) clamped to
    [0, size - 1], end floor(x1 + w) clamped to [0, size], exclusive; a box
    with a negative coordinate sum gives a zero mask. Twin of
    `region_pooling.py:414`."""
    x1 = torch.floor(bboxes[..., 0]).clamp(0, size - 1)
    y1 = torch.floor(bboxes[..., 1]).clamp(0, size - 1)
    x2 = torch.floor(bboxes[..., 0] + bboxes[..., 2]).clamp(0, size)
    y2 = torch.floor(bboxes[..., 1] + bboxes[..., 3]).clamp(0, size)
    valid = bboxes.sum(dim=-1) >= 0
    xs = torch.arange(size, dtype=torch.float32, device=bboxes.device)
    in_x = (xs >= x1[..., None]) & (xs < x2[..., None])
    in_y = (xs >= y1[..., None]) & (xs < y2[..., None])
    mask = in_y[..., :, None] & in_x[..., None, :]
    return mask.to(torch.float32) * valid[..., None, None]


def ctx_cleaner(dirty_embeds: torch.Tensor, ctx_embed: torch.Tensor,
                cleaning_type: str = "orthogonal_projection", alpha: float = 1.0,
                epsilon: float = 1e-6) -> torch.Tensor:
    """Remove the global context `ctx_embed` (B, D) from `dirty_embeds`
    (B, N, D): 'orthogonal_projection' subtracts `alpha` times each row's
    projection on the context, 'contrastive_mask' scales each row by
    1 - ctx / (|ctx| + epsilon); another type raises ValueError. Twin of
    `region_pooling.py:436` (reference src/model.py:1425-1436)."""
    ctx = ctx_embed[:, None, :]
    if cleaning_type == "orthogonal_projection":
        denom = (ctx * ctx).sum(dim=-1, keepdim=True)
        proj = (dirty_embeds * ctx).sum(dim=-1, keepdim=True) / denom
        return dirty_embeds - alpha * proj * ctx
    if cleaning_type == "contrastive_mask":
        norm = torch.linalg.vector_norm(ctx, dim=-1, keepdim=True) + epsilon
        return dirty_embeds * (1.0 - ctx / norm)
    raise ValueError(f"unknown cleaning_type: {cleaning_type}")
