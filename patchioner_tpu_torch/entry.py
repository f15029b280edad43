"""The flagship caption step, in PyTorch.

Twins of `__graft_entry__.make_prefix_step`, `make_caption_step`,
`make_state` and `example_inputs`, generalised over the pooling as the
reference's `Patchioner._build_fused_step(key, pool)` is
(`patchioner_tpu/models/patchioner.py:1408-1485`): pixels -> ViT encoder
(kernel A, the attention kernels its `attn_impl` selects, and C or, for
ViT-g, G) -> a pool of the encoder outputs (a trace by default; a box, a
box set or the whole image through the `make_*_pool` builders) ->
support-memory projection (kernel D, or H over an int8 bank) ->
[Talk2DINO inversion] -> 30-step greedy DeCap decode. Every pool shares
the projection and the decode. The device of the state and inputs decides
where it runs: on CUDA tensors every kernel launches and a state's
`decap.GreedyDecoder` replays its CUDA graph of the decode, on CPU tensors
the plain versions and the eager loop run. `Patchioner` builds its fused
caption paths from these same functions.
"""

from __future__ import annotations

import numpy as np
import torch

from patchioner_tpu_torch.models import decap, talk2dino, vit
from patchioner_tpu_torch.ops import memory_projection as memproj
from patchioner_tpu_torch.ops import region_pooling as rp

__all__ = ["make_prefix_step", "make_caption_step", "make_state", "example_inputs",
           "resolve_device", "project", "make_trace_pool", "make_bbox_pool",
           "make_region_set_pool", "make_image_pool", "IMAGE_POOLS"]

# what `make_image_pool` captions the whole image from
IMAGE_POOLS = ("cls", "avg_self_attn", "patches")


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; "cuda" without a card raises, never
    falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on a CUDA card by default and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return device


def project(state: dict, feats: torch.Tensor, bank_num_real: int, *,
            normalize: bool) -> torch.Tensor:
    """The support-memory projection of the state's bank: kernel H when the
    state holds an int8 bank (`bank_scale`), kernel D otherwise."""
    if "bank_scale" in state:
        bank = memproj.QuantizedBank(state["bank_rows"], state["bank_scale"],
                                     state["bank_inv"], bank_num_real)
        return memproj.memory_project_int8(feats, bank, normalize=normalize)
    bank = memproj.PreparedBank(state["bank_rows"], state["bank_inv"], bank_num_real)
    return memproj.memory_project_streamed(feats, bank, normalize=normalize)


def make_trace_pool(vit_cfg: vit.ViTConfig, use_attention: bool = True):
    """Pool (B, P, 2) trace points with a (B, P) valid mask into (B, D);
    with `use_attention` the trace weights are multiplied by the CLS->patch
    attention row (the reference's attention tracing). The reference's
    `_fused_trace_step` pool, `patchioner.py:1777-1798`."""
    g = vit_cfg.grid_size

    def pool(outs, extract_attn, trace_pts, trace_valid):
        grid = rp.traces_to_grid(trace_pts, trace_valid, g)
        attn = extract_attn() if use_attention else None
        return rp.trace_pool(outs["x_norm_patchtokens"], grid, attn)

    return pool


def make_bbox_pool(patch_size: int, *, gaussian_avg: bool = False,
                   gaussian_bbox_variance: float = 0.5, use_attn_map: bool = False):
    """Pool (B, NB, 4) pixel `[x1, y1, w, h]` boxes into (B * NB, D), one
    row a box, image-major. The weights are the attention map's under
    `use_attn_map`, else Gaussian under `gaussian_avg`, else uniform; the
    parameters of the modes not taken do nothing. The reference's
    `_fused_bbox_step` pool, `patchioner.py:1811-1840`."""

    def pool(outs, extract_attn, bboxes):
        feats = rp.extract_bbox_features(
            outs["x_norm_patchtokens"], bboxes, patch_size=patch_size,
            gaussian_avg=gaussian_avg, gaussian_bbox_variance=gaussian_bbox_variance,
            attention_map=extract_attn() if use_attn_map else None)
        return feats.reshape(-1, feats.shape[-1])

    return pool


def make_region_set_pool(patch_size: int, *, gaussian_avg: bool = False,
                         gaussian_bbox_variance: float = 0.5, use_attn_map: bool = False):
    """Pool each image's (NB, 4) box set into one (B, D) row over the union
    of its boxes; `[-1] * 4` rows are skipped. Modes as `make_bbox_pool`.
    The reference's `_fused_controllable_step` pool,
    `patchioner.py:1913-1939`."""

    def pool(outs, extract_attn, bboxes):
        return rp.extract_bbox_features_single(
            outs["x_norm_patchtokens"], bboxes, patch_size=patch_size,
            gaussian_avg=gaussian_avg, gaussian_bbox_variance=gaussian_bbox_variance,
            attention_map=extract_attn() if use_attn_map else None)

    return pool


def make_image_pool(caption_from: str = "cls", gaussian_img_variance: float = 1.0):
    """Pool the whole image into (B, D): 'cls' the normalised CLS token,
    'avg_self_attn' the mean over patches of the tokens weighted by the
    CLS->patch attention row, 'patches' `compute_region_means` at
    `gaussian_img_variance` (which only 'patches' reads). The reference's
    `_fused_global_step` pool, `patchioner.py:1868-1898`."""
    if caption_from not in IMAGE_POOLS:
        raise ValueError(f"caption_from={caption_from!r} is not one of {IMAGE_POOLS}")

    def pool(outs, extract_attn):
        tokens = outs["x_norm_patchtokens"]
        if caption_from == "cls":
            return outs["x_norm_clstoken"]
        if caption_from == "patches":
            return rp.compute_region_means(tokens, gaussian_img_variance)
        return (extract_attn()[..., None] * tokens.float()).mean(dim=1)

    return pool


def make_prefix_step(vit_cfg: vit.ViTConfig, bank_num_real: int, *,
                     use_attention: bool = True, normalize: bool = True, pool=None):
    """The caption step up to the projected prefix,
    `prefix_step(state, pixels, *pool_args)`. `pool(outs, extract_attn,
    *pool_args)` reduces the encoder outputs to the features to project;
    `extract_attn()` computes the CLS->patch attention row when the pool
    asks for it. The default pool is `make_trace_pool(vit_cfg,
    use_attention)`, which `use_attention` only configures."""
    if pool is None:
        pool = make_trace_pool(vit_cfg, use_attention)

    @torch.no_grad()
    def prefix_step(state, pixels, *pool_args):
        outs = vit.vit_forward(state["vit"], pixels, vit_cfg)

        def extract_attn():
            attn, _ = vit.process_self_attention(
                outs["qkv_last"], num_heads=vit_cfg.extract_heads,
                num_global_tokens=vit_cfg.num_global_tokens,
                scale=vit_cfg.extract_scale,
            )
            return attn

        feats = pool(outs, extract_attn, *pool_args)
        prefix = project(state, feats, bank_num_real, normalize=normalize)
        if "inversion" in state:
            prefix = talk2dino.revert_transformation(prefix, state["inversion"])
        return prefix

    return prefix_step


def make_caption_step(vit_cfg: vit.ViTConfig, gcfg, bank_num_real: int, *,
                      n_steps: int = decap.ENTRY_LENGTH, **prefix_kw):
    """`caption_step(state, pixels, *pool_args) -> (tokens, scores)`; the
    keywords of `make_prefix_step` choose the pool. The decode is the
    state's `GreedyDecoder` (`state["decode"]`, of the same config and
    steps) when it has one, else `decap.greedy_decode` of its decoder."""
    prefix_step = make_prefix_step(vit_cfg, bank_num_real, **prefix_kw)

    def caption_step(state, pixels, *pool_args):
        prefix = prefix_step(state, pixels, *pool_args)
        decode = state.get("decode")
        if decode is None:
            return decap.greedy_decode(state["decoder"], prefix, gcfg, n_steps)
        if decode.cfg != gcfg or decode.n_steps != n_steps:
            raise ValueError(f"the state's decoder runs {decode.n_steps} steps of "
                             f"{decode.cfg}, the step {n_steps} of {gcfg}")
        return decode(prefix)

    return caption_step


def make_state(vit_params: dict, decoder: decap.DecapParams, bank,
               inversion=None, decode: decap.GreedyDecoder | None = None) -> dict:
    """The step's state; a `QuantizedBank` adds its per-row `bank_scale`,
    and `decode` the decoder object the caption step decodes with."""
    state = {"vit": vit_params, "decoder": decoder,
             "bank_rows": bank.rows, "bank_inv": bank.inv_norm}
    if decode is not None:
        state["decode"] = decode
    if isinstance(bank, memproj.QuantizedBank):
        state["bank_scale"] = bank.scale
    if inversion is not None:
        state["inversion"] = inversion
    return state


def example_inputs(batch: int, img: int = 518, n_pts: int = 64, seed: int = 0,
                   device="cuda"):
    """The JAX entry's example inputs from the same numpy seed: (pixels
    (B, img, img, 3) f32, trace points (B, n_pts, 2), valid (B, n_pts)) on
    `device`, the card unless the caller asks for "cpu"."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    pixels = rng.standard_normal((batch, img, img, 3)).astype(np.float32)
    pts = rng.uniform(0, 1, (batch, n_pts, 2)).astype(np.float32)
    valid = np.ones((batch, n_pts), np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (pixels, pts, valid))
