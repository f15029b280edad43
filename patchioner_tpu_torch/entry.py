"""The flagship trace-caption step, in PyTorch.

Twins of `__graft_entry__.make_prefix_step`, `make_caption_step`,
`make_state` and `example_inputs`: pixels -> ViT encoder (kernel A, the
attention kernels its `attn_impl` selects, and C or, for ViT-g, G) ->
CLS->patch attention extraction -> trace pooling -> support-memory
projection (kernel D, or H over an int8 bank, as the reference's fused
step, patchioner.py:1418,1466-1474) -> [Talk2DINO inversion] -> 30-step
greedy DeCap decode. The device of the
state and inputs decides where it runs: on CUDA tensors every kernel
launches, on CPU tensors their plain versions run.
`Patchioner` builds its fused trace step from these same functions.
"""

from __future__ import annotations

import numpy as np
import torch

from patchioner_tpu_torch.models import decap, talk2dino, vit
from patchioner_tpu_torch.ops import memory_projection as memproj
from patchioner_tpu_torch.ops import region_pooling as rp

__all__ = ["make_prefix_step", "make_caption_step", "make_state", "example_inputs",
           "resolve_device", "project"]


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


def make_prefix_step(vit_cfg: vit.ViTConfig, bank_num_real: int, *,
                     use_attention: bool = True, normalize: bool = True):
    """The caption step up to the projected prefix. With `use_attention`
    the trace weights are multiplied by the CLS->patch attention row (the
    reference's attention tracing, on in the flagship step)."""

    @torch.no_grad()
    def prefix_step(state, pixels, trace_pts, trace_valid):
        outs = vit.vit_forward(state["vit"], pixels, vit_cfg)
        attn = None
        if use_attention:
            attn, _ = vit.process_self_attention(
                outs["qkv_last"], num_heads=vit_cfg.extract_heads,
                num_global_tokens=vit_cfg.num_global_tokens,
                scale=vit_cfg.extract_scale,
            )
        grid = rp.traces_to_grid(trace_pts, trace_valid, vit_cfg.grid_size)
        feats = rp.trace_pool(outs["x_norm_patchtokens"], grid, attn)
        prefix = project(state, feats, bank_num_real, normalize=normalize)
        if "inversion" in state:
            prefix = talk2dino.revert_transformation(prefix, state["inversion"])
        return prefix

    return prefix_step


def make_caption_step(vit_cfg: vit.ViTConfig, gcfg, bank_num_real: int, *,
                      n_steps: int = decap.ENTRY_LENGTH, **prefix_kw):
    prefix_step = make_prefix_step(vit_cfg, bank_num_real, **prefix_kw)

    def caption_step(state, pixels, trace_pts, trace_valid):
        prefix = prefix_step(state, pixels, trace_pts, trace_valid)
        return decap.greedy_decode(state["decoder"], prefix, gcfg, n_steps)

    return caption_step


def make_state(vit_params: dict, decoder: decap.DecapParams, bank,
               inversion=None) -> dict:
    """The step's state; a `QuantizedBank` adds its per-row `bank_scale`."""
    state = {"vit": vit_params, "decoder": decoder,
             "bank_rows": bank.rows, "bank_inv": bank.inv_norm}
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
