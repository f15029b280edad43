"""Carry the JAX package's parameters and state into the port.

Both packages store dense weights (in, out) and keep the same nested-dict
trees, so the bridge converts leaves (numpy or JAX arrays, any float type
including bfloat16) to torch tensors and checks the structure. Tests use it
to feed identical weights to both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from patchioner_tpu_torch.models import decap
from patchioner_tpu_torch.ops import memory_projection as memproj

__all__ = ["to_torch", "vit_from_jax", "clip_vision_from_jax", "clip_text_from_jax",
           "resnet_clip_from_jax", "proxyclip_from_jax", "decap_from_jax",
           "bank_from_jax", "inversion_from_jax", "mlp_w8_from_jax"]


def _leaf(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable host copy
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: widen exactly
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(a).to(device)


def to_torch(tree, device="cpu"):
    """A nested dict / list / tuple of arrays as the same tree of tensors;
    None leaves (a linear without a bias, as in ViECap's mapping network)
    stay None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch(v, device) for v in tree]
    return _leaf(tree, device)


def vit_from_jax(tree: dict, cfg, device="cpu") -> dict:
    """An `init_vit` / ported-checkpoint tree -> the port's ViT params: fc1 /
    fc2 for the MLP FFN, w12 / w3 for SwiGLU (`cfg.ffn`)."""
    if len(tree["blocks"]) != cfg.depth:
        raise ValueError(f"tree has {len(tree['blocks'])} blocks, cfg.depth={cfg.depth}")
    blk = tree["blocks"][0]
    if "w" not in blk["qkv"]:
        raise NotImplementedError("int8 (W8A8) encoder weights are not ported yet")
    ffn = ("w12", "w3") if cfg.ffn == "swiglu" else ("fc1", "fc2")
    if not all(k in blk for k in ffn):
        raise ValueError(f"ffn={cfg.ffn!r} needs {ffn} in each block, got {sorted(blk)}")
    return to_torch(tree, device)


_CLIP_KEYS = {"patch_embed_w", "class_embedding", "pos_embed", "ln_pre", "ln_post", "proj",
              "blocks"}
_CLIP_BLOCK_KEYS = {"ln_1", "qkv", "out_proj", "ln_2", "fc1", "fc2"}


def clip_vision_from_jax(tree: dict, cfg, device="cpu") -> dict:
    """An `init_clip_vision` / ported CLIP vision tree (AlphaCLIP's
    `alpha_embed_w` included) -> the port's CLIP tower params."""
    if len(tree["blocks"]) != cfg.depth:
        raise ValueError(f"tree has {len(tree['blocks'])} blocks, cfg.depth={cfg.depth}")
    missing = _CLIP_KEYS - set(tree)
    if missing or set(tree) - _CLIP_KEYS - {"alpha_embed_w"}:
        raise ValueError(f"not a CLIP vision tree: keys {sorted(tree)}")
    _check_clip_blocks(tree)
    return to_torch(tree, device)


def _check_clip_blocks(tree: dict) -> None:
    for blk in tree["blocks"]:
        if set(blk) != _CLIP_BLOCK_KEYS:
            raise ValueError(f"a CLIP block needs {sorted(_CLIP_BLOCK_KEYS)}, got {sorted(blk)}")


_CLIP_TEXT_KEYS = {"token_embedding", "pos_embed", "ln_final", "text_projection", "blocks"}


def clip_text_from_jax(tree: dict, cfg, device="cpu") -> dict:
    """An `init_clip_text` / ported CLIP text tree -> the port's text tower
    params (`clip.clip_text_forward`)."""
    if len(tree["blocks"]) != cfg.depth:
        raise ValueError(f"tree has {len(tree['blocks'])} blocks, cfg.depth={cfg.depth}")
    if set(tree) != _CLIP_TEXT_KEYS:
        raise ValueError(f"not a CLIP text tree: keys {sorted(tree)}")
    _check_clip_blocks(tree)
    return to_torch(tree, device)


def resnet_clip_from_jax(tree: dict, cfg, device="cpu") -> dict:
    """An `init_resnet_clip` / `port_clip_resnet` tree of the JAX package ->
    the port's ResNet params: each convolution's HWIO kernel as torch's
    OIHW, every other leaf as it is."""
    if len(tree["layers"]) != len(cfg.layers) or any(
            len(blocks) != n for blocks, n in zip(tree["layers"], cfg.layers)):
        raise ValueError(f"tree has {[len(b) for b in tree['layers']]} blocks a layer, "
                         f"cfg.layers={cfg.layers}")

    def convs(node: dict) -> dict:
        return {k: (to_torch(v, device).permute(3, 2, 0, 1).contiguous()
                    if k.startswith(("conv", "down_conv")) else to_torch(v, device))
                for k, v in node.items()}

    return {"stem": convs(tree["stem"]),
            "layers": [[convs(blk) for blk in blocks] for blocks in tree["layers"]],
            "attnpool": to_torch(tree["attnpool"], device)}


def proxyclip_from_jax(tree: dict, cfg, device="cpu") -> dict:
    """ProxyCLIP's {'clip': CLIP vision tree, 'vfm': DINOv2 tree} of the JAX
    package -> the port's, each through its tower's bridge."""
    return {"clip": clip_vision_from_jax(tree["clip"], cfg.clip, device),
            "vfm": vit_from_jax(tree["vfm"], cfg.vfm, device)}


def decap_from_jax(params, device="cpu") -> decap.DecapParams:
    return decap.DecapParams(gpt2=to_torch(params.gpt2, device),
                             clip_project=to_torch(params.clip_project, device))


def bank_from_jax(bank, device="cpu"):
    """A JAX `PreparedBank` or `QuantizedBank` as the port's own; its padded
    tail comes along and stays masked by `num_real`."""
    kind = type(bank).__name__
    if kind not in ("PreparedBank", "QuantizedBank"):
        raise NotImplementedError(f"{kind} is not ported yet")
    fields = [_leaf(t, device) for t in bank[:-1]]
    return getattr(memproj, kind)(*fields, int(bank.num_real))


def mlp_w8_from_jax(quantized, device="cpu") -> tuple:
    """`quantize_mlp_weights`' (w1q, w1s, b1, w2q, w2s, b2) as tensors."""
    return tuple(_leaf(t, device) for t in quantized)


def inversion_from_jax(inv: dict, device="cpu") -> dict:
    return {"A_pinv": _leaf(inv["A_pinv"], device), "b": _leaf(inv["b"], device)}
