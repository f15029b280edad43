"""Published torch checkpoints -> the port's parameter trees.

Twin of `patchioner_tpu/io/torch_port.py`: the torch.hub DINOv2 layout
(`port_dinov2`), the transformers `Dinov2Model` layout (`port_hf_dinov2`,
q/k/v fused into one qkv, SwiGLU's `weights_in` / `weights_out`), a
transformers `GPT2LMHeadModel` (`port_hf_gpt2_lmhead`), a DeCap
checkpoint (`port_decap`) and Talk2DINO's `ProjectionLayer`
(`port_talk2dino`). The trees are the ones `io.bridge` makes from the JAX
package's arrays, of contiguous f32 CPU tensors: each dense weight is
stored (in, out), so a torch `nn.Linear` weight is transposed and GPT-2's
`Conv1D` is not, and the patch conv becomes one dense weight in the order
`vit.patch_embed` flattens a patch.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["port_dinov2", "port_hf_dinov2", "port_hf_gpt2_lmhead", "port_decap",
           "port_talk2dino"]


def _t(x) -> torch.Tensor:
    """A checkpoint tensor (torch or numpy, any float type) as a contiguous
    f32 CPU tensor; widening from bf16 or f16 is exact."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.asarray(x))
    return x.detach().to("cpu", torch.float32).contiguous()


def _linear(sd: Mapping, prefix: str) -> dict:
    """A torch `nn.Linear` (out, in) as {'w': (in, out), 'b'}."""
    return {"w": _t(sd[f"{prefix}.weight"]).t().contiguous(),
            "b": _t(sd[f"{prefix}.bias"])}


def _ln(sd: Mapping, prefix: str) -> dict:
    return {"scale": _t(sd[f"{prefix}.weight"]), "bias": _t(sd[f"{prefix}.bias"])}


def _patch_conv_to_dense(w_conv: torch.Tensor) -> torch.Tensor:
    """(D, 3, P, P) conv kernel -> (P * P * 3, D): a patch's pixels row-major,
    channel last, as `vit.patch_embed` flattens them."""
    d, c, p, _ = w_conv.shape
    return w_conv.permute(2, 3, 1, 0).reshape(p * p * c, d).contiguous()


def port_dinov2(sd: Mapping, depth: int, num_registers: int) -> dict:
    """A facebookresearch/dinov2 torch.hub state dict: cls_token, pos_embed,
    register_tokens, patch_embed.proj.*, norm.*, and per block norm1,
    attn.qkv, attn.proj, ls1.gamma, norm2, ls2.gamma and mlp.fc1 / mlp.fc2
    (S, B, L) or giant's fused SwiGLU mlp.w12 / mlp.w3."""
    params = {
        "cls_token": _t(sd["cls_token"]),
        "pos_embed": _t(sd["pos_embed"]),
        "patch_embed": {"w": _patch_conv_to_dense(_t(sd["patch_embed.proj.weight"])),
                        "b": _t(sd["patch_embed.proj.bias"])},
        "norm": _ln(sd, "norm"),
        "blocks": [],
    }
    if num_registers:
        params["register_tokens"] = _t(sd["register_tokens"])
    for i in range(depth):
        p = f"blocks.{i}"
        blk = {"norm1": _ln(sd, f"{p}.norm1"), "qkv": _linear(sd, f"{p}.attn.qkv"),
               "proj": _linear(sd, f"{p}.attn.proj"), "norm2": _ln(sd, f"{p}.norm2")}
        if f"{p}.mlp.w12.weight" in sd:
            blk["w12"] = _linear(sd, f"{p}.mlp.w12")
            blk["w3"] = _linear(sd, f"{p}.mlp.w3")
        else:
            blk["fc1"] = _linear(sd, f"{p}.mlp.fc1")
            blk["fc2"] = _linear(sd, f"{p}.mlp.fc2")
        if f"{p}.ls1.gamma" in sd:
            blk["ls1"] = _t(sd[f"{p}.ls1.gamma"])
            blk["ls2"] = _t(sd[f"{p}.ls2.gamma"])
        params["blocks"].append(blk)
    return params


def port_hf_dinov2(sd: Mapping, depth: int, num_registers: int) -> dict:
    """A transformers Dinov2Model / Dinov2WithRegistersModel state dict: its
    separate query, key and value linears are fused into the qkv layout."""
    emb = "embeddings"
    params = {
        "cls_token": _t(sd[f"{emb}.cls_token"]),
        "pos_embed": _t(sd[f"{emb}.position_embeddings"]),
        "patch_embed": {
            "w": _patch_conv_to_dense(_t(sd[f"{emb}.patch_embeddings.projection.weight"])),
            "b": _t(sd[f"{emb}.patch_embeddings.projection.bias"])},
        "norm": _ln(sd, "layernorm"),
        "blocks": [],
    }
    if num_registers:
        params["register_tokens"] = _t(sd[f"{emb}.register_tokens"])
    for i in range(depth):
        p = f"encoder.layer.{i}"
        att = f"{p}.attention.attention"
        blk = {
            "norm1": _ln(sd, f"{p}.norm1"),
            "qkv": {"w": torch.cat([_t(sd[f"{att}.{k}.weight"])
                                    for k in ("query", "key", "value")]).t().contiguous(),
                    "b": torch.cat([_t(sd[f"{att}.{k}.bias"])
                                    for k in ("query", "key", "value")])},
            "proj": _linear(sd, f"{p}.attention.output.dense"),
            "norm2": _ln(sd, f"{p}.norm2"),
            "ls1": _t(sd[f"{p}.layer_scale1.lambda1"]),
            "ls2": _t(sd[f"{p}.layer_scale2.lambda1"]),
        }
        if f"{p}.mlp.weights_in.weight" in sd:  # use_swiglu_ffn (giant)
            blk["w12"] = _linear(sd, f"{p}.mlp.weights_in")
            blk["w3"] = _linear(sd, f"{p}.mlp.weights_out")
        else:
            blk["fc1"] = _linear(sd, f"{p}.mlp.fc1")
            blk["fc2"] = _linear(sd, f"{p}.mlp.fc2")
        params["blocks"].append(blk)
    return params


def port_hf_gpt2_lmhead(sd: Mapping, n_layer: int, prefix: str = "") -> dict:
    """A transformers GPT2LMHeadModel state dict under `prefix`. GPT-2's
    Conv1D already stores (in, out); the LM head is tied to wte."""

    def dense(key):
        return {"w": _t(sd[f"{prefix}{key}.weight"]), "b": _t(sd[f"{prefix}{key}.bias"])}

    def ln(key):
        return {"scale": _t(sd[f"{prefix}{key}.weight"]),
                "bias": _t(sd[f"{prefix}{key}.bias"])}

    params = {"wte": _t(sd[f"{prefix}transformer.wte.weight"]),
              "wpe": _t(sd[f"{prefix}transformer.wpe.weight"]),
              "ln_f": ln("transformer.ln_f"), "blocks": []}
    for i in range(n_layer):
        p = f"transformer.h.{i}"
        params["blocks"].append({
            "ln_1": ln(f"{p}.ln_1"),
            "attn": {"c_attn": dense(f"{p}.attn.c_attn"), "c_proj": dense(f"{p}.attn.c_proj")},
            "ln_2": ln(f"{p}.ln_2"),
            "mlp": {"c_fc": dense(f"{p}.mlp.c_fc"), "c_proj": dense(f"{p}.mlp.c_proj")},
        })
    return params


def port_decap(sd: Mapping, n_layer: int = 4) -> dict:
    """A DeCap checkpoint: decoder.* is the GPT-2 LM head model and
    clip_project.model.0.* the prefix mapper, one `nn.Linear` (reference
    src/decap/decap.py:61-79)."""
    return {"gpt2": port_hf_gpt2_lmhead(sd, n_layer, prefix="decoder."),
            "clip_project": _linear(sd, "clip_project.model.0")}


def port_talk2dino(sd: Mapping) -> dict:
    """Talk2DINO's ProjectionLayer: linear_layer and hidden_layers.N
    (reference src/talk2dino/talk2dino.py:6-97); the legacy name
    `linear_layer2` of hidden layer 0 is taken too."""
    sd = dict(sd)
    if "linear_layer2.weight" in sd:
        sd["hidden_layers.0.weight"] = sd.pop("linear_layer2.weight")
        sd["hidden_layers.0.bias"] = sd.pop("linear_layer2.bias")
    params = {"linear": _linear(sd, "linear_layer"), "hidden": []}
    i = 0
    while f"hidden_layers.{i}.weight" in sd:
        params["hidden"].append(_linear(sd, f"hidden_layers.{i}"))
        i += 1
    return params
