"""Frozen text-encoder spaces for decoder training and bank building.

Twin of `patchioner_tpu/train/text_spaces.py`. The reference trains the
DeCap decoder, and builds support-memory banks, in five text spaces
(src/decap/decoderTraining.py:84-208): plain CLIP, open_clip, DINO.txt
(2048 wide; training takes the patch-aligned half `[:, 1024:]`, :302-303),
RegionCLIP (keys under 'lang_encoder.', projection 1024 for RN50) and
DenseCLIP (keys under 'text_encoder.', context 13 from its config). All
five are the same causal CLIP text transformer in the openai/CLIP layout,
so a space is a geometry, a checkpoint prefix and a tokenizer context in
front of `clip.clip_text_forward`. Without a checkpoint a space is a
seeded random tower at its documented geometry, said so on stdout.

A space holds its device: its weights live there, `encode_tokens` returns
a tensor there, `encode_texts` and `encode_texts_for_bank` numpy arrays.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from patchioner_tpu_torch import entry
from patchioner_tpu_torch.models import clip, dinotxt, vit

__all__ = ["TextSpace", "TEXT_SPACE_NAMES", "build_text_space"]

TEXT_SPACE_NAMES = ("clip", "open_clip", "dinotxt", "regionclip", "denseclip")

# where each space's text tower sits in its checkpoint
CHECKPOINT_PREFIX = {"clip": "", "open_clip": "", "dinotxt": "text_model.",
                     "regionclip": "lang_encoder.", "denseclip": "text_encoder."}


@dataclasses.dataclass
class TextSpace:
    """A frozen text encoder: tokenize -> encode -> (B, prefix_size)."""

    name: str
    prefix_size: int
    cfg: clip.ClipTextConfig
    params: dict
    device: torch.device
    # the raw tower output -> the training-space feature (DINO.txt's
    # patch-aligned half; identity for the other spaces)
    _post: Optional[Callable] = None

    def tokenize(self, texts: Sequence[str]) -> np.ndarray:
        """(B, context) int32 ids at the tower's context (13 for DenseCLIP)."""
        from patchioner_tpu_torch.text import clip_bpe

        return clip_bpe.get_tokenizer().tokenize(texts, self.cfg.context_length)

    def encode_tokens_raw(self, tokens) -> torch.Tensor:
        """(B, T) int tokens -> (B, proj_dim), the tower's whole output."""
        return clip.clip_text_forward(self.params, torch.as_tensor(tokens), self.cfg)

    def encode_tokens(self, tokens) -> torch.Tensor:
        """(B, T) int tokens -> (B, prefix_size) training-space features."""
        feats = self.encode_tokens_raw(tokens)
        return self._post(feats) if self._post is not None else feats

    def _encode(self, texts: Sequence[str], batch_size: int, fn, width: int) -> np.ndarray:
        chunks = [fn(self.tokenize(list(texts[i:i + batch_size]))).float().cpu().numpy()
                  for i in range(0, len(texts), batch_size)]
        return np.concatenate(chunks) if chunks else np.zeros((0, width), np.float32)

    def encode_texts(self, texts: Sequence[str], batch_size: int = 256) -> np.ndarray:
        return self._encode(texts, batch_size, self.encode_tokens, self.prefix_size)

    def encode_texts_for_bank(self, texts: Sequence[str], batch_size: int = 256) -> np.ndarray:
        """The raw tower output: a bank keeps every column (2048 for
        DINO.txt; `load_bank(dinotxt_slice=True)` takes [:, 1024:] at load,
        im2txtprojection.py:405-406)."""
        return self._encode(texts, batch_size, self.encode_tokens_raw, self.cfg.proj_dim)


def _load_state_dict(path: str) -> dict:
    """A checkpoint's state dict, unwrapped from a `state_dict` or `model`
    entry when it has one."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(ckpt, dict) and isinstance(ckpt.get(key), dict):
            return ckpt[key]
    return ckpt


def _geometry_from_sd(sd: dict) -> clip.ClipTextConfig:
    """The tower's geometry from a prefix-stripped openai-layout state dict
    (as src/regionclip/loader.py:200-210 reads it): depth from the largest
    resblock index; heads = width // 64, the CLIP family's head width (the
    count is not in the shapes; DINO.txt's 1280 gives its 20)."""
    vocab, width = sd["token_embedding.weight"].shape
    depth = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("transformer.resblocks."))
    return clip.ClipTextConfig(
        vocab_size=int(vocab), context_length=int(sd["positional_embedding"].shape[0]),
        width=int(width), depth=depth, heads=int(width) // 64,
        proj_dim=int(sd["text_projection"].shape[1]))


def _hf_geometry(sd: dict) -> clip.ClipTextConfig:
    """The same from a transformers CLIPTextModelWithProjection export; its
    `text_projection.weight` is an `nn.Linear` (proj, D)."""
    e = "text_model.embeddings"
    vocab, width = sd[f"{e}.token_embedding.weight"].shape
    depth = 1 + max(int(k.split(".")[3]) for k in sd
                    if k.startswith("text_model.encoder.layers."))
    return clip.ClipTextConfig(
        vocab_size=int(vocab), context_length=int(sd[f"{e}.position_embedding.weight"].shape[0]),
        width=int(width), depth=depth, heads=int(width) // 64,
        proj_dim=int(sd["text_projection.weight"].shape[0]))


def _strip(sd: dict, prefix: str) -> dict:
    out = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return out or dict(sd)


def _denseclip_text_cfg(config_name: str) -> clip.ClipTextConfig:
    """DenseCLIP's text geometry (`model.text`) from the port's JSON copy of
    the config (the card's machine has no PyYAML)."""
    from patchioner_tpu_torch.models.patchioner import _denseclip_config

    text = _denseclip_config(config_name).get("model", {}).get("text", {})
    return clip.ClipTextConfig(
        vocab_size=int(text.get("vocab_size", 49408)),
        context_length=int(text.get("context_length", 13)),
        width=int(text.get("transformer_width", 512)),
        depth=int(text.get("transformer_layers", 12)),
        heads=int(text.get("transformer_heads", 8)),
        proj_dim=int(text.get("embed_dim", 512)))


def _random_geometry(name: str, denseclip_config: str) -> clip.ClipTextConfig:
    if name == "dinotxt":
        return dinotxt.DINOTXT_TEXT_CONFIG
    if name == "denseclip":
        return _denseclip_text_cfg(denseclip_config)
    if name == "regionclip":
        # RN50 detection checkpoints: a 512-wide tower projected to 1024
        # (decoderTraining.py:86-88)
        return clip.ClipTextConfig(proj_dim=1024)
    return clip.ClipTextConfig()  # clip / open_clip: ViT-B


def build_text_space(name: str, weights: Optional[str] = None, *,
                     denseclip_config: str = "denseclip_segmentation_vitb16", seed: int = 0,
                     device="cuda") -> TextSpace:
    """The frozen text space `name` on `device` (the card unless asked for
    the CPU): `weights` ported when the file exists, else a tower drawn
    from `seed` at the space's documented geometry."""
    if name not in TEXT_SPACE_NAMES:
        raise ValueError(f"unknown text space {name!r}; choose from {TEXT_SPACE_NAMES}")
    device = entry.resolve_device(device)
    sd = None
    if weights and os.path.exists(weights):
        sd = _strip(_load_state_dict(weights), CHECKPOINT_PREFIX[name])
        if name == "dinotxt":
            sd = dinotxt._unnest(sd)
    if sd is not None and name == "clip" and "text_model.embeddings.token_embedding.weight" in sd:
        cfg = _hf_geometry(sd)
        params = clip.port_hf_clip_text(sd, cfg.depth)
    elif sd is not None:
        cfg = _geometry_from_sd(sd)
        params = clip.port_openai_clip_text(sd, cfg.depth)
    else:
        where = f"text weights not found at {weights}" if weights else "no text weights"
        print(f"[!] {where} — seeded random {name} encoder")
        cfg = _random_geometry(name, denseclip_config)
        params = clip.init_clip_text(cfg, torch.Generator(device=device).manual_seed(seed),
                                     device)
    params = vit.cast_params(params, torch.float32, device)
    post, prefix_size = None, cfg.proj_dim
    if name == "dinotxt":
        if cfg.proj_dim % 2:
            raise ValueError("dinotxt text tower must have an even proj dim (CLS-aligned | "
                             f"patch-aligned halves); got {cfg.proj_dim}")
        half = prefix_size = cfg.proj_dim // 2

        def post(f):  # the patch-aligned half (decoderTraining.py:302-303)
            return f[:, half:]
    return TextSpace(name=name, prefix_size=prefix_size, cfg=cfg, params=params,
                     device=device, _post=post)
