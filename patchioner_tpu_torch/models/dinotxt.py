"""DINO.txt: its text tower and its checkpoint porters, in PyTorch.

Twin of `patchioner_tpu/models/dinotxt.py` (reference src/model.py:345-346,
src/dinotxt_utils.py:11-43, im2txtprojection.py:405-406,520,680-682). The
release `dinov2_vitl14_reg4_dinotxt_tet1280d20h24l` carries a DINOv2
ViT-L/14 with 4 registers (the backbone, under
`visual_model.backbone.model.`) and a causal CLIP-style text tower 1280
wide, 20 heads, 24 layers (under `text_model.`), whose 2048-wide output is
a CLS-aligned half then a patch-aligned half: bank rows keep all 2048
columns, and a bank is read with its columns [1024:]. The tower is
`clip.clip_text_forward` at this geometry, plain PyTorch.

`Patchioner.from_config` serves the backbone: a `dino_model` naming
`dinotxt` builds DINOv2 ViT-L/14 with registers on kernels A, B and C,
its `dino_weights` ported by `port_dinotxt_visual`, and the bank read with
its columns [1024:].
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from patchioner_tpu_torch import entry
from patchioner_tpu_torch.models import clip, vit

__all__ = ["DINOTXT_TEXT_CONFIG", "init_dinotxt_text", "encode_text", "tokenize",
           "visual_state_dict", "port_dinotxt_visual", "port_dinotxt_text", "port_dinotxt", "DinotxtTextEncoder"]

# tet1280d20h24l; output 2048 = [CLS-aligned 1024 | patch-aligned 1024]
DINOTXT_TEXT_CONFIG = clip.ClipTextConfig(vocab_size=49408, context_length=77, width=1280,
                                          depth=24, heads=20, proj_dim=2048)

_VISUAL_PREFIX = "visual_model.backbone.model."
_TEXT_PREFIX = "text_model."


def init_dinotxt_text(generator: torch.Generator, cfg=DINOTXT_TEXT_CONFIG,
                      device="cpu") -> dict:
    return clip.init_clip_text(cfg, generator, device)


def encode_text(params: dict, tokens, cfg=DINOTXT_TEXT_CONFIG) -> torch.Tensor:
    """(B, 77) int tokens -> (B, 2048) DINO.txt text embeddings."""
    return clip.clip_text_forward(params, torch.as_tensor(tokens), cfg)


def tokenize(texts: Sequence[str], context_length: int = 77) -> np.ndarray:
    """CLIP-BPE with SOT and EOT, zero-padded, cut with EOT kept last (the
    DINO.txt tokenizer subclasses CLIP's, src/dinotxt_utils.py:15-43)."""
    from patchioner_tpu_torch.text import clip_bpe

    return clip_bpe.get_tokenizer().tokenize(texts, context_length)


def _strip_prefix(sd: Mapping, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def visual_state_dict(sd: Mapping) -> dict:
    """The inner DINOv2 backbone's keys of a DINO.txt checkpoint (under
    `visual_model.backbone.model.`), or the state dict as it is when it
    has none."""
    return _strip_prefix(sd, _VISUAL_PREFIX) or dict(sd)


def port_dinotxt_visual(sd: Mapping, depth: int = 24, num_registers: int = 4) -> dict:
    """The inner DINOv2 backbone of a DINO.txt checkpoint (keys under
    `visual_model.backbone.model.`), or a bare DINOv2 state dict, through
    `io.torch_port.port_dinov2`."""
    from patchioner_tpu_torch.io import torch_port

    inner = visual_state_dict(sd)
    if "cls_token" not in inner:
        raise KeyError("dinotxt visual port: no 'visual_model.backbone.model.*' keys and no "
                       f"bare DINOv2 layout; got e.g. {sorted(sd)[:5]}")
    return torch_port.port_dinov2(inner, depth=depth, num_registers=num_registers)


def _unnest(sd: dict) -> dict:
    """One extra nesting level (e.g. `backbone.token_embedding.weight`)
    taken off when a single key prefix holds the token embedding."""
    if "token_embedding.weight" not in sd:
        heads = {k.split(".", 1)[0] for k in sd if "token_embedding" in k}
        if len(heads) == 1:
            return _strip_prefix(sd, heads.pop() + ".")
    return sd


def port_dinotxt_text(sd: Mapping, depth: int = 24) -> dict:
    """The text tower in the openai/CLIP layout under `text_model.` (or
    bare), one extra nesting level tolerated (`text_model.backbone.*`)."""
    inner = _unnest(_strip_prefix(sd, _TEXT_PREFIX) or dict(sd))
    return clip.port_openai_clip_text(inner, depth)


def port_dinotxt(sd: Mapping, *, visual_depth: int = 24, num_registers: int = 4,
                 text_depth: int = 24) -> dict:
    """A full checkpoint -> {"visual": ViT params, "text": text params}. A
    checkpoint without `text_model.*` keys gives `text: None`; one with
    them whose text port fails raises (a bank must not be built without
    the tower the checkpoint carries)."""
    out = {"visual": port_dinotxt_visual(sd, visual_depth, num_registers)}
    has_text = any(k.startswith(_TEXT_PREFIX) for k in sd)
    out["text"] = port_dinotxt_text(sd, text_depth) if has_text else None
    return out


class DinotxtTextEncoder:
    """`encode_texts` for bank building (the role of the hub model and its
    tokenizer, im2txtprojection.py:680-682): the tower's params cast to f32
    on `device`, the card unless asked for the CPU."""

    def __init__(self, params: dict, cfg=DINOTXT_TEXT_CONFIG, device="cuda"):
        self.device = entry.resolve_device(device)
        self.params = vit.cast_params(params, torch.float32, self.device)
        self.cfg = cfg

    def encode_texts(self, texts: Sequence[str], batch_size: int = 256) -> np.ndarray:
        chunks = [encode_text(self.params, tokenize(texts[i:i + batch_size],
                                                    self.cfg.context_length), self.cfg)
                  .float().cpu().numpy() for i in range(0, len(texts), batch_size)]
        return (np.concatenate(chunks) if chunks
                else np.zeros((0, self.cfg.proj_dim), np.float32))
