"""Prefix-mapper training: the ViECap and ClipCap training loops.

Twin of `patchioner_tpu/train/prefix_train.py` (reference
src/viecap/training/main.py:26-105, the MappingNetwork trained on
text-only captions with feature noise, GPT-2 frozen; and
src/clipcap/clipcapTraining.py, the prefix mapper with `only_prefix`). One
step covers both: gradients flow through the mapper only, the language
model's leaves have requires_grad False. The CE is the standard shift
(position prefix_len - 1 + i predicts token i) under an explicit mask.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from patchioner_tpu_torch.io.checkpoints import flatten_tree
from patchioner_tpu_torch.models import gpt2 as gpt2_mod
from patchioner_tpu_torch.train.decoder_train import _lm_head_weight, _smoothed_ce_chunked

__all__ = ["PrefixTrainConfig", "noise_injection", "prefix_loss", "make_prefix_train_step"]


@dataclasses.dataclass(frozen=True)
class PrefixTrainConfig:
    lr: float = 2e-5  # viecap/training/main.py default
    warmup_steps: int = 5000
    total_steps: int = 100_000
    noise_variance: float = 0.016  # ViECap text-only noise (main.py:48)
    # transformers.AdamW's default, which both reference loops build
    # (main.py:51, clipcapTraining.py:300), not torch AdamW's 0.01
    weight_decay: float = 0.0
    # the lm head + CE `loss_chunk` positions at a time (decoder
    # training's TrainConfig.loss_chunk); 0 = the full logits
    loss_chunk: int = 0


@torch.no_grad()
def noise_injection(features: torch.Tensor, variance: float, *,
                    noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """ViECap's feature noise (viecap/training/utils.py:6-22): L2
    normalize, add sqrt(variance) times a standard-normal draw (`noise`,
    else drawn from `generator`), re-normalize. The flag is a variance
    (main.py:122, default 0.016); variance 0 is the identity."""
    if not variance:
        return features
    features = features / torch.linalg.vector_norm(features, dim=-1, keepdim=True)
    if noise is None:
        noise = torch.randn(features.shape, generator=generator, device=features.device,
                            dtype=features.dtype)
    features = features + (variance ** 0.5) * noise
    return features / torch.linalg.vector_norm(features, dim=-1, keepdim=True)


def prefix_loss(mapper_params, mapper_fn: Callable, gpt2_params: dict,
                features: torch.Tensor, tokens: torch.Tensor, mask: torch.Tensor,
                gpt2_cfg: gpt2_mod.GPT2Config, hard_tokens: Optional[torch.Tensor] = None,
                loss_chunk: int = 0):
    """CE and accuracy of the caption tokens given [hard prompt || soft
    prefix] (or the soft prefix alone). tokens: (B, T) 0-padded; mask:
    (B, T) 1 for real tokens (a genuine token id 0 under mask 1 scores).

    mapper_fn(mapper_params, features) -> (B, L, D) soft prompt.
    loss_chunk > 0 applies the tied-wte lm head `loss_chunk` positions at
    a time (`decoder_train._smoothed_ce_chunked` without smoothing)."""
    tokens = tokens.long()
    soft = mapper_fn(mapper_params, features)
    parts = [soft, gpt2_params["wte"][tokens]]
    prefix_len = soft.shape[1]
    if hard_tokens is not None:
        parts.insert(0, gpt2_params["wte"][hard_tokens.long()])
        prefix_len += hard_tokens.shape[1]
    embeds = torch.cat(parts, dim=1)
    if loss_chunk:
        hidden = gpt2_mod.gpt2_hidden(gpt2_params, embeds, gpt2_cfg)[:, prefix_len - 1:-1]
        return _smoothed_ce_chunked(hidden, _lm_head_weight(gpt2_params, gpt2_cfg), tokens,
                                    0.0, loss_chunk, mask=mask)
    logits = gpt2_mod.gpt2_forward(gpt2_params, embeds, gpt2_cfg)
    pred = logits[:, prefix_len - 1:-1]
    logp = torch.log_softmax(pred.float(), dim=-1)
    nll = -logp.gather(-1, tokens[..., None])[..., 0]
    m = mask.float()
    denom = m.sum().clamp_min(1.0)
    loss = (nll * m).sum() / denom
    acc = ((pred.argmax(dim=-1) == tokens).float() * m).sum() / denom
    return loss, acc


def make_prefix_train_step(mapper_fn: Callable, gpt2_cfg: gpt2_mod.GPT2Config,
                           cfg: PrefixTrainConfig):
    """step(mapper_params, opt_state, gpt2_params, features, tokens, mask,
    generator=None, noise=None) -> (mapper_params, opt_state, metrics),
    the mapper updated in place by `opt_state` (an OptState of the mapper's
    leaves). The language model is a frozen input (ClipCaptionPrefix,
    clipcap/entrypoint.py:185-193): its leaves are set to requires_grad
    False. The feature noise is `noise` or drawn from `generator`."""

    def step(mapper_params, opt_state, gpt2_params, features, tokens, mask,
             generator=None, noise=None):
        for _, leaf in flatten_tree(gpt2_params):
            leaf.requires_grad_(False)
        features = noise_injection(features, cfg.noise_variance, noise=noise,
                                   generator=generator)
        opt_state.zero_grad()
        loss, acc = prefix_loss(mapper_params, mapper_fn, gpt2_params, features, tokens, mask,
                                gpt2_cfg, loss_chunk=cfg.loss_chunk)
        loss.backward()
        opt_state.apply()
        return mapper_params, opt_state, {"loss": loss.detach(), "acc": acc.detach()}

    return step
