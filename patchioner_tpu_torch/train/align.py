"""Contrastive image-text alignment trainer (CLIP-style symmetric InfoNCE).

Twin of `patchioner_tpu/train/align.py`: a DINOv2-architecture ViT
(`models/vit.py`) and a CLIP text tower (`models/clip.py`) trained from
scratch on the synthetic world (`train/synthetic.py`), so that the
convergence proof (`scripts/convergence_proof_torch.py`) has a shared
embedding space without pretrained weights. The image embedding is the
masked mean over the final-norm patch tokens (the mask is the object's
patches), what the captioner pools under a trace at eval time.

On the card the ViT's forward runs kernels A, B and C inside their
`torch.autograd.Function`s (`ops/mlp.py`, `ops/attention.py`), whose
backwards are written in torch ops; the text tower, the out-projection
and the loss are plain torch. The optimizer is `decoder_train.AdamW`
with betas (0.9, 0.98) and a cosine decay, `optax.adamw(
cosine_decay_schedule(lr, steps), b1=0.9, b2=0.98, weight_decay=...)`.
Every device is explicit and defaults to the card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from patchioner_tpu_torch import entry
from patchioner_tpu_torch.models import clip as clip_mod
from patchioner_tpu_torch.models import vit as vit_mod
from patchioner_tpu_torch.models.patchioner import IMAGENET_MEAN, IMAGENET_STD
from patchioner_tpu_torch.text import clip_bpe
from patchioner_tpu_torch.train import decoder_train, synthetic

__all__ = ["AlignConfig", "init_align", "image_embed", "text_embed", "align_loss",
           "make_optimizer", "make_align_step", "tokens_and_masks", "train_align",
           "retrieval_accuracy"]


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    vit: vit_mod.ViTConfig
    text: clip_mod.ClipTextConfig
    lr: float = 1e-3
    weight_decay: float = 0.01
    steps: int = 400
    batch: int = 48
    init_logit_scale: float = 2.6593  # ln(1/0.07), CLIP's init
    max_logit_scale: float = 4.6052  # ln(100), CLIP's clamp

    def __post_init__(self):
        if self.text.proj_dim != self.vit.embed_dim:
            raise ValueError(
                "text proj_dim must equal the ViT embed_dim — the bank and "
                "the pooled patch features must share one space "
                f"({self.text.proj_dim} vs {self.vit.embed_dim})"
            )


def init_align(cfg: AlignConfig, generator: torch.Generator, device="cuda") -> dict:
    """Seeded random towers (`init_vit`, then `init_clip_text`, both drawn
    from `generator`) and CLIP's initial logit scale, on `device`."""
    device = entry.resolve_device(device)
    return {
        "vit": vit_mod.init_vit(cfg.vit, generator, device),
        "text": clip_mod.init_clip_text(cfg.text, generator, device),
        "logit_scale": torch.tensor(cfg.init_logit_scale, dtype=torch.float32,
                                    device=device),
    }


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


def image_embed(vit_params: dict, pixels_u8: torch.Tensor, vit_cfg: vit_mod.ViTConfig,
                patch_mask: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 + (B, P) bool -> (B, D) normalized masked-mean
    patch embedding, through the normalization and `vit_forward` the
    captioner runs at eval."""
    dev = pixels_u8.device
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=dev)
    x = (pixels_u8.float() / 255.0 - mean) / std
    toks = vit_mod.vit_forward(vit_params, x, vit_cfg)["x_norm_patchtokens"]
    m = patch_mask.to(toks.dtype)
    pooled = (toks * m[:, :, None]).sum(1) / m.sum(1, keepdim=True).clamp_min(1.0)
    return _l2(pooled)


def text_embed(text_params: dict, tokens: torch.Tensor,
               text_cfg: clip_mod.ClipTextConfig) -> torch.Tensor:
    return _l2(clip_mod.clip_text_forward(text_params, tokens, text_cfg))


def align_loss(params: dict, pixels: torch.Tensor, mask: torch.Tensor, tokens: torch.Tensor,
               cfg: AlignConfig):
    """(symmetric InfoNCE loss, batch accuracy of the image -> text argmax)
    with logits exp(clamp(logit_scale, 0, max)) * img @ txt^T. Batches must
    not repeat a caption (a duplicate is a false negative)."""
    img = image_embed(params["vit"], pixels, cfg.vit, mask)
    txt = text_embed(params["text"], tokens, cfg.text)
    scale = torch.exp(params["logit_scale"].clamp(0.0, cfg.max_logit_scale))
    logits = scale * img @ txt.T
    labels = torch.arange(logits.shape[0], device=logits.device)
    loss = 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))
    acc = (logits.argmax(dim=-1) == labels).float().mean()
    return loss, acc


def make_optimizer(cfg: AlignConfig) -> decoder_train.AdamW:
    """AdamW (b2 0.98) over a cosine decay to 0 at `cfg.steps`."""
    return decoder_train.AdamW(decoder_train.cosine_decay(cfg.lr, cfg.steps),
                               cfg.weight_decay, betas=(0.9, 0.98))


def make_align_step(cfg: AlignConfig):
    """step(params, opt_state, pixels_u8, patch_mask, tokens) -> (params,
    opt_state, metrics {loss, acc} as device tensors); the params are
    updated in place by the OptState that `make_optimizer(cfg).init(params)`
    gave."""

    def step(params, opt_state, pixels, mask, tokens):
        metrics = decoder_train._plain_apply(
            opt_state, lambda: align_loss(params, pixels, mask, tokens, cfg))
        return params, opt_state, metrics

    return step


def tokens_and_masks(cfg: AlignConfig, combos, grid: int) -> Tuple[np.ndarray, np.ndarray]:
    """The combos' captions as (N, context) int64 CLIP tokens and their
    objects' (N, grid * grid) bool patch masks."""
    tokens = clip_bpe.get_tokenizer().tokenize([c.caption for c in combos],
                                               cfg.text.context_length)
    masks = np.stack([synthetic.patch_mask_for(c, grid) for c in combos])
    return tokens.astype(np.int64), masks


def train_align(cfg: AlignConfig, combos, *, seed: int = 0, log_every: int = 50,
                verbose: bool = True, device="cuda") -> Tuple[dict, dict]:
    """Train the two towers on the synthetic world. Returns (params, info).

    The towers are drawn from a generator seeded `seed` on `device`
    (`init_align`) and trained in place. Each step renders a fresh
    batch of unique combos with the host generator `default_rng(seed + 1)`,
    as the JAX trainer does: the jitter is the augmentation, uniqueness
    keeps false negatives out. `info["steps_per_s"]` is the rate of the
    steps after the first (on the card, synchronised)."""
    device = entry.resolve_device(device)
    tokens_all, masks_all = tokens_and_masks(cfg, combos, cfg.vit.grid_size)
    tokens_all = torch.from_numpy(tokens_all).to(device)
    masks_all = torch.from_numpy(masks_all).to(device)
    params = init_align(cfg, torch.Generator(device=device).manual_seed(seed), device)
    opt_state = make_optimizer(cfg).init(params)
    step_fn = make_align_step(cfg)

    rng = np.random.default_rng(seed + 1)
    n = len(combos)
    bs = min(cfg.batch, n)
    history = []
    for step in range(cfg.steps):
        idx = rng.permutation(n)[:bs]
        pixels = synthetic.render_training_batch([combos[i] for i in idx], rng,
                                                 cfg.vit.img_size)
        at = torch.from_numpy(idx).to(device)
        params, opt_state, metrics = step_fn(
            params, opt_state, torch.from_numpy(pixels).to(device), masks_all[at],
            tokens_all[at])
        if step == 0:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t_first = time.perf_counter()
        if (step + 1) % log_every == 0 or step == cfg.steps - 1:
            loss, acc = float(metrics["loss"]), float(metrics["acc"])
            history.append({"step": step + 1, "loss": loss, "acc": acc})
            if verbose:
                print(f"align step {step + 1}/{cfg.steps} loss {loss:.4f} batch-acc {acc:.3f}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timed = cfg.steps - 1
    rate = timed / (time.perf_counter() - t_first) if timed > 0 else None
    return params, {"history": history, "final": history[-1] if history else None,
                    "steps_per_s": rate}


@torch.no_grad()
def retrieval_accuracy(params: dict, cfg: AlignConfig, combos, *, seed: int = 123) -> float:
    """Fraction of fresh renderings whose masked-mean image embedding ranks
    its own caption first among all combos' captions: the alignment gate
    the convergence proof pins. Runs on the params' device."""
    device = params["logit_scale"].device
    tokens, masks = tokens_and_masks(cfg, combos, cfg.vit.grid_size)
    txt = text_embed(params["text"], torch.from_numpy(tokens).to(device), cfg.text)
    pixels = synthetic.render_training_batch(combos, np.random.default_rng(seed),
                                             cfg.vit.img_size)
    img = image_embed(params["vit"], torch.from_numpy(pixels).to(device), cfg.vit,
                      torch.from_numpy(masks).to(device))
    pred = (img @ txt.T).argmax(dim=-1)
    return float((pred == torch.arange(len(combos), device=device)).float().mean())
