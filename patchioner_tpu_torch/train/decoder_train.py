"""DeCap/CapDec decoder training: text-only caption reconstruction.

Twin of `patchioner_tpu/train/decoder_train.py` (reference
src/decap/decoderTraining.py:62-387). A caption's frozen text embedding is
optionally memory-projected (`--im_proj`, normalize=True) and noised
(CapDec, re-normalized); DeCap reconstructs the caption under a
label-smoothed CE (ignore_index 0, smoothing 0.1), with AdamW and a linear
warmup-then-decay schedule.

A step takes the JAX step's inputs and returns its metrics, `loss` and
`acc`, as device tensors. The parameters are the tree's own tensors,
updated in place by `torch.optim.AdamW`; `make_optimizer` gives the
learning rate optax gives at every update. The frozen pipeline
(`prepare_features`) runs under `torch.no_grad`, through kernel D when the
bank is on the card and its plain version on the CPU. The tied wte is one
leaf: the embedding and the lm head add into one gradient. The mesh (dp,
mp) of the JAX step is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from patchioner_tpu_torch.io.checkpoints import flatten_tree
from patchioner_tpu_torch.models import decap as decap_mod
from patchioner_tpu_torch.models import gpt2 as gpt2_mod
from patchioner_tpu_torch.ops import memory_projection as memproj
from patchioner_tpu_torch.train.packing import PackedBatch

__all__ = [
    "TrainConfig", "decap_loss", "decap_loss_packed", "prepare_features",
    "linear_warmup_decay", "cosine_decay", "AdamW", "OptState", "make_optimizer",
    "make_train_step", "make_packed_train_step", "pack_to_device",
]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-5  # reference CLI default (decoderTraining.py:418)
    warmup_steps: int = 1000  # train_decoder's default (:63)
    total_steps: int = 100_000
    # torch AdamW's default decoupled weight decay, which the reference
    # runs (decoderTraining.py:255)
    weight_decay: float = 0.01
    label_smoothing: float = 0.1  # :229
    gaussian_noise: float = 0.0  # CapDec (:314-316)
    grad_clip: Optional[float] = None
    # lm head + CE `loss_chunk` positions at a time, each chunk recomputed
    # in the backward, so the (B, T, V) f32 logits are never live; 0 = the
    # plain loss
    loss_chunk: int = 0
    # micro-batches per update: the step takes inputs with a leading
    # (grad_accum,) axis, sums the micro-batches' gradients and divides by
    # the global count of scored tokens, the big batch's gradient; 1 = off
    grad_accum: int = 1


def _smoothed_ce(logits, targets, label_smoothing, ignore_index=0):
    """torch.nn.CrossEntropyLoss(ignore_index=0, label_smoothing=0.1): the
    mean over non-ignored positions of the smoothed NLL; and the mask."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    smooth = -logp.mean(dim=-1)
    loss = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    mask = (targets != ignore_index).float()
    return (loss * mask).sum() / mask.sum().clamp_min(1.0), mask


def _ce_chunk(h, tgt, m, wte, label_smoothing):
    """One chunk's (loss sum, correct count) from post-ln_f hidden states:
    logp = logits - lse, so nll = lse - logits[target] and -mean(logp) =
    lse - mean(logits)."""
    logits = torch.matmul(h, wte.T).float()  # (B, chunk, V)
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - logits.gather(-1, tgt[..., None])[..., 0]
    smooth = lse - logits.mean(dim=-1)
    loss = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    correct = (logits.argmax(dim=-1) == tgt).float() * m
    return (loss * m).sum(), correct.sum()


def _smoothed_ce_chunked(hidden, wte, targets, label_smoothing, chunk,
                         ignore_index=0, mask=None):
    """`_smoothed_ce` and the argmax accuracy from post-ln_f hidden states,
    the tied-wte lm head applied `chunk` positions at a time. Each chunk
    runs under `torch.utils.checkpoint`, so the backward re-derives its
    (B, chunk, V) logits and only one such block is live at a time.

    `mask` (B, T), when given, replaces `targets != ignore_index` (prefix
    training passes its explicit mask, so a genuine token id 0 under
    mask 1 scores)."""
    targets = targets.long()
    mask = ((targets != ignore_index) if mask is None else mask).float()
    loss_sum = corr_sum = 0.0
    for lo in range(0, hidden.shape[1], chunk):
        sl = slice(lo, lo + chunk)
        ls, cs = checkpoint(_ce_chunk, hidden[:, sl], targets[:, sl], mask[:, sl], wte,
                            label_smoothing, use_reentrant=False)
        loss_sum, corr_sum = loss_sum + ls, corr_sum + cs
    denom = mask.sum().clamp_min(1.0)
    return loss_sum / denom, corr_sum / denom


def _lm_head_weight(params: dict, cfg: gpt2_mod.GPT2Config) -> torch.Tensor:
    wte = params["wte"]
    return wte if cfg.dtype == torch.float32 else wte.to(cfg.dtype)


def decap_loss(params: decap_mod.DecapParams, features: torch.Tensor, tokens: torch.Tensor,
               gpt2_cfg: gpt2_mod.GPT2Config, *, label_smoothing: float = 0.1,
               loss_chunk: int = 0):
    """CE reconstruction loss and accuracy.

    features: (B, prefix) already projected / noised / normalized.
    tokens:   (B, T) caption token ids, 0-padded.

    The prefix takes position 0 and logits[:, :-1] predict tokens[:, :]
    (reference :323-330). loss_chunk > 0 applies the lm head in position
    chunks (`_smoothed_ce_chunked`)."""
    tokens = tokens.long()
    prefix_emb = decap_mod.decap_project_prefix(params, features)[:, None, :]
    tok_emb = params.gpt2["wte"][tokens]
    embeds = torch.cat([prefix_emb, tok_emb], dim=1)
    if loss_chunk:
        hidden = gpt2_mod.gpt2_hidden(params.gpt2, embeds, gpt2_cfg)[:, :-1]
        return _smoothed_ce_chunked(hidden, _lm_head_weight(params.gpt2, gpt2_cfg), tokens,
                                    label_smoothing, loss_chunk)
    logits = gpt2_mod.gpt2_forward(params.gpt2, embeds, gpt2_cfg)[:, :-1]
    loss, mask = _smoothed_ce(logits, tokens, label_smoothing)
    acc = ((logits.argmax(dim=-1) == tokens).float() * mask).sum() / mask.sum().clamp_min(1.0)
    return loss, acc


def decap_loss_packed(params: decap_mod.DecapParams, seg_features: torch.Tensor,
                      pack: PackedBatch, gpt2_cfg: gpt2_mod.GPT2Config, *,
                      label_smoothing: float = 0.1, loss_chunk: int = 0):
    """CE reconstruction loss over packed rows (`train/packing.py`).

    seg_features: (R, S, prefix) per-segment features, already through
      `prepare_features`.
    pack: a PackedBatch of tensors (`pack_to_device`); position j of a
      segment predicts target j, the unpacked loss's alignment."""
    r, s, _ = seg_features.shape
    prefix = decap_mod.decap_project_prefix(
        params, seg_features.reshape(r * s, -1)).reshape(r, s, -1)
    tok_emb = params.gpt2["wte"][pack.input_tokens]  # (R, L, D)
    seg_slot = (pack.segment_ids - 1).clamp_min(0)  # pads take segment 0
    pre = prefix.gather(1, seg_slot[..., None].expand(-1, -1, prefix.shape[-1]))
    embeds = torch.where(pack.prefix_mask[..., None], pre.to(tok_emb.dtype), tok_emb)
    hidden = gpt2_mod.gpt2_hidden_packed(params.gpt2, embeds, pack.segment_ids,
                                         pack.pos_ids, gpt2_cfg)
    wte = _lm_head_weight(params.gpt2, gpt2_cfg)
    if loss_chunk:
        return _smoothed_ce_chunked(hidden, wte, pack.targets, label_smoothing, loss_chunk)
    logits = torch.matmul(hidden, wte.T).float()
    loss, mask = _smoothed_ce(logits, pack.targets, label_smoothing)
    acc = ((logits.argmax(dim=-1) == pack.targets).float() * mask).sum() / mask.sum().clamp_min(1.0)
    return loss, acc


def pack_to_device(pack: PackedBatch, device) -> PackedBatch:
    """A numpy PackedBatch as tensors on `device`: int64 indices, a bool
    prefix mask."""
    return PackedBatch(*(torch.as_tensor(np.asarray(a, bool if a.dtype == bool else np.int64),
                                         device=device) for a in pack))


@torch.no_grad()
def prepare_features(features: torch.Tensor, *, gaussian_noise: float = 0.0,
                     bank: Optional[memproj.PreparedBank] = None,
                     noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The frozen input pipeline (:303-316): the memory projection with
    normalize=True (kernel D on the card, its plain version on the CPU),
    L2 normalize, CapDec noise (`noise`, a standard-normal draw of
    features' shape, else drawn from `generator`), re-normalize."""
    if bank is not None:
        features = memproj.memory_project_streamed(features, bank, normalize=True)
    features = features / torch.linalg.vector_norm(features, dim=-1, keepdim=True)
    if gaussian_noise != 0.0:
        if noise is None:
            noise = torch.randn(features.shape, generator=generator, device=features.device,
                                dtype=features.dtype)
        features = features + gaussian_noise * noise
        features = features / torch.linalg.vector_norm(features, dim=-1, keepdim=True)
    return features


# ------------------------------------------------------------- optimizer


def _linear(init: float, end: float, steps: int, count: int) -> float:
    """optax.linear_schedule(init, end, steps) at `count`, in f32 as optax
    computes it (a constant `init` when steps <= 0)."""
    if steps <= 0:
        return float(np.float32(init))
    frac = np.float32(1) - np.float32(min(max(count, 0), steps)) / np.float32(steps)
    return float(np.float32(init - end) * frac + np.float32(end))


def linear_warmup_decay(lr: float, warmup_steps: int, total_steps: int) -> Callable[[int], float]:
    """Linear warmup from 0 to `lr` over `warmup_steps`, then linear decay
    to 0 at `total_steps` (get_linear_schedule_with_warmup, :265-267), as
    optax.join_schedules of two linear schedules gives it."""
    decay = max(total_steps - warmup_steps, 1)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return _linear(0.0, lr, warmup_steps, count)
        return _linear(lr, 0.0, decay, count - warmup_steps)

    return schedule


def cosine_decay(lr: float, steps: int) -> Callable[[int], float]:
    """optax.cosine_decay_schedule(lr, steps) (alpha 0): lr * (1 + cos(pi *
    min(count, steps) / steps)) / 2, in f32 as optax computes it."""
    if steps <= 0:
        raise ValueError(f"cosine_decay needs steps > 0, got {steps}")

    def schedule(count: int) -> float:
        t = np.float32(np.pi) * np.float32(min(count, steps)) / np.float32(steps)
        decay = np.float32(0.5) * (np.float32(1) + np.cos(t))
        return float(np.float32(lr) * decay)

    return schedule


class OptState:
    """The optimizer state of one parameter tree: `torch.optim.AdamW` over
    its leaves (betas 0.9 / 0.999 unless given, eps 1e-8 outside the square root,
    decoupled weight decay on every leaf, as optax.adamw without a mask),
    the count of updates applied, which picks the learning rate (optax
    reads the schedule at the count before the update, so the first update
    of a warmup has lr 0), and the optional global-norm clip."""

    def __init__(self, params, schedule: Callable[[int], float], weight_decay: float,
                 grad_clip: Optional[float] = None, betas: tuple = (0.9, 0.999)):
        self.leaves = [leaf.requires_grad_(True) for _, leaf in flatten_tree(params)]
        self.schedule, self.grad_clip = schedule, grad_clip
        self.count = 0
        self.opt = torch.optim.AdamW(self.leaves, lr=schedule(0), betas=tuple(betas),
                                     eps=1e-8, weight_decay=weight_decay)

    def zero_grad(self) -> None:
        for p in self.leaves:
            p.grad = None

    @torch.no_grad()
    def _clip(self) -> None:
        """optax.clip_by_global_norm: every gradient scaled by max / norm
        when the global norm is at least max (not torch's
        clip_grad_norm_, which divides by norm + 1e-6)."""
        grads = [p.grad for p in self.leaves if p.grad is not None]
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        keep = norm < self.grad_clip
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * self.grad_clip))

    def apply(self) -> None:
        """One update from the leaves' gradients."""
        if self.grad_clip:
            self._clip()
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        self.opt.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"adamw": self.opt.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state["adamw"])
        self.count = int(state["count"])


@dataclasses.dataclass(frozen=True)
class AdamW:
    """The transform `optax.adamw(schedule, b1, b2, weight_decay=...)`,
    chained after `clip_by_global_norm(grad_clip)` when grad_clip is set:
    `init(params)` gives the tree's OptState."""

    schedule: Callable[[int], float]
    weight_decay: float
    grad_clip: Optional[float] = None
    betas: tuple = (0.9, 0.999)

    def init(self, params) -> OptState:
        return OptState(params, self.schedule, self.weight_decay, self.grad_clip, self.betas)


def make_optimizer(cfg: TrainConfig) -> AdamW:
    """AdamW + linear warmup then linear decay (reference
    get_linear_schedule_with_warmup, :255,265-267)."""
    return AdamW(linear_warmup_decay(cfg.lr, cfg.warmup_steps, cfg.total_steps),
                 cfg.weight_decay, cfg.grad_clip or None)


# ----------------------------------------------------------------- steps


def _accum_apply(opt_state: OptState, micro_loss, xs) -> dict:
    """Run `micro_loss(x) -> (loss, acc, msum)` over the micro-batches `xs`:
    the backward of loss * msum, the micro-batch's loss sum, adds each
    micro-batch's sum gradients into the leaves' `.grad`; they are then
    divided by the global mask count, which gives the big batch's
    mean-over-tokens gradient, and one update is applied."""
    opt_state.zero_grad()
    lsum = msum = csum = 0.0
    for x in xs:
        loss, acc, m = micro_loss(x)
        (loss * m).backward()
        lsum, msum, csum = lsum + loss.detach() * m, msum + m, csum + acc.detach() * m
    denom = msum.clamp_min(1.0)
    with torch.no_grad():
        for p in opt_state.leaves:
            if p.grad is not None:
                p.grad.div_(denom.to(p.grad.dtype))
    opt_state.apply()
    return {"loss": lsum / denom, "acc": csum / denom}


def _plain_apply(opt_state: OptState, loss_fn) -> dict:
    opt_state.zero_grad()
    loss, acc = loss_fn()
    loss.backward()
    opt_state.apply()
    return {"loss": loss.detach(), "acc": acc.detach()}


def make_train_step(gpt2_cfg: gpt2_mod.GPT2Config, train_cfg: TrainConfig):
    """step(params, opt_state, features, tokens, generator=None, bank=None,
    noise=None) -> (params, opt_state, metrics), params updated in place.

    With `train_cfg.grad_accum > 1`, features / tokens (and noise) carry a
    leading (grad_accum, micro_batch, ...) axis, the CapDec noise is drawn
    per micro-batch, and one big-batch update is applied (`_accum_apply`).
    `bank`, a PreparedBank, turns on the projection."""
    accum = max(int(train_cfg.grad_accum), 1)

    def prep(feats, generator, bank, noise):
        return prepare_features(feats, gaussian_noise=train_cfg.gaussian_noise, bank=bank,
                                noise=noise, generator=generator)

    def loss(params, feats, toks):
        return decap_loss(params, feats, toks, gpt2_cfg,
                          label_smoothing=train_cfg.label_smoothing,
                          loss_chunk=train_cfg.loss_chunk)

    def step(params, opt_state, features, tokens, generator=None, bank=None, noise=None):
        if accum > 1:
            def micro(i):
                feats = prep(features[i], generator, bank, None if noise is None else noise[i])
                lo, acc = loss(params, feats, tokens[i])
                return lo, acc, (tokens[i] != 0).float().sum()

            return params, opt_state, _accum_apply(opt_state, micro, range(accum))
        feats = prep(features, generator, bank, noise)
        return params, opt_state, _plain_apply(opt_state, lambda: loss(params, feats, tokens))

    return step


def make_packed_train_step(gpt2_cfg: gpt2_mod.GPT2Config, train_cfg: TrainConfig):
    """Packed-rows variant of `make_train_step`: step(params, opt_state,
    features, pack, generator=None, bank=None, noise=None). `features` is
    the whole corpus's feature array, resident on the device;
    `pack.seg_feature_idx` selects the batch's captions, and the frozen
    pipeline runs once per segment (noise: (R * S, prefix), per
    micro-batch with a leading axis). With grad_accum > 1 every pack leaf
    carries a leading (grad_accum, micro_rows, ...) axis."""
    accum = max(int(train_cfg.grad_accum), 1)

    def seg_features(features, pack, generator, bank, noise):
        r, s = pack.seg_feature_idx.shape
        feats = features[pack.seg_feature_idx.reshape(-1)]
        return prepare_features(feats, gaussian_noise=train_cfg.gaussian_noise, bank=bank,
                                noise=noise, generator=generator).reshape(r, s, -1)

    def loss(params, feats, pack):
        return decap_loss_packed(params, feats, pack, gpt2_cfg,
                                 label_smoothing=train_cfg.label_smoothing,
                                 loss_chunk=train_cfg.loss_chunk)

    def step(params, opt_state, features, pack, generator=None, bank=None, noise=None):
        if accum > 1:
            def micro(i):
                pm = PackedBatch(*(a[i] for a in pack))
                feats = seg_features(features, pm, generator, bank,
                                     None if noise is None else noise[i])
                lo, acc = loss(params, feats, pm)
                return lo, acc, (pm.targets != 0).float().sum()

            return params, opt_state, _accum_apply(opt_state, micro, range(accum))
        feats = seg_features(features, pack, generator, bank, noise)
        return params, opt_state, _plain_apply(opt_state, lambda: loss(params, feats, pack))

    return step
