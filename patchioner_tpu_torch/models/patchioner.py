"""Patchioner: the DINOv2 + DeCap captioning subset, in PyTorch.

Twin of the fused caption paths of `patchioner_tpu/models/patchioner.py`:
`from_config`, `supports_fused_trace_path`, `caption_traces_fused` (a
trace), `caption_bboxes_fused` (a caption per box),
`caption_images_fused` (the whole image) and `caption_region_sets_fused`
(a caption per box set), `patch_size`, `crop_dim` and `resize_dim` — the
surface the caption server (`patchioner_tpu_torch.serve`, twin of
`patchioner_tpu/serve.py`) drives. Each path is `entry.make_caption_step`
with its own pool; all share the encoder, the projection and the decode,
which the model's `decap.GreedyDecoder` (`decode`) runs: on the card one
CUDA graph a batch's row count.
`Patchioner.forward` and its flag surface are not ported.

`from_config` takes the reference YAML schema (a path or a dict), with
the encoder keys `attn_impl`, `proj_fused` and `gelu_approx` of the
reference's `from_config` (patchioner.py:487-505) and its
`memory_bank_int8` opt-in (the bank quantized per row to int8 from the f32
bank, whatever the model's type, and projected by kernel H). The DINOv2
backbones it takes are ViT-S and ViT-B (MLP FFN, kernel C: D <= 768) and
ViT-g, `dinov2_vitg14(_reg)` (SwiGLU FFN, kernel G: D <= 1536), whose
prefix and bank are 1536-wide as the config gives them; every `attn_impl`
runs on each. Any key that leaves this subset raises NotImplementedError:
other backbones (ViT-L among them, until C's f32 kernel takes D = 1024),
ViECap / MeaCap / ClipCap, argmax-text, int8 (W8A8) encoders, the
compute-dtype softmax (`softmax_f32: false`), a non-qkv attention_type,
and checkpoint or bank files, which are not ported yet. With `allow_missing_weights=True` the weights and the bank
are seeded random tensors drawn with `torch.Generator`.

The model lives on `device`, "cuda" unless the caller asks for "cpu";
without a card, asking for "cuda" raises.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from patchioner_tpu_torch import entry
from patchioner_tpu_torch.models import decap, gpt2, vit
from patchioner_tpu_torch.ops import memory_projection as memproj

__all__ = ["Patchioner"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# keys the subset reads
_KEYS = {
    "dino_model", "crop_dim", "resize_dim", "image_mean", "image_std",
    "dino_geometry", "attention_type", "prefix_size", "decap_arch",
    "normalize", "support_memory_size", "decap_weights", "dino_weights",
    "talk2dino_weights", "memory_bank_int8",
}
# keys that only name the bank file to load; the subset draws a random bank
# and reads no bank file, so they change nothing it computes
_BANK_NAME_KEYS = {
    "projection_type", "linear_talk2dino", "use_talk2dino_project",
    "clip_model_name", "talk2dino_attn_type",
}
# the reference's encoder kernel-stack switches (configs/*tpu-serving.yaml):
# numerics-preserving; the port always runs kernels A and C on CUDA
_KERNEL_STACK_KEYS = {"qkv_fused", "mlp_fused"}
# encoder keys read into ViTConfig (vit.py:93-104 of the reference)
_ENCODER_KEYS = {"attn_impl", "proj_fused", "gelu_approx"}
# keys whose only ported value is "off" (None or False)
_OFF_ONLY_KEYS = {
    "calculate_argmax_text", "viecap", "clipcap",
    "encoder_w8a8", "regionclip_config",
    "proxyclip_clipmodel", "alphaclip_config", "denseclip_config",
    "use_open_clip", "invite_config", "memory_bank_path",
}
# the widest encoder each FFN kernel takes in both types: the f32 SIMT
# kernels keep a block's output rows in registers, 24 columns a thread in C
# (D <= 768) and 48 in G (D <= 1536); their bf16 GEMMs take any D % 128
_MAX_EMBED_DIM = {"mlp": 768, "swiglu": 1536}


def _check_config(config: dict) -> None:
    for key, value in config.items():
        if key in _KEYS or key in _BANK_NAME_KEYS or key in _KERNEL_STACK_KEYS:
            continue
        if key == "attn_impl" and value not in (None, *vit.ViTConfig.ATTN_IMPLS):
            raise NotImplementedError(f"attn_impl={value!r} is not ported")
        if key in _ENCODER_KEYS:
            continue
        if key == "softmax_f32" and value in (None, True):
            continue
        if key in _OFF_ONLY_KEYS and value in (None, False):
            continue
        raise NotImplementedError(
            f"config key {key}={value!r} is outside the ported DINOv2 + DeCap "
            "subset"
        )
    dino_model = config.get("dino_model")
    if not dino_model or "dinov2" not in dino_model or "dinotxt" in dino_model:
        raise NotImplementedError(f"backbone {dino_model!r} is not ported yet")
    if config.get("attention_type", "qkv") != "qkv":
        raise NotImplementedError(
            f"attention_type={config['attention_type']!r} is not ported yet")
    if int(config.get("support_memory_size", 0)) <= 0:
        raise NotImplementedError("captioning without a support memory is not ported yet")


def _encoder_options(config: dict) -> dict:
    """The ViTConfig fields the encoder keys set; a key left out or None
    keeps the default."""
    opts = {k: config[k] for k in _ENCODER_KEYS if config.get(k) is not None}
    return {k: v if k == "attn_impl" else bool(v) for k, v in opts.items()}


def _as_nhwc(imgs) -> torch.Tensor:
    x = torch.as_tensor(np.asarray(imgs)) if not torch.is_tensor(imgs) else imgs
    if x.dim() != 4:
        raise ValueError(f"expected a 4D image batch, got shape {tuple(x.shape)}")
    if x.shape[1] == 3 and x.shape[-1] != 3:
        x = x.permute(0, 2, 3, 1)
    return x


class Patchioner:
    def __init__(self, *, vit_cfg: vit.ViTConfig, vit_params: dict,
                 gpt2_cfg: gpt2.GPT2Config, decoder: decap.DecapParams,
                 bank, normalize: bool = True,
                 inversion: Optional[dict] = None, config: Optional[dict] = None,
                 device="cuda", tokenizer=None,
                 entry_length: int = decap.ENTRY_LENGTH):
        self.vit_cfg = vit_cfg
        self.gpt2_cfg = gpt2_cfg
        self.device = entry.resolve_device(device)
        self.vit_params = vit.cast_params(vit_params, vit_cfg.dtype, self.device)
        # the f32 master, which `to()` copies; `decode` holds the weights
        # cast to the decoder's type and its CUDA graphs
        self.decoder = decap.DecapParams(
            *(vit.cast_params(p, torch.float32, self.device) for p in decoder))
        self.decode = decap.GreedyDecoder(self.decoder, gpt2_cfg, entry_length)
        # a PreparedBank, or a QuantizedBank (int8 rows, per-row scales)
        self.bank = type(bank)(*(t.to(self.device).contiguous() for t in bank[:-1]),
                               int(bank.num_real))
        self.normalize = normalize
        self.inversion = (None if inversion is None else
                          {k: v.to(self.device) for k, v in inversion.items()})
        self.config = dict(config or {})
        self.entry_length = entry_length
        if tokenizer is None:
            from patchioner_tpu_torch.text import clip_bpe

            tokenizer = clip_bpe.get_tokenizer()
        self.tokenizer = tokenizer
        self.patch_size = vit_cfg.patch_size
        self.crop_dim = vit_cfg.img_size
        self.resize_dim = int(self.config.get("resize_dim", vit_cfg.img_size))
        self._mean = torch.tensor(self.config.get("image_mean", IMAGENET_MEAN),
                                  dtype=torch.float32, device=self.device)
        self._std = torch.tensor(self.config.get("image_std", IMAGENET_STD),
                                 dtype=torch.float32, device=self.device)

    @classmethod
    def from_config(cls, config, *, rng_seed: int = 0,
                    allow_missing_weights: bool = False,
                    random_bank_size: Optional[int] = None,
                    dtype: torch.dtype = torch.float32,
                    device="cuda") -> "Patchioner":
        if isinstance(config, str):
            import yaml

            with open(config) as f:
                config = yaml.safe_load(f)
        config = dict(config)
        _check_config(config)
        for key in ("dino_weights", "decap_weights", "talk2dino_weights"):
            path = config.get(key)
            if path and os.path.exists(str(path)):
                raise NotImplementedError(f"loading {key}={path!r} is not ported yet")
        if not allow_missing_weights:
            raise FileNotFoundError(
                "no loadable DINOv2 / DeCap weights (checkpoint loading is not "
                "ported yet); pass allow_missing_weights=True for seeded "
                "random weights")
        device = entry.resolve_device(device)

        def gen(offset):
            return torch.Generator(device=device).manual_seed(rng_seed + offset)

        vit_cfg = vit.config_for(
            config["dino_model"], img_size=int(config.get("crop_dim", 518)),
            dtype=dtype, **_encoder_options(config),
            **dict(config.get("dino_geometry") or {}))
        widest = _MAX_EMBED_DIM[vit_cfg.ffn]
        if vit_cfg.embed_dim > widest:
            raise NotImplementedError(
                f"{config['dino_model']} (D = {vit_cfg.embed_dim}) is not ported yet: "
                f"kernel {'G' if vit_cfg.ffn == 'swiglu' else 'C'} takes D <= {widest}")
        prefix_size = int(config["prefix_size"])
        if prefix_size > memproj.MAX_D:
            raise NotImplementedError(
                f"prefix_size={prefix_size} is not ported yet: the projection "
                f"kernels take D <= {memproj.MAX_D}")
        vit_params = vit.init_vit(vit_cfg, gen(0), device)

        da = dict(config.get("decap_arch") or {})
        gpt2_cfg = gpt2.GPT2Config(
            n_layer=int(da.get("n_layer", 4)), n_head=int(da.get("n_head", 4)),
            n_embd=int(da.get("n_embd", 768)),
            vocab_size=int(da.get("vocab_size", gpt2.GPT2Config.vocab_size)),
            dtype=dtype)
        decoder = decap.init_decap(gpt2_cfg, prefix_size, gen(1), device)

        size = random_bank_size or int(config["support_memory_size"])
        emb = torch.randn(size, prefix_size, generator=gen(2), device=device)
        if config.get("memory_bank_int8"):
            bank = memproj.quantize_bank(emb)
        else:
            bank = memproj.prepare_bank(
                emb, dtype=None if dtype == torch.float32 else dtype)
        del emb
        return cls(vit_cfg=vit_cfg, vit_params=vit_params, gpt2_cfg=gpt2_cfg,
                   decoder=decoder, bank=bank,
                   normalize=bool(config.get("normalize", True)),
                   config=config, device=device)

    def to(self, device) -> "Patchioner":
        """A copy of the model with every tensor on `device`."""
        return type(self)(
            vit_cfg=self.vit_cfg, vit_params=self.vit_params,
            gpt2_cfg=self.gpt2_cfg, decoder=self.decoder, bank=self.bank,
            normalize=self.normalize, inversion=self.inversion,
            config=self.config, device=device, tokenizer=self.tokenizer,
            entry_length=self.entry_length)

    def supports_fused_trace_path(self) -> bool:
        """Always: the port holds only the DINO + DeCap subset with a bank."""
        return True

    def state(self) -> dict:
        return entry.make_state(self.vit_params, self.decoder, self.bank,
                                self.inversion, decode=self.decode)

    def pixels_to_device(self, imgs) -> torch.Tensor:
        """NHWC or NCHW uint8 / normalised float images -> normalised f32
        NHWC on the model's device (uint8 is normalised on the device)."""
        x = _as_nhwc(imgs).to(self.device)
        if x.shape[1] != self.crop_dim or x.shape[2] != self.crop_dim:
            raise ValueError(
                f"the fused caption paths need {self.crop_dim}px images, got "
                f"{x.shape[1]}x{x.shape[2]}")
        if x.dtype == torch.uint8:
            x = (x.float() / 255.0 - self._mean) / self._std
        return x.float()

    def _caption_rows(self, pool, imgs, *pool_args) -> list:
        """One fused step with `pool` over the images and the pool's
        arrays (f32 on the model's device); a caption string per row."""
        step = entry.make_caption_step(
            self.vit_cfg, self.gpt2_cfg, self.bank.num_real,
            n_steps=self.entry_length, normalize=self.normalize, pool=pool)
        args = [torch.as_tensor(np.asarray(a, np.float32), device=self.device)
                for a in pool_args]
        tokens, _ = step(self.state(), self.pixels_to_device(imgs), *args)
        return [self.tokenizer.decode_caption(row) for row in tokens.cpu().numpy()]

    def caption_traces_fused(self, imgs, pts, valid, *,
                             use_attention_tracing: bool = False) -> list:
        """Caption (B, P, 2) trace points in [0, 1] with a (B, P) valid mask;
        `use_attention_tracing` weights the trace by the CLS->patch
        attention row. Twin of `patchioner.py:1800`."""
        pool = entry.make_trace_pool(self.vit_cfg, use_attention_tracing)
        return self._caption_rows(pool, imgs, pts, valid)

    def caption_bboxes_fused(self, imgs, bboxes, *, gaussian_avg: bool = False,
                             gaussian_bbox_variance: float = 0.5,
                             use_attn_map_for_bboxes: bool = False) -> list:
        """Caption each of (B, NB, 4) pixel `[x1, y1, w, h]` boxes, padded
        to a fixed NB; B lists of NB captions. The B * NB rows go through
        one projection and one decode. Twin of `patchioner.py:1842`."""
        n_boxes = int(np.shape(bboxes)[1])
        pool = entry.make_bbox_pool(
            self.patch_size, gaussian_avg=gaussian_avg,
            gaussian_bbox_variance=gaussian_bbox_variance,
            use_attn_map=use_attn_map_for_bboxes)
        capts = self._caption_rows(pool, imgs, bboxes)
        return [capts[i:i + n_boxes] for i in range(0, len(capts), n_boxes)]

    def caption_images_fused(self, imgs, *, caption_from: str = "cls",
                             gaussian_img_variance: float = 1.0) -> list:
        """Caption each whole image from `caption_from` ('cls',
        'avg_self_attn' or 'patches', which takes `gaussian_img_variance`;
        anything else raises ValueError). Twin of `patchioner.py:1900`."""
        pool = entry.make_image_pool(caption_from, gaussian_img_variance)
        return self._caption_rows(pool, imgs)

    def caption_region_sets_fused(self, imgs, bboxes, *, gaussian_avg: bool = False,
                                  gaussian_bbox_variance: float = 0.5,
                                  use_attn_map_for_bboxes: bool = False) -> list:
        """One caption per image for the union of its (NB, 4) pixel boxes;
        `[-1] * 4` rows pad a set and are skipped. Twin of
        `patchioner.py:1941`."""
        pool = entry.make_region_set_pool(
            self.patch_size, gaussian_avg=gaussian_avg,
            gaussian_bbox_variance=gaussian_bbox_variance,
            use_attn_map=use_attn_map_for_bboxes)
        return self._caption_rows(pool, imgs, bboxes)
