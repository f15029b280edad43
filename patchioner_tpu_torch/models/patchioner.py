"""Patchioner: every backbone with DeCap, ViECap, MeaCap or ClipCap, in PyTorch.

Twin of `patchioner_tpu/models/patchioner.py` for the DINOv2 backbone
(ViT-S, B, L and g, and DINO.txt's ViT-L), the CLIP ViT family
(`models/clip.py`: OpenAI CLIP by its timm name, INViTE, OpenCLIP,
AlphaCLIP, DenseCLIP), RegionCLIP's ResNet (`models/resnet_clip.py`) and
ProxyCLIP (`models/proxyclip.py`): `from_config`,
`supports_fused_trace_path`, the fused caption paths
`caption_traces_fused` (a trace), `caption_bboxes_fused` (a caption per
box), `caption_images_fused` (the whole image) and
`caption_region_sets_fused` (a caption per box set), and the generic path
`forward` over `encode_images`, `project_features` and `caption_tokens`,
with `patch_size`, `crop_dim` and `resize_dim`: the surface the caption
server (`patchioner_tpu_torch.serve`, twin of `patchioner_tpu/serve.py`)
drives. Each fused path is `entry.make_caption_step` with its own pool;
all share the encoder, the projection and the decode, which the model's
`decap.GreedyDecoder` (`decode`) runs: on the card one CUDA graph a
batch's row count. A DeCap model over a support memory has the fused
paths on the DINOv2 backbone; another backbone, a ViECap, MeaCap or ClipCap
model, or one without a bank, captions through `forward`
(`supports_fused_trace_path()` is False), as in the reference.

`forward` takes the reference's flags: `get_cls_capt`,
`get_avg_self_attn_capt`, `get_avg_patch_capt`, `get_patch_capts`,
`get_register_capts`, `bboxes` (with `gaussian_avg`,
`gaussian_bbox_variance`, `use_attn_map_for_bboxes`),
`get_controllable_capts`, `traces` (with `use_attention_tracing`),
`get_attn_heads_capt` (a caption per extracted head, from the patch tokens
weighted by that head's attention), `cleaning_type` (with
`clean_after_projection`, `clean_from` and `alpha`: the context cleaner,
`ops.region_pooling.ctx_cleaner`, on the patch tokens, projected through
the bank at unit norm before or after it), `return_n_best_sims` (each
box's top-k cosine similarities to the bank, `bbox_sims`) and
`compute_scores`, and returns the reference's keys, split per image. Only
the DINOv2 and DenseCLIP towers' attention is read: elsewhere attention
boxes and tracing pool uniformly and `get_avg_self_attn_capt` raises
ValueError, and on ProxyCLIP, which emits patch tokens only, so does
`get_cls_capt`. `analyze_feature_compatibility` is RegionCLIP's layer
diagnostic. AlphaCLIP captions boxes and traces by one encoder pass a
region, the region as its alpha mask (`_forward_alphaclip_regions`).
`caption_bboxes_type` routes to `caption_bboxes`, the crop-and-caption
baseline (PIL images in, one `forward` pass a chunk of crops).
`double_DINO_for_bboxes` (with `double_DINO_for_bboxes_return_type` and
`double_DINO_use_cls`) captions each box from the last encoder block
re-run on its tokens alone (`_double_dino_features`, DINOv2 backbones
only: elsewhere ValueError, as in the reference). With
`calculate_argmax_text` (a config key, or the attribute set on a built
model) a caption is the text of the bank row nearest the feature
(`ops.memory_projection.memory_argmax`), its score 1.0; such a model has
no decoder and no fused path.

`from_config` takes the reference YAML schema (a path or a dict) and
loads what the reference's `from_config` loads for this subset
(patchioner.py:155-300, 506-547, 836-972), the same files:
- the backbone, in the JAX builder's order (`_backbone_type`): a DINOv2
  `dino_model` whatever other backbone key the config holds, with
  `dino_weights`, a torch.hub DINOv2 `.pth` (a `state_dict` key is
  unwrapped) through `io.torch_port.port_dinov2` (a DINO.txt checkpoint
  through `dinotxt.port_dinotxt_visual`), or an `.npz` of
  `io.checkpoints.save_params_npz`; else RegionCLIP (`regionclip_config`,
  its `checkpoint` an openai-CLIP ResNet or a detection checkpoint with
  the backbone under `model` and `backbone.`), ProxyCLIP
  (`proxyclip_clipmodel`, `clip_weights` in the openai layout and the
  VFM's `dino_weights`), AlphaCLIP (`alphaclip_config`,
  its `checkpoint` in the openai/CLIP layout, the alpha conv drawn when
  the file lacks it), DenseCLIP (`denseclip_config`, a geometry of the
  port's data folder or a file; `denseclip_weights`, the openai layout
  under `backbone.`), OpenCLIP (`use_open_clip` and a `ViT-B/16`-style
  `dino_model`; `clip_weights` in the openai layout), INViTE
  (`invite_config`) or a timm OpenAI CLIP name, whose `clip_weights` are
  in the transformers layout (`models.clip`'s porters); a CLIP-space bank
  file's rows are taken at unit norm;
- `decap_weights`: a DeCap `.pt` through `port_decap`, or a directory the
  port's `train/cli.py` wrote (its latest step, through
  `io.checkpoints.load_decap_from_train_dir`; an Orbax directory of the
  JAX package's trainers raises NotImplementedError);
- `talk2dino_weights`: Talk2DINO's projection through `port_talk2dino`,
  whose `talk2dino.build_inversion` takes the projected prefix back to
  CLIP space; the bank then lives in DINO space, the prefix in CLIP space;
- the support memory, when `support_memory_size` > 0: the HDF5 bank at
  `memory_bank_path`, or else at `$IM2TXT_MEMORY_PATH` (default
  /im2txtmemories) under the name `io.memory_bank.bank_filename` gives the
  config; its texts are `bank_texts`. Reading it needs h5py. Without one,
  `bank` is None and DeCap decodes the features as they are;
- a `viecap` block: the ViECap `.pt` at `weight_path` (`mapping_network.*`
  through `viecap.port_mapping_network`, `gpt.*` through
  `port_hf_gpt2_lmhead` into GPT-2 base, f32) or a directory of the
  port's `train/prefix_cli.py --model viecap` (the mapper alone), the entity vocabulary and
  its embedding pickle from `files_path/annotations/vocabulary` or else
  the port's data folder (the COCO, VG/OI, Visual Genome and Open Images
  vocabularies with their CLIP-space embeddings, and the Talk2DINO-space
  COCO embeddings, are there), and the GPT-2 tokenizer
  (`text.gpt2_bpe` over $GPT2_BPE_DIR or the Hugging Face cache, else the
  whitespace fallback under `allow_missing_weights`). A `meacap` block in
  it gives MeaCap instead: no entity vocabulary, the caption memory
  `memory_base_path/memory/memory_id/` (`memory_captions.json`,
  `memory_clip_embeddings.pt`) and `from_config`'s `concept_extractor`;
- a `clipcap` block: the ClipCap `.pt` at `weight_path`
  (`clip_project.model.{0,2}.*` for the MLP mapper, `clip_project.*` for
  the transformer one, `gpt.*`) or a directory of the port's
  `train/prefix_cli.py --model clipcap` (the MLP mapper alone), GPT-2
  base in f32, the mapper taking the DINOv2 backbone's width
  (`clipcap.feature_width`). ViECap wins where a config has both.
A file that is missing falls back to seeded random tensors, drawn with
`torch.Generator`, only under `allow_missing_weights=True`, and otherwise
raises FileNotFoundError, as the reference does; a missing Talk2DINO file
leaves the inversion off. The config decides every shape: a loaded tree
whose depth, width, register count, FFN or vocabulary disagrees with it
raises ValueError, naming both. The files are ported into f32 CPU trees
and uploaded once, by the constructor, as random weights are;
`load_seconds` holds the seconds spent reading, porting and uploading.

The encoder keys `attn_impl`, `proj_fused`, `gelu_approx` and
`softmax_f32` are the reference's (patchioner.py:487-505; `softmax_f32:
false` is the compute-type softmax of `attn_impl: xla`, and ValueError at
the first encoder pass under any other `attn_impl`), and so is its `memory_bank_int8`
opt-in (the bank quantized per row to int8 from the f32 bank, whatever the
model's type, and projected by kernel H). The DINOv2 backbones are ViT-S,
ViT-B and ViT-L (MLP FFN, kernel C: D <= 1024) and ViT-g,
`dinov2_vitg14(_reg)` (SwiGLU FFN, kernel G: D <= 1536), whose prefix and
bank are as wide as the config gives them; every `attn_impl` runs on
each. The CLIP towers (ViT-B and ViT-L), RegionCLIP's ResNet and
ProxyCLIP's CLIP half run as plain PyTorch, as the JAX package runs them
as plain XLA; ProxyCLIP's VFM is the DINOv2 encoder. Any key that leaves
this subset raises NotImplementedError: another backbone and int8 (W8A8)
encoders. `calculate_argmax_text: true` builds no DeCap decoder (so
`decap_weights` is not read). The DINOv2 encoder keys are ignored on the other
backbones, as the JAX package's `from_config` ignores them. An
`attention_type` other than 'qkv' (the README's KKV mode is 'kkv')
reorders the built tower's last-block qkv (`vit.reorder_qkv_params`) on
the DINOv2 and CLIP ViT towers, and raises ValueError on RegionCLIP and
ProxyCLIP, which have no fused last-block qkv, as in the JAX package. The README's
`kkv_attention` key is read by neither the reference's loader nor the
JAX package: it is ignored, with a UserWarning where `attention_type` is
absent. A config given as a Hugging Face model id is not ported
(it must be a path or a dict), nor are the reference's
`save_pretrained` / `load_pretrained` snapshots.

The model lives on `device`, "cuda" unless the caller asks for "cpu";
without a card, asking for "cuda" raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import pickle
import time
import warnings
from typing import Any, Optional

import numpy as np
import torch

from patchioner_tpu_torch import entry
from patchioner_tpu_torch.io import checkpoints, memory_bank, torch_port
from patchioner_tpu_torch.models import clip as clip_mod
from patchioner_tpu_torch.models import clipcap as clipcap_mod
from patchioner_tpu_torch.models import decap, dinotxt, gpt2, talk2dino, vit, viecap as viecap_mod
from patchioner_tpu_torch.models import proxyclip as proxyclip_mod
from patchioner_tpu_torch.models import resnet_clip
from patchioner_tpu_torch.ops import memory_projection as memproj
from patchioner_tpu_torch.ops import region_pooling as rp

__all__ = ["Patchioner", "uses_fallback_tokenizer"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# keys the subset reads
_KEYS = {
    "dino_model", "crop_dim", "resize_dim", "image_mean", "image_std",
    "dino_geometry", "attention_type", "prefix_size", "decap_arch",
    "normalize", "support_memory_size", "decap_weights", "dino_weights",
    "talk2dino_weights", "memory_bank_int8", "memory_bank_path", "viecap", "clipcap",
    "kkv_attention", "clip_weights", "use_open_clip", "denseclip_config",
    "denseclip_weights", "alphaclip_config", "invite_config", "calculate_argmax_text",
}
# the RegionCLIP and ProxyCLIP keys; beside a DINOv2 `dino_model` they are
# ignored, as the JAX package's `from_config` ignores them
_BACKBONE_KEYS = {"regionclip_config", "proxyclip_clipmodel", "proxyclip_vfm",
                  "proxyclip_beta", "proxyclip_gamma"}
# keys that name the bank file under $IM2TXT_MEMORY_PATH
# (`io.memory_bank.bank_filename`) when `memory_bank_path` is not given
_BANK_NAME_KEYS = {
    "projection_type", "linear_talk2dino", "use_talk2dino_project",
    "clip_model_name", "talk2dino_attn_type",
}
# the reference's encoder kernel-stack switches (configs/*tpu-serving.yaml):
# numerics-preserving; the port always runs kernels A and C on CUDA
_KERNEL_STACK_KEYS = {"qkv_fused", "mlp_fused"}
# encoder keys read into ViTConfig on the DINOv2 branch (patchioner.py:489-505
# of the reference)
_ENCODER_KEYS = {"attn_impl", "proj_fused", "gelu_approx", "softmax_f32"}
# keys whose only ported value is "off" (None or False)
_OFF_ONLY_KEYS = {"encoder_w8a8"}
# the widest encoder each FFN kernel takes in both types: the f32 SIMT
# kernels keep a block's output rows in registers, up to 32 columns a
# thread in C (D <= 1024, ViT-L) and 48 in G (D <= 1536); their bf16 GEMMs
# take any D % 128
_MAX_EMBED_DIM = {"mlp": 1024, "swiglu": 1536}


def _backbone_type(config: dict) -> str:
    """The backbone `from_config` builds, in the JAX builder's order of
    branches (`patchioner.py:470-797`): a DINOv2 `dino_model` first,
    whatever other backbone key the config holds, then RegionCLIP,
    ProxyCLIP, AlphaCLIP, DenseCLIP, OpenCLIP (`use_open_clip` with a
    `dino_model`), INViTE (`invite_config`) and a timm OpenAI CLIP name.
    'DINO', 'RegionCLIP', 'ProxyCLIP', 'AlphaClip', 'DenseClip', 'OpenCLIP',
    'INViTE' or 'CLIP'; anything else raises NotImplementedError, as in the
    JAX package."""
    dino_model = config.get("dino_model")
    if dino_model is not None and "dinov2" in dino_model:
        return "DINO"
    for key, kind in (("regionclip_config", "RegionCLIP"), ("proxyclip_clipmodel", "ProxyCLIP"),
                      ("alphaclip_config", "AlphaClip"), ("denseclip_config", "DenseClip")):
        if config.get(key) is not None:
            return kind
    if config.get("use_open_clip") and dino_model is not None:
        return "OpenCLIP"
    if config.get("invite_config"):
        return "INViTE"
    if dino_model is not None and "openai" in dino_model:
        return "CLIP"
    raise NotImplementedError(f"backbone {dino_model!r} not wired (DINOv2 / OpenAI-CLIP / "
                              "INViTE variants)")


def _check_config(config: dict) -> None:
    for key, value in config.items():
        if (key in _KEYS or key in _BANK_NAME_KEYS or key in _KERNEL_STACK_KEYS
                or key in _BACKBONE_KEYS):
            continue
        if key == "attn_impl" and value not in (None, *vit.ViTConfig.ATTN_IMPLS):
            raise NotImplementedError(f"attn_impl={value!r} is not ported")
        if key in _ENCODER_KEYS:
            continue
        if key in _OFF_ONLY_KEYS and value in (None, False):
            continue
        raise NotImplementedError(
            f"config key {key}={value!r} is outside the ported DINOv2 / CLIP + DeCap "
            "subset"
        )
    _backbone_type(config)
    if (config.get("viecap") or {}).get("hard_prompt_pad_multiple"):
        # the JAX package's shape buckets for its per-shape compiles; the
        # port's searches run eagerly and pad to the batch's longest
        raise NotImplementedError(
            "viecap.hard_prompt_pad_multiple is not ported: the hard prompt pads to "
            "the batch's longest")


def _rewire_attention(vit_params, attention_type, kind: str):
    """The tower's params with the last block's qkv reordered for a non-qkv
    `attention_type` (`patchioner.py:798-814`): wherever the params carry a
    fused last-block qkv, as every DINOv2 and CLIP ViT tree of both
    packages does; RegionCLIP's ResNet and ProxyCLIP's pair of towers have
    none and raise ValueError, where the reference's
    `.blocks[-1].attn.qkv` access crashes."""
    if attention_type == "qkv":
        return vit_params
    blocks = vit_params.get("blocks") if isinstance(vit_params, dict) else None
    if blocks and isinstance(blocks[-1], dict) and "qkv" in blocks[-1]:
        return vit.reorder_qkv_params(vit_params, attention_type)
    raise ValueError(f"attention_type={attention_type!r} needs a tower with a fused "
                     f"last-block qkv; {kind} has none (the reference's "
                     ".blocks[-1].attn.qkv access crashes there too)")


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


class _Clock(dict):
    """Seconds spent in each named stage: `with clock("read"): ...`."""

    @contextlib.contextmanager
    def __call__(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self[stage] = self.get(stage, 0.0) + time.perf_counter() - t0


def _num_blocks(sd, prefix: str) -> int:
    """How many `{prefix}N.` blocks a state dict holds."""
    idx = {k[len(prefix):].split(".", 1)[0] for k in sd if k.startswith(prefix)}
    return 1 + max((int(i) for i in idx if i.isdigit()), default=-1)


def _torch_load(path: str, clock: _Clock):
    with clock("read"):
        return torch.load(path, map_location="cpu", weights_only=True)


def _load_dino(path: str, cfg: vit.ViTConfig, clock: _Clock, is_dinotxt: bool = False) -> dict:
    """`dino_weights` (a hub `.pth` or an `.npz`) as an f32 CPU tree, checked
    against `cfg`; with `is_dinotxt` a DINO.txt checkpoint, whose backbone
    `dinotxt.port_dinotxt_visual` takes out (`patchioner.py:528-536`)."""
    if path.endswith(".npz"):
        with clock("read"):
            tree = checkpoints.load_params_npz(path)
    else:
        sd = _torch_load(path, clock)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        inner = dinotxt.visual_state_dict(sd) if is_dinotxt else sd
        with clock("port"):
            port = dinotxt.port_dinotxt_visual if is_dinotxt else torch_port.port_dinov2
            tree = port(sd, _num_blocks(inner, "blocks."), "register_tokens" in inner)
    if cfg.embed_dim % cfg.num_heads:
        raise ValueError(f"dino_weights={path!r}: the config's {cfg.num_heads} heads "
                         f"do not split its width {cfg.embed_dim}")
    checkpoints.check_tree("dino_weights", path, tree, vit.param_template(cfg),
                           f"depth {cfg.depth}, width {cfg.embed_dim}, {cfg.num_heads} heads, "
                           f"{cfg.num_registers} registers, {cfg.ffn} FFN {cfg.ffn_hidden}, "
                           f"patch {cfg.patch_size}, position grid {cfg.stored_pos_grid}")
    return tree


# DenseCLIP's tower geometries, converted once from the YAML files the JAX
# package carries (`patchioner_tpu/data/denseclip_configs`)
DENSECLIP_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "data", "denseclip_configs")


def _denseclip_config(name: str) -> dict:
    """`denseclip_config`: a file path (JSON, or YAML where PyYAML is
    installed), else the name of a geometry in the port's data folder
    (`patchioner.py:686-694`)."""
    path = name if os.path.exists(str(name)) else os.path.join(DENSECLIP_DIR, f"{name}.json")
    with open(path) as f:
        if path.endswith(".json"):
            return json.load(f)
        import yaml

        return yaml.safe_load(f)


def _clip_size(large: bool) -> dict:
    """ViT-L/14's width, depth, heads and projection, else ViT-B's."""
    width, depth, heads, proj = (1024, 24, 16, 768) if large else (768, 12, 12, 512)
    return dict(width=width, depth=depth, heads=heads, proj_dim=proj)


def _clip_geometry(config: dict, kind: str, dtype) -> tuple:
    """(ClipVisionConfig, weights path, checkpoint layout, Patchioner
    keywords) of one of the JAX builder's CLIP branches
    (`patchioner.py:636-797`); the layout is 'hf' (transformers), 'openai'
    or 'denseclip' (the openai layout under `backbone.`, maybe wrapped in
    `state_dict`)."""
    dino_model = config.get("dino_model")
    crop = int(config.get("crop_dim", 518))
    opts = {}
    if kind == "DenseClip":
        dc = _denseclip_config(config["denseclip_config"])
        vis = dc.get("model", {}).get("vision", {})
        width = vis.get("vision_width", 768)
        cfg = clip_mod.ClipVisionConfig(
            img_size=crop, patch_size=vis.get("vision_patch_size", 16), width=width,
            depth=vis.get("vision_layers", 12), heads=width // 64,
            proj_dim=vis.get("embed_dim", 512), dtype=dtype)
        path = config.get("denseclip_weights", dc.get("checkpoint", {}).get("path"))
        return cfg, path, "denseclip", opts
    if kind == "AlphaClip":
        acfg = dict(config["alphaclip_config"])
        name = acfg.get("name", "ViT-B/16")
        patch = acfg.get("patch_size") or (32 if "/32" in name else (14 if "/14" in name else 16))
        size = _clip_size("ViT-L" in name)
        size["proj_dim"] = acfg.get("embed_dim", size["proj_dim"])
        path, layout = acfg.get("checkpoint"), "openai"
    elif kind == "OpenCLIP":
        # the reference projects the tokens before ln_post (src/model.py:766-768,848-859)
        patch = int(str(dino_model).split("/")[-1])
        size = _clip_size("ViT-L" in dino_model)
        opts["skip_ln_post"] = True
        path, layout = config.get("clip_weights"), "openai"
    else:  # a timm OpenAI CLIP name, or INViTE
        invite = config.get("invite_config") or {}
        if invite:
            # the last k blocks attend diagonally; the JAX branch reads
            # `clip_weights`, not invite_config.checkpoint (ROADMAP §3)
            opts["diag_last_layers"] = max(0, int(invite.get("extract_last_k_th_token", -1)))
            name = invite.get("name", "ViT-B/32")
            patch = 32 if "/32" in name else (16 if "/16" in name else 14)
        else:
            patch = int(dino_model.split("patch")[1].split("_")[0])
        size = _clip_size("large" in (dino_model or "") or "ViT-L" in str(invite.get("name", "")))
        path, layout = config.get("clip_weights"), "hf"
    return (clip_mod.ClipVisionConfig(img_size=crop, patch_size=patch, dtype=dtype, **size),
            path, layout, opts)


def _load_clip(path: str, layout: str, cfg: clip_mod.ClipVisionConfig,
               clock: _Clock) -> dict:
    """A CLIP tower's checkpoint in `layout` as an f32 CPU tree, checked
    against `cfg` (the stored position grid is the file's)."""
    sd = _torch_load(path, clock)
    if layout == "denseclip":
        sd = sd.get("state_dict", sd)
        # segmentation checkpoints prefix the tower with 'backbone.'
        sd = {k.replace("backbone.", "", 1) if k.startswith("backbone.") else k: v
              for k, v in sd.items()}
    with clock("port"):
        if layout == "hf":
            tree = clip_mod.port_hf_clip_vision(
                sd, _num_blocks(sd, "vision_model.encoder.layers."))
        else:
            prefix = "visual." if any(k.startswith("visual.") for k in sd) else ""
            tree = clip_mod.port_openai_clip_vision(
                sd, _num_blocks(sd, f"{prefix}transformer.resblocks."), prefix=prefix)
    pos = tree["pos_embed"].shape[1]
    side = int(round((pos - 1) ** 0.5))
    if side * side + 1 != pos:
        raise ValueError(f"{path!r}: {pos} position embeddings are not a square grid and a "
                         "class token")
    checkpoints.check_tree(
        "clip weights", path, tree, clip_mod.param_template(cfg, pos, "alpha_embed_w" in tree),
        f"depth {cfg.depth}, width {cfg.width}, patch {cfg.patch_size}, projection "
        f"{cfg.proj_dim}, position grid {side}")
    return tree


def _build_clip(config: dict, kind: str, dtype, generator: torch.Generator,
                allow_missing_weights: bool, device, clock: _Clock) -> tuple:
    """The CLIP tower of `kind` (`patchioner.py:636-797`): (its config, its
    f32 params, the Patchioner keywords it sets). A missing file falls back
    to seeded random weights only under `allow_missing_weights`;
    AlphaCLIP's alpha conv is drawn whenever the weights lack it."""
    cfg, path, layout, opts = _clip_geometry(config, kind, dtype)
    if path and os.path.exists(str(path)):
        params = _load_clip(str(path), layout, cfg, clock)
    elif allow_missing_weights:
        params = clip_mod.init_clip_vision(cfg, generator, device)
    else:
        raise FileNotFoundError(f"no local {kind} weights at {path!r} (pass "
                                "allow_missing_weights=True for random init)")
    if kind == "AlphaClip" and "alpha_embed_w" not in params:
        params["alpha_embed_w"] = clip_mod.init_alpha_embed(cfg, generator, device)
    return cfg, params, dict(opts, backbone_type=kind)


def _build_regionclip(config: dict, dtype, generator: torch.Generator,
                      allow_missing_weights: bool, device, clock: _Clock) -> tuple:
    """RegionCLIP's ModifiedResNet (`patchioner.py:549-577`): (its config,
    its f32 params, the Patchioner keywords). `regionclip_config.checkpoint`
    is an openai-CLIP state dict or a RegionCLIP detection checkpoint (the
    tensors under `model`, the backbone under detectron's `backbone.`);
    a missing file falls back to seeded random weights only under
    `allow_missing_weights`."""
    rc = dict(config["regionclip_config"])
    cfg = resnet_clip.ResNetClipConfig(img_size=int(config.get("crop_dim", 518)),
                                       output_dim=int(rc.get("embed_dim", 1024)), dtype=dtype)
    path = rc.get("checkpoint")
    if path and os.path.exists(str(path)):
        sd = _torch_load(str(path), clock)
        sd = sd.get("model", sd)
        # detectron-style prefixes (regionclip/loader.py:92-105)
        sd = {"visual." + k[len("backbone."):] if k.startswith("backbone.") else k: v
              for k, v in sd.items()}
        with clock("port"):
            params = resnet_clip.port_clip_resnet(sd, cfg, prefix="visual.")
        checkpoints.check_tree(
            "regionclip_config.checkpoint", str(path), params, resnet_clip.param_template(cfg),
            f"layers {cfg.layers}, width {cfg.width}, {cfg.heads} heads, output_dim "
            f"{cfg.output_dim}")
    elif allow_missing_weights:
        params = resnet_clip.init_resnet_clip(cfg, generator, device)
    else:
        raise FileNotFoundError(f"RegionCLIP checkpoint not found: {path}")
    return cfg, params, dict(backbone_type="RegionCLIP")


def _build_proxyclip(config: dict, dtype, generator: torch.Generator,
                     allow_missing_weights: bool, device, clock: _Clock) -> tuple:
    """ProxyCLIP (`patchioner.py:578-631`): the CLIP trunk of
    `proxyclip_clipmodel` (B/16, B/32 or L/14 at 224 px) and the VFM of
    `proxyclip_vfm`, 'dinov2' as DINOv2 ViT-B/14 with registers and 'dino'
    as ViT-B/14 without (the JAX package's mapping of DINO v1), at
    `crop_dim`. `clip_weights` (the openai layout) and `dino_weights` (a
    hub `.pth` or an `.npz`) are read where they exist; a missing one falls
    back to seeded random weights only under `allow_missing_weights`, else
    FileNotFoundError."""
    name = config["proxyclip_clipmodel"]
    patch = 14 if "/14" in name else (32 if "/32" in name else 16)
    ccfg = clip_mod.ClipVisionConfig(img_size=224, patch_size=patch, dtype=dtype,
                                     **_clip_size("ViT-L" in name))
    variant = "dinov2_vitb14_reg" if config.get("proxyclip_vfm", "dinov2") == "dinov2" \
        else "dinov2_vitb14"
    cfg = proxyclip_mod.ProxyClipConfig(
        clip=ccfg, vfm=vit.config_for(variant, img_size=int(config.get("crop_dim", 518)),
                                      dtype=dtype),
        beta=float(config.get("proxyclip_beta", 1.2)),
        gamma=float(config.get("proxyclip_gamma", 3.0)))
    paths = [config.get(k) for k in ("clip_weights", "dino_weights")]
    found = [bool(p) and os.path.exists(str(p)) for p in paths]
    if not (all(found) or allow_missing_weights):
        raise FileNotFoundError("ProxyCLIP needs 'clip_weights' (openai layout) and "
                                "'dino_weights' locally")
    params = {
        "clip": (_load_clip(str(paths[0]), "openai", ccfg, clock) if found[0]
                 else clip_mod.init_clip_vision(ccfg, generator, device)),
        "vfm": (_load_dino(str(paths[1]), cfg.vfm, clock) if found[1]
                else vit.init_vit(cfg.vfm, generator, device))}
    return cfg, params, dict(backbone_type="ProxyCLIP")


def _load_decap(path: str, cfg: gpt2.GPT2Config, prefix_size: int,
                clock: _Clock) -> decap.DecapParams:
    """`decap_weights` (a DeCap `.pt`) as f32 CPU DecapParams, checked
    against the decoder's config and the prefix width."""
    sd = _torch_load(path, clock)
    with clock("port"):
        tree = torch_port.port_decap(sd, _num_blocks(sd, "decoder.transformer.h."))
    if cfg.n_embd % cfg.n_head:
        raise ValueError(f"decap_weights={path!r}: the config's {cfg.n_head} heads "
                         f"do not split its width {cfg.n_embd}")
    template = {"gpt2": gpt2.param_template(cfg),
                "clip_project": {"w": torch.empty(prefix_size, cfg.n_embd, device="meta"),
                                 "b": torch.empty(cfg.n_embd, device="meta")}}
    checkpoints.check_tree("decap_weights", path, tree, template,
                           f"n_layer {cfg.n_layer}, n_embd {cfg.n_embd}, {cfg.n_head} heads, "
                           f"vocab_size {cfg.vocab_size}, n_positions {cfg.n_positions}, "
                           f"prefix_size {prefix_size}")
    return decap.DecapParams(**tree)


def _load_inversion(path: str, prefix_size: int, clock: _Clock) -> dict:
    """The Talk2DINO inversion of `talk2dino_weights`: (clip, dino) A_pinv
    whose CLIP side must be the decoder's prefix."""
    sd = _torch_load(path, clock)
    with clock("port"):
        inv = talk2dino.build_inversion(torch_port.port_talk2dino(sd))
    clip, dino = inv["A_pinv"].shape
    if clip != prefix_size:
        raise ValueError(f"talk2dino_weights={path!r} maps CLIP {clip} -> DINO {dino}, "
                         f"but the config's prefix_size is {prefix_size}")
    return inv


def _bank_path(config: dict) -> tuple[str, str]:
    """(the bank file, its dataset): `memory_bank_path`, or the reference's
    filename under $IM2TXT_MEMORY_PATH (patchioner.py:904-923)."""
    projection_type = config.get("projection_type", "coco")
    path = config.get("memory_bank_path")
    if path is not None:
        return path, memory_bank.PROJECTION_DATASETS.get(projection_type, projection_type)
    fname, dataset = memory_bank.bank_filename(
        projection_type, config.get("clip_model_name"), int(config["support_memory_size"]),
        use_talk2dino=config.get("use_talk2dino_project", True),
        linear_talk2dino=config.get("linear_talk2dino", False),
        talk2dino_attn_type=config.get("talk2dino_attn_type", "qkv"),
        use_open_clip=config.get("use_open_clip", False))
    return os.path.join(os.getenv("IM2TXT_MEMORY_PATH", "/im2txtmemories"), fname), dataset


class _FallbackWordTokenizer:
    """The whitespace tokenizer taken only when no GPT-2 vocabulary is on
    the machine and `allow_missing_weights=True`: it keeps the ViECap path
    runnable, and its strings are not the reference's. Ids go to words in
    order of first use from 10 on; the pad id is 0. Twin of
    `patchioner_tpu/models/patchioner.py:68`."""

    pad_token_id = 0

    def __init__(self):
        self.vocab, self.rev = {}, {}

    def _id(self, w):
        if w not in self.vocab:
            i = len(self.vocab) + 10
            self.vocab[w] = i
            self.rev[i] = w
        return self.vocab[w]

    def encode(self, text):
        return [self._id(w) for w in text.strip().split(" ") if w]

    def decode(self, ids):
        return " ".join(self.rev.get(int(i), "") for i in ids).strip()


def _get_gpt2_tokenizer(allow_fallback: bool):
    """The GPT-2 tokenizer: `text.gpt2_bpe` over local vocabulary files
    ($GPT2_BPE_DIR, then the Hugging Face cache), else the whitespace
    fallback under `allow_fallback` (a UserWarning, which Python shows once
    by default), else FileNotFoundError.
    The reference asks transformers' cache first; over the same files the
    in-tree BPE gives its ids."""
    from patchioner_tpu_torch.text import gpt2_bpe

    tok = gpt2_bpe.load_gpt2_tokenizer()
    if tok is not None:
        return tok
    if not allow_fallback:
        raise FileNotFoundError("GPT-2 tokenizer files unavailable; set $GPT2_BPE_DIR to a "
                                "directory with vocab.json + merges.txt or pass "
                                "allow_missing_weights=True")
    warnings.warn("GPT-2 vocab files unavailable locally (set $GPT2_BPE_DIR to a dir with "
                  "vocab.json+merges.txt): using a whitespace fallback tokenizer (not "
                  "caption parity)")
    return _FallbackWordTokenizer()


def uses_fallback_tokenizer(model) -> bool:
    """True when a GPT-2 decoder of the model (ViECap, MeaCap or ClipCap)
    detokenises through the whitespace fallback, so its strings are not
    the reference's (`patchioner.py:128-136`). DeCap's CLIP BPE never
    does."""
    return any(isinstance(getattr(getattr(model, name, None), "tokenizer", None),
                          _FallbackWordTokenizer) for name in ("viecap", "clipcap"))


def require_parity_tokenizer(model, allow_fallback: bool, context: str) -> None:
    """Refuse a result-producing run whose captions would come from the
    whitespace fallback tokenizer: the eval CLI and `ExperimentRunner` call
    it once the model is built; `allow_fallback` lets the run go on. Twin
    of `patchioner.py:138`."""
    if allow_fallback or not uses_fallback_tokenizer(model):
        return
    raise RuntimeError(
        f"{context}: this model decodes captions through GPT-2, but no "
        "GPT-2 BPE vocab is available locally, so caption strings would "
        "come from the whitespace FALLBACK tokenizer (not parity with the "
        "reference). Set $GPT2_BPE_DIR to a directory containing "
        "vocab.json + merges.txt (or populate the HF cache), or pass "
        "--allow-tokenizer-fallback to run anyway.")


# the entity vocabularies: the text file and the stem of the embedding
# pickle (`{stem}_{suffix}[_with_ensemble].pickle`) of each
_ENTITY_FILES = {
    "coco_entities": ("coco_categories.json", "coco_embeddings"),
    "vinvl_vgoi_entities": ("vgcocooiobjects_v1_class2ind.json", "vgoi_embeddings"),
    "visual_genome_entities": ("all_objects_attributes_relationships.pickle",
                               "visual_genome_embedding"),
    "open_image_entities": ("oidv7-class-descriptions-boxable.csv", "open_image_embeddings"),
    "vinvl_vg_entities": ("VG-SGG-dicts-vgoi6-clipped.json", "vg_embeddings"),
}


def _load_viecap_file(path: str, cfg: viecap_mod.ViecapConfig, gcfg: gpt2.GPT2Config,
                      clock: _Clock) -> tuple[dict, Optional[dict]]:
    """A ViECap `.pt` (`mapping_network.*`, and `gpt.*` in GPT2LMHeadModel
    naming when it carries the GPT-2) as f32 CPU trees, checked against
    the config: (mapping, gpt2 or None)."""
    sd = _torch_load(path, clock)
    mapping = _port_mapping(sd, "viecap.weight_path", path, "mapping_network.", cfg,
                            gcfg.n_embd, clock)
    return mapping, _port_gpt(sd, "viecap.weight_path", path, gcfg, clock)


def _port_mapping(sd, key: str, path: str, prefix: str, cfg: viecap_mod.ViecapConfig,
                  d_model: int, clock: _Clock) -> dict:
    """The transformer mapping network under `prefix` of a state dict,
    checked against `cfg`."""
    layers = _num_blocks(sd, f"{prefix}transformer.layers.")
    if layers != cfg.num_layers:
        raise ValueError(f"{key}={path!r} holds a mapping network of {layers} layers where "
                         f"the config gives {cfg.num_layers}")
    with clock("port"):
        mapping = viecap_mod.port_mapping_network(sd, prefix=prefix, num_layers=layers)
    checkpoints.check_tree(key, path, mapping, viecap_mod.mapping_template(cfg, d_model),
                           _mapping_description(cfg, d_model))
    return mapping


def _mapping_description(cfg: viecap_mod.ViecapConfig, d_model: int) -> str:
    return (f"clip_hidden_size {cfg.clip_hidden_size}, clip_project_length "
            f"{cfg.clip_project_length}, continuous_prompt_length "
            f"{cfg.continuous_prompt_length}, {cfg.num_layers} layers of {d_model}")


def _port_gpt(sd, key: str, path: str, gcfg: gpt2.GPT2Config, clock: _Clock) -> Optional[dict]:
    """The GPT-2 under `gpt.` of a state dict (GPT2LMHeadModel naming),
    checked against `gcfg`; None when the file carries none."""
    if not any(k.startswith("gpt.") for k in sd):
        return None
    with clock("port"):
        gpt = torch_port.port_hf_gpt2_lmhead(sd, _num_blocks(sd, "gpt.transformer.h."),
                                             prefix="gpt.")
    checkpoints.check_tree(key, path, gpt, gpt2.param_template(gcfg),
                           f"GPT-2 n_layer {gcfg.n_layer}, n_embd {gcfg.n_embd}, vocab_size "
                           f"{gcfg.vocab_size}, n_positions {gcfg.n_positions}")
    return gpt


def _load_memory(mea: dict, clip_hidden: int, generator: torch.Generator,
                 allow_missing_weights: bool, device, clock: _Clock):
    """MeaCap's caption memory (captions, (N, clip_hidden) embeddings) from
    `memory_base_path/memory/memory_id/`, else 64 synthetic captions and
    seeded rows under `allow_missing_weights` (`patchioner.py:230-241`)."""
    from patchioner_tpu_torch.models import meacap as meacap_mod

    base, mem_id = mea.get("memory_base_path", ""), mea.get("memory_id", "")
    mem_dir = os.path.join(base, "memory", mem_id)
    if os.path.exists(mem_dir):
        with clock("read"):
            captions, emb = meacap_mod.MeaCap.load_memory(base, mem_id)
    elif allow_missing_weights:
        return ([f"synthetic memory caption {i}" for i in range(64)],
                torch.randn(64, clip_hidden, generator=generator, device=device))
    else:
        raise FileNotFoundError(f"MeaCap memory bank not found: {mem_dir}")
    if emb.dim() != 2 or emb.shape[1] != clip_hidden or emb.shape[0] != len(captions):
        raise ValueError(f"the MeaCap memory {mem_dir!r} holds {len(captions)} captions and "
                         f"embeddings {tuple(emb.shape)} where the config gives "
                         f"clip_hidden_size {clip_hidden}, a row a caption")
    return captions, emb


def _build_viecap_family(vd: dict, clip_model_name, generator: torch.Generator,
                         allow_missing_weights: bool, gpt2_tokenizer, device,
                         clock: _Clock, concept_extractor=None) -> viecap_mod.VieCap:
    """VieCap or MeaCap from the config's `viecap:` block (reference
    src/model.py:107-113, viecap/entrypoint.py:61-96; twin of
    `patchioner.py:155-300`): the mapping network and GPT-2 base
    (`gpt2.GPT2_BASE_CONFIG`) from `weight_path`, a `.pt` or a training
    directory (the mapper alone); then, under a `meacap`
    block, the caption memory and `concept_extractor` (MeaCap), else the
    entity vocabulary and its embeddings from
    `files_path/annotations/vocabulary` or the port's data folder. A
    missing file falls back to random tensors only under
    `allow_missing_weights`, else raises FileNotFoundError."""
    clip_hidden = vd.get("clip_hidden_size") or (
        640 if clip_model_name and "RN" in clip_model_name else 512)
    cfg = viecap_mod.ViecapConfig(
        continuous_prompt_length=vd.get("continuous_prompt_length", 10),
        clip_project_length=vd.get("clip_project_length", 10),
        clip_hidden_size=clip_hidden,
        temperature=vd.get("temperature", 0.01),
        top_k=vd.get("top_k", 3),
        threshold=vd.get("threshold", 0.2),
        using_hard_prompt=vd.get("using_hard_prompt", False),
        soft_prompt_first=vd.get("soft_prompt_first", False),
        only_hard_prompt=vd.get("only_hard_prompt", False),
        using_greedy_search=vd.get("using_greedy_search", False),
        beam_width=vd.get("beam_width", 5),
        name_of_entities_text=vd.get("name_of_entities_text", "vinvl_vgoi_entities"),
        prompt_ensemble=vd.get("prompt_ensemble", False))
    gcfg = gpt2.GPT2_BASE_CONFIG

    path = vd.get("weight_path")
    gpt = None
    if path and os.path.isdir(str(path)):
        # a directory of the port's `train/prefix_cli.py --model viecap`:
        # the mapper alone, of the depth its mapper_meta.json gives (the
        # block has no depth key), GPT-2 as for a file without one
        meta = os.path.join(str(path), "mapper_meta.json")
        if os.path.exists(meta):
            with open(meta) as f:
                cfg = dataclasses.replace(cfg, num_layers=int(json.load(f).get(
                    "num_layers", cfg.num_layers)))
        with clock("read"):
            mapping = checkpoints.load_mapper_from_train_dir(
                str(path), "viecap.weight_path", viecap_mod.mapping_template(cfg, gcfg.n_embd),
                _mapping_description(cfg, gcfg.n_embd))
    elif path and os.path.exists(str(path)):
        mapping, gpt = _load_viecap_file(str(path), cfg, gcfg, clock)
    elif allow_missing_weights:
        mapping = viecap_mod.init_mapping_network(cfg, gcfg.n_embd, generator, device)
    else:
        raise FileNotFoundError(f"ViECap weights not found: {path}")
    if gpt is None:
        if not allow_missing_weights:
            raise FileNotFoundError("pretrained GPT-2 weights unavailable locally for ViECap")
        gpt = gpt2.init_gpt2(gcfg, generator, device)
    tokenizer = gpt2_tokenizer or _get_gpt2_tokenizer(allow_missing_weights)

    mea = vd.get("meacap")
    if mea is not None:
        from patchioner_tpu_torch.models import meacap as meacap_mod

        captions, memory = _load_memory(mea, clip_hidden, generator, allow_missing_weights,
                                        device, clock)
        with clock("upload"):
            return meacap_mod.MeaCap(cfg, gcfg, gpt, mapping, captions, memory, tokenizer,
                                     device, memory_caption_num=mea.get("memory_caption_num", 5),
                                     concept_extractor=concept_extractor)

    suffix = (vd.get("suffix") or (clip_model_name or "ViT-B/32")).replace("/", "")
    name = cfg.name_of_entities_text
    text_file, stem = _ENTITY_FILES[name]
    vocab_dir = os.path.join(vd.get("files_path", ""), "annotations/vocabulary")
    if not os.path.exists(vocab_dir):
        vocab_dir = viecap_mod.VOCAB_DIR
    entities = viecap_mod.load_entities_text(name, os.path.join(vocab_dir, text_file))
    ens = "_with_ensemble" if cfg.prompt_ensemble else ""
    emb_path = os.path.join(vocab_dir, f"{stem}_{suffix}{ens}.pickle")
    if os.path.exists(emb_path):
        with clock("read"), open(emb_path, "rb") as f:
            emb = pickle.load(f)
        emb = torch.as_tensor(np.asarray(emb.detach().cpu() if torch.is_tensor(emb) else emb,
                                         np.float32))
    elif allow_missing_weights:
        emb = torch.randn(len(entities), clip_hidden, generator=generator, device=device)
    else:
        raise FileNotFoundError(f"entity embeddings not found: {emb_path}")
    if tuple(emb.shape) != (len(entities), clip_hidden):
        raise ValueError(f"entity embeddings {emb_path!r} are {tuple(emb.shape)} where the "
                         f"config gives {len(entities)} entities of clip_hidden_size "
                         f"{clip_hidden}")
    with clock("upload"):
        return viecap_mod.VieCap(cfg, gcfg, gpt, mapping, entities, emb, tokenizer,
                                 device=device)


def _build_clipcap(cd: dict, dino_model, prefix_size: int, generator: torch.Generator,
                   allow_missing_weights: bool, gpt2_tokenizer, device,
                   clock: _Clock) -> clipcap_mod.ClipCap:
    """ClipCap from the config's `clipcap:` block (reference
    src/model.py:114-127; twin of `patchioner.py:973-1064`): the mapper
    (`mapping_type` mlp or transformer) and GPT-2 base from the `.pt` at
    `weight_path`, the mapper taking `clipcap.feature_width` (the DINOv2
    backbone's width, not `prefix_size`). A missing file falls back to
    random tensors only under `allow_missing_weights`, else raises
    FileNotFoundError. A training directory of the port's
    `train/prefix_cli.py --model clipcap` gives the MLP mapper alone."""
    cfg = clipcap_mod.ClipCapConfig(
        prefix_length=cd.get("prefix_length", 10), clip_length=cd.get("clip_length", 10),
        num_layers=cd.get("num_layers", 8), mapping_type=cd.get("mapping_type", "mlp").lower(),
        temperature=cd.get("temperature", 1.0), top_p=cd.get("top_p", 0.8),
        entry_length=cd.get("entry_length", 67), stop_token=cd.get("stop_token", "."),
        normalize_prefix=cd.get("normalize_prefix", False))
    width = clipcap_mod.feature_width(dino_model, prefix_size)
    gcfg = gpt2.GPT2_BASE_CONFIG
    path = cd.get("weight_path")
    gpt = None
    if path and os.path.isdir(str(path)):
        # a directory of the port's `train/prefix_cli.py --model clipcap`,
        # which trains the MLP mapper: the mapper alone
        if cfg.mapping_type != "mlp":
            raise ValueError(f"clipcap.weight_path={path!r} is a training directory, which "
                             "holds an MLP mapper; the config gives mapping_type "
                             f"{cfg.mapping_type!r}")
        with clock("read"):
            mapper = checkpoints.load_mapper_from_train_dir(
                str(path), "clipcap.weight_path",
                clipcap_mod.mlp_template(width, cfg.prefix_length, gcfg.n_embd),
                f"an MLP mapper {width} -> {cfg.prefix_length} x {gcfg.n_embd}")
    elif path and os.path.exists(str(path)):
        sd = _torch_load(str(path), clock)
        if cfg.mapping_type == "mlp":
            with clock("port"):
                mapper = clipcap_mod.port_clipcap(
                    {k: v for k, v in sd.items() if k.startswith("clip_project.")}, cfg)["mapper"]
            checkpoints.check_tree("clipcap.weight_path", str(path), mapper,
                                   clipcap_mod.mlp_template(width, cfg.prefix_length, gcfg.n_embd),
                                   f"an MLP mapper {width} -> {cfg.prefix_length} x {gcfg.n_embd}")
        else:
            mapper = _port_mapping(sd, "clipcap.weight_path", str(path), "clip_project.",
                                   clipcap_mod.mapper_config(cfg, width), gcfg.n_embd, clock)
        gpt = _port_gpt(sd, "clipcap.weight_path", str(path), gcfg, clock)
    elif allow_missing_weights:
        if cfg.mapping_type == "mlp":
            mapper = clipcap_mod.init_mlp_mapper(width, cfg.prefix_length, gcfg.n_embd,
                                                 generator, device)
        else:
            mapper = viecap_mod.init_mapping_network(clipcap_mod.mapper_config(cfg, width),
                                                     gcfg.n_embd, generator, device)
    else:
        raise FileNotFoundError(f"ClipCap weights not found: {path}")
    if gpt is None:
        if not allow_missing_weights:
            raise FileNotFoundError("pretrained GPT-2 weights unavailable for ClipCap")
        gpt = gpt2.init_gpt2(gcfg, generator, device)
    tokenizer = gpt2_tokenizer or _get_gpt2_tokenizer(allow_missing_weights)
    with clock("upload"):
        return clipcap_mod.ClipCap(cfg, gcfg, gpt, mapper, tokenizer, width, device)


def trace_arrays(traces, max_points: Optional[int] = None) -> tuple[np.ndarray, np.ndarray]:
    """Traces in the reference's format (a list a image of {'x', 'y'} point
    dicts, or of (x, y) pairs) -> (B, P, 2) f32 points and a (B, P) valid
    mask, P = `max_points` (a longer trace is cut to it), else the longest
    trace. Twin of `_traces_to_arrays` at `patchioner.py:303`, on the host."""
    seqs = [[(float(p["x"]), float(p["y"])) if isinstance(p, dict)
             else (float(p[0]), float(p[1])) for p in tr] for tr in traces]
    p = max_points or max((len(s) for s in seqs), default=1) or 1
    out = np.zeros((len(seqs), p, 2), np.float32)
    valid = np.zeros((len(seqs), p), np.float32)
    for i, s in enumerate(seqs):
        if s:
            out[i, : len(s)] = s[:p]
            valid[i, : len(s)] = 1.0
    return out, valid


def _traces_to_arrays(traces, device):
    """`trace_arrays` padded to the longest trace, on `device`."""
    return tuple(torch.from_numpy(a).to(device) for a in trace_arrays(traces))


class Patchioner:
    def __init__(self, *, vit_cfg, vit_params: dict,
                 gpt2_cfg: gpt2.GPT2Config, decoder: Optional[decap.DecapParams],
                 bank=None, normalize: bool = True, bank_texts: Optional[list] = None,
                 inversion: Optional[dict] = None, config: Optional[dict] = None,
                 device="cuda", tokenizer=None,
                 entry_length: int = decap.ENTRY_LENGTH,
                 viecap: Optional[viecap_mod.VieCap] = None,
                 clipcap: Optional[clipcap_mod.ClipCap] = None,
                 backbone_type: str = "DINO", diag_last_layers: int = 0,
                 skip_ln_post: bool = False, calculate_argmax_text: bool = False):
        # a vit.ViTConfig for the DINO backbone, else a
        # clip.ClipVisionConfig, with the tower options of
        # `clip_visual_forward`
        self.vit_cfg = vit_cfg
        self.backbone_type = backbone_type
        self.diag_last_layers = diag_last_layers
        self.skip_ln_post = skip_ln_post
        self.gpt2_cfg = gpt2_cfg
        self.device = entry.resolve_device(device)
        self.vit_params = vit.cast_params(vit_params, vit_cfg.dtype, self.device)
        # the f32 master, which `to()` copies; `decode` holds the weights
        # cast to the decoder's type and its CUDA graphs. An argmax-text
        # model built by `from_config` has neither
        self.decoder = self.decode = None
        if decoder is not None:
            self.decoder = decap.DecapParams(
                *(vit.cast_params(p, torch.float32, self.device) for p in decoder))
            self.decode = decap.GreedyDecoder(self.decoder, gpt2_cfg, entry_length)
        # captions are the bank's texts at the nearest row (`caption_tokens`)
        self.calculate_argmax_text = calculate_argmax_text
        # a PreparedBank, a QuantizedBank (int8 rows, per-row scales), or
        # None: no support memory, the features decode as they are
        self.bank = None if bank is None else type(bank)(
            *(t.to(self.device).contiguous() for t in bank[:-1]), int(bank.num_real))
        self.bank_texts = bank_texts
        self.normalize = normalize
        self.inversion = (None if inversion is None else
                          {k: v.to(self.device) for k, v in inversion.items()})
        # the decoder families that caption instead of DeCap: ViECap (or
        # its subclass MeaCap), and ClipCap
        self.viecap = None if viecap is None else viecap.to(self.device)
        self.clipcap = None if clipcap is None else clipcap.to(self.device)
        self.config = dict(config or {})
        self.entry_length = entry_length
        self.load_seconds: dict = {}
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
        # the CLS->patch attention's extraction (`patchioner.py:390-405`): the
        # DINO config's, else 16 heads when `dino_model` is set and names no
        # ViT-S (6 otherwise), one global token, scale 0.125
        if backbone_type == "DINO":
            self.extract_heads = vit_cfg.extract_heads
            self.num_global_tokens = vit_cfg.num_global_tokens
            self.extract_scale = vit_cfg.extract_scale
        else:
            dino_model = self.config.get("dino_model")
            self.extract_heads = 16 if dino_model is not None and "vits" not in dino_model else 6
            self.num_global_tokens, self.extract_scale = 1, 0.125

    @classmethod
    def from_config(cls, config, *, rng_seed: int = 0,
                    allow_missing_weights: bool = False,
                    random_bank_size: Optional[int] = None,
                    dtype: torch.dtype = torch.float32,
                    device="cuda", gpt2_tokenizer=None,
                    concept_extractor=None) -> "Patchioner":
        if isinstance(config, str):
            import yaml

            with open(config) as f:
                config = yaml.safe_load(f)
        config = dict(config)
        _check_config(config)
        if "kkv_attention" in config and "attention_type" not in config:
            # the reference's loader reads attention_type only (src/model.py:696):
            # the README's kkv_attention key is ignored (`patchioner.py:450-457`)
            warnings.warn("config key 'kkv_attention' is ignored (reference parity); "
                          "use attention_type: 'kkv'")
        device = entry.resolve_device(device)
        clock = _Clock()

        def gen(offset):
            return torch.Generator(device=device).manual_seed(rng_seed + offset)

        kind = _backbone_type(config)
        if kind != "DINO":
            build = {"RegionCLIP": _build_regionclip, "ProxyCLIP": _build_proxyclip}.get(
                kind, functools.partial(_build_clip, kind=kind))
            vit_cfg, vit_params, backbone = build(config, dtype=dtype, generator=gen(0),
                                                  allow_missing_weights=allow_missing_weights,
                                                  device=device, clock=clock)
        else:
            backbone = {}
            # DINO.txt serves its inner DINOv2 ViT-L/14 with registers
            # (src/model.py:345-346); its bank is read with columns [1024:]
            is_dinotxt = "dinotxt" in config["dino_model"]
            vit_cfg = vit.config_for(
                "dinov2_vitl14_reg" if is_dinotxt else config["dino_model"],
                img_size=int(config.get("crop_dim", 518)),
                dtype=dtype, **_encoder_options(config),
                **dict(config.get("dino_geometry") or {}))
            widest = _MAX_EMBED_DIM[vit_cfg.ffn]
            if vit_cfg.embed_dim > widest:
                raise NotImplementedError(
                    f"{config['dino_model']} (D = {vit_cfg.embed_dim}) is not ported yet: "
                    f"kernel {'G' if vit_cfg.ffn == 'swiglu' else 'C'} takes D <= {widest}")
            path = config.get("dino_weights")
            if path and os.path.exists(str(path)):
                vit_params = _load_dino(str(path), vit_cfg, clock, is_dinotxt)
            elif allow_missing_weights:
                vit_params = vit.init_vit(vit_cfg, gen(0), device)
            else:
                raise FileNotFoundError("no local DINOv2 weights (set 'dino_weights' or pass "
                                        "allow_missing_weights=True)")

        vit_params = _rewire_attention(vit_params, config.get("attention_type", "qkv"), kind)

        # the argmax-text mode reads the bank's texts and builds no decoder
        # (`patchioner.py:816,836`)
        calculate_argmax_text = bool(config.get("calculate_argmax_text", False))
        prefix_size = int(config["prefix_size"])
        da = dict(config.get("decap_arch") or {})
        gpt2_cfg = gpt2.GPT2Config(
            n_layer=int(da.get("n_layer", 4)), n_head=int(da.get("n_head", 4)),
            n_embd=int(da.get("n_embd", 768)),
            vocab_size=int(da.get("vocab_size", gpt2.GPT2Config.vocab_size)),
            dtype=dtype)
        path = config.get("decap_weights")
        if calculate_argmax_text:
            decoder = None
        elif path and os.path.isdir(str(path)):
            # a directory of the port's `train/cli.py`: its latest step
            with clock("read"):
                decoder = checkpoints.load_decap_from_train_dir(str(path), gpt2_cfg,
                                                                prefix_size)
        elif path and os.path.exists(str(path)):
            decoder = _load_decap(str(path), gpt2_cfg, prefix_size, clock)
        elif allow_missing_weights:
            decoder = decap.init_decap(gpt2_cfg, prefix_size, gen(1), device)
        else:
            raise FileNotFoundError("no local DeCap weights ('decap_weights' missing); "
                                    "pass allow_missing_weights=True for random init")

        # with the Talk2DINO inversion the bank lives in DINO space and the
        # prefix in CLIP space, so the bank is the inversion's input width
        path = config.get("talk2dino_weights")
        inversion = None
        if path and os.path.exists(str(path)):
            inversion = _load_inversion(str(path), prefix_size, clock)
        bank, bank_texts = None, None
        if int(config.get("support_memory_size", 0)) > 0:
            bank, bank_texts = cls._build_bank(config, inversion, prefix_size, dtype,
                                               device, allow_missing_weights,
                                               random_bank_size, gen(2), clock)
        viecap = None
        if config.get("viecap") is not None:
            viecap = _build_viecap_family(config["viecap"], config.get("clip_model_name"),
                                          gen(3), allow_missing_weights, gpt2_tokenizer,
                                          device, clock, concept_extractor)
        clipcap = None
        if config.get("clipcap") is not None:
            clipcap = _build_clipcap(config["clipcap"], config.get("dino_model"), prefix_size,
                                     gen(4), allow_missing_weights, gpt2_tokenizer, device,
                                     clock)
        with clock("upload"):
            model = cls(vit_cfg=vit_cfg, vit_params=vit_params, gpt2_cfg=gpt2_cfg,
                        decoder=decoder, bank=bank, bank_texts=bank_texts,
                        normalize=bool(config.get("normalize", True)),
                        inversion=inversion, config=config, device=device, viecap=viecap,
                        clipcap=clipcap, calculate_argmax_text=calculate_argmax_text,
                        **backbone)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        model.load_seconds = dict(clock)
        return model

    @staticmethod
    def _build_bank(config, inversion, prefix_size, dtype, device, allow_missing_weights,
                    random_bank_size, generator, clock):
        """The support memory as (a PreparedBank or QuantizedBank on
        `device`, its texts): the HDF5 file `_bank_path` names, else random
        rows under `allow_missing_weights`."""
        width = prefix_size if inversion is None else int(inversion["A_pinv"].shape[1])
        if width > memproj.MAX_D:
            raise NotImplementedError(
                f"a {width}-wide support memory is not ported yet: the projection "
                f"kernels take D <= {memproj.MAX_D}")
        path, dataset = _bank_path(config)
        if os.path.exists(path):
            dino_model = config.get("dino_model")
            with clock("read"):
                loaded = memory_bank.load_bank(
                    path, dataset, dinotxt_slice="dinotxt" in (dino_model or ""))
            if loaded.embeddings.shape[1] != width:
                raise ValueError(f"the memory bank {path!r} is {loaded.embeddings.shape[1]} "
                                 f"wide where the config gives {width}")
            bank_texts = loaded.texts
            emb = loaded.embeddings
            if dino_model is not None and "dinov2" not in dino_model:
                # a CLIP-space bank's rows are taken at unit norm (`patchioner.py:935-938`)
                emb = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
            with clock("upload"):  # f32 rows onto the device, prepared there
                emb = torch.from_numpy(emb).to(device)
        elif allow_missing_weights:
            size = random_bank_size or int(config["support_memory_size"])
            emb = torch.randn(size, width, generator=generator, device=device)
            bank_texts = [f"synthetic caption {i}" for i in range(size)]
        else:
            raise FileNotFoundError(f"memory bank not found at {path}")
        with clock("upload"):
            if config.get("memory_bank_int8"):
                return memproj.quantize_bank(emb), bank_texts
            return memproj.prepare_bank(
                emb, dtype=None if dtype == torch.float32 else dtype), bank_texts

    def to(self, device) -> "Patchioner":
        """A copy of the model with every tensor on `device`."""
        return type(self)(
            vit_cfg=self.vit_cfg, vit_params=self.vit_params,
            gpt2_cfg=self.gpt2_cfg, decoder=self.decoder, bank=self.bank,
            bank_texts=self.bank_texts, normalize=self.normalize,
            inversion=self.inversion, config=self.config, device=device,
            tokenizer=self.tokenizer, entry_length=self.entry_length, viecap=self.viecap,
            clipcap=self.clipcap, backbone_type=self.backbone_type,
            diag_last_layers=self.diag_last_layers, skip_ln_post=self.skip_ln_post,
            calculate_argmax_text=self.calculate_argmax_text)

    def supports_fused_trace_path(self) -> bool:
        """True for DeCap over a support memory on the DINO backbone; another
        backbone, a ViECap, MeaCap or ClipCap model, the argmax-text mode,
        or a model without a bank or a decoder, captions through `forward`
        (`patchioner.py:1366-1379`)."""
        return (self.backbone_type == "DINO" and self.viecap is None and self.clipcap is None
                and not self.calculate_argmax_text and self.bank is not None
                and self.decoder is not None)

    @property
    def mixes_batch(self) -> bool:
        """True when an image's features depend on its batchmates:
        ProxyCLIP's affinity takes its mean over the whole batch
        (proxyclip.py:101-104), so the server pads no batch of it."""
        return self.backbone_type == "ProxyCLIP"

    def state(self) -> dict:
        return entry.make_state(self.vit_params, self.decoder, self.bank,
                                self.inversion, decode=self.decode)

    def _pixels(self, imgs) -> torch.Tensor:
        """NHWC or NCHW images on the model's device as normalised f32 NHWC
        (uint8 is normalised on the device)."""
        x = _as_nhwc(imgs).to(self.device)
        if x.dtype == torch.uint8:
            x = (x.float() / 255.0 - self._mean) / self._std
        return x.float()

    def pixels_to_device(self, imgs) -> torch.Tensor:
        """`_pixels`, for the fused paths, which take `crop_dim` images."""
        x = _as_nhwc(imgs)
        if x.shape[1] != self.crop_dim or x.shape[2] != self.crop_dim:
            raise ValueError(
                f"the fused caption paths need {self.crop_dim}px images, got "
                f"{x.shape[1]}x{x.shape[2]}")
        return self._pixels(x)

    def _caption_rows(self, pool, imgs, *pool_args) -> list:
        """One fused step with `pool` over the images and the pool's
        arrays (f32 on the model's device); a caption string per row."""
        if not self.supports_fused_trace_path():
            raise ValueError("this model has no fused caption path (a non-DINO backbone, a "
                             "ViECap, MeaCap or ClipCap decoder, or no support memory): "
                             "caption through forward()")
        step = entry.make_caption_step(
            self.vit_cfg, self.gpt2_cfg, self.bank.num_real,
            n_steps=self.entry_length, normalize=self.normalize, pool=pool)
        args = [a.to(self.device, torch.float32) if torch.is_tensor(a) else
                torch.as_tensor(np.asarray(a, np.float32), device=self.device)
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

    # ------------------------------------------------- the generic path

    @torch.no_grad()
    def encode_images(self, imgs) -> dict:
        """The encoder's outputs for images of any size (NHWC or NCHW,
        uint8 normalised on the device), with `self_attn` (B, P), the
        CLS->patch attention row, and `self_attn_maps` (B, H, P) softmaxed
        per head. A CLIP tower's `x_norm_regtokens` is empty (B, 0, P), and
        AlphaCLIP encodes the whole image (an all-ones alpha). RegionCLIP
        gives its CLS and patch tokens alone, ProxyCLIP its patch tokens
        alone: neither has an attention to extract (src/model.py:784-786,
        863-866). Twin of `patchioner.py:1085`."""
        pixels = self._pixels(imgs)
        if self.backbone_type == "RegionCLIP":
            return resnet_clip.resnet_spatial_forward(
                self.vit_params, pixels, self.vit_cfg,
                use_attnpool_for_spatial_feats=(self.config.get("regionclip_config") or {}).get(
                    "use_attnpool_for_spatial_feats", True))
        if self.backbone_type == "ProxyCLIP":
            return proxyclip_mod.proxyclip_forward(self.vit_params["clip"], self.vit_params["vfm"],
                                                   pixels, self.vit_cfg)
        if self.backbone_type == "DINO":
            outs = vit.vit_forward(self.vit_params, pixels, self.vit_cfg)
        else:
            alpha = None
            if self.backbone_type == "AlphaClip":
                alpha = torch.ones(pixels.shape[:3] + (1,), dtype=pixels.dtype,
                                   device=pixels.device)
            outs = clip_mod.clip_visual_forward(
                self.vit_params, pixels, self.vit_cfg, diag_last_layers=self.diag_last_layers,
                alpha=alpha, skip_ln_post=self.skip_ln_post)
            patches = outs["x_norm_patchtokens"]
            outs["x_norm_regtokens"] = patches.new_zeros(
                (patches.shape[0], 0, patches.shape[-1]))
        self_attn, maps = vit.process_self_attention(
            outs["qkv_last"], num_heads=self.extract_heads,
            num_global_tokens=self.num_global_tokens, scale=self.extract_scale)
        outs["self_attn"] = self_attn
        outs["self_attn_maps"] = torch.softmax(maps, dim=-1)
        return outs

    @torch.no_grad()
    def analyze_feature_compatibility(self, imgs, analyze_layers: bool = True) -> dict:
        """RegionCLIP's layer3-against-layer4 diagnostic (src/model.py:1438-1528;
        twin of `patchioner.py:1149`): per layer its spatial resolution,
        width and patch count, and with a bank of the features' width the
        CLS token's and the patch mean's projections (kernel D, or H over an
        int8 bank, at unit norm, no inversion), their similarities to the
        stored rows, their norms, and the variability of the features and
        of the projections (Bessel-corrected, as torch.std). Under res5 both
        rows read layer4's attention-pool features, as the reference's do
        (its default `use_attnpool_for_spatial_feats`); only the nominal
        patch size differs. Images as `encode_images` takes them. Another
        backbone prints a notice and gets {}."""
        if self.backbone_type != "RegionCLIP":
            print("Feature compatibility analysis only available for RegionCLIP ResNet models")
            return {}
        pixels = self._pixels(imgs)
        # {row name: use_layer3}; the nominal patch size names the row
        layers = ({"layer3": True, "layer4": False} if analyze_layers else
                  {"layer3" if self.patch_size == 16 else "layer4": self.patch_size == 16})
        res5_out = (self.config.get("regionclip_config") or {}).get("res5_out", True)
        results = {}
        for name, use_layer3 in layers.items():
            outs = resnet_clip.resnet_spatial_forward(self.vit_params, pixels, self.vit_cfg,
                                                      use_layer3=use_layer3, res5_out=res5_out)
            feats, cls_feats = outs["x_norm_patchtokens"], outs["x_norm_clstoken"]
            res = {"spatial_resolution": "{0}x{0}".format(int(feats.shape[1] ** 0.5)),
                   "embed_dim": int(feats.shape[-1]), "num_patches": int(feats.shape[1])}
            if self.bank is not None and feats.shape[-1] == self.bank.rows.shape[-1]:
                state = self.state()
                patch_mean = feats.mean(dim=1)
                proj_patches, proj_cls = (entry.project(state, x, self.bank.num_real,
                                                        normalize=True)
                                          for x in (patch_mean, cls_feats))
                # against the stored rows, not at unit norm (src/model.py:1495-1496)
                rows = self._bank_real_rows()
                cls_sims, patch_sims = proj_cls.float() @ rows.T, proj_patches.float() @ rows.T

                def norm(x):
                    return float(torch.linalg.vector_norm(x.float(), dim=1).mean())

                feature_std = float(feats.reshape(-1, feats.shape[-1]).float().std(dim=0).mean())
                projection_std = float(proj_patches.float().std(dim=0).mean())
                res.update({
                    "cls_max_similarity": float(cls_sims.amax(dim=1).mean()),
                    "cls_mean_similarity": float(cls_sims.mean()),
                    "patch_max_similarity": float(patch_sims.amax(dim=1).mean()),
                    "patch_mean_similarity": float(patch_sims.mean()),
                    "cls_feature_norm": norm(cls_feats), "patch_feature_norm": norm(patch_mean),
                    "cls_projected_norm": norm(proj_cls),
                    "patch_projected_norm": norm(proj_patches),
                    "feature_variability": feature_std,
                    "projection_variability": projection_std,
                    "projection_efficiency": projection_std / (feature_std + 1e-8)})
            results[name] = res
        return results

    def _bank_real_rows(self) -> torch.Tensor:
        """The bank's real rows in f32 as stored (int8 rows dequantized):
        the reference's `im_proj.embs_dataset`."""
        rows = self.bank.rows[:self.bank.num_real].float()
        if isinstance(self.bank, memproj.QuantizedBank):
            rows = rows * self.bank.scale[:self.bank.num_real]
        return rows

    @torch.no_grad()
    def project_features(self, feats: torch.Tensor, project: bool = True,
                         normalize: Optional[bool] = None) -> torch.Tensor:
        """The support-memory projection (kernel D, or H over an int8 bank),
        then the Talk2DINO inversion when the model has one. Under the
        inversion the projection runs whatever `project` says, as in the
        reference (`patchioner.py:1282-1297`)."""
        norm = self.normalize if normalize is None else normalize
        if (project or self.inversion is not None) and self.bank is not None:
            feats = entry.project(self.state(), feats, self.bank.num_real, normalize=norm)
        if self.inversion is not None:
            feats = talk2dino.revert_transformation(feats, self.inversion)
        return feats

    @torch.no_grad()
    def caption_tokens(self, feats, project: bool = True,
                       return_n_best_sims: Optional[int] = None,
                       compute_scores: bool = False):
        """(N, D) features -> N captions (with `compute_scores` also N
        scores): ViECap's (or MeaCap's), else ClipCap's, before any
        projection, when the model has one; else, in the argmax-text mode,
        the texts of the nearest bank rows (scores 1.0); else projected
        (when there is a bank) and decoded by DeCap. `return_n_best_sims`
        = k makes the captions (captions, each feature's top-k cosine
        similarities to the bank rows, before any projection); the
        argmax-text mode adds them only for k > 0, as the reference.
        Without a bank, the argmax-text mode and `return_n_best_sims`
        raise ValueError. Twin of `patchioner.py:1301-1363`."""
        feats = torch.as_tensor(feats).to(self.device)
        for name, family in (("viecap", self.viecap), ("clipcap", self.clipcap)):
            if family is not None:
                if return_n_best_sims:
                    raise ValueError(f"return_n_best_sims is not supported with {name}")
                if feats.shape[0] == 0:
                    return ([], []) if compute_scores else []
                return family.forward(feats, compute_scores=compute_scores)
        if self.bank is None and (return_n_best_sims is not None
                                  or self.calculate_argmax_text):
            raise ValueError("return_n_best_sims / calculate_argmax_text require a support "
                             "memory bank (support_memory_size > 0)")
        if feats.shape[0] == 0:
            # a CLIP tower's register tokens: no row, nothing to launch
            body = ([], []) if return_n_best_sims is not None else []
            return (body, []) if compute_scores else body
        # the stored rows in f32, scored at their own unit norm
        rows = (self._bank_real_rows()
                if self.calculate_argmax_text or return_n_best_sims is not None else None)

        def n_best(capts):
            sims = memproj.memory_topk_sims(feats, rows, return_n_best_sims)
            return capts, sims.cpu().numpy().tolist()

        if self.calculate_argmax_text:
            idx = memproj.memory_argmax(feats, rows).cpu().numpy()
            capts = [self.bank_texts[i] for i in idx]
            body = n_best(capts) if return_n_best_sims else capts
            return (body, [1.0] * len(capts)) if compute_scores else body
        prefix = self.project_features(feats, project=project)
        # DeCap's eager loop in the reference; the graph decoder replays its
        # very launches on the card
        tokens, scores = self.decode(prefix.float())
        capts = [self.tokenizer.decode_caption(row) for row in tokens.cpu().numpy()]
        body = capts if return_n_best_sims is None else n_best(capts)
        if compute_scores:
            return body, scores.cpu().numpy().tolist()
        return body

    @torch.no_grad()
    def forward(self, imgs, get_cls_capt: bool = True, get_avg_self_attn_capt: bool = False,
                get_attn_heads_capt: bool = False, get_patch_capts: bool = False,
                get_register_capts: bool = False, bboxes=None, traces=None,
                get_controllable_capts: bool = False, bs_factor: int = 4,
                gaussian_avg: bool = False, gaussian_bbox_variance: float = 0.5,
                get_avg_patch_capt: bool = False, gaussian_img_variance: float = 1,
                use_attn_map_for_bboxes: bool = False, use_attention_tracing: bool = False,
                double_DINO_for_bboxes: bool = False,
                double_DINO_for_bboxes_return_type: str = "avg",
                double_DINO_use_cls: bool = False, cleaning_type: Optional[str] = None,
                clean_after_projection: bool = True, alpha: float = 1.0,
                clean_from: str = "cls", caption_bboxes_type: Optional[str] = None,
                return_n_best_sims: Optional[int] = None,
                compute_scores: bool = False) -> dict:
        """Every caption the flags ask for, in the reference's output keys
        and per-image nesting (`patchioner.py:1959-2216`, the DINO
        backbone): `cls_capt`, `avg_self_attn_capt`, `avg_patch_capt`,
        `attn_heads_capts` (B x extract_heads: the patch tokens weighted by
        each head's CLS attention, averaged over the patches),
        `patch_tokens_capts`, `register_capts`, `bbox_capts` (pixel
        `[x1, y1, w, h]` boxes; uniform, Gaussian or attention-map weights, or
        double-DINO features; with `return_n_best_sims` = k also `bbox_sims`,
        B x NB lists of each box feature's top-k cosine similarities to the
        bank), `set_controllable_capts` (one caption per box set) and
        `trace_capts` (a list of traces, or padded (points, valid)); with
        `compute_scores` each caption list but the last two has a `_scores`
        twin. `caption_bboxes_type` returns `caption_bboxes`' result on PIL
        images.

        `cleaning_type` cleans the patch tokens of the context of
        `clean_from` ('cls', or 'avg_self_attn', which falls back to the
        CLS token where the tower's attention is not read) with
        `rp.ctx_cleaner` and `alpha`: with `clean_after_projection` the
        patch tokens and the context are each projected through the bank
        at unit norm (kernel D, or H over an int8 bank; no Talk2DINO
        inversion) and then cleaned, else normalised, cleaned and then
        projected. The reference's routing is kept: patch and box captions
        of the cleaned tokens skip the caption's projection, the
        whole-image mean, traces and box sets are projected once more, and
        the attention-head and double-DINO features come from the
        uncleaned tokens."""
        assert clean_from in ("cls", "avg_self_attn")
        assert cleaning_type in (None, "orthogonal_projection", "contrastive_mask")
        if double_DINO_for_bboxes and self.backbone_type != "DINO":
            raise ValueError("double_DINO_for_bboxes requires a DINO backbone")
        if caption_bboxes_type is not None:
            return self.caption_bboxes(imgs, bboxes, capt_type=caption_bboxes_type,
                                       compute_scores=compute_scores)
        if self.backbone_type == "AlphaClip" and (bboxes is not None or traces is not None):
            return self._forward_alphaclip_regions(
                imgs, bboxes, traces, get_controllable_capts=get_controllable_capts,
                compute_scores=compute_scores, return_n_best_sims=return_n_best_sims)

        outs: dict[str, Any] = {}
        enc = self.encode_images(imgs)
        patch_tokens = enc["x_norm_patchtokens"]
        bs, n_patches, embed_dim = patch_tokens.shape
        # only the DINO and DenseCLIP towers' attention is read
        # (`patchioner.py:2014-2021`): elsewhere boxes and traces pool
        # uniformly, the attention-weighted mean and the head captions
        # raise, and cleaning from it falls back to the CLS token
        has_attention = self.backbone_type in ("DINO", "DenseClip")
        self_attn = enc["self_attn"] if has_attention else None
        if (get_avg_self_attn_capt or get_attn_heads_capt) and not has_attention:
            raise ValueError(f"backbone {self.backbone_type} exposes no self-attention")
        avg_self_attn = None
        if has_attention and (get_avg_self_attn_capt or (
                cleaning_type is not None and clean_from == "avg_self_attn")):
            avg_self_attn = (self_attn[..., None] * patch_tokens).mean(dim=1)
        if get_attn_heads_capt:
            # (B, H, D): the mean over patches of the tokens times each
            # head's map, from the uncleaned tokens
            disentangled = torch.einsum("bhp,bpd->bhd", enc["self_attn_maps"].float(),
                                        patch_tokens.float()) / n_patches

        if cleaning_type is not None:
            def proj_norm(x):
                if self.bank is None:
                    return x
                return entry.project(self.state(), x, self.bank.num_real, normalize=True)

            src = (avg_self_attn if clean_from != "cls" and avg_self_attn is not None
                   else enc["x_norm_clstoken"])
            if clean_after_projection:
                proj = proj_norm(patch_tokens.reshape(-1, embed_dim)).reshape(bs, n_patches, -1)
                patch_tokens = rp.ctx_cleaner(proj, proj_norm(src), cleaning_type, alpha)
            else:
                unit = patch_tokens / torch.linalg.vector_norm(patch_tokens, dim=-1, keepdim=True)
                src = src / torch.linalg.vector_norm(src, dim=-1, keepdim=True)
                cleaned = rp.ctx_cleaner(unit, src, cleaning_type, alpha)
                patch_tokens = proj_norm(cleaned.reshape(-1, cleaned.shape[-1])).reshape(
                    bs, n_patches, -1)
            embed_dim = patch_tokens.shape[-1]
        # the cleaned tokens are in the bank's space already: their patch
        # and box captions skip the caption's projection
        # (`patchioner.py:2126,2173`)
        project = cleaning_type is None

        def emit(key, feats):
            ret = self.caption_tokens(feats, compute_scores=compute_scores)
            if compute_scores:
                outs[key], outs[f"{key}_scores"] = ret
            else:
                outs[key] = ret

        def emit_per_image(key, score_key, feats, per, project=True, n_best=None):
            # (B * per) captions nested B x per; `n_best` adds `bbox_sims`
            ret = self.caption_tokens(feats.reshape(-1, embed_dim), project=project,
                                      return_n_best_sims=n_best,
                                      compute_scores=compute_scores)
            body, scores = ret if compute_scores else (ret, None)
            capts, sims = body if n_best is not None else (body, None)

            def nest(xs):
                return [xs[i * per:(i + 1) * per] for i in range(bs)]

            outs[key] = nest(capts)
            if compute_scores:
                outs[score_key] = nest(scores)
            if sims is not None:
                outs["bbox_sims"] = nest(sims)

        if get_cls_capt:
            if "x_norm_clstoken" not in enc:
                raise ValueError(f"backbone {self.backbone_type} emits patch tokens only")
            emit("cls_capt", enc["x_norm_clstoken"])
        if get_avg_self_attn_capt:
            emit("avg_self_attn_capt", avg_self_attn)
        if get_avg_patch_capt:
            emit("avg_patch_capt", rp.compute_region_means(patch_tokens, gaussian_img_variance))
        if get_attn_heads_capt:
            emit_per_image("attn_heads_capts", "attn_heads_scores", disentangled,
                           disentangled.shape[1])
        if get_patch_capts:
            emit_per_image("patch_tokens_capts", "patch_tokens_scores", patch_tokens,
                           n_patches, project=project)
        if get_register_capts:
            regs = enc["x_norm_regtokens"]
            emit_per_image("register_capts", "register_scores", regs, regs.shape[1])

        if bboxes is not None:
            boxes = torch.as_tensor(np.asarray(bboxes, np.float32), device=self.device)
            weight_kw = dict(patch_size=self.patch_size, gaussian_avg=gaussian_avg,
                             gaussian_bbox_variance=float(gaussian_bbox_variance),
                             attention_map=self_attn if use_attn_map_for_bboxes else None)
            if get_controllable_capts:
                outs["set_controllable_capts"] = self.caption_tokens(
                    rp.extract_bbox_features_single(patch_tokens, boxes, **weight_kw))
            else:
                if double_DINO_for_bboxes:  # from the uncleaned encoder output
                    feats = self._double_dino_features(
                        enc, boxes, return_type=double_DINO_for_bboxes_return_type,
                        use_cls=double_DINO_use_cls,
                        gaussian_bbox_variance=float(gaussian_bbox_variance))
                else:
                    feats = rp.extract_bbox_features(patch_tokens, boxes, **weight_kw)
                emit_per_image("bbox_capts", "bbox_scores", feats, boxes.shape[1],
                               project=project, n_best=return_n_best_sims)

        if traces is not None:
            if isinstance(traces, (list, tuple)):
                pts, valid = _traces_to_arrays(traces, self.device)
            else:  # pre-padded (B, P, 2) points and (B, P) valid mask
                pts, valid = (torch.as_tensor(np.asarray(a, np.float32), device=self.device)
                              for a in traces)
            grid = rp.traces_to_grid(pts, valid, int(round(n_patches ** 0.5)))
            outs["trace_capts"] = self.caption_tokens(rp.trace_pool(
                patch_tokens, grid, self_attn if use_attention_tracing else None))
        return outs

    @torch.no_grad()
    def _double_dino_features(self, enc: dict, bboxes: torch.Tensor, *,
                              return_type: str = "avg", use_cls: bool = False,
                              gaussian_bbox_variance: float = 0.5) -> torch.Tensor:
        """Double-DINO box features, (B, NB, D) f32: the last encoder block
        re-run on each box's tokens alone (reference src/bbox_utils.py:300-403),
        every (image, box) pair in one `vit.last_block_rerun` over key-masked
        rows. Twin of `patchioner.py:2218`, with the reference's quirks: the
        re-run takes the final normalised tokens; a box's grid span is
        `floor([x1, y1, x2, y2] / patch)` with both ends inclusive (the
        elements read as corners, not xywh); the global tokens are keys only
        under `use_cls`; 'cls' reads row 0 of the output, 'avg' the mean over
        the box's patches (an empty box gives zeros); 'gaussian_avg' weights
        the box's INPUT patches by `bbox_weight_maps` on grid-unit boxes and
        does not read the re-run, so it does not run it."""
        if return_type not in ("cls", "avg", "gaussian_avg"):
            raise ValueError(f"unknown double-DINO return type: {return_type}")
        patches = enc["x_norm_patchtokens"]
        bs, n_patches, d = patches.shape
        if return_type == "gaussian_avg":
            g = int(round(n_patches ** 0.5))
            x1, y1, x2, y2 = self._box_grid(bboxes).unbind(-1)
            pseudo = torch.stack([x1, y1, x2 - x1, y2 - y1], dim=-1).float()
            w = rp.bbox_weight_maps(pseudo, g, 1, gaussian_avg=True,
                                    gaussian_bbox_variance=gaussian_bbox_variance)
            return torch.einsum("bkyx,byxd->bkd", w, patches.float().reshape(bs, g, g, d))
        tokens, key_mask = self._double_dino_rows(enc, bboxes, use_cls)
        out = vit.last_block_rerun(self.vit_params, tokens, key_mask, self.vit_cfg)
        if return_type == "cls":
            feats = out[:, 0].float()
        else:
            ng = self.num_global_tokens
            w = key_mask[:, ng:, None].float()
            feats = (out[:, ng:].float() * w).sum(dim=1) / w.sum(dim=1).clamp(min=1.0)
        return feats.reshape(bs, bboxes.shape[1], d)

    def _box_grid(self, bboxes: torch.Tensor) -> torch.Tensor:
        """(..., 4) pixel boxes -> int32 `floor([x1, y1, x2, y2] / patch)`."""
        return torch.floor(bboxes.float() / self.patch_size).to(torch.int32)

    def _double_dino_rows(self, enc: dict, bboxes: torch.Tensor, use_cls: bool):
        """The re-run's rows for (B, NB, 4) boxes: (tokens (B * NB, T, D),
        the normalised [cls, registers, patches] of each box's image, and
        key_mask (B * NB, T), the box's patches with both grid ends
        inclusive, and the global tokens under `use_cls`)."""
        patches = enc["x_norm_patchtokens"]
        bs, n_patches, _ = patches.shape
        nb = bboxes.shape[1]
        x1, y1, x2, y2 = self._box_grid(bboxes).unbind(-1)
        idx = torch.arange(int(round(n_patches ** 0.5)), dtype=torch.int32,
                           device=patches.device)
        in_y = (idx >= y1[..., None]) & (idx <= y2[..., None])
        in_x = (idx >= x1[..., None]) & (idx <= x2[..., None])
        inside = (in_y[..., :, None] & in_x[..., None, :]).reshape(bs * nb, n_patches)
        tokens = torch.cat([enc["x_norm_clstoken"][:, None], enc["x_norm_regtokens"], patches],
                           dim=1).repeat_interleave(nb, dim=0)
        globals_ = inside.new_full((bs * nb, self.num_global_tokens), bool(use_cls))
        return tokens, torch.cat([globals_, inside], dim=1)

    @torch.no_grad()
    def caption_bboxes(self, imgs, bboxes, capt_type: str = "cls_capt",
                       crop_boxes: bool = False, compute_scores: bool = False) -> dict:
        """The crop-and-caption baseline: crop each (B, NB, 4) pixel
        `[x1, y1, w, h]` box out of its PIL image in `imgs`, bring the crop
        to the model's input (`utils.transforms.preprocess_pil_uint8`, a
        stretch unless `crop_boxes`), and caption the crops through
        `forward` (`capt_type` 'cls_capt' or 'avg_self_attn_capt') in
        chunks of B; `bbox_capts` (and `bbox_scores`) nested B x NB. Twin
        of `patchioner.py:2449`."""
        from patchioner_tpu_torch.utils import transforms

        bboxes = np.asarray(bboxes)
        bs, n_boxes = bboxes.shape[0], bboxes.shape[1]
        crops = np.stack([
            transforms.preprocess_pil_uint8(img.crop((x1, y1, x1 + w, y1 + h)),
                                            self.resize_dim, self.crop_dim, crop=crop_boxes)
            for img, img_boxes in zip(imgs, bboxes) for x1, y1, w, h in img_boxes.tolist()])
        capts, scores = [], []
        for i in range(0, len(crops), bs):
            outs = self.forward(crops[i:i + bs], get_cls_capt=capt_type == "cls_capt",
                                get_avg_self_attn_capt=capt_type == "avg_self_attn_capt",
                                compute_scores=compute_scores)
            capts.extend(outs[capt_type])
            if compute_scores:
                scores.extend(outs[f"{capt_type}_scores"])
        ret = {"bbox_capts": [capts[i * n_boxes:(i + 1) * n_boxes] for i in range(bs)]}
        if compute_scores:
            ret["bbox_scores"] = [scores[i * n_boxes:(i + 1) * n_boxes] for i in range(bs)]
        return ret

    @torch.no_grad()
    def _forward_alphaclip_regions(self, imgs, bboxes=None, traces=None, *,
                                   get_controllable_capts: bool = False,
                                   compute_scores: bool = False,
                                   return_n_best_sims: Optional[int] = None) -> dict:
        """AlphaCLIP's region captions (`patchioner.py:2297-2420`): every
        (image, box) pair, or each image's trace, through one batched
        encoder pass with the region as the alpha mask. The encoder's mask
        is at pixel resolution (a trace marks single pixels); under
        `use_cls_for_localized_captions: false` the patch tokens are
        averaged under the region's patch-grid mask, else the CLS token is
        captioned. A dummy box (negative coordinate sum) gets "", a score
        of 0.0 and, under `return_n_best_sims`, no similarities (`[]`) in
        `bbox_sims`. `get_controllable_capts` captions the OR of each
        image's boxes and trace."""
        pixels = self._pixels(imgs)
        bs, hw = pixels.shape[0], pixels.shape[1]
        grid = self.vit_cfg.grid_size
        use_cls = (self.config.get("alphaclip_config") or {}).get(
            "use_cls_for_localized_captions", True)
        outs: dict[str, Any] = {}

        def encode_with_masks(px, masks, patch_masks):
            out = clip_mod.clip_visual_forward(self.vit_params, px, self.vit_cfg,
                                               alpha=masks[..., None])
            if use_cls:
                return out["x_norm_clstoken"]
            af = patch_masks.reshape(patch_masks.shape[0], -1)
            return ((out["x_norm_patchtokens"] * af[..., None]).sum(dim=1)
                    / (af.sum(dim=1, keepdim=True) + 1e-8))

        if traces is not None:
            if isinstance(traces, (list, tuple)):
                pts, valid = _traces_to_arrays(traces, self.device)
            else:  # pre-padded (B, P, 2) points and (B, P) valid mask
                pts, valid = (torch.as_tensor(np.asarray(a, np.float32), device=self.device)
                              for a in traces)

        def trace_masks(size):
            return (rp.traces_to_grid(pts, valid, size) > 0).float()

        if bboxes is not None:
            boxes = torch.as_tensor(np.asarray(bboxes, np.float32), device=self.device)
        if get_controllable_capts:
            mask = torch.zeros(bs, hw, hw, device=self.device)
            pmask = torch.zeros(bs, grid, grid, device=self.device)
            if bboxes is not None:
                mask = torch.maximum(mask, rp.boxes_to_pixel_masks(boxes, hw).amax(dim=1))
                pmask = torch.maximum(pmask, rp.boxes_to_pixel_masks(
                    boxes / self.patch_size, grid).amax(dim=1))
            if traces is not None:
                mask = torch.maximum(mask, trace_masks(hw))
                pmask = torch.maximum(pmask, trace_masks(grid))
            ret = self.caption_tokens(encode_with_masks(pixels, mask, pmask),
                                      compute_scores=compute_scores)
            outs["set_controllable_capts"] = ret[0] if compute_scores else ret
            return outs

        if bboxes is not None:
            n_boxes = boxes.shape[1]
            masks = rp.boxes_to_pixel_masks(boxes, hw).reshape(-1, hw, hw)
            pmasks = rp.boxes_to_pixel_masks(boxes / self.patch_size, grid)
            ret = self.caption_tokens(
                encode_with_masks(pixels.repeat_interleave(n_boxes, dim=0), masks,
                                  pmasks.reshape(-1, grid, grid)),
                compute_scores=compute_scores, return_n_best_sims=return_n_best_sims)
            body, scores = ret if compute_scores else (ret, None)
            capts, sims = body if return_n_best_sims is not None else (body, None)
            dummy = (boxes.sum(dim=-1) < 0).cpu().numpy()

            def per_box(values, empty):
                return [[empty if dummy[i, j] else values[i * n_boxes + j]
                         for j in range(n_boxes)] for i in range(bs)]

            outs["bbox_capts"] = per_box(capts, "")
            if compute_scores:
                outs["bbox_scores"] = per_box(scores, 0.0)
            if sims is not None:
                outs["bbox_sims"] = per_box(sims, [])
        if traces is not None:
            ret = self.caption_tokens(
                encode_with_masks(pixels, trace_masks(hw), trace_masks(grid)),
                compute_scores=compute_scores)
            if compute_scores:
                outs["trace_capts"], outs["trace_scores"] = ret
            else:
                outs["trace_capts"] = ret
        return outs
