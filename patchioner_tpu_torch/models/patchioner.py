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

`from_config` takes the reference YAML schema (a path or a dict) and
loads what the reference's `from_config` loads for this subset
(patchioner.py:506-547, 836-957), the same files:
- `dino_weights`: a torch.hub DINOv2 `.pth` (a `state_dict` key is
  unwrapped) through `io.torch_port.port_dinov2`, or an `.npz` of
  `io.checkpoints.save_params_npz`;
- `decap_weights`: a DeCap `.pt` through `port_decap` (an Orbax directory
  of the JAX package's decoder training raises NotImplementedError);
- `talk2dino_weights`: Talk2DINO's projection through `port_talk2dino`,
  whose `talk2dino.build_inversion` takes the projected prefix back to
  CLIP space; the bank then lives in DINO space, the prefix in CLIP space;
- the support memory: the HDF5 bank at `memory_bank_path`, or else at
  `$IM2TXT_MEMORY_PATH` (default /im2txtmemories) under the name
  `io.memory_bank.bank_filename` gives the config; its texts are
  `bank_texts`. Reading it needs h5py.
A file that is missing falls back to seeded random tensors, drawn with
`torch.Generator`, only under `allow_missing_weights=True`, and otherwise
raises FileNotFoundError, as the reference does; a missing Talk2DINO file
leaves the inversion off. The config decides every shape: a loaded tree
whose depth, width, register count, FFN or vocabulary disagrees with it
raises ValueError, naming both. The files are ported into f32 CPU trees
and uploaded once, by the constructor, as random weights are;
`load_seconds` holds the seconds spent reading, porting and uploading.

The encoder keys `attn_impl`, `proj_fused` and `gelu_approx` are the
reference's (patchioner.py:487-505), and so is its `memory_bank_int8`
opt-in (the bank quantized per row to int8 from the f32 bank, whatever the
model's type, and projected by kernel H). The DINOv2 backbones it takes
are ViT-S and ViT-B (MLP FFN, kernel C: D <= 768) and ViT-g,
`dinov2_vitg14(_reg)` (SwiGLU FFN, kernel G: D <= 1536), whose prefix and
bank are 1536-wide as the config gives them; every `attn_impl` runs on
each. Any key that leaves this subset raises NotImplementedError: other
backbones (ViT-L among them, until C's f32 kernel takes D = 1024, and
DINO.txt), ViECap / MeaCap / ClipCap, argmax-text, int8 (W8A8) encoders,
the compute-dtype softmax (`softmax_f32: false`) and a non-qkv
attention_type. A config given as a Hugging Face model id is not ported
(it must be a path or a dict), nor are the reference's
`save_pretrained` / `load_pretrained` snapshots.

The model lives on `device`, "cuda" unless the caller asks for "cpu";
without a card, asking for "cuda" raises.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch

from patchioner_tpu_torch import entry
from patchioner_tpu_torch.io import checkpoints, memory_bank, torch_port
from patchioner_tpu_torch.models import decap, gpt2, talk2dino, vit
from patchioner_tpu_torch.ops import memory_projection as memproj

__all__ = ["Patchioner"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# keys the subset reads
_KEYS = {
    "dino_model", "crop_dim", "resize_dim", "image_mean", "image_std",
    "dino_geometry", "attention_type", "prefix_size", "decap_arch",
    "normalize", "support_memory_size", "decap_weights", "dino_weights",
    "talk2dino_weights", "memory_bank_int8", "memory_bank_path",
}
# keys that name the bank file under $IM2TXT_MEMORY_PATH
# (`io.memory_bank.bank_filename`) when `memory_bank_path` is not given
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
    "use_open_clip", "invite_config",
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


class _Clock(dict):
    """Seconds spent in each named stage: `with clock("read"): ...`."""

    @contextlib.contextmanager
    def __call__(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self[stage] = self.get(stage, 0.0) + time.perf_counter() - t0


def _check_tree(key: str, path: str, tree, template, config: str) -> None:
    """ValueError unless `tree` has the structure and shapes of `template`,
    the tree the config gives; the message names both."""

    def walk(got, want, at):
        if isinstance(want, dict):
            if not isinstance(got, dict) or sorted(got) != sorted(want):
                raise ValueError(
                    f"{key}={path!r}: {at or 'the tree'} holds "
                    f"{sorted(got) if isinstance(got, dict) else type(got).__name__} "
                    f"where the config ({config}) gives {sorted(want)}")
            for k in want:
                walk(got[k], want[k], f"{at}[{k!r}]")
        elif isinstance(want, (list, tuple)):
            if not isinstance(got, (list, tuple)) or len(got) != len(want):
                raise ValueError(
                    f"{key}={path!r}: {at} has "
                    f"{len(got) if isinstance(got, (list, tuple)) else 'no'} entries "
                    f"where the config ({config}) gives {len(want)}")
            for i, (g, w) in enumerate(zip(got, want)):
                walk(g, w, f"{at}[{i}]")
        elif not torch.is_tensor(got) or got.shape != want.shape:
            shape = tuple(got.shape) if torch.is_tensor(got) else type(got).__name__
            raise ValueError(f"{key}={path!r}: {at} is {shape} where the "
                             f"config ({config}) gives {tuple(want.shape)}")

    walk(tree, template, "")


def _num_blocks(sd, prefix: str) -> int:
    """How many `{prefix}N.` blocks a state dict holds."""
    idx = {k[len(prefix):].split(".", 1)[0] for k in sd if k.startswith(prefix)}
    return 1 + max((int(i) for i in idx if i.isdigit()), default=-1)


def _torch_load(path: str, clock: _Clock):
    with clock("read"):
        return torch.load(path, map_location="cpu", weights_only=True)


def _load_dino(path: str, cfg: vit.ViTConfig, clock: _Clock) -> dict:
    """`dino_weights` (a hub `.pth` or an `.npz`) as an f32 CPU tree, checked
    against `cfg`."""
    if path.endswith(".npz"):
        with clock("read"):
            tree = checkpoints.load_params_npz(path)
    else:
        sd = _torch_load(path, clock)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        with clock("port"):
            tree = torch_port.port_dinov2(sd, _num_blocks(sd, "blocks."),
                                          "register_tokens" in sd)
    if cfg.embed_dim % cfg.num_heads:
        raise ValueError(f"dino_weights={path!r}: the config's {cfg.num_heads} heads "
                         f"do not split its width {cfg.embed_dim}")
    _check_tree("dino_weights", path, tree, vit.param_template(cfg),
                f"depth {cfg.depth}, width {cfg.embed_dim}, {cfg.num_heads} heads, "
                f"{cfg.num_registers} registers, {cfg.ffn} FFN {cfg.ffn_hidden}, "
                f"patch {cfg.patch_size}, position grid {cfg.stored_pos_grid}")
    return tree


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
    _check_tree("decap_weights", path, tree, template,
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


class Patchioner:
    def __init__(self, *, vit_cfg: vit.ViTConfig, vit_params: dict,
                 gpt2_cfg: gpt2.GPT2Config, decoder: decap.DecapParams,
                 bank, normalize: bool = True, bank_texts: Optional[list] = None,
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
        self.bank_texts = bank_texts
        self.normalize = normalize
        self.inversion = (None if inversion is None else
                          {k: v.to(self.device) for k, v in inversion.items()})
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
        device = entry.resolve_device(device)
        clock = _Clock()

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
        path = config.get("dino_weights")
        if path and os.path.exists(str(path)):
            vit_params = _load_dino(str(path), vit_cfg, clock)
        elif allow_missing_weights:
            vit_params = vit.init_vit(vit_cfg, gen(0), device)
        else:
            raise FileNotFoundError("no local DINOv2 weights (set 'dino_weights' or pass "
                                    "allow_missing_weights=True)")

        prefix_size = int(config["prefix_size"])
        da = dict(config.get("decap_arch") or {})
        gpt2_cfg = gpt2.GPT2Config(
            n_layer=int(da.get("n_layer", 4)), n_head=int(da.get("n_head", 4)),
            n_embd=int(da.get("n_embd", 768)),
            vocab_size=int(da.get("vocab_size", gpt2.GPT2Config.vocab_size)),
            dtype=dtype)
        path = config.get("decap_weights")
        if path and os.path.isdir(str(path)):
            raise NotImplementedError(
                f"decap_weights={path!r} is a directory, an Orbax checkpoint of the JAX "
                "package's decoder training: loading one waits for the port's training "
                "slice")
        if path and os.path.exists(str(path)):
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
        width = prefix_size if inversion is None else int(inversion["A_pinv"].shape[1])
        if width > memproj.MAX_D:
            raise NotImplementedError(
                f"a {width}-wide support memory is not ported yet: the projection "
                f"kernels take D <= {memproj.MAX_D}")

        path, dataset = _bank_path(config)
        if os.path.exists(path):
            with clock("read"):
                loaded = memory_bank.load_bank(
                    path, dataset, dinotxt_slice="dinotxt" in config["dino_model"])
            if loaded.embeddings.shape[1] != width:
                raise ValueError(f"the memory bank {path!r} is {loaded.embeddings.shape[1]} "
                                 f"wide where the config gives {width}")
            bank_texts = loaded.texts
            with clock("upload"):  # f32 rows onto the device, prepared there
                emb = torch.from_numpy(loaded.embeddings).to(device)
        elif allow_missing_weights:
            size = random_bank_size or int(config["support_memory_size"])
            emb = torch.randn(size, width, generator=gen(2), device=device)
            bank_texts = [f"synthetic caption {i}" for i in range(size)]
        else:
            raise FileNotFoundError(f"memory bank not found at {path}")
        with clock("upload"):
            if config.get("memory_bank_int8"):
                bank = memproj.quantize_bank(emb)
            else:
                bank = memproj.prepare_bank(
                    emb, dtype=None if dtype == torch.float32 else dtype)
            del emb
            model = cls(vit_cfg=vit_cfg, vit_params=vit_params, gpt2_cfg=gpt2_cfg,
                        decoder=decoder, bank=bank, bank_texts=bank_texts,
                        normalize=bool(config.get("normalize", True)),
                        inversion=inversion, config=config, device=device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        model.load_seconds = dict(clock)
        return model

    def to(self, device) -> "Patchioner":
        """A copy of the model with every tensor on `device`."""
        return type(self)(
            vit_cfg=self.vit_cfg, vit_params=self.vit_params,
            gpt2_cfg=self.gpt2_cfg, decoder=self.decoder, bank=self.bank,
            bank_texts=self.bank_texts, normalize=self.normalize,
            inversion=self.inversion, config=self.config, device=device,
            tokenizer=self.tokenizer, entry_length=self.entry_length)

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
