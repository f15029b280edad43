"""Pre-extract features for decoder training and build support-memory banks.

Twin of `patchioner_tpu/train/extract_features.py` (reference
src/clipcap/clipcap_dino_parse_coco.py, and the bank-building loop of
src/decap/im2txtprojection/im2txtprojection.py:448-560), with the same
sub-commands and flags plus `--device` (the card unless `--device cpu`):

  python -m patchioner_tpu_torch.train.extract_features text --data captions.json \
      --out feats.npy [--text-encoder dinotxt] [--talk2dino weights.pth]
  python -m patchioner_tpu_torch.train.extract_features bank --data captions.json \
      --size 500000 --text-encoder regionclip --text-weights ckpt.pth
  python -m patchioner_tpu_torch.train.extract_features image --config model.yaml \
      --images dir/ --out feats.npy --select cls

`text` encodes a caption corpus in one of the five text spaces
(`train/text_spaces.py`), Talk2DINO-projected on request, into a .npy
aligned with the corpus (the input of `train.cli --features`). `bank`
encodes a corpus into an HDF5 bank under the reference's filename scheme
or `--out`; h5py is needed at the write only. `image` runs a model's
encoder (`Patchioner.encode_images`) over an image folder and keeps one
feature an image (`cls`, `avg_self_attn` or `avg_patch`); `--config` is a
YAML file, or JSON where PyYAML is missing.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from patchioner_tpu_torch import entry
from patchioner_tpu_torch.train import text_spaces

__all__ = ["build_argparser", "main", "BankEncoder", "make_bank", "talk2dino_projection",
           "encode_corpus", "select_features", "IMAGE_SELECTIONS"]


def _build_space(args, device) -> text_spaces.TextSpace:
    weights = getattr(args, "text_weights", None) or getattr(args, "clip_weights", None)
    if not (weights and os.path.exists(weights)) and not args.allow_random:
        raise SystemExit("no local text weights (--text-weights); pass --allow-random for a "
                         "seeded tower")
    return text_spaces.build_text_space(args.text_encoder, weights,
                                        denseclip_config=args.denseclip_config, device=device)


def talk2dino_projection(path, device):
    """Talk2DINO's projection (CLIP text -> DINO) of the file at `path` as
    a function of a tensor on `device`; None without a path. A path that
    names no file raises FileNotFoundError: features in the wrong space
    must not be written silently."""
    if not path:
        return None
    if not os.path.exists(path):
        raise FileNotFoundError(f"talk2dino weights {path!r} not found")
    from patchioner_tpu_torch.io import torch_port
    from patchioner_tpu_torch.models import talk2dino
    from patchioner_tpu_torch.models.vit import cast_params

    params = cast_params(torch_port.port_talk2dino(
        torch.load(path, map_location="cpu", weights_only=True)), torch.float32, device)
    return lambda x: talk2dino.project_clip_txt(params, x)


@torch.no_grad()
def encode_corpus(space: text_spaces.TextSpace, project, captions: list,
                  bs: int) -> np.ndarray:
    """The captions' training-space features, `bs` at a time, each batch
    tokenized at the space's own context and through `project` (Talk2DINO)
    when given, as f32 numpy rows."""
    out = []
    for i in range(0, len(captions), bs):
        feats = space.encode_tokens(space.tokenize(captions[i:i + bs]))
        if project is not None:
            feats = project(feats)
        out.append(feats.float().cpu().numpy())
    return np.concatenate(out)


def extract_text_features(args, device) -> np.ndarray:
    from patchioner_tpu_torch.train import data as data_mod

    captions, _ = data_mod.load_coco_captions(args.data)
    feats = encode_corpus(_build_space(args, device), talk2dino_projection(args.talk2dino, device),
                          captions, args.bs)
    np.save(args.out, feats)
    print(f"wrote {feats.shape} -> {args.out}")
    return feats


class BankEncoder:
    """`memory_bank.build_bank`'s encode function: a batch of captions
    tokenized, through the space's whole tower, then Talk2DINO when given,
    as f32 numpy rows. `seconds` adds up the host time of the tokenizer
    and of the rest (the tower and the projection, waited for)."""

    def __init__(self, space: text_spaces.TextSpace, project=None):
        self.space = space
        self.project = project
        self.seconds = {"tokenizer": 0.0, "tower": 0.0}

    @torch.no_grad()
    def __call__(self, texts) -> np.ndarray:
        t0 = time.perf_counter()
        tokens = self.space.tokenize(texts)
        t1 = time.perf_counter()
        feats = self.space.encode_tokens_raw(tokens)
        if self.project is not None:
            feats = self.project(feats)
        rows = feats.float().cpu().numpy()
        self.seconds["tokenizer"] += t1 - t0
        self.seconds["tower"] += time.perf_counter() - t1
        return rows


def make_bank(args, device):
    """The bank of `bank` mode before its write: (a `MemoryBank`, the
    `BankEncoder` with its seconds). Rows keep the tower's whole output
    (2048 columns for DINO.txt, sliced at load), Talk2DINO-projected when
    `--talk2dino` is given (the reference's use_talk2dino banks)."""
    from patchioner_tpu_torch.io import memory_bank as mb

    captions = mb.load_caption_corpus(args.data, args.size, sample=not args.no_sample,
                                      seed=args.seed)
    encoder = BankEncoder(_build_space(args, device), talk2dino_projection(args.talk2dino,
                                                                            device))
    return mb.build_bank(captions, encoder, batch_size=args.bs), encoder


def build_memory_bank(args, device) -> str:
    """`bank` mode: the bank written to `--out`, or under `--bank-dir` by the
    reference's filename scheme; the path written."""
    from patchioner_tpu_torch.io import memory_bank as mb

    bank, _ = make_bank(args, device)
    if args.out:
        out = args.out
        dataset = mb.PROJECTION_DATASETS.get(args.projection_type, args.projection_type)
    else:
        filename, dataset = mb.bank_filename(
            args.projection_type, support_memory_size=args.size,
            use_talk2dino=bool(args.talk2dino), use_open_clip=args.text_encoder == "open_clip")
        out = os.path.join(args.bank_dir, filename)
    mb.save_bank(out, dataset, bank)
    print(f"wrote bank {bank.embeddings.shape} [{args.text_encoder}] -> {out}")
    return out


def _load_config(path: str):
    """A model config file: JSON read here, anything else left to
    `Patchioner.from_config` (YAML, which needs PyYAML)."""
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    return path


IMAGE_SELECTIONS = ("cls", "avg_self_attn", "avg_patch")


def select_features(enc: dict, select: str) -> torch.Tensor:
    """One (B, D) feature an image from `Patchioner.encode_images`' outputs:
    the CLS token, the patch tokens weighted by the CLS->patch attention
    and averaged, or the patch tokens averaged."""
    if select == "cls":
        return enc["x_norm_clstoken"]
    if select == "avg_self_attn":
        return (enc["self_attn"][..., None] * enc["x_norm_patchtokens"]).mean(dim=1)
    if select == "avg_patch":
        return enc["x_norm_patchtokens"].mean(dim=1)
    raise ValueError(f"select {select!r} is not one of {IMAGE_SELECTIONS}")


@torch.no_grad()
def extract_image_features(args, device) -> np.ndarray:
    from PIL import Image

    from patchioner_tpu_torch.models.patchioner import Patchioner
    from patchioner_tpu_torch.utils import transforms

    model = Patchioner.from_config(_load_config(args.config),
                                   allow_missing_weights=args.allow_random, device=device)
    paths = sorted(os.path.join(args.images, f) for f in os.listdir(args.images)
                   if f.lower().endswith((".jpg", ".jpeg", ".png")))
    out, names = [], []
    for i in range(0, len(paths), args.bs):
        # uint8 to the device, normalised there
        batch = np.stack([transforms.preprocess_pil_uint8(Image.open(p), model.resize_dim,
                                                          model.crop_dim)
                          for p in paths[i:i + args.bs]])
        feats = select_features(model.encode_images(batch), args.select)
        out.append(feats.float().cpu().numpy())
        names.extend(os.path.basename(p) for p in paths[i:i + args.bs])
    feats = np.concatenate(out).astype(np.float32)
    np.save(args.out, feats)
    with open(args.out + ".names.json", "w") as f:
        json.dump(names, f)
    print(f"wrote {feats.shape} -> {args.out}")
    return feats


def _text_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--text-encoder", default="clip", dest="text_encoder",
                   choices=list(text_spaces.TEXT_SPACE_NAMES))
    p.add_argument("--text-weights", default=None, dest="text_weights")
    p.add_argument("--denseclip-config", default="denseclip_segmentation_vitb16",
                   dest="denseclip_config")
    p.add_argument("--talk2dino", default=None)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="mode", required=True)
    t = sub.add_parser("text")
    t.add_argument("--data", required=True)
    t.add_argument("--out", required=True)
    _text_flags(t)
    t.add_argument("--clip-weights", default=None, help="legacy alias for --text-weights")
    t.add_argument("--bs", type=int, default=256)
    t.add_argument("--allow-random", action="store_true")
    k = sub.add_parser("bank", help="build an HDF5 support-memory bank")
    k.add_argument("--data", required=True, help="COCO-format annotation json (caption corpus)")
    k.add_argument("--size", type=int, default=500000)
    k.add_argument("--projection-type", default="coco", dest="projection_type")
    k.add_argument("--out", default=None,
                   help="explicit output path (default: reference filename scheme under "
                        "--bank-dir)")
    k.add_argument("--bank-dir", default=".", dest="bank_dir")
    _text_flags(k)
    k.add_argument("--no-sample", action="store_true", dest="no_sample",
                   help="head slice instead of random.sample (VG corpora)")
    k.add_argument("--seed", type=int, default=None)
    k.add_argument("--bs", type=int, default=1000)
    k.add_argument("--allow-random", action="store_true")
    i = sub.add_parser("image")
    i.add_argument("--config", required=True)
    i.add_argument("--images", required=True)
    i.add_argument("--out", required=True)
    i.add_argument("--select", default="cls", choices=list(IMAGE_SELECTIONS))
    i.add_argument("--bs", type=int, default=16)
    i.add_argument("--allow-random", action="store_true")
    for sp in (t, k, i):
        sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    device = entry.resolve_device(args.device)
    if args.mode == "text":
        return extract_text_features(args, device)
    if args.mode == "bank":
        return build_memory_bank(args, device)
    return extract_image_features(args, device)


if __name__ == "__main__":
    main()
