"""Prefix-mapper training CLI: the ViECap and ClipCap training mains.

Twin of `patchioner_tpu/train/prefix_cli.py` (reference
src/viecap/training/main.py, the MappingNetwork trained on text-only
features with noise, GPT-2 frozen; src/clipcap/clipcapTraining.py, the MLP
prefix mapper over pre-extracted features, `only_prefix`):

  python -m patchioner_tpu_torch.train.prefix_cli --model viecap \
      --data captions.json --features feats.npy --out_dir ./viecap_ckpt \
      --epochs 5 [--noise 0.016] [--num_layers 8] [--resume] [--device cpu]

  python -m patchioner_tpu_torch.train.prefix_cli --model clipcap \
      --data captions.json --features image_feats.npy --prefix_length 10 \
      --out_dir ./clipcap_ckpt

Checkpoints are the port's train states (mapper, optimizer, step) with
`--resume`. The trained mapper serves through `Patchioner.from_config`
with the config block's `weight_path` pointed at `--out_dir` (the
reference's torch.save -> torch.load cycle, viecap/training/main.py:100-105
-> viecap/entrypoint.py:82-96). Runs on the card unless `--device cpu`.
Without `--features`, `--allow_random` trains on the captions' own
features from a seeded CLIP text tower (ViECap trains text-only,
viecap/training/main.py:43-48). Not ported yet: `--dp` above 1.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from patchioner_tpu_torch import entry
from patchioner_tpu_torch.io.checkpoints import CheckpointManager, restore_into
from patchioner_tpu_torch.train.cli import MESH_MISSING, epoch_means


def build_argparser():
    p = argparse.ArgumentParser()
    p.add_argument("--model", choices=["viecap", "clipcap"], required=True)
    p.add_argument("--data", required=True, help="COCO-format caption json")
    p.add_argument("--features", default=None,
                   help=".npy aligned with the corpus (image features for clipcap, the "
                        "captions' CLIP text features for viecap)")
    p.add_argument("--out_dir", default="./prefix_ckpt")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--bs", type=int, default=80)  # viecap main.py default
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--warmup_steps", type=int, default=5000)
    p.add_argument("--noise", type=float, default=None,
                   help="feature noise variance (viecap main.py:122); defaults to 0.016 "
                        "for viecap, 0.0 for clipcap")
    p.add_argument("--normalize_prefix", action="store_true",
                   help="L2-normalize features once before training "
                        "(clipcapTraining.py:44,350)")
    p.add_argument("--max_seq_len", type=int, default=40)
    p.add_argument("--loss_chunk", type=int, default=0)
    # mapper geometry
    p.add_argument("--num_layers", type=int, default=8, help="viecap MappingNetwork depth")
    p.add_argument("--prefix_length", type=int, default=10, help="clipcap soft-prefix length")
    # frozen language model (seeded random init under --allow_random)
    p.add_argument("--gpt2_weights", default=None,
                   help="local torch GPT-2 lm-head state dict")
    p.add_argument("--n_layer", type=int, default=12)
    p.add_argument("--n_head", type=int, default=12)
    p.add_argument("--n_embd", type=int, default=768)
    p.add_argument("--vocab_size", type=int, default=50257)
    p.add_argument("--dp", type=int, default=None, help="data-parallel size (1 only)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_every", type=int, default=1)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--limit_steps", type=int, default=0)
    p.add_argument("--allow_random", action="store_true",
                   help="permit a seeded random GPT-2 and the fallback tokenizer")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def _tokenize(captions, tokenizer, max_len):
    """GPT-2 ids 0-padded to (N, max_len) and a real-token mask, as the
    reference's dataset pads and masks."""
    toks = np.zeros((len(captions), max_len), np.int32)
    mask = np.zeros((len(captions), max_len), np.float32)
    for i, c in enumerate(captions):
        ids = tokenizer.encode(c)[:max_len]
        toks[i, : len(ids)] = ids
        mask[i, : len(ids)] = 1.0
    return toks, mask


@torch.no_grad()
def _text_features(captions: list, seed: int, device) -> np.ndarray:
    """The captions' own features in the `clip` space, a tower drawn from
    `seed`, 512 captions at a time."""
    from patchioner_tpu_torch.train import text_spaces

    space = text_spaces.build_text_space("clip", None, seed=seed, device=device)
    return space.encode_texts(captions, batch_size=512)


def main(argv=None):
    from patchioner_tpu_torch.io import torch_port
    from patchioner_tpu_torch.models import clipcap as clipcap_mod
    from patchioner_tpu_torch.models import gpt2 as gpt2_mod
    from patchioner_tpu_torch.models import patchioner as patchioner_mod
    from patchioner_tpu_torch.models import viecap as viecap_mod
    from patchioner_tpu_torch.models.vit import cast_params
    from patchioner_tpu_torch.train import data as data_mod
    from patchioner_tpu_torch.train import decoder_train, prefix_train

    args = build_argparser().parse_args(argv)
    if (args.dp or 1) > 1:
        raise NotImplementedError(f"--dp {args.dp}: {MESH_MISSING}")
    device = entry.resolve_device(args.device)
    captions, _ = data_mod.load_coco_captions(args.data)
    n = len(captions)

    gcfg = gpt2_mod.GPT2Config(vocab_size=args.vocab_size, n_layer=args.n_layer,
                               n_head=args.n_head, n_embd=args.n_embd)
    if args.gpt2_weights and not os.path.exists(args.gpt2_weights):
        # --allow_random must not absorb a mistyped weights path
        raise FileNotFoundError(f"--gpt2_weights {args.gpt2_weights!r} not found")
    if args.gpt2_weights:
        gpt2_params = torch_port.port_hf_gpt2_lmhead(
            torch.load(args.gpt2_weights, map_location="cpu", weights_only=True), gcfg.n_layer)
        gpt2_params = cast_params(gpt2_params, torch.float32, device)
    elif args.allow_random:
        gpt2_params = gpt2_mod.init_gpt2(
            gcfg, torch.Generator(device=device).manual_seed(args.seed + 1), device)
    else:
        raise SystemExit("no --gpt2_weights; pass --allow_random for a seeded frozen LM")

    tokenizer = patchioner_mod._get_gpt2_tokenizer(allow_fallback=args.allow_random)
    tokens, mask = _tokenize(captions, tokenizer, args.max_seq_len)
    if args.features:
        features = np.load(args.features).astype(np.float32)
        if len(features) != n:
            raise ValueError(f"--features holds {len(features)} rows for {n} captions")
    elif args.allow_random:
        features = _text_features(captions, args.seed + 7, device)
    else:
        raise SystemExit("--features required (or --allow_random for a seeded CLIP text "
                         "tower)")
    if args.noise is None:
        args.noise = 0.016 if args.model == "viecap" else 0.0
    if args.normalize_prefix:
        features = features / np.maximum(
            np.linalg.norm(features, axis=-1, keepdims=True), 1e-12)
    feat_dim = int(features.shape[1])

    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.model == "viecap":
        vcfg = viecap_mod.ViecapConfig(clip_hidden_size=feat_dim, num_layers=args.num_layers)
        mapper = viecap_mod.init_mapping_network(vcfg, gcfg.n_embd, gen, device)

        def mapper_fn(p, f):
            return viecap_mod.mapping_network_forward(p, f, vcfg, gcfg.n_embd)

        meta = {"model": "viecap", "clip_hidden_size": feat_dim,
                "num_layers": args.num_layers, "n_embd": gcfg.n_embd}
    else:
        mapper = clipcap_mod.init_mlp_mapper(feat_dim, args.prefix_length, gcfg.n_embd,
                                             gen, device)

        def mapper_fn(p, f):
            return clipcap_mod.mlp_mapper_forward(p, f, args.prefix_length, gcfg.n_embd)

        meta = {"model": "clipcap", "prefix_size": feat_dim,
                "prefix_length": args.prefix_length, "n_embd": gcfg.n_embd}

    total_steps = max(1, args.epochs * (n // max(args.bs, 1)))
    # short runs clamp the reference's 5000-step warmup so that the decay
    # keeps a positive length
    warmup = min(args.warmup_steps, max(1, total_steps // 10))
    tcfg = prefix_train.PrefixTrainConfig(
        lr=args.lr, warmup_steps=warmup, total_steps=total_steps,
        noise_variance=args.noise, loss_chunk=args.loss_chunk)
    # the reference's transformers.AdamW (weight decay 0.0) with
    # get_linear_schedule_with_warmup (viecap/training/main.py:51-54,
    # clipcapTraining.py:300-303)
    tx = decoder_train.AdamW(
        decoder_train.linear_warmup_decay(tcfg.lr, warmup, tcfg.total_steps),
        tcfg.weight_decay)
    step_fn = prefix_train.make_prefix_train_step(mapper_fn, gcfg, tcfg)
    opt_state = tx.init(mapper)

    ckpt = CheckpointManager(args.out_dir)
    step = 0
    if args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore()
        restore_into(mapper, state["params"])
        opt_state.load_state_dict(state["opt_state"])
        step = int(state["step"])
        print(f"resumed from step {step}")

    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "mapper_meta.json"), "w") as f:
        json.dump(meta, f)
    # the corpus on the device once when it fits beside the training set:
    # each step gathers its batch by index there
    stage_on_device = features.nbytes + tokens.nbytes + mask.nbytes <= 1_000_000_000
    if stage_on_device:
        features, tokens, mask = (torch.from_numpy(a).to(device)
                                  for a in (features, tokens.astype(np.int64), mask))
    if n < args.bs:
        # batch_iterator drops the remainder: no full batch would ever run
        raise SystemExit(f"corpus ({n} captions) is smaller than --bs {args.bs}: no full "
                         "batch would ever run; lower --bs")
    generator = torch.Generator(device=device).manual_seed(args.seed + 2)
    log_path = os.path.join(args.out_dir, "train_log.csv")
    done = False

    def save():
        ckpt.save(step, {"params": mapper, "opt_state": opt_state, "step": step})

    # resume continues from the restored step's epoch, rounded down
    steps_per_epoch = max(1, n // max(args.bs, 1))
    start_epoch = min(args.epochs, step // steps_per_epoch)
    if start_epoch:
        print(f"resuming at epoch {start_epoch}/{args.epochs}")
    for epoch in range(start_epoch, args.epochs):
        losses, accs = [], []
        t0 = time.time()
        for idx in data_mod.batch_iterator(n, args.bs, seed=args.seed + epoch):
            if stage_on_device:
                i = torch.from_numpy(idx).to(device)
                batch = features[i], tokens[i], mask[i]
            else:
                batch = (torch.from_numpy(features[idx]).to(device),
                         torch.from_numpy(tokens[idx].astype(np.int64)).to(device),
                         torch.from_numpy(mask[idx]).to(device))
            mapper, opt_state, m = step_fn(mapper, opt_state, gpt2_params, *batch, generator)
            losses.append(m["loss"])
            accs.append(m["acc"])
            step += 1
            if args.limit_steps and step >= args.limit_steps:
                done = True
                break
        loss, acc = epoch_means(losses, accs)
        line = f"{epoch},{step},{loss:.5f},{acc:.5f},{time.time() - t0:.1f}"
        print("epoch,step,loss,acc,seconds ->", line)
        with open(log_path, "a") as f:
            f.write(line + "\n")
        if (epoch + 1) % args.save_every == 0 or done:
            save()
        if done:
            break
    save()
    print(f"done at step {step}; checkpoints in {args.out_dir}")


if __name__ == "__main__":
    main()
