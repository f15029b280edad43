"""Decoder training CLI: the `decoderTraining.py` loop on one CUDA card.

Twin of `patchioner_tpu/train/cli.py` (reference
src/decap/decoderTraining.py:410-440 for the flags, :62-387 for the loop),
with the same flags, loop, resume and `train_log.csv`. Checkpoints are the
port's train states (`io.checkpoints.CheckpointManager`); `decap_weights:
<out_dir>` in a model config serves the trained decoder through
`Patchioner.from_config`.

Usage:
  python -m patchioner_tpu_torch.train.cli --data captions.json \
      --features feats.npy --out_dir ./ckpt --epochs 10 --bs 64 \
      [--gaussian_noise 0.016] [--im_proj --bank bank.h5] [--device cpu]

Runs on the card unless `--device cpu`. Not ported yet, and refused with
NotImplementedError: encoding captions with a frozen text tower
(`--encode_on_the_fly`, `--text_encoder` other than clip,
`--talk2dino_weights`), which waits for the CLIP text towers; and the
device mesh (`--dp` or `--mp` above 1), which waits for multi-device
support.
"""

from __future__ import annotations

import argparse
import os
import random
import sys
import time

import numpy as np
import torch

from patchioner_tpu_torch import entry
from patchioner_tpu_torch.io.checkpoints import CheckpointManager, restore_into
from patchioner_tpu_torch.models import gpt2 as gpt2_mod
from patchioner_tpu_torch.models.decap import init_decap
from patchioner_tpu_torch.ops import memory_projection as memproj
from patchioner_tpu_torch.train import data as data_mod
from patchioner_tpu_torch.train import decoder_train, packing

TOWERS_MISSING = ("the port has no frozen text tower yet (the CLIP text towers, "
                  "ROADMAP queue 1 item 11): pass pre-extracted --features")
MESH_MISSING = "the port trains on one device (the mesh is ROADMAP queue 1 item 13)"


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the DeCap/CapDec decoder")
    p.add_argument("--data", required=True,
                   help="caption corpus (COCO json or json list of strings)")
    p.add_argument("--features", default=None,
                   help="pre-extracted text features .npy aligned with --data")
    p.add_argument("--encode_on_the_fly", action="store_true",
                   help="encode captions with a frozen text tower (not ported yet)")
    p.add_argument("--text_encoder", default="clip",
                   help="text-embedding space of --encode_on_the_fly (not ported yet)")
    p.add_argument("--text_weights", default=None)
    p.add_argument("--denseclip_config", default="denseclip_segmentation_vitb16")
    p.add_argument("--clip_text_weights", default=None)
    p.add_argument("--talk2dino_weights", default=None,
                   help="Talk2DINO projection of the encoded captions (not ported yet)")
    p.add_argument("--out_dir", default="./decap_ckpt")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--bs", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--warmup", type=int, default=1000,
                   help="reference train_decoder default (decoderTraining.py:63)")
    p.add_argument("--weight_decay", type=float, default=0.01,
                   help="torch AdamW default, what the reference runs "
                        "(decoderTraining.py:255)")
    p.add_argument("--prefix_size", type=int, default=768)
    p.add_argument("--max_seq_len", type=int, default=20,
                   help="reference max_seq_len (dataset.py:45); captions are raw-sliced "
                        "like pad_tokens, no EOT re-insert")
    p.add_argument("--gaussian_noise", type=float, default=0.0, help="CapDec noise")
    p.add_argument("--im_proj", action="store_true",
                   help="project features through the support memory (kernel D)")
    p.add_argument("--bank", default=None, help="memory bank .h5 for --im_proj")
    p.add_argument("--mix_captions", action="store_true",
                   help="pair tokens with a different same-image caption's features")
    p.add_argument("--dp", type=int, default=None, help="data-parallel size (1 only)")
    p.add_argument("--mp", type=int, default=1, help="bank tensor-parallel size (1 only)")
    p.add_argument("--save_every", type=int, default=1)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--limit_steps", type=int, default=None)
    p.add_argument("--loss_chunk", type=int, default=0,
                   help="compute the lm-head CE this many sequence positions at a time "
                        "(0 = unchunked), so the (B, T, V) logits are never live")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="split each --bs batch into this many micro-batches, one "
                        "big-batch update; --bs must be divisible by it")
    p.add_argument("--pack_len", type=int, default=0,
                   help="pack captions into rows of this many positions with "
                        "segment-local attention (0 = off); --bs counts packed rows")
    # decoder architecture (defaults = the DeCap decoder_config.pkl values)
    p.add_argument("--n_layer", type=int, default=4)
    p.add_argument("--n_head", type=int, default=4)
    p.add_argument("--n_embd", type=int, default=768)
    p.add_argument("--vocab_size", type=int, default=50257)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def refuse_unported(args) -> None:
    """NotImplementedError for the JAX CLI's flags the port lacks."""
    if (args.encode_on_the_fly or args.text_encoder != "clip"
            or args.talk2dino_weights):
        raise NotImplementedError(
            f"--encode_on_the_fly / --text_encoder / --talk2dino_weights: {TOWERS_MISSING}")
    if (args.dp or 1) > 1 or args.mp > 1:
        raise NotImplementedError(f"--dp {args.dp} --mp {args.mp}: {MESH_MISSING}")


def microbatch(a, grad_accum: int):
    """A (B, ...) batch as (grad_accum, B / grad_accum, ...) for the
    accumulating step (TrainConfig.grad_accum)."""
    if grad_accum <= 1:
        return a
    return a.reshape((grad_accum, a.shape[0] // grad_accum) + tuple(a.shape[1:]))


def epoch_means(losses: list, accs: list) -> tuple[float, float]:
    """The epoch's mean loss and accuracy over its steps (0 for none), in
    f32 as numpy averages the JAX CLI's metrics; one copy to the host."""
    if not losses:
        return 0.0, 0.0
    both = torch.stack([torch.stack(losses), torch.stack(accs)]).cpu().numpy()
    return float(np.mean(both[0])), float(np.mean(both[1]))


def main(argv=None):
    args = build_argparser().parse_args(argv)
    refuse_unported(args)
    device = entry.resolve_device(args.device)

    captions, image_ids = data_mod.load_coco_captions(args.data)
    ds = data_mod.CaptionDataset(captions, image_ids, max_len=args.max_seq_len)
    n = len(ds)
    if not args.features:
        raise SystemExit(f"--features required: {TOWERS_MISSING}")
    features = np.load(args.features).astype(np.float32)
    if len(features) != n:
        raise ValueError(f"--features holds {len(features)} rows for {n} captions")
    if features.shape[1] != args.prefix_size:
        # the reference derives prefix_size from the feature space
        # (decoderTraining.py:84-105)
        print(f"Updating prefix_size from {args.prefix_size} to "
              f"{features.shape[1]} (loaded features)")
        args.prefix_size = int(features.shape[1])

    gcfg = gpt2_mod.GPT2Config(vocab_size=args.vocab_size, n_layer=args.n_layer,
                               n_head=args.n_head, n_embd=args.n_embd)
    params = init_decap(gcfg, args.prefix_size,
                        torch.Generator(device=device).manual_seed(args.seed), device)

    if args.grad_accum > 1 and args.bs % args.grad_accum:
        raise SystemExit(f"--bs {args.bs} not divisible by --grad_accum {args.grad_accum}")
    if args.pack_len:
        # the schedule's length and the static segment budget come from an
        # actual epoch-0 pack: a packed step takes --bs rows of several
        # captions each
        pack0 = packing.pack_captions(ds.tokens, args.pack_len)
        max_segments = pack0.seg_feature_idx.shape[1]
        steps_per_epoch = pack0.targets.shape[0] // args.bs
        if steps_per_epoch == 0:
            raise SystemExit(
                f"--bs {args.bs} rows exceeds the packed corpus ({pack0.targets.shape[0]} "
                f"rows at --pack_len {args.pack_len}); lower --bs")
    else:
        steps_per_epoch = n // args.bs
    tcfg = decoder_train.TrainConfig(
        lr=args.lr, warmup_steps=args.warmup, weight_decay=args.weight_decay,
        total_steps=args.epochs * max(steps_per_epoch, 1),
        gaussian_noise=args.gaussian_noise, loss_chunk=args.loss_chunk,
        grad_accum=args.grad_accum,
    )
    opt_state = decoder_train.make_optimizer(tcfg).init(params)

    bank = None
    if args.im_proj:
        if not args.bank:
            raise SystemExit("--im_proj requires --bank")
        from patchioner_tpu_torch.io import memory_bank as mb

        loaded = mb.load_bank(args.bank)
        if loaded is None:
            raise SystemExit(f"--bank {args.bank}: no such file")
        # the f32 rows, as the JAX step reads them: kernel D's SIMT body
        bank = memproj.prepare_bank(torch.as_tensor(loaded.embeddings, dtype=torch.float32,
                                                    device=device))
    if args.pack_len:
        step_fn = decoder_train.make_packed_train_step(gcfg, tcfg)
    else:
        step_fn = decoder_train.make_train_step(gcfg, tcfg)

    ckpt = CheckpointManager(args.out_dir)
    step = 0
    if args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore()
        restore_into(params, state["params"])
        opt_state.load_state_dict(state["opt_state"])
        step = int(state["step"])
        print(f"resumed from step {step}")

    rng = random.Random(args.seed)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    log_path = os.path.join(args.out_dir, "train_log.csv")
    os.makedirs(args.out_dir, exist_ok=True)

    def save():
        ckpt.save(step, {"params": params, "opt_state": opt_state, "step": step})

    # the corpus on the device once: the packed step gathers its segments'
    # features from all of them; the unpacked one gathers each batch by
    # index there, unless the corpus is above 1 GB (then host slices)
    stage_on_device = (not args.pack_len) and (
        features.nbytes + ds.tokens.nbytes <= 1_000_000_000)
    if args.pack_len or stage_on_device:
        feats_all = torch.from_numpy(features).to(device)
    if stage_on_device:
        toks_all = torch.from_numpy(ds.tokens.astype(np.int64)).to(device)

    # resume continues from the restored step's epoch (rounded down), with
    # the mix-index stream realigned to an uninterrupted run's
    start_epoch = min(args.epochs, step // max(steps_per_epoch, 1))
    if start_epoch:
        print(f"resuming at epoch {start_epoch}/{args.epochs}")
        for _ in range(start_epoch):
            if args.mix_captions:
                ds.mix_indices(rng)
    ga = args.grad_accum
    for epoch in range(start_epoch, args.epochs):
        mix = ds.mix_indices(rng) if args.mix_captions else None
        losses, accs = [], []
        t0 = time.time()
        if args.pack_len:
            order = np.random.default_rng(args.seed + epoch).permutation(n)
            pack = packing.pack_captions(ds.tokens, args.pack_len, feature_indices=mix,
                                         order=order, max_segments=max_segments)
            nrows = pack.targets.shape[0]
            for start in range(0, nrows - args.bs + 1, args.bs):
                batch = decoder_train.pack_to_device(packing.PackedBatch(
                    *(microbatch(a[start:start + args.bs], ga) for a in pack)), device)
                params, opt_state, metrics = step_fn(params, opt_state, feats_all, batch,
                                                     generator, bank)
                losses.append(metrics["loss"])
                accs.append(metrics["acc"])
                step += 1
                if args.limit_steps and step >= args.limit_steps:
                    break
            if not losses:
                print(f"WARNING: epoch {epoch} ran 0 packed steps ({nrows} rows < --bs "
                      f"{args.bs}); nothing trained", file=sys.stderr)
        else:
            for idx in data_mod.batch_iterator(n, args.bs, seed=args.seed + epoch):
                feat_idx = mix[idx] if mix is not None else idx
                if stage_on_device:
                    bf = feats_all[torch.from_numpy(feat_idx).to(device)]
                    bt = toks_all[torch.from_numpy(idx).to(device)]
                else:
                    bf = torch.from_numpy(features[feat_idx]).to(device)
                    bt = torch.from_numpy(ds.tokens[idx].astype(np.int64)).to(device)
                params, opt_state, metrics = step_fn(params, opt_state, microbatch(bf, ga),
                                                     microbatch(bt, ga), generator, bank)
                losses.append(metrics["loss"])
                accs.append(metrics["acc"])
                step += 1
                if args.limit_steps and step >= args.limit_steps:
                    break
        epoch_loss, epoch_acc = epoch_means(losses, accs)
        line = f"{epoch},{step},{epoch_loss:.5f},{epoch_acc:.5f},{time.time() - t0:.1f}"
        if args.pack_len:
            print(f"epoch,step,loss,acc,seconds -> {line} (packed: {nrows} rows, "
                  f"{packing.packing_efficiency(pack):.0%} slot use)")
        else:
            print(f"epoch,step,loss,acc,seconds -> {line}")
        with open(log_path, "a") as f:
            f.write(line + "\n")
        if (epoch + 1) % args.save_every == 0:
            save()
        if args.limit_steps and step >= args.limit_steps:
            break
    save()
    print(f"done at step {step}; checkpoints in {args.out_dir}")


if __name__ == "__main__":
    main()
