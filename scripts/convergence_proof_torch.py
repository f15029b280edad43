"""Convergence proof of the PyTorch port: it learns to caption, end to end.

Twin of `scripts/convergence_proof.py` for `patchioner_tpu_torch`: without
pretrained weights, on the synthetic closed-vocabulary world
(`train/synthetic.py`),

  1. ALIGN   a DINOv2-architecture ViT and a CLIP text tower trained
             contrastively on rendered (image, caption) pairs
             (`train/align.py`); on the card the ViT's forward runs
             kernels A, B and C and their backwards;
  2. BANK    a support memory of the train captions' text embeddings
             (`io/memory_bank.build_bank`);
  3. TRAIN   DeCap trained text-only through `train/cli.py` on those
             embeddings;
  4. PROVE   (a) held-out caption reconstruction by greedy decoding;
             (a') the ViECap mapper trained through `train/prefix_cli.py`
             on a frozen seeded GPT-2 (loss-level only);
             (b) the trace-captioning evaluator and scorers
             (`eval/trace_captioning.evaluate` + `compute_scores`) over
             on-disk JPEGs and traces, against a shuffled-caption control,
             and on images of the held-out captions.

The model is built by `Patchioner.from_config` from the files the proof
wrote (the aligned ViT's `.npz` and the training directory); neither may
be drawn at random. Where h5py imports, the bank goes through `bank.h5`
as well; without it (the card's machine) the built bank is handed to the
model. Left out: the JAX script's trained grid-rehearsal slice, which
drives JAX code.

Scales (copied from the JAX script): `tiny` and `test` have a 128-wide,
4-head ViT (head dim 32), which kernel B refuses: run them with
`--device cpu`. `full` is ViT-S (D = 384, 12 layers, 6 heads of 64) at
56 px, a 256-wide 4-layer text tower and the 4L/4H/768 DeCap.

Usage: python -m scripts.convergence_proof_torch --scale full --out DIR
       python -m scripts.convergence_proof_torch --scale test --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ProofScale:
    name: str
    colors: tuple
    shapes: tuple
    positions: tuple
    held_out: int
    # alignment
    vit_geometry: dict  # dino_geometry config-key payload
    text_width: int
    text_depth: int
    text_heads: int
    align_steps: int
    align_batch: int
    # decoder
    decap_arch: dict | None  # None = the real reference 4L/4H/768 DeCap
    decoder_repeats: int
    decoder_epochs: int
    decoder_bs: int
    decoder_lr: float
    decoder_warmup: int
    # eval
    eval_samples_per_combo: int
    eval_batch: int
    # ViECap mapper (train/prefix_cli.py); lm_arch None = the reference's
    # 12L/768 frozen GPT-2 geometry
    mapper_epochs: int = 8
    mapper_lr: float = 5e-4
    lm_arch: dict | None = None


TINY = ProofScale(
    name="tiny",
    colors=("red", "green", "blue", "yellow", "purple", "orange"),
    shapes=("square", "circle", "triangle", "cross"),
    positions=("top left", "top right", "bottom left", "bottom right"),
    held_out=8,
    vit_geometry=dict(embed_dim=128, depth=2, num_heads=4, num_registers=0,
                      pos_grid=4, extract_heads=4),
    text_width=128, text_depth=2, text_heads=4,
    align_steps=300, align_batch=48,
    decap_arch=dict(n_layer=2, n_head=2, n_embd=128, vocab_size=49408),
    decoder_repeats=8, decoder_epochs=16, decoder_bs=32,
    decoder_lr=1e-3, decoder_warmup=50,
    eval_samples_per_combo=1, eval_batch=16,
    mapper_epochs=4, mapper_lr=5e-4,
    lm_arch=dict(n_layer=2, n_head=2, n_embd=128),
)

TEST = ProofScale(
    name="test",
    colors=("red", "green", "blue", "yellow"),
    shapes=("square", "circle", "cross"),
    positions=("top left", "top right", "bottom left", "bottom right"),
    held_out=6,
    vit_geometry=dict(embed_dim=128, depth=2, num_heads=4, num_registers=0,
                      pos_grid=4, extract_heads=4),
    text_width=128, text_depth=2, text_heads=4,
    align_steps=250, align_batch=42,
    decap_arch=dict(n_layer=2, n_head=2, n_embd=128, vocab_size=49408),
    decoder_repeats=6, decoder_epochs=15, decoder_bs=16,
    decoder_lr=1e-3, decoder_warmup=30,
    eval_samples_per_combo=1, eval_batch=16,
    mapper_epochs=4, mapper_lr=5e-4,
    lm_arch=dict(n_layer=2, n_head=2, n_embd=128),
)

FULL = ProofScale(
    name="full",
    colors=tuple(),  # empty = all (train/synthetic.py vocab)
    shapes=tuple(),
    positions=tuple(),
    held_out=16,
    # ViT-S geometry, pos-embed stored at the native 4x4 grid (a
    # from-scratch tower has no 518px-pretrained grid to interpolate from)
    vit_geometry=dict(pos_grid=4),
    text_width=256, text_depth=4, text_heads=4,
    align_steps=800, align_batch=64,
    decap_arch=None,  # the real 4L/4H/768 DeCap (from_config default)
    decoder_repeats=16, decoder_epochs=12, decoder_bs=64,
    decoder_lr=1e-3, decoder_warmup=100,
    eval_samples_per_combo=2, eval_batch=32,
)

SCALES = {"tiny": TINY, "test": TEST, "full": FULL}

IMG_SIZE = 56  # 4x4 grid of 14px patches — quadrants are 2x2 patches


def _token_accuracy(pred_tokens, gt_tokens) -> float:
    """Mean per-position match over the GT's real (pre-EOT) tokens."""
    from patchioner_tpu_torch.text import clip_bpe

    total = hits = 0
    for p, g in zip(pred_tokens, gt_tokens):
        g = list(g)
        if clip_bpe.EOT_TOKEN in g:
            g = g[: g.index(clip_bpe.EOT_TOKEN)]
        for i, t in enumerate(g):
            total += 1
            if i < len(p) and int(p[i]) == int(t):
                hits += 1
    return hits / max(total, 1)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


class _Stages:
    """Seconds of each stage (the card synchronised at its end) and, on
    the card, its peak allocated memory."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: dict = {}
        self.peak_gib: dict = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        yield
        if cuda:
            torch.cuda.synchronize(self.device)
            self.peak_gib[name] = torch.cuda.max_memory_allocated(self.device) / 2**30
        self.seconds[name] = time.perf_counter() - t0


def _read_log(path: str) -> list:
    with open(path) as f:
        return [ln.strip().split(",") for ln in f if ln.strip()]


def _attach_bank(model, bank, device) -> None:
    """The built bank as the model's support memory, f32 rows on `device`
    (`Patchioner._build_bank` prepares a file's rows the same way)."""
    from patchioner_tpu_torch.ops import memory_projection as mp

    model.bank = mp.prepare_bank(torch.from_numpy(bank.embeddings).to(device))
    model.bank_texts = list(bank.texts)
    model.config["support_memory_size"] = len(bank)


def run_proof(out_dir: str, scale: ProofScale, *, seed: int = 0, device="cuda",
              verbose: bool = True) -> dict:
    from patchioner_tpu_torch import entry
    from patchioner_tpu_torch.eval import harness, trace_captioning
    from patchioner_tpu_torch.io import checkpoints, memory_bank as mb
    from patchioner_tpu_torch.models import clip as clip_mod
    from patchioner_tpu_torch.models import decap as decap_mod
    from patchioner_tpu_torch.models import vit as vit_mod
    from patchioner_tpu_torch.models.patchioner import Patchioner
    from patchioner_tpu_torch.text import clip_bpe
    from patchioner_tpu_torch.train import align, prefix_cli, synthetic
    from patchioner_tpu_torch.train import cli as train_cli

    device = entry.resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    t_start = time.perf_counter()
    stage = _Stages(device)
    info: dict = {"scale": scale.name, "device": str(device)}
    if device.type == "cuda":
        info["card"] = card_line()
        info["torch"] = torch.__version__
        info["tf32"] = bool(torch.backends.cuda.matmul.allow_tf32)

    def log(msg):
        if verbose:
            print(msg, flush=True)

    # ---------------------------------------------------------- 1. world
    combos = synthetic.all_combos(
        scale.colors or None, scale.shapes or None, scale.positions or None)
    train_combos, held_combos = synthetic.split_combos(combos, scale.held_out, seed=seed)
    info.update(n_combos=len(combos), n_train=len(train_combos),
                n_held_out=len(held_combos))
    log(f"[world] {len(combos)} captions, {len(train_combos)} train / "
        f"{len(held_combos)} held out")

    # ---------------------------------------------------------- 2. align
    vit_cfg = vit_mod.config_for("dinov2_vits14", img_size=IMG_SIZE, **scale.vit_geometry)
    text_cfg = clip_mod.ClipTextConfig(
        context_length=16, width=scale.text_width, depth=scale.text_depth,
        heads=scale.text_heads, proj_dim=vit_cfg.embed_dim)
    acfg = align.AlignConfig(vit=vit_cfg, text=text_cfg, steps=scale.align_steps,
                             batch=scale.align_batch)
    with stage("align"):
        align_params, align_info = align.train_align(acfg, train_combos, seed=seed,
                                                     verbose=verbose, device=device)
    info["align_seconds"] = stage.seconds["align"]
    info["align_steps_per_s"] = align_info["steps_per_s"]
    info["align_final"] = align_info["final"]
    # retrieval gate: fresh renderings of the TRAIN combos must rank their
    # own caption first among all train captions
    info["align_retrieval_acc"] = align.retrieval_accuracy(
        align_params, acfg, train_combos, seed=seed + 99)
    log(f"[align] retrieval acc {info['align_retrieval_acc']:.3f} "
        f"({info['align_seconds']:.1f} s, {info['align_steps_per_s']:.2f} steps/s)")

    # -------------------------------------------- 3. text features + bank
    tok = clip_bpe.get_tokenizer()

    @torch.no_grad()
    def encode_texts(texts):
        toks = torch.from_numpy(tok.tokenize(list(texts), text_cfg.context_length)).to(device)
        return align.text_embed(align_params["text"], toks, text_cfg).cpu().numpy()

    train_captions = [c.caption for c in train_combos]
    held_captions = [c.caption for c in held_combos]
    with stage("bank"):
        bank = mb.build_bank(train_captions, encode_texts)
    bank_path = None
    try:
        import h5py  # noqa: F401  (save_bank's writer)
    except ImportError:
        log("[bank] no h5py here: the built bank is handed to the model")
    else:
        bank_path = os.path.join(out_dir, "bank.h5")
        mb.save_bank(bank_path, "online_texts", bank)
    info["bank_file"] = bank_path is not None

    # ------------------------------------------- 4. decoder (train/cli.py)
    corpus = train_captions * scale.decoder_repeats
    # the corpus is the caption list concatenated R times, so the features
    # tile the same way to stay row-aligned
    feats = np.tile(bank.embeddings, (scale.decoder_repeats, 1))
    corpus_path = os.path.join(out_dir, "captions.json")
    with open(corpus_path, "w") as f:
        json.dump(corpus, f)
    feats_path = os.path.join(out_dir, "features.npy")
    np.save(feats_path, feats.astype(np.float32))

    ckpt_dir = os.path.join(out_dir, "decap_ckpt")
    argv = [
        "--data", corpus_path, "--features", feats_path,
        "--out_dir", ckpt_dir,
        "--epochs", str(scale.decoder_epochs),
        "--bs", str(scale.decoder_bs),
        "--lr", str(scale.decoder_lr),
        "--warmup", str(scale.decoder_warmup),
        "--prefix_size", str(vit_cfg.embed_dim),
        "--gaussian_noise", "0.016",  # CapDec bridge noise
        "--save_every", "4",
        "--seed", str(seed),
    ]
    if scale.decap_arch is not None:
        da = scale.decap_arch
        argv += ["--n_layer", str(da["n_layer"]), "--n_head", str(da["n_head"]),
                 "--n_embd", str(da["n_embd"]), "--vocab_size", str(da["vocab_size"])]
    with stage("decoder"):
        train_cli.main(argv + ["--device", str(device)])
    info["decoder_seconds"] = stage.seconds["decoder"]
    rows = _read_log(os.path.join(ckpt_dir, "train_log.csv"))
    info["decoder_first_epoch"] = {"loss": float(rows[0][2]), "acc": float(rows[0][3])}
    info["decoder_last_epoch"] = {"loss": float(rows[-1][2]), "acc": float(rows[-1][3])}
    log(f"[decoder] loss {rows[0][2]} -> {rows[-1][2]}, teacher-forced acc "
        f"{rows[-1][3]} ({info['decoder_seconds']:.1f} s)")

    # ------------------------------------------------ 5. assemble the model
    vit_npz = os.path.join(out_dir, "vit_aligned.npz")
    checkpoints.save_params_npz(vit_npz, align_params["vit"])
    config = {
        "dino_model": "dinov2_vits14",
        "crop_dim": IMG_SIZE,
        "resize_dim": IMG_SIZE,
        "prefix_size": vit_cfg.embed_dim,
        "dino_geometry": dict(scale.vit_geometry),
        "dino_weights": vit_npz,
        "decap_weights": ckpt_dir,
        "support_memory_size": len(bank) if bank_path else 0,
        "projection_type": "online_texts",
        "normalize": True,
        "use_talk2dino_project": False,
    }
    if bank_path:
        config["memory_bank_path"] = bank_path
    if scale.decap_arch is not None:
        config["decap_arch"] = dict(scale.decap_arch)
    with open(os.path.join(out_dir, "model_config.json"), "w") as f:
        json.dump(config, f, indent=2)
    for path in (vit_npz, ckpt_dir):
        if not os.path.exists(path):
            raise FileNotFoundError(f"the proof wrote no {path}")
    with stage("model"):
        # no allow_missing_weights: a missing file raises, nothing is drawn
        model = Patchioner.from_config(config, rng_seed=seed, device=device)
        if not bank_path:
            _attach_bank(model, bank, device)
    loaded = model.vit_params["patch_embed"]["w"]
    if not torch.equal(loaded, align_params["vit"]["patch_embed"]["w"].detach().to(loaded)):
        raise AssertionError("the model's ViT is not the aligned one the proof wrote")
    info["load_seconds"] = dict(model.load_seconds)
    gcfg = model.gpt2_cfg

    # ------------------------- 6a. reconstruction (train + HELD-OUT text)
    def reconstruct(captions):
        emb = torch.from_numpy(encode_texts(captions)).to(device)
        tokens, _ = decap_mod.greedy_decode(model.decoder, emb, gcfg)
        toks = tokens.cpu().numpy()
        texts = [tok.decode_caption(row).strip(" .") for row in toks]
        # the decoder's first emitted token is SOT (training targets are
        # [SOT]...[EOT], train/data.CaptionDataset), so compare against the
        # full tokenized row including SOT
        gt_tokens = tok.tokenize(list(captions), 20)
        exact = float(np.mean([p == g for p, g in zip(texts, captions)]))
        return texts, exact, _token_accuracy(toks, gt_tokens)

    with stage("reconstruct"):
        train_texts, train_exact, train_tacc = reconstruct(train_captions)
        held_texts, held_exact, held_tacc = reconstruct(held_captions)
    info["reconstruction"] = {
        "train_exact_match": train_exact, "train_token_acc": train_tacc,
        "held_out_exact_match": held_exact, "held_out_token_acc": held_tacc,
        "held_out_examples": [{"gt": g, "pred": p}
                              for g, p in zip(held_captions[:8], held_texts[:8])],
    }
    log(f"[reconstruct] train exact {train_exact:.3f} token-acc {train_tacc:.3f} | "
        f"HELD-OUT exact {held_exact:.3f} token-acc {held_tacc:.3f}")

    # ----------------------- 6a'. ViECap mapper convergence (loss-level)
    # The reference trains the mapper against a frozen pretrained GPT-2;
    # here the frozen LM is seeded random, so only the loss can show that
    # the mapper learns to steer it toward the caption tokens.
    mapper_dir = os.path.join(out_dir, "viecap_mapper")
    margv = [
        "--model", "viecap", "--data", corpus_path,
        "--features", feats_path, "--out_dir", mapper_dir,
        "--epochs", str(scale.mapper_epochs),
        "--bs", str(scale.decoder_bs), "--lr", str(scale.mapper_lr),
        "--allow_random", "--seed", str(seed),
    ]
    if scale.lm_arch is not None:
        la = scale.lm_arch
        margv += ["--n_layer", str(la["n_layer"]), "--n_head", str(la["n_head"]),
                  "--n_embd", str(la["n_embd"]),
                  # CPU scale: a shallow mapping network and the corpus's
                  # caption lengths instead of the reference's 40-token pad
                  "--num_layers", "2", "--max_seq_len", "24"]
    with stage("mapper"):
        prefix_cli.main(margv + ["--device", str(device)])
    mrows = _read_log(os.path.join(mapper_dir, "train_log.csv"))
    info["viecap_mapper"] = {
        "first_epoch": {"loss": float(mrows[0][2]), "acc": float(mrows[0][3])},
        "last_epoch": {"loss": float(mrows[-1][2]), "acc": float(mrows[-1][3])},
        "seconds": stage.seconds["mapper"],
        "note": "frozen seeded-random LM + fallback tokenizer (no pretrained GPT-2 / "
                "BPE vocab offline); loss-level convergence only",
    }
    log(f"[viecap-mapper] loss {mrows[0][2]} -> {mrows[-1][2]} acc {mrows[-1][3]} "
        f"({stage.seconds['mapper']:.1f} s)")

    # ------------------------------- 6b. the trace evaluator and scorers
    eval_dir = os.path.join(out_dir, "eval_data")
    ann_path = synthetic.write_eval_dataset(
        eval_dir, train_combos, samples_per_combo=scale.eval_samples_per_combo,
        img_size=IMG_SIZE, seed=seed + 7)
    with stage("eval"):
        result = trace_captioning.evaluate(model, ann_path, os.path.join(eval_dir, "images"),
                                           batch_size=scale.eval_batch)
    info["eval_seconds"] = stage.seconds["eval"]
    scores = trace_captioning.compute_scores(result)
    info["eval_scores"] = {k: float(v) for k, v in scores.items()}

    # shuffled-caption control: the same predictions against a deranged GT,
    # rolled by a whole combo's samples (rolling by 1 would pair a combo's
    # second rendering with its own first)
    preds = [p["pred"] for p in result["predictions"]]
    gts = [p["gt"] for p in result["predictions"]]
    shuffled = list(np.roll(np.asarray(gts, object), scale.eval_samples_per_combo))
    control = harness.score_and_log(preds, [[g] for g in shuffled])
    info["control_scores"] = {k: float(v) for k, v in control.items()}
    info["eval_exact_match"] = float(np.mean([p == g for p, g in zip(preds, gts)]))
    log(f"[eval] CIDEr {info['eval_scores'].get('CIDEr'):.3f} "
        f"Bleu_4 {info['eval_scores'].get('Bleu_4', float('nan')):.3f} "
        f"exact {info['eval_exact_match']:.3f} | control CIDEr "
        f"{info['control_scores'].get('CIDEr'):.3f}")

    # images of HELD-OUT combos: the support memory holds only train
    # captions, so credit comes from partial n-gram overlap; reported
    held_eval_dir = os.path.join(out_dir, "eval_data_held")
    held_ann = synthetic.write_eval_dataset(held_eval_dir, held_combos, samples_per_combo=1,
                                            img_size=IMG_SIZE, seed=seed + 11)
    with stage("eval_held_out"):
        held_result = trace_captioning.evaluate(
            model, held_ann, os.path.join(held_eval_dir, "images"),
            batch_size=scale.eval_batch)
    info["held_out_image_scores"] = {
        k: float(v) for k, v in trace_captioning.compute_scores(held_result).items()}

    info["stage_seconds"] = dict(stage.seconds)
    if stage.peak_gib:
        info["peak_memory_gib"] = dict(stage.peak_gib)
    info["total_seconds"] = time.perf_counter() - t_start
    with open(os.path.join(out_dir, "proof.json"), "w") as f:
        json.dump(info, f, indent=2, default=float)
    return info


# ----------------------------------------------------------------- report


def write_report(info: dict, path: str) -> None:
    es, cs = info["eval_scores"], info["control_scores"]
    rec = info["reconstruction"]
    on_card = "card" in info
    where = (f"on `{info['device']}` ({info['card']}, torch {info['torch']}, TF32 "
             f"{'on' if info['tf32'] else 'off'})" if on_card else f"on `{info['device']}`")

    def row(k):
        return f"| {k} | {es.get(k, float('nan')):.4f} | {cs.get(k, float('nan')):.4f} |"

    def secs(name):
        return f"{info['stage_seconds'][name]:.1f} s"

    lines = [
        "# Convergence proof of the PyTorch port",
        "",
        f"Generated by `scripts/convergence_proof_torch.py --scale {info['scale']}` "
        f"{where} in {info['total_seconds']:.1f} s."
        + (" Every time below was taken on that card, at that power limit." if on_card
           else " The times below are of the host's CPU."),
        "",
        "Pipeline (the port's code paths): `train/align.py` contrastive tower "
        "alignment (on the card the ViT runs kernels A, B and C and their "
        "backwards; on the CPU their plain versions) -> `io/memory_bank.build_bank` "
        "-> `train/cli.py` text-only DeCap "
        "training -> `Patchioner.from_config` on the written files -> "
        "`eval/trace_captioning.evaluate` + `compute_scores` over on-disk JPEGs and "
        "LN-schema traces. The JAX package's run is `reports/convergence_proof.md`.",
        "",
        "## World",
        "",
        f"- captions: {info['n_combos']} (`a {{color}} {{shape}} in the {{position}}`), "
        f"{info['n_train']} train / {info['n_held_out']} held out (held-out captions "
        "are unseen by alignment, decoder and bank)",
        "",
        "## Stage results",
        "",
        f"- alignment: batch-acc {info['align_final']['acc']:.3f}, retrieval acc "
        f"{info['align_retrieval_acc']:.3f} ({secs('align')}, "
        f"{info['align_steps_per_s']:.2f} steps/s after the first)",
        f"- decoder: loss {info['decoder_first_epoch']['loss']:.3f} -> "
        f"{info['decoder_last_epoch']['loss']:.3f}, teacher-forced acc "
        f"{info['decoder_last_epoch']['acc']:.3f} ({secs('decoder')})",
    ]
    vm = info["viecap_mapper"]
    lines += [
        f"- ViECap mapper (train/prefix_cli.py, frozen seeded LM): loss "
        f"{vm['first_epoch']['loss']:.3f} -> {vm['last_epoch']['loss']:.3f}, "
        f"teacher-forced acc {vm['first_epoch']['acc']:.3f} -> "
        f"{vm['last_epoch']['acc']:.3f} ({secs('mapper')}). Loss-level only: the "
        "reference rides a frozen pretrained GPT-2, which no offline run has.",
        "",
        "## (a) Caption reconstruction from text embeddings",
        "",
        f"- train captions: exact-match {rec['train_exact_match']:.3f}, token-acc "
        f"{rec['train_token_acc']:.3f}",
        f"- **held-out** captions (never seen in training): exact-match "
        f"{rec['held_out_exact_match']:.3f}, token-acc {rec['held_out_token_acc']:.3f}",
        "",
        "Held-out examples:",
        "",
    ]
    lines += [f"- gt: `{ex['gt']}` -> pred: `{ex['pred']}`"
              for ex in rec["held_out_examples"]]
    lines += [
        "",
        "## (b) Trace-captioning eval (images + traces from disk)",
        "",
        f"Exact caption match on the train-combo scenes: "
        f"**{info['eval_exact_match']:.3f}** ({secs('eval')}).",
        "",
        "| metric | trained model | shuffled-GT control |",
        "|---|---|---|",
    ]
    lines += [row(k) for k in ("Bleu_1", "Bleu_4", "ROUGE_L", "CIDEr", "METEOR") if k in es]
    lines += [
        "",
        "Held-out-combo images (captions absent from decoder training and the bank, "
        "reported unthresholded): " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(info["held_out_image_scores"].items())
            if k in ("Bleu_1", "CIDEr", "ROUGE_L")),
        "",
        "## Stages",
        "",
        "| stage | seconds | peak allocated (GiB) |",
        "|---|---|---|",
    ]
    peak = info.get("peak_memory_gib", {})
    lines += [f"| {k} | {v:.1f} | " + (f"{peak[k]:.2f}" if k in peak else "not measured")
              + " |" for k, v in info["stage_seconds"].items()]
    lines.append("")
    with open(path, "w") as f:
        f.write("\n".join(lines))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", choices=tuple(SCALES), default="full")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "convergence_proof_torch"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--report", default=None, help="also write a markdown report here")
    args = ap.parse_args(argv)
    info = run_proof(args.out, SCALES[args.scale], seed=args.seed, device=args.device)
    print(json.dumps(info, indent=2, default=float))
    if args.report:
        write_report(info, args.report)
        print(f"report -> {args.report}")
    return info


if __name__ == "__main__":
    main()
