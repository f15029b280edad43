#!/usr/bin/env python3
"""Smoke run of the PyTorch port (patchioner_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # needs one CUDA card

Phases, each reporting on its own lines; any failure raises, and the script
then exits non-zero without the final result line:

1. device: a CUDA card is required (no CPU fallback); prints its name and
   power limit as nvidia-smi reports them;
2. build: compiles the CUDA kernels from `patchioner_tpu_torch/csrc`, one
   nvcc process per source, all started together; prints ptxas' registers,
   spills and wgmma remarks per kernel, and the HGMMA and IGMMA
   instructions that cuobjdump finds in each kernel. Every wgmma
   instantiation must have them, each found by its own mangled name
   (`WGMMA_KERNELS`): the online attention of B, F and K, J's exact-max
   attention, A's qkv GEMM, E's dense + residual GEMM, F's out-projection
   GEMM, and the fc1 and fc2 GEMMs of C and of G; I's integer GEMMs, fc1 and
   fc2 in both activation types, must have the integer warpgroup MMA
   (`INT_WGMMA_KERNELS`); and the projection's tensor-core kernels, D's
   over a bf16 bank and H's over an int8 one, must have mma.sync (HMMA) in
   both instantiations of each (`MMA_KERNELS`);
3. kernels: each kernel (A-K, and C with the tanh GELU) against its plain
   PyTorch version on the card, in float32 (TF32 off) and bfloat16, at the
   shapes its path gives it: the flagship's (B = 8, N = 1374, D = 768, 12
   heads of 64, the full 591,753-row bank, in int8 for H), ViT-g's for G
   (D = 1536, SwiGLU hidden 4096), and for A, E, F, D and H a second time
   at ViT-g's shapes (D = 1536, 24 heads, the 1536-wide bank), and the
   flagship MLP's for I (int8 weights), with CUDA-event timings,
   the least time the card could take for the same work, and torch's
   `scaled_dot_product_attention` on the same q, k, v as the attention
   kernels' library yardstick, and as D's: softmax(f b^T / T) b is one
   SDPA call with q the unit features, k the bank's unit rows (made once,
   outside the timer, in the bank's type) and v its rows, held to D's
   plain version after the output's L2 normalisation (left out of the
   timed call), at 8 and 128 rows and at giant's width, each call's SDPA
   backend printed (H has none: no PyTorch call reads an int8 bank); the
   projections (D and H, each also at
   giant's width) also print the rate they read their bank at and its
   share of 3.35 TB/s. D and H also run at 128 batch rows (a served box
   batch: 8 images x 16 boxes) against the full flagship bank, and D at 8
   and 128 rows against the CLIP DeCap configs' 500,000 x 512 bank
   (`memory_project_clip`, `memory_project_clip_128`), each with its bound
   and SDPA's time, printed with their bank rate, not rows of the JSON
   summary; so are A, B and C at ViT-L's shapes (DINO.txt's tower: 8 x
   1374 rows, D = 1024, 16 heads, hidden 4096; C's f32 body in its
   32-column instantiation) and D at 8 and 128 rows against a 500,000 x
   1024 bank (`*_vitl`).
   No model path reaches I: its launches are this phase's;
4. main path: ViT-B/14-reg at 518 px, the 591,753-row bank and the 30-step
   DeCap decode behind the port's `CaptionServer`, seeded random weights in
   bfloat16; the kernels' launch counters prove the path ran through them,
   and the decoder's counters that every served batch replayed a CUDA
   graph of the decode, none captured after the server's `warmup()` (in
   every served phase below as well);
4b. the same for each further attention configuration of the encoder
   (`proj_fused`, `fusedqkv_proj`, `flash`, `flash1p`, `flash_builtin`):
   one batch of 8 served, the launch counters of its kernels asserted;
   for `flash_builtin` a batch through a new server, and one through a
   new server after `CaptionServer.warmup()`, their latencies printed
   beside the first server's;
4c. giant: ViT-g/14-reg at full width (40 layers, D = 1536, 24 heads,
   SwiGLU FFN) with the 591,753 x 1536 bank, one batch of 8 served: A, B
   and G 40 launches a batch, D one; then the same with
   `attn_impl: fusedqkv_proj`: A, F and G 40 launches a batch, D one;
4d. int8 bank: the flagship with `memory_bank_int8: true`, one batch of 8
   served: H one launch a batch, D none;
4e. the other spatial queries on phase 4's model: 8 whole-image
   requests, 8 box requests of 1-16 boxes (padded to 16: 128 rows through
   the projection and the decode) and 8 region-set requests, each kind one
   batch through the `CaptionServer`, A, B and C 12 launches and D one
   asserted for each; the box batch's prefix and decode (graph and eager)
   timed apart;
4f. decode graph vs eager: the flagship's decoder weights in bfloat16 and
   in float32, at 8 and 128 rows, as a replayed CUDA graph and as the
   eager loop on the same prefixes: tokens equal, scores within
   `SCORE_TOLERANCE`, and a clean batch after one with NaN rows still
   equal; each decode's time, launches a step and the graphs' memory;
4g. the decode graphs kept, one a power-of-two row bucket: one flagship
   `forward` of 8 images' patch captions (8 x 1369 = 10,952 rows), box
   batches of three distinct totals and one total again, then a sweep of
   16 box totals; each call's graph captures (one only for a new bucket,
   asserted), time and the card's reserved memory printed; then 100 rows
   on the 128-row graph against the eager loop on the zero-padded batch
   (tokens equal, asserted) and on the 100 rows alone (reported);
5. f32 cross-check: the projected prefix on the card (kernels) against the
   CPU (plain versions) within 1e-4 * max(1, max|ref|), with layerscale
   drawn near 1 so that the kernels move the residual stream, for the
   flagship, the int8-bank flagship, and giant cut to 4 layers (full width)
   under `fusedqkv` and under `fusedqkv_proj`; for the flagship also the
   box path with the attention map, the region-set path with Gaussian
   weights and the whole-image `avg_self_attn` path;
5b. the same gate between each further attention configuration's prefix
   and the `fusedqkv` one's, both on the card: the flagship's, and giant's
   `fusedqkv_proj`;
6. loaded checkpoints: the flagship's weights at full width, seeded,
   written with `torch.save` in the published layouts (a torch.hub DINOv2
   ViT-B/14-reg and a DeCap decoder) into a temporary directory, loaded
   through `Patchioner.from_config` in bf16 on the card, the seconds spent
   reading, porting and uploading printed; 8 trace requests served after
   the server's `warmup()`, A-D's launches and the decode graphs'
   replays asserted, the first batch's latency printed; then the f32
   prefix of the model loaded on the card against the same files loaded
   on the CPU, under the gate of phase 5: plain, with a Talk2DINO file
   (512 -> 768) and a DeCap file whose prefix linear takes 512 under
   `prefix_size: 512`, so that the inversion runs on the card, and on the
   int8 bank (H). No bank file is read (the card's machine has no h5py):
   the bank is drawn at random at the config's size;
7. ViECap on DINOv2: `configs/mlp.viecap.k.yaml` (`VIECAP_CONFIG`) loaded
   through `from_config` from phase 6's DINOv2 and DeCap files and a
   seeded full-width ViECap checkpoint in the published layout (the
   8-layer mapping network, GPT-2 base in f32), the vendored COCO entity
   embeddings and the whitespace fallback tokenizer; 8 trace, 8 box (1-16
   boxes) and 8 whole-image requests served through `forward` after each
   kind's `warmup()`, A, B and C 12 launches a batch asserted and neither
   D nor H, with captions/s, latency and a whole-image batch's split
   (encoder, prompts, search, timed inside the same `forward` calls); then
   on 8 rows of the model's prompts the soft prompt and the prefill's
   logits held to the CPU under phase 5's gate, the greedy, beam (width 5)
   and contrastive (top_k 48, alpha 0.1) tokens over 16 steps compared
   with the CPU's (reported), and each search timed at the config's 64
   tokens with its kernels a step;
7b. the served route in f32: one trace batch and one box batch of an f32
   copy of the same model served on the card and on the CPU, the features
   `forward` hands to `caption_tokens` and the prompt embeddings built from
   them held to each other under phase 5's gate, captions compared
   (reported);
7c. DeCap without a bank: the same config without its `viecap` block
   (`support_memory_size: 0`), 8 whole-image and 8 box requests served
   through `forward` in bf16 after `warmup()`, each batch replaying a CUDA
   graph of the DeCap decoder that warm-up captured; then as 7b, the
   prefix DeCap decodes in place of the prompt embeddings, with one graph
   replay asserted for each `caption_tokens` call on the card;
8. ClipCap on DINOv2: the flagship's encoder without a bank and an MLP
   `clipcap` block at its defaults (prefix 10: 768 -> 3,840 -> 7,680;
   top_p 0.8, temperature 1, 67 tokens, stop at '.'; GPT-2 base in f32),
   loaded through `from_config` from phase 6's DINOv2 file and a seeded
   ClipCap file in the published layout (`clip_project.model.{0,2}.*`,
   `gpt.*`); 8 trace, 8 box and 8 whole-image requests served after each
   kind's `warmup()`, with A, B and C 12 launches a batch and neither D nor
   H nor the DeCap graph, captions/s, latency and a whole-image batch's
   split (encoder, mapper, noise, sampling, inside the same `forward`
   calls); the sampler's time, kernels and device ms a step; in f32 on the
   card against the CPU, TF32 off, the mapper's output and the prefill's
   logits under phase 5's gate and the tokens of 16 steps on the same
   Gumbel noise, drawn on the CPU (reported); then one whole-image batch of
   the transformer mapper (8 layers, `clip_project.*`), its output gated
   the same way;
9. MeaCap on DINOv2: `configs/mlp.meacap.k.yaml` (`MEACAP_CONFIG`) loaded
   from phase 6's DINOv2 file, phase 7's ViECap file and a caption memory
   written here in the published layout under `memory/coco_B16_t2d/`:
   591,753 seeded captions from a small word list and their 1.82 GB of
   f32 embeddings; 8 trace, 8 box and 8 whole-image requests served as in
   phase 8, a whole-image batch's split (encoder, retrieval, concept
   extraction on the host, search); in f32, card against CPU, the
   retrieved indices and the concepts equal (asserted), the prompt
   embeddings under the gate, greedy tokens of 16 steps (reported);
10. training, f32 with TF32 off, seeded weights and corpus
   (`TrainShapes`): the DeCap decoder at the reference CLI's defaults (4
   layers, 4 heads, 768 wide, vocab 50,257, prefix 768, 20 tokens, batch
   64) trained plain and with `--im_proj` through a seeded 591,753 x 768
   f32 bank, kernel D launched once a step (counted from 0 before the
   timed steps) and timed at the step's 64 rows against its plain version
   and bound; a packed run (1024 rows of 64, `loss_chunk` 8, `grad_accum`
   2); steps/s, captions/s trained and peak memory of each; the
   `--im_proj` step with CapDec noise on the card against the CPU, same
   init, batches and noise, under phase 5's gate: loss and accuracy, every
   gradient leaf after one step, the params after three; ViECap's 8-layer
   mapping network and ClipCap's MLP mapper (prefix 10) on a frozen seeded
   GPT-2 base at batch 80 and 40 tokens, timed, and one step at 8 rows
   gated card vs CPU (loss, accuracy, every mapper gradient leaf); then
   the decoder CLI trains 20 steps on a `--features` file, a `--resume`
   continues it, and `from_config(decap_weights: <out_dir>)` serves 8
   trace requests on the flagship (A-D and the decode graph asserted); the
   prefix CLI trains a ViECap and a ClipCap mapper, and each directory is
   served once through `weight_path`;
11. the CLIP ViT backbone family (plain PyTorch towers, as in the JAX
   package): 11a, DeCap on CLIP ViT-B/16 at 592 px
   (`configs/decap_B16_resize.k.yaml`: 37 x 37 + 1 = 1370 tokens, 12
   layers, D = 768, projection 512; DeCap 4L/4H/768 with prefix 512; a
   random 500,000 x 512 bank; bf16): 8 trace, 8 box (16 boxes, 128 rows)
   and 8 whole-image requests served through `forward` after each kind's
   `warmup()`, D once a batch and a decode graph replayed each batch, none
   captured, asserted; captions/s, mean latency, a whole-image batch's
   encoder, projection and decode by CUDA events, and the encoder's
   kernels by device time and its idle share (torch.profiler); 11b, f32 card against
   CPU on the same weights (two images), under phase 5's gate, the
   encoder's CLS and patch tokens and the projected prefix of CLIP B/16
   and B/32 at 224 px, INViTE at 592 (the position grid resized, the last
   block diagonal), OpenCLIP, DenseCLIP at 640 (1601 tokens) and
   AlphaCLIP, whose box path (2 images x 4 boxes, a pass each) is gated
   too, captions compared (reported); 11c, ViECap
   (`configs/viecap.k.yaml`, the copied CLIP-space entity embeddings) and
   MeaCap (`configs/meacap_invlm.k.yaml`, a seeded 591,753 x 512 memory)
   on CLIP ViT-B/32: a whole-image batch of 8 each, its encoder and search
   ms inside the same `forward` calls, no kernel launched;
12. the CLIP text towers (plain PyTorch, as in the JAX package), each of
   the five text spaces at full geometry written from a seed in the
   openai/CLIP layout under its checkpoint prefix (`TEXT_SPACES`), with a
   Talk2DINO projection 512 -> 768: 12a, a quarter of the flagship's
   support memory built as `extract_features bank` builds it, without its
   HDF5 write (no h5py on the card): 147,938 seeded captions through the CLIP ViT-B/16
   text tower (f32, TF32 off) and Talk2DINO in batches of 1000, the
   tokenizer's and the tower's seconds apart, captions/s and peak memory;
   12b, f32 card against CPU on the same files under phase 5's gate: the
   clip space's output on 256 of those captions and the built bank's rows,
   open_clip, regionclip (1024 out), denseclip (context 13) and DINO.txt
   (1280 x 24, 2048 out and its patch-aligned half) on 8 captions each;
   12c, the flagship (bf16) with the built bank as its support memory, 8
   trace requests served after `warmup()`, A-D and a decode-graph replay a
   batch asserted; 12d, `train.cli --encode_on_the_fly --talk2dino_weights
   --im_proj` on 2,048 seeded captions over the built bank in f32, 32
   steps, steps/s and D's launches (one a step) asserted; 12e,
   `extract_features image` over 16 seeded images through the flagship
   config in f32 (A, B and C 12 launches a run), `cls` and
   `avg_self_attn` of two images held to the CPU under the gate; 12f,
   `ClipScorer` on CLIP ViT-B/16 (the vision tower at 224 px and the clip
   text file): PAC-S and RefPAC-S of 8 captions against 8 images, card
   against CPU within 1e-4;
13. evaluation (`[eval ...]` lines): a seeded dataset in the published
   layouts (64 JPEG images of 640 x 480, a Localized-Narratives trace
   file, a COCO dense file of 1-16 boxes an image, a region-set file and
   a COCO captions file) through the port's four task evaluators on the
   flagship (bf16, the 591,753-row bank, built once, its decode graphs
   warmed) at the grid's batch of 16: trace `patches` (fused) and
   Gaussian (`forward`); image `cls`, `avg_self_attn` and `patches` at
   variance 100; dense `patches` (fused), `cls` and the crop-and-caption
   baseline (`caption_bboxes_type: cls_capt`, 16 images); region-set
   `patches`. Each run prints its images (boxes) a second in inference and
   in total, the preprocessing stall's share, A-D's launches and the
   decode graphs' replays, and asserts 12 launches of A, B and C and one
   of D a projection, one graph replay each and no capture, and one step a
   batch on the fused paths; each run's scores go to a CSV. The first
   trace, `cls` and dense batches equal the direct fused calls on the same
   pixels and padding; `ExperimentRunner` writes a trace and a dense row,
   a second run skips both, `ResultsCollector` reads them back;
   `profile_trace` records kernels; the trace evaluator's rate is printed
   beside phase 4's served captions/s;
14. the rest of the backbone family, on seeded files in the published
   layouts (`write_backbone_checkpoints`), bf16, each config's random
   bank: 14a, RegionCLIP's RN50 at 512 px
   (`configs/regionclip_resnet50_p32_512.k.yaml`) from a detection
   checkpoint whose 224 px attention pool is drawn anew (asserted equal
   to the CPU generator's draw), DeCap with prefix 1024 over 500,000 x
   1024: 8 trace, 8 box and 8 whole-image requests through `forward`, D
   once a batch, a whole-image batch's split, the crop-and-caption
   baseline (8 PIL images of 640 x 480, 4 boxes each),
   `analyze_feature_compatibility` (D four times), f32 card against CPU
   (cuDNN's TF32 off); 14b, ProxyCLIP B/16 with DINOv2 B/14-reg at 518 px
   (`configs/proxyclip_b16_dinov2.k.yaml`, its CLIP and DINOv2 files) over
   500,000 x 512: 8 trace and 8 box requests, A, B and C 12 launches a
   batch, a whole-image request raising through the server as in JAX,
   the patch mean's captions and split, f32 card against CPU on mosaic
   images whose affinity keeps at least 10% of every row off its
   diagonal (the VFM's tokens, the affinity's masks compared, the tokens
   and prefix of the rows whose mask agrees), and `configs/proxyclip_b16.k.yaml` (the `dino` VFM at 296 px) f32
   only; 14c, DINO.txt's ViT-L/14-reg at 518 px (`configs/dinotxt.yaml`,
   its checkpoint) over 591,753 x 1024: trace, box, region-set and
   whole-image requests on the fused steps, A, B and C 24 launches and D
   one a batch, a whole-image batch's split, f32 card against CPU at full
   width and 4 layers;
15. training through the kernels (`[align grad ...]` and `[proof ...]`
   lines): 15a, one FULL-width batch of 64 of the convergence proof's
   contrastive alignment (ViT-S, D = 384, 12 layers, 17 tokens; the 256 x
   4 text tower) through A, B and C's autograd Functions and through their
   plain versions under autograd, from one init with the layerscale drawn
   near 1: loss, accuracy and every leaf's gradient under phase 5's gate,
   every ViT leaf's gradient within 1e-4 of its own largest (each kind's
   range of sizes printed), finite, and every weight matrix's non-zero, A,
   B and C 12 launches each, a backward of A, B or C with one term of its
   derivative dropped failing that gate, A's output carrying its
   Function's node and E refusing a grad-requiring call, with both routes' forward + backward times and a whole step's
   device time and idle share under the profiler; 15b,
   `scripts/convergence_proof_torch.run_proof` at FULL scale (align 800
   steps, DeCap 4L/4H/768 through `train/cli.py`, the ViECap mapper on a
   frozen 12L/768 GPT-2, the trace evaluator and the shuffled control),
   every threshold of tests/test_convergence.py asserted, each stage's
   seconds and peak memory, align steps/s;
16. the encoder options (`[kkv ...]`, `[softmax_f32 false]`,
   `[double-DINO]` and `[dd rerun ...]` lines): 16a, the flagship built
   with `attention_type: kkv` served (trace and box requests after
   `warmup()`, A, B, C and D counted), its f32 prefix and self_attn card vs
   CPU with the layerscale drawn near 1, the rewired queries equal to the
   keys; 16b, `softmax_f32: false` (the compute-type softmax, no B)
   served, the encoder's ms by CUDA events beside the default route's, its
   f32 prefix against the default route's under phase 5's gate, its bf16
   prefix's difference and caption agreement reported; 16c, double-DINO
   box captions through `forward` (8 images x 16 boxes, the four
   (use_cls, return_type) cases, compute_scores) with A, B, C and D
   counted (the re-run one A and one C beyond the encoder's), the re-run's
   ms at 128 rows in bf16 against its plain version's, its chunk and peak
   memory, the re-run through A and C against its plain version at 128
   rows in both types (the output and the block's delta, the layerscale
   near 1) and through A and G on ViT-g at 4 layers, each with a mutant
   that drops the key mask and must fail, and `_double_dino_features`
   card vs CPU at f32 on the card's encoding;
17. the rest of `forward` (`[argmax ...]`, `[n-best]`, `[cleaning ...]`,
   `[heads]` and `[f32 modes]` lines), on the flagship at full width:
   17a, the flagship built with `calculate_argmax_text: true` (no decoder,
   no decode graph) captions 8 images by their CLS token, their
   attention-weighted mean, 8 x 16 boxes with their top-5 similarities and
   every patch (10,952 rows against the whole bank, chunked) through
   `forward`, and serves 8 trace requests, which the server routes through
   `forward`: A, B and C 12 launches an encoder pass, D and H none; each
   call's ms, the chunk's rows and the peak memory; 17b, the DeCap
   flagship's 8 x 16 boxes with `return_n_best_sims=5` (one D launch),
   the top-k's ms beside the box batch's; 17d, per-head captions (8 x 16
   rows, one D launch); 17c, the cleaning grid (both types x both orders x
   both sources) on 2 images with patch and box captions (D two launches
   after the projection, one before), one combination on 8 images (10,952
   rows through D at unit norm, then that bucket's decode graph), D's ms
   at that row count with its first 64 rows against the plain version,
   and the int8-bank flagship once (H in D's place); 17e, f32 with TF32
   off, card vs CPU on the card's encoding: the cleaned patch features
   `caption_tokens` receives in both orders and the per-head features
   under phase 5's gate, the top-5 similarities of 16 patch rows against
   the whole bank within 1e-5, their argmax equal on every row whose CPU
   top-2 gap exceeds 1e-5 (the rows inside it counted).

Nothing of JAX or of the JAX package `patchioner_tpu` is imported.

The second-to-last line is the kernels' JSON summary, the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

# configs/mlp.k.yaml (the flagship config) as a dict: the card's machine
# has no PyYAML. tests/test_torch_slice.py holds it against the file.
FLAGSHIP_CONFIG = {
    "decap_weights": "weights/decap/talkingdino-ksplits/coco_karpathy-009.pt",
    "prefix_size": 768,
    "linear_talk2dino": False,
    "support_memory_size": 591753,
    "dino_model": "dinov2_vitb14_reg",
    "normalize": True,
    "attention_type": "qkv",
    "projection_type": "coco",
}
# ViT-g/14 with registers: the bank and prefix live in encoder space
GIANT_CONFIG = dict(FLAGSHIP_CONFIG, dino_model="dinov2_vitg14_reg", prefix_size=1536)
# configs/mlp.viecap.k.yaml (ViECap on DINOv2 features) as a dict;
# tests/test_torch_slice.py holds it against the file
VIECAP_CONFIG = {
    "decap_weights": "weights/decap/talkingdino/talkingDINO.pt",
    "prefix_size": 768,
    "support_memory_size": 0,
    "dino_model": "dinov2_vitb14_reg",
    "normalize": False,
    "use_talk2dino_project": False,
    "clip_model_name": "ViT-B/16",
    "viecap": {
        "clip_hidden_size": 768,
        "suffix": "ViT-B16_t2d_",
        "temperature": 0.01,
        "top_k": 3,
        "threshold": 0.4,
        "name_of_entities_text": "coco_entities",
        "prompt_ensemble": True,
        "weight_path": "weights/viecap/train_coco_t2d_B16/coco_prefix-0014.pt",
        "using_hard_prompt": True,
        "soft_prompt_first": True,
        "using_greedy_search": True,
        "beam_width": 5,
    },
}

# Max |kernel - plain| over max |plain|. float32: the two differ only in the
# order of f32 sums (relative error ~1e-6 over <= 3072 terms), so 1e-4
# leaves a wide margin. bfloat16: a different f32 summation order can move
# a value across one bf16 rounding boundary (2^-8 = 3.9e-3 relative), and a
# result passes through up to three such roundings. The memory projection
# reads the same bank rows on both sides and computes in f32 whatever the
# bank's type, so it is held to the f32 bound in both (H dequantizes the
# same int8 rows on both sides). I quantizes its activations per row: an f32
# difference of one ulp in LN(x) or GELU can move a value across a rounding
# boundary of round(a / s), which moves an output by about amax / 127 * |w|,
# so it takes 1e-3 in float32.
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
PROJECTIONS = {"memory_project", "memory_project_int8", "memory_project_giant",
               "memory_project_int8_giant", "memory_project_128", "memory_project_int8_128",
               "memory_project_clip", "memory_project_clip_128", "memory_project_vitl",
               "memory_project_vitl_128"}
W8_F32_TOLERANCE = 1e-3
# The decode graph replays the very launches of the eager loop, so its
# scores should equal the loop's; any difference is a bug, and these
# bounds (relative) only leave room for what a different cuBLAS choice
# between the two could move.
SCORE_TOLERANCE = {torch.float32: 1e-6, torch.bfloat16: 1e-3}

B, IMG, N, D, HEADS = 8, 518, 1374, 768, 12
HD = D // HEADS
GD, GH, GHEADS = 1536, 4096, 24  # ViT-g's width, SwiGLU hidden and heads
MAX_BOXES = 16  # the server's boxes a request: a box batch is B * 16 rows

# The least time the card could take: the larger of the operations over the
# peak rate for their type (dense tensor cores in bf16 and int8, the SIMT
# pipes in f32; the projections' tensor-core bodies, D over a bf16 bank and
# H, at the bf16 rate) and the bytes over the memory rate, each input read
# once and each output written once. NVIDIA H100 SXM.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}
PEAK_BYTES_PER_S = 3.35e12

# configs/mlp.meacap.k.yaml (MeaCap on DINOv2 features) as a dict;
# tests/test_torch_slice.py holds it against the file
MEACAP_CONFIG = {
    "decap_weights": "weights/decap/talkingdino/talkingDINO.pt",
    "prefix_size": 768,
    "support_memory_size": 0,
    "dino_model": "dinov2_vitb14_reg",
    "normalize": False,
    "use_talk2dino_project": False,
    "clip_model_name": "ViT-B/16",
    "viecap": {
        "meacap": {
            "memory_caption_num": 5,
            "memory_id": "coco_B16_t2d",
            "memory_base_path": "weights/meacap",
        },
        "clip_hidden_size": 768,
        "suffix": "ViT-B16_t2d_",
        "temperature": 0.01,
        "top_k": 3,
        "threshold": 0.4,
        "name_of_entities_text": "coco_entities",
        "prompt_ensemble": True,
        "weight_path": "weights/viecap/train_coco_t2d_B16/coco_prefix-0014.pt",
        "using_hard_prompt": True,
        "soft_prompt_first": True,
        "using_greedy_search": True,
    },
}
# ClipCap on the flagship's encoder: no shipped config has a `clipcap`
# block, so this one takes the block's defaults with the MLP mapper
CLIPCAP_CONFIG = dict(FLAGSHIP_CONFIG, support_memory_size=0,
                      clipcap={"mapping_type": "mlp"})
MEMORY_ROWS = 591753  # the flagship's COCO support memory, as MeaCap's

# the shipped CLIP-backbone configs phase 11 drives, as dicts (the card's
# machine has no PyYAML); tests/test_torch_clip.py holds each against its
# configs/<name>.k.yaml
_CLIP_DECAP = {"prefix_size": 512, "support_memory_size": 500000, "normalize": False,
               "resize_dim": 224, "crop_dim": 224, "use_talk2dino_project": False,
               "projection_type": "coco"}
_B16 = {"decap_weights": "weights/decap/clip-b16-ksplits/coco_karpathy-009.pt",
        "clip_model_name": "ViT-B/16"}
_B32_FAMILY = {"decap_weights": "weights/decap/clip-b32-ksplits/coco_karpathy-009.pt",
               "prefix_size": 512, "support_memory_size": 0,
               "dino_model": "vit_base_patch32_clip_224.openai", "normalize": False,
               "resize_dim": 224, "crop_dim": 224, "clip_model_name": "ViT-B/32",
               "use_talk2dino_project": False}
_VIECAP_BLOCK = {"weight_path": "weights/viecap/train_coco/coco_prefix-0014.pt",
                 "project_length": 10, "temperature": 0.01, "top_k": 3, "threshold": 0.4,
                 "language_model": "gpt2", "name_of_entities_text": "coco_entities",
                 "prompt_ensemble": True, "using_hard_prompt": True, "soft_prompt_first": True,
                 "only_hard_prompt": False, "using_greedy_search": True, "beam_width": 5}
CLIP_CONFIGS = {
    "decap_B16": dict(_CLIP_DECAP, **_B16, clip_weights="weights/clip/vit-b16-hf.pt",
                      dino_model="vit_base_patch16_clip_224.openai"),
    "decap_B32": dict(_CLIP_DECAP, decap_weights=_B32_FAMILY["decap_weights"],
                      clip_weights="weights/clip/vit-b32-hf.pt",
                      dino_model=_B32_FAMILY["dino_model"], clip_model_name="ViT-B/32"),
    "INViTE_B16_1layer_bigResize": dict(
        _CLIP_DECAP, **_B16, dino_model="INViTE_B16", resize_dim=592, crop_dim=592,
        linear_talk2dino=False, invite_config={
            "name": "ViT-B/16", "checkpoint": "weights/clip/vit-b16-openai.pt", "jit": False,
            "extract_last_k_th_token": 1, "viz": False, "resolution": 592}),
    "alphaclip_B16_CLS": dict(_CLIP_DECAP, **_B16, dino_model="alphaclip_vitb16",
                              alphaclip_config={
                                  "name": "ViT-B/16",
                                  "checkpoint": "weights/alphaclip/clip_b16_grit_1m.pth",
                                  "use_cls_for_localized_captions": True}),
    "denseclip_B16_seg_40patches": dict(
        _CLIP_DECAP, decap_weights="weights/decap/denseclip/coco_karpathy-009.pt",
        dino_model="denseclip_vitb16", denseclip_config="denseclip_segmentation_vitb16",
        denseclip_weights="weights/denseclip/ViT-B-DenseCLIP.pth", resize_dim=640,
        crop_dim=640, clip_model_name="DenseClip"),
    "viecap": dict(_B32_FAMILY, viecap=_VIECAP_BLOCK),
    "meacap_invlm": dict(_B32_FAMILY, viecap=dict(_VIECAP_BLOCK, meacap={
        "memory_caption_num": 5, "vl_model": "openai/clip-vit-base-patch32",
        "wte_model_path": "sentence-transformers/all-MiniLM-L6-v2",
        "parser_checkpoint": "lizhuang144/flan-t5-base-VG-factual-sg", "memory_id": "coco",
        "memory_base_path": "data/meacap_files/"})),
}
CLIP_CONFIGS["decap_B16_resize"] = dict(CLIP_CONFIGS["decap_B16"], resize_dim=592, crop_dim=592)
# OpenCLIP: no shipped config; the DeCap B/16 one with the branch's keys
OPENCLIP_CONFIG = dict(CLIP_CONFIGS["decap_B16"], use_open_clip=True, dino_model="ViT-B/16")
CLIP_BANK_ROWS, CLIP_D = 500000, 512  # the CLIP DeCap configs' support memory
CLIP_TOKENS = (592 // 16) ** 2 + 1  # ViT-B/16 at 592 px

# the shipped configs of the rest of the backbone family phase 14 drives,
# as dicts; tests/test_torch_backbone_family.py holds each against its file
REGIONCLIP_CONFIG = {
    "decap_weights": "weights/decap/regionclip/coco_karpathy-009.pt", "prefix_size": 1024,
    "support_memory_size": 500000, "dino_model": "RN50_regionclip", "normalize": False,
    "resize_dim": 512, "crop_dim": 512, "clip_model_name": "RegionCLIP",
    "use_talk2dino_project": False, "projection_type": "coco",
    "regionclip_config": {"checkpoint": "weights/regionclip/regionclip_pretrained-cc_rn50.pth",
                          "embed_dim": 1024, "patch_size": 32}}
_PROXYCLIP = {"prefix_size": 512, "support_memory_size": 500000,
              "proxyclip_clipmodel": "ViT-B/16", "normalize": False,
              "use_talk2dino_project": False, "clip_model_name": "ViT-B/16",
              "projection_type": "coco"}
PROXYCLIP_CONFIGS = {
    "proxyclip_b16_dinov2": dict(
        _PROXYCLIP, decap_weights="weights/decap/clip-b16-ksplits/coco_karpathy-009.pt",
        proxyclip_vfm="dinov2", clip_weights="weights/clip/vit-b16-openai.pt",
        dino_weights="weights/dinov2/dinov2_vitb14_reg.pth", resize_dim=518, crop_dim=518),
    "proxyclip_b16": dict(_PROXYCLIP, decap_weights="weights/decap/clip-b16/coco_prefix-009.pt",
                          proxyclip_vfm="dino", resize_dim=296, crop_dim=296),
}
DINOTXT_CONFIG = {"decap_weights": "weights/decap/talkingdinotxt/coco_prefix-009.pt",
                  "prefix_size": 1024, "support_memory_size": 591753,
                  "dino_model": "dinov2_vitl14_reg4_dinotxt_tet1280d20h24l", "normalize": True,
                  "use_talk2dino_project": False, "projection_type": "coco"}
LD, LH, LHEADS = 1024, 4096, 16  # ViT-L's width, MLP hidden and heads (DINO.txt)
LBANK_ROWS = 500000  # RegionCLIP's support memory, 1024 wide

# each further attention configuration of the encoder (phase 4b, 5b)
CONFIGS = {
    "proj_fused": {"attn_impl": "fusedqkv", "proj_fused": True},
    "fusedqkv_proj": {"attn_impl": "fusedqkv_proj"},
    "flash": {"attn_impl": "flash"},
    "flash1p": {"attn_impl": "flash1p"},
    "flash_builtin": {"attn_impl": "flash_builtin"},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, warmup: int = 3, iters: int = 10) -> float:
    """Median of `iters` CUDA-event timings of fn(), after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "the port's smoke run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}, {torch.cuda.device_count()} card(s), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)
    return name, smi


# Every wgmma kernel instantiation, by the parts of its mangled name: the
# kernel's name and its template argument (a bool, or an epilogue type),
# each with the length prefix it has there. Each must have HGMMA in SASS.
WGMMA_KERNELS = {
    "B, F and K, online softmax": ("attention_sm90_kernel", False),
    "J, exact-max softmax": ("attention_sm90_kernel", True),
    "A qkv": ("gemm_bf16_kernel", "QkvEpilogue"),
    "E dense + residual": ("gemm_bf16_kernel", "DenseResidualEpilogue"),
    "F out-projection": ("gemm_bf16_kernel", "AttnProjEpilogue"),
    "C fc1": ("gemm_bf16_kernel", "Fc1Epilogue"),
    "C fc2": ("gemm_bf16_kernel", "Fc2Epilogue"),
    "G fc1": ("gemm_bf16_kernel", "SwigluFc1Epilogue"),
    "G fc2": ("gemm_bf16_kernel", "SwigluFc2Epilogue"),
}
# Every mma.sync kernel instantiation, the same way; each must have HMMA.
MMA_KERNELS = {
    "D bf16, D <= 768": ("mem_proj_bf16_kernel", 6),
    "D bf16, D <= 1536": ("mem_proj_bf16_kernel", 12),
    "H int8, D <= 768": ("mem_proj_int8_kernel", 6),
    "H int8, D <= 1536": ("mem_proj_int8_kernel", 12),
}
# I's integer GEMMs (wgmma .s8); each instantiation (fc2's in both
# activation types) must have the integer warpgroup MMA, IGMMA.
INT_WGMMA_KERNELS = {
    "I fc1": ("gemm_s8_kernel", "W8Fc1Epilogue"),
    "I fc2": ("gemm_s8_kernel", "W8Fc2Epilogue"),
}


def _is_instantiation(fn: str, kernel: str, arg) -> bool:
    """Whether the mangled name `fn` is kernel<arg>."""
    targ = (f"Lb{int(arg)}E" if isinstance(arg, bool) else
            f"Li{arg}E" if isinstance(arg, int) else f"{len(arg)}{arg}")
    return f"{len(kernel)}{kernel}I" in fn and targ in fn


def phase_build() -> None:
    from patchioner_tpu_torch import kernels
    from patchioner_tpu_torch.kernels import build

    kernels.lib()
    log(f"[build] nvcc {' '.join(build.NVCC_FLAGS)}: "
        f"{kernels.build_seconds:.1f} s for {len(build.sources())} sources")
    for line in build.build_log().splitlines():
        if "wgmma" in line:
            log(f"[build] {line.strip()}")
    resources = build.kernel_resources()
    for fn, (regs, stores, loads) in sorted(resources.items()):
        log(f"[build] {fn}: {regs} registers, spills {stores} B stored, {loads} B loaded")
    counts = {op: build.sass_counts(op) for op in ("HGMMA", "HMMA", "IGMMA")}
    for op in ("HGMMA", "IGMMA"):
        for fn, n in sorted(counts[op].items()):
            log(f"[build] {n} {op} in {fn}")
    # each wgmma instantiation must be a Hopper warpgroup design (HGMMA in
    # SASS, IGMMA for I's integer ones), and each mma.sync one must run on
    # the tensor cores (HMMA); every compiled instantiation that matches a
    # row is checked
    for opcode, table in (("HGMMA", WGMMA_KERNELS), ("HMMA", MMA_KERNELS),
                          ("IGMMA", INT_WGMMA_KERNELS)):
        for label, (kernel, arg) in table.items():
            found = [fn for fn in resources if _is_instantiation(fn, kernel, arg)]
            missing = [fn for fn in found if not counts[opcode].get(fn)]
            if not found or missing:
                raise AssertionError(f"no {opcode} instruction in {label} "
                                     f"({kernel}<{arg}>): {missing or 'not compiled'}")
            for fn in found:
                regs, stores, loads = resources[fn]
                log(f"[build] {label}: {counts[opcode][fn]} {opcode}, {regs} registers, "
                    f"spills {stores} B stored, {loads} B loaded")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _sdpa(q, k, v, scale: float):
    """torch's scaled_dot_product_attention on (q, k, v), a library call; its
    `backend` is the one the dispatcher picks for these inputs (a private
    query of torch's, only printed)."""
    from torch.nn.functional import scaled_dot_product_attention

    def call():
        return scaled_dot_product_attention(q, k, v, scale=scale)

    try:
        from torch.nn.attention import SDPBackend

        call.backend = SDPBackend(torch._fused_sdp_choice(q, k, v, scale=scale)).name
    except Exception:
        call.backend = "unknown"
    return call


def _bank_sdpa(feats, bank, unit, dtype):
    """D's function, softmax(f b^T / T) b, as one SDPA call: q the unit
    features, k the bank's unit rows `unit`, v its rows, all in `dtype`; the
    output is not normalised (the plain version's L2 normalisation is left
    out of the timed call)."""
    from patchioner_tpu_torch.ops import memory_projection as mp

    q = (feats / feats.norm(dim=-1, keepdim=True)).to(dtype)
    return _sdpa(q[None, None], unit[None, None], bank.rows[:bank.num_real][None, None],
                 1.0 / mp.DEFAULT_TEMPERATURE)


def _unit_rows(bank, dtype):
    """The bank's real rows at unit norm in `dtype`: SDPA's keys for D."""
    n = bank.num_real
    return (bank.rows[:n].float() * bank.inv_norm[:n]).to(dtype)


def _kernel_cases(dtype, gen):
    """(name, source, replaces, kernel call, plain call, library call or
    None, operations, bytes) at the shapes each kernel's path gives it;
    inputs are seeded random tensors in `dtype` (the banks' features f32, H's
    rows and I's weights int8), and the work is counted from them."""
    from patchioner_tpu_torch.ops import attention, memory_projection as mp, mlp

    dev = "cuda"

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    x, r = randn(B, N, D), randn(B, N, D)
    g, bg = 1 + randn(D, scale=0.1), randn(D, scale=0.1)
    wqkv, bqkv = randn(D, 3 * D, scale=D ** -0.5), randn(3 * D, scale=0.1)
    wproj, bproj = randn(D, D, scale=D ** -0.5), randn(D, scale=0.1)
    qkv = randn(B, N, 3 * D)
    q, k, v = attention.split_heads(qkv, HEADS)
    w1, b1 = randn(D, 4 * D, scale=D ** -0.5), randn(4 * D, scale=0.1)
    w2, b2 = randn(4 * D, D, scale=(4 * D) ** -0.5), randn(D, scale=0.1)
    # per channel, so a kernel that reads ls at the wrong index disagrees
    ls = 1 + randn(D, scale=0.1)
    bank = mp.prepare_bank(
        torch.randn(FLAGSHIP_CONFIG["support_memory_size"], D, generator=gen,
                    device=dev),
        dtype=dtype)
    feats = torch.randn(B, D, generator=gen, device=dev)
    eps, scale = 1e-6, HD ** -0.5
    rows, nb = B * N, bank.num_real
    # H: the flagship bank in int8; D over giant's 1536-wide bank
    qbank = mp.quantize_bank(torch.randn(nb, D, generator=gen, device=dev))
    gbank = mp.prepare_bank(torch.randn(nb, GD, generator=gen, device=dev), dtype=dtype)
    gfeats = torch.randn(B, GD, generator=gen, device=dev)
    # G, A and F at giant's shapes
    xg = randn(B, N, GD)
    gg, bgg, lsg = 1 + randn(GD, scale=0.1), randn(GD, scale=0.1), 1 + randn(GD, scale=0.1)
    swiglu_args = (xg, gg, bgg, randn(GD, 2 * GH, scale=GD ** -0.5),
                   randn(2 * GH, scale=0.1), randn(GH, GD, scale=GH ** -0.5),
                   randn(GD, scale=0.1), lsg)
    ln_dense_g = (xg, gg, bgg, randn(GD, 3 * GD, scale=GD ** -0.5), randn(3 * GD, scale=0.1))
    qkvg = randn(B, N, 3 * GD)
    qkv_proj_g = (qkvg, xg, randn(GD, GD, scale=GD ** -0.5), randn(GD, scale=0.1), lsg)
    dense_res_g = (xg, randn(B, N, GD), *qkv_proj_g[2:])
    # I: the flagship MLP's weights quantized per column
    w8_args = (x, g, bg, *mlp.quantize_mlp_weights(w1.float(), b1.float(), w2.float(),
                                                   b2.float()), ls)
    # H over giant's 1536-wide bank in int8
    qgbank = mp.quantize_bank(torch.randn(nb, GD, generator=gen, device=dev))
    # D and H at a served box batch's rows
    bfeats = torch.randn(B * MAX_BOXES, D, generator=gen, device=dev)
    sdpa = _sdpa(q, k, v, scale)
    # D over the CLIP DeCap configs' 500,000 x 512 bank, at 8 and 128 rows
    cbank = mp.prepare_bank(torch.randn(CLIP_BANK_ROWS, CLIP_D, generator=gen, device=dev),
                            dtype=dtype)
    cfeats = torch.randn(B, CLIP_D, generator=gen, device=dev)
    cbfeats = torch.randn(B * MAX_BOXES, CLIP_D, generator=gen, device=dev)
    # D's library calls: the unit rows made once here, outside the timer
    unit, gunit = _unit_rows(bank, dtype), _unit_rows(gbank, dtype)
    cunit = _unit_rows(cbank, dtype)
    # A, B and C at ViT-L's shapes (DINO.txt's tower: D = 1024, 16 heads of
    # 64, hidden 4096), and D over RegionCLIP's 500,000 x 1024 bank
    xl = randn(B, N, LD)
    gl, bgl, lsl = 1 + randn(LD, scale=0.1), randn(LD, scale=0.1), 1 + randn(LD, scale=0.1)
    ln_dense_l = (xl, gl, bgl, randn(LD, 3 * LD, scale=LD ** -0.5), randn(3 * LD, scale=0.1))
    qkvl = randn(B, N, 3 * LD)
    mlp_l = (xl, gl, bgl, randn(LD, LH, scale=LD ** -0.5), randn(LH, scale=0.1),
             randn(LH, LD, scale=LH ** -0.5), randn(LD, scale=0.1), lsl)
    lbank = mp.prepare_bank(torch.randn(LBANK_ROWS, LD, generator=gen, device=dev), dtype=dtype)
    lunit = _unit_rows(lbank, dtype)

    attn_flops = 4 * B * HEADS * N * N * HD  # QK^T and PV
    gattn_flops = 4 * B * GHEADS * N * N * HD
    mlp_args = (x, g, bg, w1, b1, w2, b2, ls)
    qkv_proj_args = (qkv, x, wproj, bproj, ls)
    return [
        ("ln_dense", "patchioner_tpu_torch/csrc/ln_dense.cu",
         "patchioner_tpu/ops/mlp.py:188",
         lambda: mlp.fused_ln_dense(x, g, bg, wqkv, bqkv, eps=eps),
         lambda: mlp.ln_dense_plain(x, g, bg, wqkv, bqkv, eps=eps), None,
         2 * rows * D * 3 * D, _nbytes(x, g, bg, wqkv, bqkv, qkv)),
        ("qkv_attention", "patchioner_tpu_torch/csrc/qkv_attention.cu",
         "patchioner_tpu/ops/attention.py:220",
         lambda: attention.fused_qkv_attention(qkv, num_heads=HEADS, scale=scale),
         lambda: attention.qkv_attention_plain(qkv, num_heads=HEADS, scale=scale),
         sdpa, attn_flops, _nbytes(qkv, x)),
        ("ln_mlp", "patchioner_tpu_torch/csrc/ln_mlp.cu",
         "patchioner_tpu/ops/mlp.py:114",
         lambda: mlp.fused_ln_mlp(*mlp_args, eps=eps),
         lambda: mlp.ln_mlp_plain(*mlp_args, eps=eps), None,
         4 * rows * D * 4 * D, _nbytes(*mlp_args, x)),
        ("ln_mlp_gelu_approx", "patchioner_tpu_torch/csrc/ln_mlp.cu",
         "patchioner_tpu/ops/mlp.py:114",
         lambda: mlp.fused_ln_mlp(*mlp_args, eps=eps, gelu_approx=True),
         lambda: mlp.ln_mlp_plain(*mlp_args, eps=eps, gelu_approx=True), None,
         4 * rows * D * 4 * D, _nbytes(*mlp_args, x)),
        ("memory_project", "patchioner_tpu_torch/csrc/memory_projection.cu",
         "patchioner_tpu/ops/memory_projection.py:521",
         lambda: mp.memory_project_streamed(feats, bank, normalize=True),
         lambda: mp.memory_project_plain(feats, bank, normalize=True),
         _bank_sdpa(feats, bank, unit, dtype),
         4 * B * nb * D, _nbytes(feats, bank.rows[:nb], bank.inv_norm[:nb], feats)),
        ("dense_residual", "patchioner_tpu_torch/csrc/ln_dense.cu",
         "patchioner_tpu/ops/mlp.py:261",
         lambda: mlp.fused_dense_residual(x, r, wproj, bproj, ls),
         lambda: mlp.dense_residual_plain(x, r, wproj, bproj, ls), None,
         2 * rows * D * D, _nbytes(x, r, wproj, bproj, ls, r)),
        ("qkv_attention_proj", "patchioner_tpu_torch/csrc/qkv_attention_proj.cu",
         "patchioner_tpu/ops/attention.py:342",
         lambda: attention.fused_qkv_attention_proj(*qkv_proj_args, num_heads=HEADS,
                                                    scale=scale),
         lambda: attention.qkv_attention_proj_plain(*qkv_proj_args, num_heads=HEADS,
                                                    scale=scale), None,
         attn_flops + 2 * rows * D * D, _nbytes(*qkv_proj_args, x)),
        ("flash_attention_1pass", "patchioner_tpu_torch/csrc/flash_attention_1pass.cu",
         "patchioner_tpu/ops/attention.py:139",
         lambda: attention.flash_attention_1pass(q, k, v, scale=scale),
         lambda: attention.attention_plain(q, k, v, scale=scale), sdpa,
         attn_flops, _nbytes(q, k, v, q)),
        ("flash_attention", "patchioner_tpu_torch/csrc/flash_attention.cu",
         "patchioner_tpu/ops/attention.py:437",
         lambda: attention.flash_attention(q, k, v, scale=scale),
         lambda: attention.attention_plain(q, k, v, scale=scale), sdpa,
         attn_flops, _nbytes(q, k, v, q)),
        ("ln_swiglu", "patchioner_tpu_torch/csrc/ln_swiglu.cu",
         "patchioner_tpu/ops/mlp.py:515",
         lambda: mlp.fused_ln_swiglu(*swiglu_args, eps=eps),
         lambda: mlp.ln_swiglu_plain(*swiglu_args, eps=eps), None,
         6 * rows * GD * GH, _nbytes(*swiglu_args, xg)),
        ("memory_project_int8", "patchioner_tpu_torch/csrc/memory_projection.cu",
         "patchioner_tpu/ops/memory_projection.py:380",
         lambda: mp.memory_project_int8(feats, qbank, normalize=True),
         lambda: mp.memory_project_int8_plain(feats, qbank, normalize=True), None,
         4 * B * nb * D, _nbytes(feats, *qbank[:-1], feats)),
        ("ln_mlp_w8", "patchioner_tpu_torch/csrc/ln_mlp_w8.cu",
         "patchioner_tpu/ops/mlp.py:381",
         lambda: mlp.fused_ln_mlp_w8(*w8_args, eps=eps),
         lambda: mlp.ln_mlp_w8_plain(*w8_args, eps=eps), None,
         4 * rows * D * 4 * D, _nbytes(*w8_args, x)),
        ("memory_project_giant", "patchioner_tpu_torch/csrc/memory_projection.cu",
         "patchioner_tpu/ops/memory_projection.py:521",
         lambda: mp.memory_project_streamed(gfeats, gbank, normalize=True),
         lambda: mp.memory_project_plain(gfeats, gbank, normalize=True),
         _bank_sdpa(gfeats, gbank, gunit, dtype),
         4 * B * nb * GD, _nbytes(gfeats, gbank.rows, gbank.inv_norm, gfeats)),
        ("ln_dense_giant", "patchioner_tpu_torch/csrc/ln_dense.cu",
         "patchioner_tpu/ops/mlp.py:188",
         lambda: mlp.fused_ln_dense(*ln_dense_g, eps=eps),
         lambda: mlp.ln_dense_plain(*ln_dense_g, eps=eps), None,
         2 * rows * GD * 3 * GD, _nbytes(*ln_dense_g, qkvg)),
        ("qkv_attention_proj_giant", "patchioner_tpu_torch/csrc/qkv_attention_proj.cu",
         "patchioner_tpu/ops/attention.py:342",
         lambda: attention.fused_qkv_attention_proj(*qkv_proj_g, num_heads=GHEADS,
                                                    scale=scale),
         lambda: attention.qkv_attention_proj_plain(*qkv_proj_g, num_heads=GHEADS,
                                                    scale=scale), None,
         gattn_flops + 2 * rows * GD * GD, _nbytes(*qkv_proj_g, xg)),
        ("dense_residual_giant", "patchioner_tpu_torch/csrc/ln_dense.cu",
         "patchioner_tpu/ops/mlp.py:261",
         lambda: mlp.fused_dense_residual(*dense_res_g),
         lambda: mlp.dense_residual_plain(*dense_res_g), None,
         2 * rows * GD * GD, _nbytes(*dense_res_g, xg)),
        ("memory_project_int8_giant", "patchioner_tpu_torch/csrc/memory_projection.cu",
         "patchioner_tpu/ops/memory_projection.py:380",
         lambda: mp.memory_project_int8(gfeats, qgbank, normalize=True),
         lambda: mp.memory_project_int8_plain(gfeats, qgbank, normalize=True), None,
         4 * B * nb * GD, _nbytes(gfeats, *qgbank[:-1], gfeats)),
        ("memory_project_128", "patchioner_tpu_torch/csrc/memory_projection.cu",
         "patchioner_tpu/ops/memory_projection.py:521",
         lambda: mp.memory_project_streamed(bfeats, bank, normalize=True),
         lambda: mp.memory_project_plain(bfeats, bank, normalize=True),
         _bank_sdpa(bfeats, bank, unit, dtype),
         4 * B * MAX_BOXES * nb * D,
         _nbytes(bfeats, bank.rows[:nb], bank.inv_norm[:nb], bfeats)),
        ("memory_project_int8_128", "patchioner_tpu_torch/csrc/memory_projection.cu",
         "patchioner_tpu/ops/memory_projection.py:380",
         lambda: mp.memory_project_int8(bfeats, qbank, normalize=True),
         lambda: mp.memory_project_int8_plain(bfeats, qbank, normalize=True), None,
         4 * B * MAX_BOXES * nb * D, _nbytes(bfeats, *qbank[:-1], bfeats)),
        ("ln_dense_vitl", "patchioner_tpu_torch/csrc/ln_dense.cu",
         "patchioner_tpu/ops/mlp.py:188",
         lambda: mlp.fused_ln_dense(*ln_dense_l, eps=eps),
         lambda: mlp.ln_dense_plain(*ln_dense_l, eps=eps), None,
         2 * rows * LD * 3 * LD, _nbytes(*ln_dense_l, qkvl)),
        ("qkv_attention_vitl", "patchioner_tpu_torch/csrc/qkv_attention.cu",
         "patchioner_tpu/ops/attention.py:220",
         lambda: attention.fused_qkv_attention(qkvl, num_heads=LHEADS, scale=scale),
         lambda: attention.qkv_attention_plain(qkvl, num_heads=LHEADS, scale=scale),
         _sdpa(*attention.split_heads(qkvl, LHEADS), scale),
         4 * B * LHEADS * N * N * HD, _nbytes(qkvl, xl)),
        ("ln_mlp_vitl", "patchioner_tpu_torch/csrc/ln_mlp.cu",
         "patchioner_tpu/ops/mlp.py:114",
         lambda: mlp.fused_ln_mlp(*mlp_l, eps=eps),
         lambda: mlp.ln_mlp_plain(*mlp_l, eps=eps), None,
         4 * rows * LD * LH, _nbytes(*mlp_l, xl)),
    ] + [
        (name, "patchioner_tpu_torch/csrc/memory_projection.cu",
         "patchioner_tpu/ops/memory_projection.py:521",
         lambda f=f, k=k: mp.memory_project_streamed(f, k, normalize=True),
         lambda f=f, k=k: mp.memory_project_plain(f, k, normalize=True),
         _bank_sdpa(f, k, u, dtype), 4 * f.shape[0] * k.num_real * f.shape[1],
         _nbytes(f, k.rows[:k.num_real], k.inv_norm[:k.num_real], f))
        for name, f, k, u in (
            ("memory_project_clip", cfeats, cbank, cunit),
            ("memory_project_clip_128", cbfeats, cbank, cunit),
            ("memory_project_vitl", torch.randn(B, LD, generator=gen, device=dev), lbank, lunit),
            ("memory_project_vitl_128", torch.randn(B * MAX_BOXES, LD, generator=gen, device=dev),
             lbank, lunit))]


def phase_kernels(seed: int) -> dict:
    """Each kernel against its plain version, timed beside its bound and its
    library call; the JSON summary's rows (bf16). A library call shared by
    several kernels (SDPA on the attention's q, k, v) is timed once. D's
    SDPA is held to D's plain version: within D's 1e-4 in f32; in bf16 its
    q is rounded to bf16 as its k and v must be (D keeps f in f32), so it
    takes the bf16 bound."""
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        library_cache = {}
        for (name, source, replaces, kern, plain, library, flops,
             nbytes) in _kernel_cases(dtype, gen):
            tol = TOLERANCE[torch.float32 if name in PROJECTIONS else dtype]
            if name == "ln_mlp_w8" and dtype == torch.float32:
                tol = W8_F32_TOLERANCE
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            if got.shape != ref.shape or not torch.isfinite(got).all():
                raise AssertionError(f"{name} {dtype}: shape {tuple(got.shape)} "
                                     f"vs {tuple(ref.shape)} or non-finite output")
            err = (got.float() - ref.float()).abs().max().item()
            rel = err / max(ref.float().abs().max().item(), 1e-30)
            ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
            peak_type = dtype
            if name == "ln_mlp_w8":
                peak_type = torch.int8
            elif name.startswith("memory_project_int8"):  # H: always tensor cores
                peak_type = torch.bfloat16
            peak = PEAK_FLOPS[peak_type]
            op_ms, byte_ms = flops / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
            bound_ms = max(op_ms, byte_ms)
            library_ms = None
            if name == "memory_project_int8":
                log(f"[kernels] {name}: no library call (no PyTorch call reads an int8 bank)")
            if library is not None:
                if library not in library_cache:
                    # D's SDPA takes tens of ms (one block of queries): fewer timings
                    reps = dict(warmup=1, iters=3) if name in PROJECTIONS else {}
                    library_cache[library] = cuda_ms(library, **reps)
                    log(f"[kernels] scaled_dot_product_attention {str(dtype)[6:]} for {name}, "
                        f"backend {library.backend}: {library_cache[library]:.4f} ms")
                library_ms = library_cache[library]
                if name in PROJECTIONS:
                    from torch.nn.attention import SDPBackend, sdpa_kernel

                    with sdpa_kernel(SDPBackend.MATH):
                        log(f"[kernels] the same call on the math backend (printed only): "
                            f"{cuda_ms(library, warmup=1, iters=3):.4f} ms")
                    out = library().float()
                    out = out.reshape(ref.shape) / out.reshape(ref.shape).norm(dim=-1,
                                                                              keepdim=True)
                    lib_err = (out - ref).abs().max().item()
                    lib_rel = lib_err / max(ref.abs().max().item(), 1e-30)
                    lib_tol = TOLERANCE[dtype]
                    log(f"[kernels] {name} {str(dtype)[6:]}: SDPA (output normalised outside "
                        f"the timed call) vs plain max|d|={lib_err:.3e} rel={lib_rel:.3e} "
                        f"(tol {lib_tol:.0e})")
                    if not lib_rel <= lib_tol:
                        raise AssertionError(f"{name} {dtype}: SDPA is not the projection's "
                                             f"function: rel error {lib_rel:.3e}")
                    del out
            log(f"[kernels] {name} {str(dtype)[6:]}: max|d|={err:.3e} "
                f"rel={rel:.3e} (tol {tol:.0e}) kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({flops / 1e9:.1f} G operations, {nbytes / 1e6:.1f} MB)")
            if name in PROJECTIONS:
                rate = nbytes / (ms * 1e-3)
                log(f"[kernels] {name} {str(dtype)[6:]}: {rate / 1e9:.1f} GB/s, "
                    f"{rate / PEAK_BYTES_PER_S:.3f} of {PEAK_BYTES_PER_S / 1e12:.2f} TB/s")
            if not rel <= tol:
                raise AssertionError(f"{name} {dtype}: rel error {rel:.3e} > {tol:.0e}")
            if dtype == torch.bfloat16 and name in _wrappers():  # the main path's type
                summary[name] = {
                    "name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": None, "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": "operations" if op_ms >= byte_ms else "bytes",
                    "library_ms": library_ms}
            del got, ref
        torch.cuda.empty_cache()
    return summary


def _wrappers() -> dict:
    """Every kernel wrapper, in the order of the kernel table (A-K)."""
    from patchioner_tpu_torch.ops import attention, memory_projection as mp, mlp

    return {"ln_dense": mlp.fused_ln_dense,
            "qkv_attention": attention.fused_qkv_attention,
            "ln_mlp": mlp.fused_ln_mlp,
            "memory_project": mp.memory_project_streamed,
            "dense_residual": mlp.fused_dense_residual,
            "qkv_attention_proj": attention.fused_qkv_attention_proj,
            "ln_swiglu": mlp.fused_ln_swiglu,
            "memory_project_int8": mp.memory_project_int8,
            "ln_mlp_w8": mlp.fused_ln_mlp_w8,
            "flash_attention_1pass": attention.flash_attention_1pass,
            "flash_attention": attention.flash_attention}


def expected_launches(model, batches: int) -> dict:
    """Launches of every kernel for `batches` batches of `model`: on a
    DINOv2 tower (ProxyCLIP's VFM too) A each layer, C (G for ViT-g's
    SwiGLU FFN) each layer, the attention kernel `attn_impl` selects each
    layer (none for the compute-type softmax of `softmax_f32: false`, plain
    PyTorch as in the reference; a CLIP tower and RegionCLIP's ResNet are
    plain PyTorch: none);
    D (H over an int8 bank) once a batch when the configuration has a
    support memory and the model decodes (none in the argmax-text mode,
    which reads the bank's texts); every other kernel never."""
    config = model.config
    kind = model.backbone_type
    cfg = model.vit_cfg.vfm if kind == "ProxyCLIP" else model.vit_cfg
    counts = dict.fromkeys(_wrappers(), 0)
    if kind in ("DINO", "ProxyCLIP"):
        impl = cfg.attn_impl
        layer = {"ln_dense", "ln_swiglu" if cfg.ffn == "swiglu" else "ln_mlp"}
        if impl in ("xla", "fusedqkv") and cfg.softmax_f32:
            layer.add("qkv_attention")
            if cfg.proj_fused:
                layer.add("dense_residual")
        layer |= {"fusedqkv_proj": {"qkv_attention_proj"}, "flash": {"flash_attention"},
                  "flash1p": {"flash_attention_1pass"}}.get(impl, set())
        counts.update({name: cfg.depth * batches for name in layer})
    if (int(config.get("support_memory_size", 0)) > 0  # a ViECap model has no bank
            and not getattr(model, "calculate_argmax_text", False)):
        counts["memory_project_int8" if config.get("memory_bank_int8")
               else "memory_project"] = batches
    return counts


def _requests(n: int, seed: int, img: int = IMG):
    """n seeded uint8 images of img px and traces of 2..64 points in [0, 1]."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, img, img, 3), dtype=np.uint8)
    traces = [rng.uniform(0, 1, (int(rng.integers(2, 65)), 2)).tolist()
              for _ in range(n)]
    return imgs, traces


def _padded(traces):
    """Traces as the (n, 64, 2) points and (n, 64) valid mask the model takes."""
    pts = np.zeros((len(traces), 64, 2), np.float32)
    valid = np.zeros((len(traces), 64), np.float32)
    for i, tr in enumerate(traces):
        pts[i, : len(tr)] = tr
        valid[i, : len(tr)] = 1.0
    return pts, valid


def build_model(config: dict, seed: int, tag: str):
    """The port's model of `config` in bf16 on the card, seeded random
    weights and bank."""
    from patchioner_tpu_torch.models.patchioner import Patchioner

    t0 = time.perf_counter()
    model = Patchioner.from_config(config, rng_seed=seed, allow_missing_weights=True,
                                   dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    bank = ("none" if model.bank is None else f"{model.bank.num_real} x "
            f"{model.bank.rows.shape[1]} {str(model.bank.rows.dtype)[6:]}")
    log(f"{tag} {config.get('dino_model')}: model built in "
        f"{time.perf_counter() - t0:.1f} s: {_tower(model)} at "
        f"{model.crop_dim} px, bank {bank}, decoder "
        f"{model.gpt2_cfg.n_layer}L/{model.gpt2_cfg.n_head}H/"
        f"{model.gpt2_cfg.n_embd}, vocab {model.gpt2_cfg.vocab_size}")
    return model


def _tower(model) -> str:
    """The backbone's geometry, for the logs."""
    cfg, kind = model.vit_cfg, model.backbone_type

    def vit_desc(c):
        return (f"{c.depth} layers x D={c.embed_dim}, {c.num_heads} heads ({c.ffn} FFN "
                f"{c.ffn_hidden}), {c.num_tokens} tokens")

    if kind == "DINO":
        return vit_desc(cfg)
    if kind == "RegionCLIP":
        return (f"RegionCLIP ResNet, layers {cfg.layers} x width {cfg.width}, pool of "
                f"{cfg.heads} heads over {cfg.num_tokens} tokens to {cfg.output_dim}")
    c = cfg.clip if kind == "ProxyCLIP" else cfg
    clip_desc = (f"{c.depth} layers x D={c.width}, {c.heads} heads, patch {c.patch_size}, "
                 f"projection {c.proj_dim}")
    if kind == "ProxyCLIP":
        return f"ProxyCLIP: CLIP {clip_desc}; VFM {vit_desc(cfg.vfm)}"
    return f"{kind} tower, {clip_desc}, {c.num_tokens} tokens"


def _check_graphs(decoder, before: tuple, batches: int, tag: str) -> None:
    """The decoder replayed its CUDA graph at least once a served batch and
    captured none: `before` is its (captures, replays) before serving."""
    captured, replayed = decoder.captures - before[0], decoder.replays - before[1]
    log(f"{tag} decode graphs: {replayed} replays and {captured} captures for "
        f"{batches} served batches ({decoder.captures} graphs in all)")
    if captured or replayed < batches:
        raise AssertionError(f"{tag} the served batches did not all replay a captured "
                             f"decode graph: {captured} captures, {replayed} replays")


def _serve(model, requests: list, tag: str,
           kind: str = "trace") -> tuple[list, dict, int, float, dict]:
    """Serve (image, submit keywords) requests of one kind through a new
    server: its `warmup()` of every bucket first, then every launch counter
    zeroed; assert the counts, and that each batch replayed a DeCap decode
    graph that warm-up had captured (on a ViECap, MeaCap or ClipCap model:
    that the DeCap decoder neither captured nor replayed one); (results,
    the server's snapshot, batches, wall s, launch counts)."""
    from patchioner_tpu_torch.serve import CaptionServer

    wrappers = _wrappers()
    with CaptionServer(model, max_batch=B, max_delay_ms=200.0,
                       max_boxes=MAX_BOXES) as server:
        server.warmup(trace=kind == "trace", cls=kind == "cls", bbox=kind == "bbox",
                      region_set=kind == "region_set", pixel_dtype=np.uint8)
        for fn in wrappers.values():
            fn.launches = 0
        decode = model.decode  # None on an argmax-text model, which has no decoder
        graphs = None if decode is None else (decode.captures, decode.replays)
        t0 = time.perf_counter()
        futures = [server.submit(im, **kw) for im, kw in requests]
        results = [f.result(timeout=900) for f in futures]
        wall = time.perf_counter() - t0
        snap = server.snapshot()
        batches = server.stats.batches
    counts = {name: fn.launches for name, fn in wrappers.items()}
    expected = expected_launches(model, batches)
    log(f"{tag} {len(results)} requests answered in {batches} batches; "
        f"launches {counts}, expected {expected}")
    if counts != expected:
        raise AssertionError(f"launch counts {counts} != {expected}")
    if decode is None:
        if "decode_captures" in snap:
            raise AssertionError(f"{tag} a model without a decoder reported decode graphs")
    elif model.viecap is None and model.clipcap is None and not model.calculate_argmax_text:
        _check_graphs(decode, graphs, batches, tag)
    elif (decode.captures, decode.replays) != graphs:
        raise AssertionError(f"{tag} the DeCap decoder ran on a ViECap, MeaCap, ClipCap or "
                             "argmax-text model")
    return results, snap, batches, wall, counts


def _host_ms(fn) -> float:
    """Median of 3 host-clock times of fn(), the card synchronised before
    and after each."""
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    return statistics.median(times) * 1e3


def phase_main_path(seed: int, smi: str, label: str = "main", opts=None,
                    n_requests: int = 2 * B, base: dict = FLAGSHIP_CONFIG,
                    model=None, warm: bool = False,
                    rates: dict | None = None) -> tuple[dict, list]:
    """Serve `n_requests` trace requests through the `base` config (the
    flagship's by default) plus `opts`, on `model` if given (kept) or on
    one built here (dropped); returns the launch counts of the served run
    and the captions, and puts the served captions/s into `rates[label]`
    when given. With `warm`, two new servers serve one batch each, the
    second after its `warmup()`."""
    from patchioner_tpu_torch import entry

    tag = f"[{label}]"
    own = model is None
    if own:
        model = build_model(dict(base, **(opts or {})), seed, f"{tag} {opts or ''}")
    config = model.config

    imgs, traces = _requests(2 * B, seed)
    imgs, traces = imgs[:n_requests], traces[:n_requests]
    # one direct batch first, outside the counted run: first-call set-up
    pts, valid = _padded(traces[:B])
    model.caption_traces_fused(imgs[:B], pts, valid)

    captions, snap, _, wall, counts = _serve(
        model, [(im, {"trace": tr}) for im, tr in zip(imgs, traces)], tag)
    if not all(isinstance(c, str) for c in captions):
        raise AssertionError("a request did not resolve to a caption string")
    log(f"{tag} caption 0: {captions[0][:80]!r}")

    # the served path's projected prefixes: finite, (B, D), unit norm
    step = entry.make_prefix_step(model.vit_cfg, model.bank.num_real,
                                  use_attention=False, normalize=model.normalize)
    prefix = step(model.state(), model.pixels_to_device(imgs[:B]),
                  torch.from_numpy(pts).cuda(), torch.from_numpy(valid).cuda())
    norm_err = (prefix.norm(dim=-1) - 1).abs().max().item()
    log(f"{tag} prefix {tuple(prefix.shape)}, finite "
        f"{bool(torch.isfinite(prefix).all())}, max |norm - 1| {norm_err:.2e}")
    width = int(config["prefix_size"])
    if prefix.shape != (B, width) or not torch.isfinite(prefix).all() or norm_err > 1e-3:
        raise AssertionError("the main path's projected prefix is malformed")

    # steady-state batch time, outside the server
    batch_ms = _host_ms(lambda: model.caption_traces_fused(imgs[:B], pts, valid))
    if rates is not None:
        rates[label] = len(captions) / wall
    log(f"{tag} {len(captions) / wall:.3f} captions/s through the server "
        f"({wall:.3f} s for {len(captions)}), mean request latency "
        f"{snap['mean_latency_ms']} ms, batch of {B}: {batch_ms:.1f} ms "
        f"(median of 3); {smi}")
    if warm:
        # two more new servers' first batches: one cold again, one after
        # warmup(), which runs its dummy batch on the server's worker thread
        from patchioner_tpu_torch.serve import CaptionServer

        for use_warmup in (False, True):
            with CaptionServer(model, max_batch=B, max_delay_ms=200.0) as server:
                t0 = time.perf_counter()
                if use_warmup:
                    server.warmup(buckets=[B], pixel_dtype=np.uint8)
                warm_s = time.perf_counter() - t0
                graphs = model.decode.captures, model.decode.replays
                futures = [server.submit(im, tr) for im, tr in zip(imgs[:B], traces[:B])]
                warm_caps = [f.result(timeout=900) for f in futures]
                warm_snap = server.snapshot()
            if use_warmup:
                _check_graphs(model.decode, graphs, warm_snap["batches"], tag)
            if not all(isinstance(c, str) for c in warm_caps):
                raise AssertionError("a request of a new server did not resolve to a caption")
            what = f"after warmup() ({warm_s:.3f} s)" if use_warmup else "without warmup()"
            log(f"{tag} a new server's first batch {what}: mean request latency "
                f"{warm_snap['mean_latency_ms']} ms in {warm_snap['batches']} batch(es), "
                f"against {snap['mean_latency_ms']} ms for the first server's; {smi}")
    if own:
        del model
        torch.cuda.empty_cache()
    return counts, captions


def _query_boxes(n: int, seed: int) -> list:
    """n sets of 1-16 normalised xyxy boxes (the first 16), seeded."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = MAX_BOXES if i == 0 else int(rng.integers(1, MAX_BOXES + 1))
        lo = rng.uniform(0, 0.7, (k, 2))
        hi = np.minimum(lo + rng.uniform(0.05, 0.5, (k, 2)), 1.0)
        out.append(np.concatenate([lo, hi], -1).tolist())
    return out


def _pixel_boxes(sets: list, pad, img: int = IMG, max_boxes: int = MAX_BOXES) -> np.ndarray:
    """Normalised xyxy box sets as the server hands them to the model:
    (n, max_boxes, 4) pixel [x1, y1, w, h] of an img px image, padded with
    `pad`."""
    boxes = np.tile(np.asarray(pad, np.float32), (len(sets), max_boxes, 1))
    for i, bs in enumerate(sets):
        b = np.asarray(bs, np.float32)[:max_boxes] * img
        boxes[i, : len(b)] = np.concatenate([b[:, :2], b[:, 2:] - b[:, :2]], -1)
    return boxes


def phase_other_queries(model, seed: int, smi: str) -> dict:
    """Phase 4e: whole-image, box and region-set requests, one batch of B
    each, through the server on `model`; returns each kind's launches."""
    from patchioner_tpu_torch import entry
    from patchioner_tpu_torch.models import decap

    imgs, _ = _requests(B, seed + 3)
    sets = _query_boxes(B, seed + 4)
    direct = {
        "cls": lambda: model.caption_images_fused(imgs),
        "bbox": lambda: model.caption_bboxes_fused(imgs, _pixel_boxes(sets, [0, 0, 1, 1])),
        "region_set": lambda: model.caption_region_sets_fused(
            imgs, _pixel_boxes(sets, [-1] * 4)),
    }
    requests = {
        "cls": [(im, {}) for im in imgs],
        "bbox": [(im, {"bboxes": bs}) for im, bs in zip(imgs, sets)],
        "region_set": [(im, {"bboxes": bs, "region_set": True})
                       for im, bs in zip(imgs, sets)],
    }
    rows = {"cls": B, "bbox": B * MAX_BOXES, "region_set": B}
    launches = {}
    for kind, call in direct.items():
        tag = f"[queries {kind}]"
        t0 = time.perf_counter()
        call()  # first call, outside the counted run
        first_ms = (time.perf_counter() - t0) * 1e3
        results, snap, batches, wall, launches[kind] = _serve(model, requests[kind], tag,
                                                              kind)
        for (_, kw), res in zip(requests[kind], results):
            want = len(kw["bboxes"]) if kind == "bbox" else None
            if (not isinstance(res, str) if want is None else
                    not (isinstance(res, list) and len(res) == want
                         and all(isinstance(c, str) for c in res))):
                raise AssertionError(f"{tag} a request resolved to {res!r}")
        log(f"{tag} result 0: {str(results[0])[:80]!r}")
        if kind == "bbox":
            n_boxes = sum(len(bs) for bs in sets)
            log(f"{tag} {n_boxes} boxes: {n_boxes / wall:.3f} box captions/s "
                "through the server")
        batch_ms = _host_ms(call)
        log(f"{tag} {len(results) / wall:.3f} requests/s through the server "
            f"({wall:.3f} s for {len(results)} in {batches} batch(es), {rows[kind]} rows "
            f"projected and decoded a batch), mean request latency "
            f"{snap['mean_latency_ms']} ms, first direct batch {first_ms:.1f} ms, "
            f"batch of {B}: {batch_ms:.1f} ms (median of 3); {smi}")

    # the box batch apart: its (128, D) prefix, finite and unit norm, and
    # the prefix step and the 128-row decode each timed
    step = entry.make_prefix_step(model.vit_cfg, model.bank.num_real,
                                  normalize=model.normalize,
                                  pool=entry.make_bbox_pool(model.patch_size))
    px = model.pixels_to_device(imgs)
    boxes = torch.from_numpy(_pixel_boxes(sets, [0, 0, 1, 1])).cuda()
    prefix = step(model.state(), px, boxes)
    norm_err = (prefix.norm(dim=-1) - 1).abs().max().item()
    if (prefix.shape != (B * MAX_BOXES, int(model.config["prefix_size"]))
            or not torch.isfinite(prefix).all() or norm_err > 1e-3):
        raise AssertionError(f"the box batch's prefix is malformed: {tuple(prefix.shape)}, "
                             f"max |norm - 1| {norm_err:.2e}")

    prefix_ms = _host_ms(lambda: step(model.state(), px, boxes))
    decode_ms = {(how, rows): _host_ms(lambda: fn(prefix[:rows]))
                 for how, fn in (("graph", model.decode), ("eager", lambda p: decap.greedy_decode(
                     model.decoder, p, model.gpt2_cfg)))
                 for rows in (B * MAX_BOXES, B)}
    log(f"[queries bbox] prefix {tuple(prefix.shape)}, max |norm - 1| {norm_err:.2e}; "
        f"encoder + pool + projection {prefix_ms:.1f} ms, decode of {B * MAX_BOXES} rows "
        f"{decode_ms['graph', B * MAX_BOXES]:.1f} ms as a graph "
        f"({decode_ms['eager', B * MAX_BOXES]:.1f} eager), of {B} rows "
        f"{decode_ms['graph', B]:.1f} ms ({decode_ms['eager', B]:.1f} eager) "
        f"(host clock, median of 3); {smi}")
    return launches


def _kernel_count(fn) -> tuple[int, float]:
    """(CUDA kernels launched, their device ms) in one call of fn(), by
    torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (sum(e.count for e in events),
            sum(e.self_device_time_total for e in events) / 1e3)


def phase_decode_graph(model, seed: int, smi: str) -> None:
    """The decode as one CUDA graph against the eager loop (its plain
    version, `decap.greedy_decode`) on the same prefixes, on the flagship's
    decoder weights in bf16 and in f32, at B and at a box batch's B * 16
    rows: tokens equal, scores within SCORE_TOLERANCE relative; then a
    batch with NaN rows and after it a clean batch, whose tokens must still
    be the eager loop's. Each decoder here is new, so that the memory of
    its graphs shows. With the DeCap init's wte (std 0.02) the logits are
    near uniform and 30 steps' scores underflow to 0; wte is scaled by 10
    here so that the scores are compared as numbers."""
    from patchioner_tpu_torch.models import decap

    master = model.decoder
    sharp = master._replace(gpt2=dict(master.gpt2, wte=master.gpt2["wte"] * 10))
    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    width = master.clip_project["w"].shape[0]

    def prefixes(rows):
        return torch.nn.functional.normalize(
            torch.randn(rows, width, generator=gen, device="cuda"), dim=-1)

    for dtype in (torch.bfloat16, torch.float32):
        cfg = dataclasses.replace(model.gpt2_cfg, dtype=dtype)
        tag = f"[decode graph {str(dtype)[6:]}]"
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        decoder = decap.GreedyDecoder(sharp, cfg, model.entry_length)
        weights = torch.cuda.memory_reserved() - reserved
        for rows in (B, B * MAX_BOXES):
            clean, later = prefixes(rows), prefixes(rows)
            tokens, scores = decoder(clean)
            torch.cuda.empty_cache()
            want_tokens, want_scores = decap.greedy_decode(sharp, clean, cfg)
            nan = clean.clone()
            nan[::3] = float("nan")
            nan_tokens, _ = decoder(nan)
            later_tokens, _ = decoder(later)
            nan_same = torch.equal(nan_tokens, decap.greedy_decode(sharp, nan, cfg)[0])
            later_same = torch.equal(later_tokens, decap.greedy_decode(sharp, later, cfg)[0])
            score_err = ((scores - want_scores).abs()
                         / want_scores.abs().clamp_min(1e-30)).max().item()
            graph_ms = cuda_ms(lambda: decoder(clean))
            eager_ms = cuda_ms(lambda: decap.greedy_decode(sharp, clean, cfg))
            graph_kernels, graph_device_ms = _kernel_count(lambda: decoder(clean))
            eager_kernels, _ = _kernel_count(
                lambda: decap._decode(decoder.params, clean, cfg, decoder.n_steps))
            steps = decoder.n_steps
            log(f"{tag} {rows} rows: tokens equal {torch.equal(tokens, want_tokens)}, "
                f"scores > 0: {int((want_scores > 0).sum())}/{rows}, max rel score error "
                f"{score_err:.3e} (tol {SCORE_TOLERANCE[dtype]:.0e}); after a batch with "
                f"{int(nan.isnan().any(1).sum())} NaN rows (their tokens equal eager's: "
                f"{nan_same}) a clean batch's tokens equal eager's: {later_same}")
            log(f"{tag} {rows} rows: graph {graph_ms:.3f} ms, eager {eager_ms:.3f} ms "
                f"(CUDA events, median of 10); the graph's kernels {graph_device_ms:.3f} ms "
                f"of device time; {eager_kernels / steps:.1f} launches a step eager, "
                f"{graph_kernels / steps:.1f} kernels a step in the graph; "
                f"{decoder.captures} graphs, {decoder.replays} replays; {smi}")
            if not (torch.equal(tokens, want_tokens) and later_same
                    and score_err <= SCORE_TOLERANCE[dtype]):
                raise AssertionError(f"{tag} {rows} rows: the graph's decode differs "
                                     "from the eager loop's")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"{tag} {decoder.captures} graphs (rows {B} and {B * MAX_BOXES}) hold "
            f"{(torch.cuda.memory_reserved() - reserved - weights) / 2**20:.1f} MiB, "
            f"the cast weights {weights / 2**20:.1f} MiB")
        del decoder
    del sharp
    torch.cuda.empty_cache()


def _gate(label: str, got: torch.Tensor, ref: torch.Tensor, what: str,
          noun: str = "prefix") -> None:
    """The f32 gate (on the prefix by default): max|got - ref| <= 1e-4 *
    max(1, max|ref|)."""
    if got.shape != ref.shape:
        raise AssertionError(f"f32 {noun} {what}: {tuple(got.shape)} vs {tuple(ref.shape)}")
    err = (got - ref).abs().max().item()
    tol = 1e-4 * max(1.0, ref.abs().max().item())
    log(f"[{label}] {noun} {what}: max|d|={err:.3e} (tol {tol:.3e})")
    if not err <= tol:
        raise AssertionError(f"f32 {noun} {what} differs: {err:.3e} > {tol:.3e}")


def phase_f32_crosscheck(seed: int, config: dict = FLAGSHIP_CONFIG, label: str = "f32",
                         configs: dict = None, queries: bool = False) -> None:
    """The f32 prefix of `config` on the card against the CPU; with
    `queries` also those of the box path (attention-map weights), the
    region-set path (Gaussian weights) and the whole image
    (`avg_self_attn`); then, for each of `configs`, the trace prefix
    against the `fusedqkv` one on the card."""
    from patchioner_tpu_torch import entry
    from patchioner_tpu_torch.models.patchioner import Patchioner

    gpu = Patchioner.from_config(config, rng_seed=seed, allow_missing_weights=True,
                                 dtype=torch.float32, device="cuda")
    # the random init's layerscale of 1e-5 would leave the residual stream
    # almost untouched by the kernels; draw it per channel near 1 instead
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    for blk in gpu.vit_params["blocks"]:
        for key in ("ls1", "ls2"):
            blk[key] = 1 + 0.1 * torch.randn(blk[key].shape, generator=gen,
                                             device="cuda")
    cpu = gpu.to("cpu")
    imgs, traces = _requests(2, seed + 1)
    pts, valid = _padded(traces)
    sets = _query_boxes(2, seed + 5)

    def prefix(m, vit_cfg, what="trace", pool=None, args=(pts, valid)):
        step = entry.make_prefix_step(vit_cfg, m.bank.num_real, use_attention=True,
                                      normalize=m.normalize, pool=pool)
        t0 = time.perf_counter()
        out = step(m.state(), m.pixels_to_device(imgs),
                   *(torch.from_numpy(a).to(m.device) for a in args))
        log(f"[{label}] {what} prefix on {m.device}, attn_impl={vit_cfg.attn_impl!r}, "
            f"proj_fused={vit_cfg.proj_fused}: {time.perf_counter() - t0:.1f} s")
        return out

    on_card = prefix(gpu, gpu.vit_cfg)
    ref = prefix(cpu, cpu.vit_cfg)
    _gate(label, on_card.cpu(), ref, "card vs CPU")
    tok_gpu, _ = gpu.decode(on_card)
    tok_cpu, _ = cpu.decode(ref)
    agree = (tok_gpu.cpu() == tok_cpu).float().mean().item()
    log(f"[{label}] caption-token agreement card vs CPU (reported, not asserted): "
        f"{agree:.4f}")
    del cpu, ref, tok_cpu
    if queries:
        patch = gpu.patch_size
        for what, pool, args in (
                ("bbox attention-map", entry.make_bbox_pool(patch, use_attn_map=True),
                 (_pixel_boxes(sets, [0, 0, 1, 1]),)),
                ("region-set gaussian", entry.make_region_set_pool(patch, gaussian_avg=True),
                 (_pixel_boxes(sets, [-1] * 4),)),
                ("avg_self_attn", entry.make_image_pool("avg_self_attn"), ())):
            on_card = prefix(gpu, gpu.vit_cfg, what, pool, args)
            cpu = gpu.to("cpu")
            _gate(label, on_card.cpu(), prefix(cpu, cpu.vit_cfg, what, pool, args),
                  f"{what} card vs CPU")
            del cpu
    # phase 5b: each further attention configuration against fusedqkv's
    fusedqkv = dataclasses.replace(gpu.vit_cfg, attn_impl="fusedqkv")
    base = prefix(gpu, fusedqkv) if configs else None
    for name, opts in (configs or {}).items():
        _gate(label, prefix(gpu, dataclasses.replace(fusedqkv, **opts)), base,
              f"{name} vs fusedqkv on the card")
    del gpu
    torch.cuda.empty_cache()


def _cpu(sd: dict) -> dict:
    """A state dict of contiguous f32 CPU tensors, each with a storage of its
    own, as `torch.save` should write it."""
    return {k: v.detach().to("cpu", torch.float32).clone(memory_format=torch.contiguous_format)
            for k, v in sd.items()}


def hub_state_dict(tree: dict) -> dict:
    """A port ViT tree as a torch.hub DINOv2 state dict, the inverse of
    `io.torch_port.port_dinov2`: an `nn.Linear` weight is (out, in), the
    patch conv (D, 3, P, P)."""
    d = tree["cls_token"].shape[-1]
    p = int(round((tree["patch_embed"]["w"].shape[0] // 3) ** 0.5))
    sd = {"cls_token": tree["cls_token"], "pos_embed": tree["pos_embed"],
          "patch_embed.proj.weight": tree["patch_embed"]["w"].reshape(p, p, 3, d)
          .permute(3, 2, 0, 1),
          "patch_embed.proj.bias": tree["patch_embed"]["b"],
          "norm.weight": tree["norm"]["scale"], "norm.bias": tree["norm"]["bias"]}
    if "register_tokens" in tree:
        sd["register_tokens"] = tree["register_tokens"]
    linears = {"qkv": "attn.qkv", "proj": "attn.proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2",
               "w12": "mlp.w12", "w3": "mlp.w3"}
    for i, blk in enumerate(tree["blocks"]):
        for key in ("norm1", "norm2"):
            sd[f"blocks.{i}.{key}.weight"] = blk[key]["scale"]
            sd[f"blocks.{i}.{key}.bias"] = blk[key]["bias"]
        for key, name in linears.items():
            if key in blk:
                sd[f"blocks.{i}.{name}.weight"] = blk[key]["w"].t()
                sd[f"blocks.{i}.{name}.bias"] = blk[key]["b"]
        for key in ("ls1", "ls2"):
            if key in blk:
                sd[f"blocks.{i}.{key}.gamma"] = blk[key]
    return _cpu(sd)


def gpt2_state_dict(g: dict, prefix: str) -> dict:
    """A port GPT-2 tree as a transformers GPT2LMHeadModel state dict under
    `prefix` (Conv1D weights stay (in, out)), the inverse of
    `io.torch_port.port_hf_gpt2_lmhead`."""
    t = f"{prefix}transformer"
    sd = {f"{t}.wte.weight": g["wte"], f"{t}.wpe.weight": g["wpe"],
          f"{t}.ln_f.weight": g["ln_f"]["scale"], f"{t}.ln_f.bias": g["ln_f"]["bias"]}
    for i, blk in enumerate(g["blocks"]):
        for key in ("ln_1", "ln_2"):
            sd[f"{t}.h.{i}.{key}.weight"] = blk[key]["scale"]
            sd[f"{t}.h.{i}.{key}.bias"] = blk[key]["bias"]
        for part in ("attn", "mlp"):
            for key, dense in blk[part].items():
                sd[f"{t}.h.{i}.{part}.{key}.weight"] = dense["w"]
                sd[f"{t}.h.{i}.{part}.{key}.bias"] = dense["b"]
    return sd


def decap_state_dict(params) -> dict:
    """Port DecapParams as a DeCap checkpoint, the inverse of
    `io.torch_port.port_decap`: the GPT-2 under decoder.*, the prefix
    linear under clip_project.model.0 as an `nn.Linear`."""
    return _cpu(gpt2_state_dict(params.gpt2, "decoder.") | {
        "clip_project.model.0.weight": params.clip_project["w"].t(),
        "clip_project.model.0.bias": params.clip_project["b"]})


def viecap_state_dict(mapping: dict, gpt, p: str = "mapping_network.") -> dict:
    """A port mapping network and GPT-2 as a ViECap checkpoint, the inverse
    of `models.viecap.port_mapping_network` and `port_hf_gpt2_lmhead`: the
    mapping network under `p` (each `nn.Linear` (out, in); the attention's
    query and key-value linears without bias) and, unless `gpt` is None,
    gpt.*. ClipCap's transformer mapper is the same network under
    clip_project.*."""
    sd = {f"{p}linear.weight": mapping["linear"]["w"].t(),
          f"{p}linear.bias": mapping["linear"]["b"],
          f"{p}prefix_const": mapping["prefix_const"]}
    for i, layer in enumerate(mapping["layers"]):
        q = f"{p}transformer.layers.{i}"
        for key, name in (("norm1", "norm1"), ("norm2", "norm2"),
                          ("to_queries", "attn.to_queries"),
                          ("to_keys_values", "attn.to_keys_values"),
                          ("project", "attn.project"), ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            leaf = layer[key]
            w, b = (leaf["scale"], leaf["bias"]) if "scale" in leaf else (leaf["w"].t(), leaf["b"])
            sd[f"{q}.{name}.weight"] = w
            if b is not None:
                sd[f"{q}.{name}.bias"] = b
    return _cpu(sd if gpt is None else sd | gpt2_state_dict(gpt, "gpt."))


def clipcap_state_dict(mapper: dict, gpt: dict) -> dict:
    """A port MLP mapper and GPT-2 as a ClipCap checkpoint, the inverse of
    `models.clipcap.port_clipcap`: clip_project.model.0 and .2 as
    `nn.Linear`s (out, in), and gpt.*."""
    sd = {}
    for i, key in ((0, "fc1"), (2, "fc2")):
        sd[f"clip_project.model.{i}.weight"] = mapper[key]["w"].t()
        sd[f"clip_project.model.{i}.bias"] = mapper[key]["b"]
    return _cpu(sd | gpt2_state_dict(gpt, "gpt."))


def talk2dino_state_dict(linear: dict) -> dict:
    """A Talk2DINO ProjectionLayer with no hidden layer: its linear_layer
    (CLIP -> DINO, {'w': (clip, dino), 'b'}) as an `nn.Linear`."""
    return _cpu({"linear_layer.weight": linear["w"].t(), "linear_layer.bias": linear["b"]})


def write_checkpoints(seed: int, directory: str) -> dict:
    """The flagship's weights at full width, seeded, written with `torch.save`
    in the published layouts: a torch.hub DINOv2 ViT-B/14-reg (layerscale
    drawn near 1, so that the blocks move the residual stream), a DeCap
    decoder (wte scaled by 10, as phase 4f does, so that 30 steps' scores
    do not underflow to 0), a second DeCap file whose prefix linear maps
    CLIP's 512 -> 768, and a Talk2DINO projection 512 -> 768; the paths."""
    from patchioner_tpu_torch.models import decap, gpt2, vit

    gen = torch.Generator().manual_seed(seed + 8)
    tree = vit.init_vit(vit.config_for(FLAGSHIP_CONFIG["dino_model"]), gen)
    for blk in tree["blocks"]:
        blk["ls1"], blk["ls2"] = 1 + 0.1 * torch.randn(2, D, generator=gen)
    dec = decap.init_decap(gpt2.DECAP_DECODER_CONFIG, D, gen)
    dec.gpt2["wte"] *= 10
    clip = 512
    bound = clip ** -0.5
    dec_clip = dec._replace(clip_project={
        "w": (torch.rand(clip, D, generator=gen) * 2 - 1) * bound,
        "b": (torch.rand(D, generator=gen) * 2 - 1) * bound})
    t2d = {"w": torch.randn(clip, D, generator=gen) * bound,
           "b": 0.1 * torch.randn(D, generator=gen)}
    paths = {name: os.path.join(directory, name) for name in (
        "dinov2_vitb14_reg4_pretrain.pth", "decap.pt", "decap_clip512.pt",
        "talk2dino.pth")}
    for name, sd in zip(paths, (hub_state_dict(tree), decap_state_dict(dec),
                                decap_state_dict(dec_clip), talk2dino_state_dict(t2d))):
        torch.save(sd, paths[name])
    return paths


def _loaded_f32_gate(config: dict, seed: int, label: str) -> None:
    """The f32 prefix of a model loaded from `config`'s files on the card
    against the same files loaded on the CPU, under the gate; the card's
    projection must be D, or H over an int8 bank."""
    from patchioner_tpu_torch import entry
    from patchioner_tpu_torch.models.patchioner import Patchioner

    gpu = Patchioner.from_config(config, rng_seed=seed, allow_missing_weights=True,
                                 dtype=torch.float32, device="cuda")
    cpu = Patchioner.from_config(config, rng_seed=seed, allow_missing_weights=True,
                                 random_bank_size=1, device="cpu")
    # no bank file on either side (phase 6): the CPU model takes the very
    # rows the card drew
    cpu.bank = type(gpu.bank)(*(t.cpu() for t in gpu.bank[:-1]), gpu.bank.num_real)
    imgs, traces = _requests(2, seed + 9)
    pts, valid = _padded(traces)
    wrappers = _wrappers()
    before = {name: fn.launches for name, fn in wrappers.items()}
    prefix = {}
    for where, m in (("card", gpu), ("cpu", cpu)):
        step = entry.make_prefix_step(m.vit_cfg, m.bank.num_real, use_attention=True,
                                      normalize=m.normalize)
        prefix[where] = step(m.state(), m.pixels_to_device(imgs),
                             *(torch.from_numpy(a).to(m.device) for a in (pts, valid)))
    launched = {name: fn.launches - before[name] for name, fn in wrappers.items()}
    want = expected_launches(gpu, 1)
    log(f"[{label}] card prefix {tuple(prefix['card'].shape)} (inversion "
        f"{'on' if gpu.inversion is not None else 'off'}, bank "
        f"{tuple(gpu.bank.rows.shape)} {str(gpu.bank.rows.dtype)[6:]}); launches {launched}")
    if launched != want:
        raise AssertionError(f"[{label}] launches {launched} != {want}")
    if prefix["card"].shape != (2, int(config["prefix_size"])):
        raise AssertionError(f"[{label}] prefix shape {tuple(prefix['card'].shape)}")
    _gate(label, prefix["card"].cpu(), prefix["cpu"], "loaded, card vs CPU")
    del gpu, cpu
    torch.cuda.empty_cache()


def phase_loaded(seed: int, smi: str, directory: str) -> dict:
    """Phase 6: the flagship loaded from checkpoint files written into
    `directory` through `Patchioner.from_config`, served, and held to the
    CPU in f32. No bank file is read (the card's machine has no h5py; the
    CPU tests read and write bank files): the bank is drawn at random at
    the config's size. Returns the files' paths, which phase 7 reads too."""
    t0 = time.perf_counter()
    paths = write_checkpoints(seed, directory)
    sizes = ", ".join(f"{os.path.basename(p)} {os.path.getsize(p) / 1e9:.3f} GB"
                      for p in paths.values())
    log(f"[loaded] wrote {sizes} in {time.perf_counter() - t0:.1f} s")
    dino, dec, dec_clip, t2d = paths.values()
    config = dict(FLAGSHIP_CONFIG, dino_weights=dino, decap_weights=dec)
    model = build_model(config, seed, "[loaded]")
    secs = model.load_seconds
    log(f"[loaded] from_config: torch.load {secs['read']:.3f} s, porting "
        f"{secs['port']:.3f} s, cast and upload {secs['upload']:.3f} s; {smi}")
    # the first batch any server of this model answers, after its warmup()
    imgs, traces = _requests(B, seed + 7)
    captions, snap, batches, wall, _ = _serve(
        model, [(im, {"trace": tr}) for im, tr in zip(imgs, traces)], "[loaded]")
    log(f"[loaded] first served batch after warmup(): {batches} batch(es), mean request "
        f"latency {snap['mean_latency_ms']} ms, {len(captions) / wall:.3f} captions/s; "
        f"caption 0: {captions[0][:60]!r}; {smi}")
    # then as the random-weight flagship is served (phase 4)
    phase_main_path(seed, smi, "loaded", model=model, n_requests=B)
    del model
    torch.cuda.empty_cache()
    _loaded_f32_gate(config, seed, "f32 loaded")
    _loaded_f32_gate(dict(config, prefix_size=512, decap_weights=dec_clip,
                          talk2dino_weights=t2d), seed, "f32 loaded talk2dino")
    _loaded_f32_gate(dict(config, memory_bank_int8=True), seed, "f32 loaded int8_bank")
    return paths


def write_viecap_checkpoint(seed: int, directory: str) -> str:
    """A ViECap checkpoint at full width, seeded, in the published layout:
    the 8-layer mapping network (768 -> 10 x 768, 10 prefix tokens) and
    GPT-2 base (12 layers, 768 wide, vocabulary 50257), wte scaled by 10
    as the DeCap file's is, so that the greedy steps are not near-ties;
    its path."""
    from patchioner_tpu_torch.models import gpt2, viecap

    gen = torch.Generator().manual_seed(seed + 11)
    cfg = viecap.ViecapConfig(clip_hidden_size=D)
    mapping = viecap.init_mapping_network(cfg, D, gen)
    gpt = gpt2.init_gpt2(gpt2.GPT2_BASE_CONFIG, gen)
    gpt["wte"] *= 10
    path = os.path.join(directory, "coco_prefix-0014.pt")
    torch.save(viecap_state_dict(mapping, gpt), path)
    return path


def _search_calls(params, cfg, embeds, eos, max_len: int) -> dict:
    """Each search of the model's GPT-2 on `embeds`, to `max_len` tokens:
    greedy, beam (width 5) and contrastive (top_k 48, alpha 0.1)."""
    from patchioner_tpu_torch.models import viecap

    return {"greedy": lambda: viecap.greedy_tokens(params, embeds, cfg, max_len),
            "beam": lambda: viecap.beam_tokens(params, embeds, eos, cfg, max_len, 5)[0],
            "contrastive": lambda: viecap.contrastive_tokens(params, embeds, cfg, max_len,
                                                             48, 0.1)}


def _kind_requests(n: int, seed: int, img: int = IMG) -> tuple[np.ndarray, dict]:
    """n seeded images of img px and, for each request kind, their (image,
    submit keywords) requests: a trace, 1-16 boxes, a set of 1-16 boxes,
    or the whole image."""
    imgs, traces = _requests(n, seed, img)
    sets = _query_boxes(n, seed + 1)
    return imgs, {"trace": [(im, {"trace": tr}) for im, tr in zip(imgs, traces)],
                  "bbox": [(im, {"bboxes": bs}) for im, bs in zip(imgs, sets)],
                  "region_set": [(im, {"bboxes": bs, "region_set": True})
                                 for im, bs in zip(imgs, sets)],
                  "cls": [(im, {}) for im in imgs]}


def _flat(results: list) -> list:
    """The captions of served requests: a box request's list is spread."""
    return [c for r in results for c in (r if isinstance(r, list) else [r])]


def _serve_kinds(model, kinds: tuple, seed: int, label: str, smi: str) -> np.ndarray:
    """B requests of each of `kinds` served through `_serve` (after each
    kind's `warmup()`, launches and decode graphs asserted); the images."""
    imgs, requests = _kind_requests(B, seed)
    for kind in kinds:
        tag = f"[{label} {kind}]"
        results, snap, batches, wall, _ = _serve(model, requests[kind], tag, kind)
        flat = _flat(results)
        if not all(isinstance(c, str) for c in flat):
            raise AssertionError(f"{tag} a request did not resolve to caption strings")
        log(f"{tag} {len(flat)} captions from {len(results)} requests in {batches} batch(es): "
            f"{len(flat) / wall:.3f} captions/s, mean request latency "
            f"{snap['mean_latency_ms']} ms; result 0: {str(results[0])[:60]!r}; {smi}")
    return imgs


def _forward_split(model, imgs, smi: str, label: str, parts: dict, runs: int = 3) -> None:
    """A whole-image batch's split, each part timed inside the same
    `forward` call as the whole (host clock, the card synchronised around
    each part): `parts` maps a name to the (object, attribute) of a step
    `forward` calls, none inside another; a part called several times a
    forward (once a row) is summed. Medians of `runs` calls, and the last
    part's share of each call's whole."""
    totals = {name: [] for name in parts}
    current = dict.fromkeys(parts, 0.0)
    old = {name: obj.__dict__.get(attr) for name, (obj, attr) in parts.items()}

    def timed(fn, name):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            if name is not None:
                current[name] += (time.perf_counter() - t1) * 1e3
            return out
        return call

    for name, (obj, attr) in parts.items():
        setattr(obj, attr, timed(getattr(obj, attr), name))
    try:
        whole = []
        model.forward(imgs, get_cls_capt=True)  # first call set-up
        for _ in range(runs):
            current.update(dict.fromkeys(parts, 0.0))
            t1 = time.perf_counter()
            timed(lambda: model.forward(imgs, get_cls_capt=True), None)()
            whole.append((time.perf_counter() - t1) * 1e3)
            for name in parts:
                totals[name].append(current[name])
    finally:
        for name, (obj, attr) in parts.items():
            if old[name] is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, old[name])
    last = list(parts)[-1]
    share = statistics.median(t / w for t, w in zip(totals[last], whole))
    split = ", ".join(f"{name} {statistics.median(totals[name]):.1f}" for name in parts)
    log(f"[{label}] a whole-image batch of {B}, inside the same forward calls: forward "
        f"{statistics.median(whole):.1f} ms; {split}; {last} {share:.3f} of its forward "
        f"(host clock, medians of {runs}); {smi}")


def _recording(model) -> dict:
    """Wrap, on this model object, the two steps of `forward`'s route that
    the served f32 gate holds to the CPU: the features handed to
    `caption_tokens`, and what the decoder is given (ViECap's prompt
    embeddings, DeCap's prefix); returns the lists they are appended to."""
    seen = {"features": [], "decoder input": []}

    def wrap(obj, name, key, argument):
        fn = getattr(obj, name)

        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen[key].append(torch.as_tensor(args[0] if argument else out).float().cpu())
            return out
        setattr(obj, name, call)

    wrap(model, "caption_tokens", "features", True)
    if model.viecap is not None:
        wrap(model.viecap, "prompt_embeds", "decoder input", False)
    else:
        wrap(model, "project_features", "decoder input", False)
    return seen


def phase_served_f32_gate(config: dict, seed: int, label: str, kinds: tuple) -> None:
    """Phases 7b and 7c: one served batch (2 requests) of each of `kinds`
    on an f32 copy of `config` on the card and on the CPU, TF32 off: the
    features `forward` hands to `caption_tokens` and the decoder's input
    under the gate, the captions compared (reported). On a DeCap model
    each `caption_tokens` call on the card must replay a decode graph."""
    from patchioner_tpu_torch.models.patchioner import Patchioner
    from patchioner_tpu_torch.serve import CaptionServer

    gpu = Patchioner.from_config(config, rng_seed=seed, allow_missing_weights=True,
                                 dtype=torch.float32, device="cuda")
    cpu = gpu.to("cpu")
    _, requests = _kind_requests(2, seed + 14)
    graphs = gpu.decode.captures, gpu.decode.replays
    seen, caps = {}, {}
    for where, m in (("card", gpu), ("cpu", cpu)):
        seen[where] = _recording(m)
        # both requests of a kind in one batch: the server waits for the second
        with CaptionServer(m, max_batch=2, max_delay_ms=2000.0,
                           max_boxes=MAX_BOXES) as server:
            for kind in kinds:
                futures = [server.submit(im, **kw) for im, kw in requests[kind]]
                caps[where, kind] = [f.result(timeout=900) for f in futures]
    for key in ("features", "decoder input"):
        if not len(seen["card"][key]) == len(seen["cpu"][key]) == len(kinds):
            raise AssertionError(f"[{label}] {key}: {len(seen['card'][key])} calls on the "
                                 f"card, {len(seen['cpu'][key])} on the CPU, for "
                                 f"{len(kinds)} batches")
        for kind, got, want in zip(kinds, seen["card"][key], seen["cpu"][key]):
            _gate(label, got, want, f"{kind} batch {tuple(want.shape)}, card vs CPU", key)
    flat = {w: [c for k in kinds for c in _flat(caps[w, k])] for w in ("card", "cpu")}
    log(f"[{label}] served captions card vs CPU (reported, not asserted): "
        f"{sum(a == b for a, b in zip(flat['card'], flat['cpu']))}/{len(flat['cpu'])} equal; "
        f"card 0: {flat['card'][0][:60]!r}")
    captured, replayed = (gpu.decode.captures - graphs[0], gpu.decode.replays - graphs[1])
    log(f"[{label}] DeCap decode graphs on the card: {captured} captures, {replayed} replays "
        f"for {len(kinds)} caption_tokens calls")
    want = len(kinds) if gpu.viecap is None else 0
    if replayed != want or captured > want:
        raise AssertionError(f"[{label}] {replayed} decode graph replays, {captured} "
                             f"captures; {want} expected")
    del gpu, cpu
    torch.cuda.empty_cache()


def phase_decap_no_bank(config: dict, seed: int, smi: str) -> None:
    """Phase 7c: `config` (no bank, no ViECap) served through `forward` in
    bf16, whole images and boxes, then held to the CPU in f32."""
    model = build_model(config, seed, "[decap no bank]")
    if model.bank is not None or model.viecap is not None:
        raise AssertionError("[decap no bank] the model must decode through DeCap, "
                             "without a bank")
    _serve_kinds(model, ("cls", "bbox"), seed + 16, "decap no bank", smi)
    del model
    torch.cuda.empty_cache()
    phase_served_f32_gate(config, seed, "f32 decap no bank", ("cls", "bbox"))


def phase_viecap(seed: int, smi: str, directory: str, paths: dict) -> str:
    """Phase 7: ViECap on DINOv2, configs/mlp.viecap.k.yaml loaded from phase
    6's hub DINOv2 and DeCap files and a full-width ViECap checkpoint written
    here, in bf16 on the card (ViECap's GPT-2 is f32 as the config's); served
    through `forward`, the searches held to the CPU and timed. Returns the
    ViECap file's path, which phase 9 reads too."""
    from patchioner_tpu_torch.models import viecap
    from patchioner_tpu_torch.models.patchioner import uses_fallback_tokenizer

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("phase 7 holds the f32 GPT-2 to the CPU: TF32 must be off")
    t0 = time.perf_counter()
    pt = write_viecap_checkpoint(seed, directory)
    log(f"[viecap] wrote {os.path.basename(pt)} {os.path.getsize(pt) / 1e9:.3f} GB in "
        f"{time.perf_counter() - t0:.1f} s")
    dino, dec = list(paths.values())[:2]
    config = dict(VIECAP_CONFIG, dino_weights=dino, decap_weights=dec,
                  viecap=dict(VIECAP_CONFIG["viecap"], weight_path=pt))
    model = build_model(config, seed, "[viecap]")
    vc = model.viecap
    secs = model.load_seconds
    log(f"[viecap] from_config: torch.load {secs['read']:.3f} s, porting {secs['port']:.3f} s, "
        f"cast and upload {secs['upload']:.3f} s; mapping network {vc.cfg.num_layers} layers "
        f"{vc.cfg.clip_hidden_size} -> {vc.cfg.clip_project_length} x {vc.gpt2_cfg.n_embd}, "
        f"GPT-2 {vc.gpt2_cfg.n_layer}L/{vc.gpt2_cfg.n_embd}/vocab {vc.gpt2_cfg.vocab_size} in "
        f"{str(vc.gpt2_params['wte'].dtype)[6:]}, {len(vc.entities)} entities x "
        f"{vc.texts_embeddings.shape[1]}; fallback tokenizer {uses_fallback_tokenizer(model)}; "
        f"bank {model.bank}, fused path {model.supports_fused_trace_path()}")
    if model.bank is not None or model.supports_fused_trace_path():
        raise AssertionError("[viecap] the model must caption through forward, without a bank")

    imgs = _serve_kinds(model, ("trace", "bbox", "cls"), seed + 12, "viecap", smi)

    _forward_split(model, imgs, smi, "viecap", {
        "encoder": (model, "encode_images"), "prompts": (vc, "prompt_embeds"),
        f"greedy search of {vc.cfg.max_len} tokens": (viecap, "run_search")})
    cls = model.encode_images(imgs)["x_norm_clstoken"]
    embeds = vc.prompt_embeds(cls)

    # card vs CPU on the same weights and prompts, f32 (TF32 off)
    cpu = vc.to("cpu")
    f = cls.float() / cls.float().norm(dim=-1, keepdim=True)
    soft = viecap.mapping_network_forward(vc.mapping_params, f, vc.cfg, vc.gpt2_cfg.n_embd)
    soft_ref = viecap.mapping_network_forward(cpu.mapping_params, f.cpu(), cpu.cfg,
                                              cpu.gpt2_cfg.n_embd)
    _gate("viecap", soft.cpu(), soft_ref, "card vs CPU", "soft prompt")
    from patchioner_tpu_torch.models import gpt2

    t_all = embeds.shape[1] + 1
    logits, _ = gpt2.gpt2_prefill(vc.gpt2_params, embeds, vc.gpt2_cfg, t_all)
    logits_ref, _ = gpt2.gpt2_prefill(cpu.gpt2_params, embeds.cpu(), cpu.gpt2_cfg, t_all)
    _gate("viecap", logits.cpu(), logits_ref, "card vs CPU", "prefill logits")
    eos = torch.tensor([vc.tokenizer.encode(e)[-1] for e in (".", " .")])
    card = _search_calls(vc.gpt2_params, vc.gpt2_cfg, embeds, eos.cuda(), 16)
    ref = _search_calls(cpu.gpt2_params, cpu.gpt2_cfg, embeds.cpu(), eos, 16)
    for name in card:
        got, want = card[name]().cpu(), ref[name]()
        log(f"[viecap] {name} tokens over max_len 16, card vs CPU (reported, not asserted): "
            f"{int((got == want).sum())}/{want.numel()} equal, {int((got == want).all(-1).sum())}"
            f"/{want[..., 0].numel()} rows")
    batched = viecap.beam_search_batched(vc.gpt2_params, embeds, vc.gpt2_cfg, vc.tokenizer,
                                         max_len=16)
    per_image = [viecap.beam_search(vc.gpt2_params, embeds[i:i + 1], vc.gpt2_cfg, vc.tokenizer,
                                    max_len=16)[0] for i in range(B)]
    log(f"[viecap] batched beam search vs per image on the card (reported): "
        f"{sum(a == b for a, b in zip(batched, per_image))}/{B} captions equal")
    del cpu, ref

    # each search on the card at the config's max_len, and its launches a step
    for name, call in _search_calls(vc.gpt2_params, vc.gpt2_cfg, embeds, eos.cuda(),
                                    vc.cfg.max_len).items():
        call()
        ms = _host_ms(call)
        short = _search_calls(vc.gpt2_params, vc.gpt2_cfg, embeds, eos.cuda(), 16)[name]
        long = _search_calls(vc.gpt2_params, vc.gpt2_cfg, embeds, eos.cuda(), 32)[name]
        (n16, dev16), (n32, dev32) = _kernel_count(short), _kernel_count(long)
        log(f"[viecap] {name} search, {B} prompts x {vc.cfg.max_len} tokens: {ms:.1f} ms "
            f"(host clock, median of 3); {(n32 - n16) / 16:.1f} kernels and "
            f"{(dev32 - dev16) / 16:.3f} ms of device time a step; {smi}")
    del model, vc
    torch.cuda.empty_cache()
    phase_served_f32_gate(config, seed, "f32 viecap served", ("trace", "bbox"))
    phase_decap_no_bank(dict(config, viecap=None), seed, smi)
    return pt


def write_clipcap_checkpoints(seed: int, directory: str) -> tuple[str, str]:
    """Two ClipCap checkpoints at full width, seeded, in the published
    layout: the MLP mapper (768 -> 3,840 -> 7,680, 10 prefix tokens) with
    GPT-2 base, wte scaled by 10 as the ViECap file's is, and the
    transformer mapper (8 layers under clip_project.*, 10 projected and 10
    prefix tokens) alone; their paths."""
    from patchioner_tpu_torch.models import clipcap, gpt2, viecap

    gen = torch.Generator().manual_seed(seed + 20)
    cfg, d_model = clipcap.ClipCapConfig(), gpt2.GPT2_BASE_CONFIG.n_embd
    mlp = clipcap.init_mlp_mapper(D, cfg.prefix_length, d_model, gen, "cpu")
    gpt = gpt2.init_gpt2(gpt2.GPT2_BASE_CONFIG, gen)
    gpt["wte"] *= 10
    mapping = viecap.init_mapping_network(clipcap.mapper_config(cfg, D), d_model, gen)
    paths = (os.path.join(directory, "clipcap_mlp.pt"),
             os.path.join(directory, "clipcap_transformer.pt"))
    torch.save(clipcap_state_dict(mlp, gpt), paths[0])
    torch.save(viecap_state_dict(mapping, None, "clip_project."), paths[1])
    return paths


def _family_loaded(model, label: str, smi: str) -> None:
    """Print what `from_config` loaded for a decoder family and assert that
    the model captions through `forward`, without a bank."""
    from patchioner_tpu_torch.models.patchioner import uses_fallback_tokenizer

    fam = model.viecap if model.viecap is not None else model.clipcap
    secs = model.load_seconds
    log(f"[{label}] from_config: torch.load {secs['read']:.3f} s, porting "
        f"{secs.get('port', 0.0):.3f} s, cast and upload {secs['upload']:.3f} s; "
        f"{type(fam).__name__}, GPT-2 {fam.gpt2_cfg.n_layer}L/{fam.gpt2_cfg.n_embd}/vocab "
        f"{fam.gpt2_cfg.vocab_size} in {str(fam.gpt2_params['wte'].dtype)[6:]}; fallback "
        f"tokenizer {uses_fallback_tokenizer(model)}; bank {model.bank}, fused path "
        f"{model.supports_fused_trace_path()}; {smi}")
    if model.bank is not None or model.supports_fused_trace_path():
        raise AssertionError(f"[{label}] the model must caption through forward, without a bank")


def phase_clipcap(seed: int, smi: str, directory: str, paths: dict) -> None:
    """Phase 8: ClipCap on the flagship's DINOv2 encoder (no bank), loaded
    from phase 6's hub DINOv2 file and an MLP ClipCap file written here, the
    encoder in bf16 and GPT-2 in f32; served, split, the sampler timed and
    held to the CPU in f32; then one batch of the transformer mapper."""
    from patchioner_tpu_torch.models import clipcap, gpt2

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("phase 8 holds the f32 GPT-2 to the CPU: TF32 must be off")
    t0 = time.perf_counter()
    mlp_pt, transformer_pt = write_clipcap_checkpoints(seed, directory)
    log(f"[clipcap] wrote {os.path.basename(mlp_pt)} {os.path.getsize(mlp_pt) / 1e9:.3f} GB, "
        f"{os.path.basename(transformer_pt)} {os.path.getsize(transformer_pt) / 1e9:.3f} GB "
        f"in {time.perf_counter() - t0:.1f} s")
    config = dict(CLIPCAP_CONFIG, dino_weights=paths["dinov2_vitb14_reg4_pretrain.pth"],
                  clipcap=dict(CLIPCAP_CONFIG["clipcap"], weight_path=mlp_pt))
    model = build_model(config, seed, "[clipcap]")
    cc = model.clipcap
    _family_loaded(model, "clipcap", smi)
    log(f"[clipcap] {cc.cfg.mapping_type} mapper {cc.prefix_size} -> "
        f"{cc.mapper_params['fc1']['w'].shape[1]} -> {cc.mapper_params['fc2']['w'].shape[1]}, "
        f"{cc.cfg.prefix_length} prefix tokens; top_p {cc.cfg.top_p}, temperature "
        f"{cc.cfg.temperature}, {cc.cfg.entry_length} tokens, stop {cc.cfg.stop_token!r}")
    if cc.prefix_size != D or cc.cfg.entry_length != 67:
        raise AssertionError(f"[clipcap] the block's defaults: width {cc.prefix_size}")

    imgs = _serve_kinds(model, ("trace", "bbox", "cls"), seed + 20, "clipcap", smi)
    _forward_split(model, imgs, smi, "clipcap", {
        "encoder": (model, "encode_images"), "mapper": (cc, "project"),
        "noise": (cc, "noise"),
        f"sampling of {cc.cfg.entry_length} tokens": (clipcap, "generate_batched")})
    cls = model.encode_images(imgs)["x_norm_clstoken"].float()
    prefix = cc.project(cls)
    stop = cc.tokenizer.encode(cc.cfg.stop_token)[0]

    def sample(params, pre, noise, cfg=cc.gpt2_cfg):
        return lambda: clipcap.sample_tokens(params, pre, noise, cfg, stop, cc.cfg.top_p,
                                             cc.cfg.temperature)

    full = sample(cc.gpt2_params, prefix, cc.noise(B))
    full()
    ms = _host_ms(full)
    toks = full()
    log(f"[clipcap] sampled tokens {tuple(toks.shape)}: {len(torch.unique(toks))} distinct, "
        f"row 0 begins {toks[0, :8].tolist()}")
    noise = cc.noise(B)
    (n16, dev16), (n32, dev32) = (_kernel_count(sample(cc.gpt2_params, prefix, noise[:n]))
                                  for n in (16, 32))
    log(f"[clipcap] sampler, {B} prefixes x {cc.cfg.entry_length} tokens: {ms:.1f} ms (host "
        f"clock, median of 3); {(n32 - n16) / 16:.1f} kernels and {(dev32 - dev16) / 16:.3f} "
        f"ms of device time a step; {smi}")

    # card vs CPU on the same weights, features and noise, f32 (TF32 off)
    cpu = cc.to("cpu")
    _gate("clipcap", prefix.cpu(), cpu.project(cls.cpu()), "card vs CPU", "mapper output")
    t_all = prefix.shape[1] + 1
    logits, _ = gpt2.gpt2_prefill(cc.gpt2_params, prefix, cc.gpt2_cfg, t_all)
    logits_ref, _ = gpt2.gpt2_prefill(cpu.gpt2_params, prefix.cpu(), cpu.gpt2_cfg, t_all)
    _gate("clipcap", logits.cpu(), logits_ref, "card vs CPU", "prefill logits")
    noise = clipcap.gumbel_noise((16, B, cc.gpt2_cfg.vocab_size),
                                 torch.Generator().manual_seed(seed + 21), "cpu")
    # the config's temperature, and 10, which undoes the file's wte x 10 so
    # that each step keeps many tokens and the noise picks among them
    for temperature in (cc.cfg.temperature, 10.0):
        def sample_at(params, pre, nz):
            return clipcap.sample_tokens(params, pre, nz, cc.gpt2_cfg, stop, cc.cfg.top_p,
                                         temperature)

        got = sample_at(cc.gpt2_params, prefix, noise.cuda()).cpu()
        want = sample_at(cpu.gpt2_params, prefix.cpu(), noise)
        log(f"[clipcap] sampled tokens over 16 steps on the same Gumbel noise at temperature "
            f"{temperature}, card vs CPU (reported, not asserted): "
            f"{int((got == want).sum())}/{want.numel()} equal, "
            f"{int((got == want).all(-1).sum())}/{B} rows; {len(torch.unique(want))} distinct")
    del model, cc, cpu, logits, logits_ref
    torch.cuda.empty_cache()

    # one whole-image batch of the transformer mapper, from its own file
    tconfig = dict(config, clipcap={"mapping_type": "transformer",
                                    "weight_path": transformer_pt})
    model = build_model(tconfig, seed, "[clipcap transformer]")
    ct = model.clipcap
    model.forward(imgs, get_cls_capt=True)  # first call set-up
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    caps = model.forward(imgs, get_cls_capt=True)["cls_capt"]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) * 1e3
    counts = {name: fn.launches for name, fn in wrappers.items()}
    want = expected_launches(model, 1)
    log(f"[clipcap transformer] {len(ct.mapper_params['layers'])}-layer mapper, "
        f"{ct.cfg.clip_length} + {ct.cfg.prefix_length} tokens: a whole-image batch of {B} "
        f"through forward {ms:.1f} ms (host clock), {len(caps)} captions; launches {counts}; "
        f"{smi}")
    if counts != want:
        raise AssertionError(f"[clipcap transformer] launches {counts} != {want}")
    out = ct.project(cls)
    _gate("clipcap transformer", out.cpu(), ct.to("cpu").project(cls.cpu()), "card vs CPU",
          "mapper output")
    del model, ct
    torch.cuda.empty_cache()
    for path in (mlp_pt, transformer_pt):
        os.remove(path)


# the memory's words: each caption is "a <adjective> <noun> in the <place>"
MEMORY_WORDS = (
    ("red", "small", "young", "white", "black", "wooden", "large", "old", "happy", "green"),
    ("dog", "cat", "man", "woman", "child", "horse", "bus", "train", "kite", "boat",
     "pizza", "bird", "car", "sheep", "bench", "clock", "surfer", "giraffe", "table", "bike"),
    ("park", "street", "kitchen", "beach", "field", "room", "city", "snow", "water", "yard"),
)


def write_meacap_memory(seed: int, directory: str, width: int = D,
                        memory_id: str = MEACAP_CONFIG["viecap"]["meacap"]["memory_id"]) -> str:
    """MeaCap's caption memory at the flagship memory's size, seeded, in the
    published layout, written by `MeaCap.build_memory` under
    `memory/<memory_id>/`: 591,753 captions drawn from `MEMORY_WORDS` (so
    that the frequency extractor finds concepts) and their (591,753, width)
    f32 embeddings; the memory's base path."""
    from patchioner_tpu_torch.models import meacap

    rng = np.random.default_rng(seed + 30)
    adj, noun, place = MEMORY_WORDS
    picks = zip(*(rng.integers(0, len(w), MEMORY_ROWS).tolist() for w in MEMORY_WORDS))
    captions = [f"a {adj[i]} {noun[j]} in the {place[k]}" for i, j, k in picks]
    base = os.path.join(directory, "meacap")
    gen = torch.Generator(device="cuda").manual_seed(seed + 31)  # drawn on the card: faster
    meacap.MeaCap.build_memory(
        captions, lambda texts: torch.randn(len(texts), width, generator=gen,
                                            device="cuda").cpu(),
        os.path.join(base, "memory", memory_id), batch_size=1 << 16)
    return base


def phase_meacap(seed: int, smi: str, directory: str, paths: dict) -> None:
    """Phase 9: MeaCap on DINOv2, configs/mlp.meacap.k.yaml loaded from phase
    6's DINOv2 and DeCap files, phase 7's ViECap file and a caption memory
    written here at the flagship memory's size; served, split, and held to
    the CPU in f32."""
    import shutil

    from patchioner_tpu_torch.models import meacap, viecap

    t0 = time.perf_counter()
    base = write_meacap_memory(seed, directory)
    mem_dir = os.path.join(base, "memory", MEACAP_CONFIG["viecap"]["meacap"]["memory_id"])
    sizes = ", ".join(f"{name} {os.path.getsize(os.path.join(mem_dir, name)) / 1e9:.3f} GB"
                      for name in sorted(os.listdir(mem_dir)))
    log(f"[meacap] wrote {sizes} in {time.perf_counter() - t0:.1f} s")
    vd = MEACAP_CONFIG["viecap"]
    config = dict(MEACAP_CONFIG, dino_weights=paths["dinov2_vitb14_reg4_pretrain.pth"],
                  decap_weights=paths["decap.pt"],
                  viecap=dict(vd, weight_path=paths["viecap"],
                              meacap=dict(vd["meacap"], memory_base_path=base)))
    model = build_model(config, seed, "[meacap]")
    mc = model.viecap
    _family_loaded(model, "meacap", smi)
    log(f"[meacap] memory {len(mc.memory_captions)} captions x "
        f"{mc.memory_clip_embeddings.shape[1]} on {mc.memory_clip_embeddings.device}, top "
        f"{mc.memory_caption_num}; extractor {mc.concept_extractor.__name__}; greedy "
        f"{mc.cfg.using_greedy_search}, {mc.cfg.max_len} tokens")
    if not isinstance(mc, meacap.MeaCap) or len(mc.memory_captions) != MEMORY_ROWS:
        raise AssertionError("[meacap] the model must be a MeaCap over the written memory")

    imgs = _serve_kinds(model, ("trace", "bbox", "cls"), seed + 30, "meacap", smi)
    _forward_split(model, imgs, smi, "meacap", {
        "encoder": (model, "encode_images"),
        "retrieval": (meacap, "retrieve_memory_captions"),
        "concept extraction (host)": (mc, "concept_extractor"),
        f"greedy search of {mc.cfg.max_len} tokens": (viecap, "run_search")})
    cls = model.encode_images(imgs)["x_norm_clstoken"].float()
    f = cls / cls.norm(dim=-1, keepdim=True)
    k = mc.memory_caption_num
    for rows in (B, B * MAX_BOXES):
        fr = f.repeat(rows // B, 1)
        ms = _host_ms(lambda: meacap.retrieve_memory_captions(fr, mc.memory_clip_embeddings, k))
        log(f"[meacap] retrieval of the top {k} of {MEMORY_ROWS} rows for {rows} features: "
            f"{ms:.2f} ms (host clock, median of 3; one copy to the host); {smi}")

    # card vs CPU on the same features, f32 (TF32 off)
    cpu = mc.to("cpu")
    idx = meacap.retrieve_memory_captions(f, mc.memory_clip_embeddings, k)
    idx_ref = meacap.retrieve_memory_captions(f.cpu(), cpu.memory_clip_embeddings, k)
    log(f"[meacap] retrieved indices card vs CPU: {int((idx == idx_ref).sum())}/{idx.size} "
        f"equal")
    if not (idx == idx_ref).all():
        raise AssertionError("[meacap] the card retrieved other memory rows than the CPU")

    def concepts(m, idx, feats):
        return [m.concept_extractor([m.memory_captions[j] for j in row], image_embeds=feats[i])
                for i, row in enumerate(idx)]

    got, want = concepts(mc, idx, f), concepts(cpu, idx_ref, f.cpu())
    log(f"[meacap] concepts card vs CPU: {sum(a == b for a, b in zip(got, want))}/{B} rows "
        f"equal; row 0 {got[0]}")
    if got != want:
        raise AssertionError("[meacap] the card's concepts differ from the CPU's")
    embeds, ref = mc.prompt_embeds(cls), cpu.prompt_embeds(cls.cpu())
    _gate("meacap", embeds.cpu(), ref, "card vs CPU", "prompt embeddings")
    tok = viecap.greedy_tokens(mc.gpt2_params, embeds, mc.gpt2_cfg, 16).cpu()
    tok_ref = viecap.greedy_tokens(cpu.gpt2_params, embeds.cpu(), cpu.gpt2_cfg, 16)
    log(f"[meacap] greedy tokens over 16 steps, card vs CPU (reported, not asserted): "
        f"{int((tok == tok_ref).sum())}/{tok_ref.numel()} equal, "
        f"{int((tok == tok_ref).all(-1).sum())}/{B} rows")
    del model, mc, cpu, embeds, ref
    torch.cuda.empty_cache()
    shutil.rmtree(base)


# ------------------------------------------------------- phase 4g and 10


def phase_decode_rows(model, seed: int, smi: str) -> None:
    """Phase 4g: the decode graphs `GreedyDecoder` keeps, one a power-of-two
    row bucket (`decap.row_bucket`), at the row counts `forward` gives:
    one flagship batch's patch captions (B x 1369 rows), box batches of
    three distinct totals and one total again, then a sweep of 16 box
    totals (B x 1..16 rows); after each call the graphs captured, the
    call's time and the card's reserved memory. A call captures a graph
    only for a bucket not seen before."""
    from patchioner_tpu_torch.models import decap

    dec = model.decode
    imgs, _ = _requests(B, seed + 50)
    rng = np.random.default_rng(seed + 51)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    start = torch.cuda.memory_reserved()

    def boxes(per):
        xy = rng.uniform(0, IMG / 2, (B, per, 2))
        wh = rng.uniform(14, IMG / 2, (B, per, 2))
        return {"get_cls_capt": False, "bboxes": np.concatenate([xy, wh], -1)}

    calls = [("patch captions", {"get_cls_capt": False, "get_patch_capts": True})]
    calls += [(f"{B * per} box rows", boxes(per)) for per in (5, 9, 13, 9)]
    for label, kw in calls + [("sweep", None)]:
        before = dec.captures, dec.replays, {k[0] for k in dec._graphs}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kw is None:  # box totals B x 1..16
            rows = [sum(len(c) for c in model.forward(imgs, **boxes(per))["bbox_capts"])
                    for per in range(1, MAX_BOXES + 1)]
            torch.cuda.synchronize()
            first, again = time.perf_counter() - t0, float("nan")
        else:
            out = model.forward(imgs, **kw)
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            again = _host_ms(lambda: model.forward(imgs, **kw))
            rows = [sum(len(c) for c in next(iter(out.values())))]
        new = {decap.row_bucket(r) for r in rows} - before[2]
        captured = dec.captures - before[0]
        log(f"[decode rows] {label}: {rows[0] if len(rows) == 1 else rows} rows, buckets "
            f"{sorted({decap.row_bucket(r) for r in rows})}, {captured} graph(s) captured "
            f"({dec.captures} kept), first call {first:.3f} s, then {again:.1f} ms (median "
            f"of 3), reserved {torch.cuda.memory_reserved() / 2**30:.2f} GiB "
            f"(+{(torch.cuda.memory_reserved() - start) / 2**30:.2f} since 4g began); {smi}")
        if dec.replays == before[1] or captured != len(new):
            raise AssertionError(f"[decode rows] {label}: {captured} captures for the new "
                                 f"buckets {sorted(new)}")
    # 100 rows replay the 128-row bucket's graph: its real rows must be the
    # eager loop's on the zero-padded batch; against the eager loop on the
    # 100 rows alone (another GEMM shape) the agreement is reported
    gen = torch.Generator(device="cuda").manual_seed(seed + 52)
    prefix = torch.nn.functional.normalize(
        torch.randn(100, model.decoder.clip_project["w"].shape[0], generator=gen,
                    device="cuda"), dim=-1)
    tokens, _ = dec(prefix)
    padded = torch.cat([prefix, prefix.new_zeros(28, prefix.shape[1])])
    want = decap.greedy_decode(model.decoder, padded, dec.cfg)[0][:100]
    alone = decap.greedy_decode(model.decoder, prefix, dec.cfg)[0]
    log(f"[decode rows] 100 rows on the 128-row graph, {str(dec.cfg.dtype)[6:]}: tokens equal "
        f"to the eager loop's on the padded batch {torch.equal(tokens, want)}; on the 100 rows "
        f"alone {int((tokens == alone).sum())}/{tokens.numel()} tokens, "
        f"{int((tokens == alone).all(1).sum())}/100 rows (reported, not asserted)")
    if not torch.equal(tokens, want):
        raise AssertionError("[decode rows] the bucket's graph differs from the eager loop")


class TrainShapes(NamedTuple):
    """Phase 10's sizes: the reference training CLI's decoder and batch at
    full width (4 layers, 4 heads, 768 wide, vocab 50,257, prefix 768,
    max_seq_len 20, batch 64), the flagship's bank, a packed run of 1024
    rows of 64 positions, and the mappers on the frozen GPT-2 base at the
    ViECap CLI's batch 80 and max_seq_len 40."""

    decoder: tuple = (4, 4, D, 50257)  # n_layer, n_head, n_embd, vocab
    max_seq_len: int = 20
    batch: int = 64
    bank_rows: int = MEMORY_ROWS
    packed_rows: int = 1024
    pack_len: int = 64
    loss_chunk: int = 8
    grad_accum: int = 2
    base: tuple = (12, 12, D, 50257)
    prefix_batch: int = 80
    prefix_len: int = 40
    gate_rows: int = 8  # the mappers' card-vs-CPU gate: GPT-2 base on the CPU
    timed_steps: int = 10
    cli_captions: int = 1280  # 20 steps of 64 an epoch


TRAIN = TrainShapes()


def _train_captions(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    adj, noun, place = MEMORY_WORDS
    picks = zip(*(rng.integers(0, len(w), n).tolist() for w in MEMORY_WORDS))
    return [f"a {adj[i]} {noun[j]} in the {place[k]}" for i, j, k in picks]


def _tree_copy(tree, device):
    """A copy of a tree of tensors on `device` (None leaves kept)."""
    if isinstance(tree, dict):
        return {k: _tree_copy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_copy(v, device) for v in tree)
    return None if tree is None else tree.detach().to(device, copy=True)


def _gate_leaves(label: str, got: dict, ref: dict, what: str) -> None:
    """Phase 5's gate, max|got - ref| <= 1e-4 * max(1, max|ref|), on every
    leaf of two {path: tensor} trees; prints the leaf nearest its bound."""
    if got.keys() != ref.keys():
        raise AssertionError(f"[{label}] {what}: leaves {sorted(got)} vs {sorted(ref)}")
    worst = None
    for name, g in got.items():
        r = ref[name].float()
        err = (g.detach().cpu().float() - r).abs().max().item()
        tol = 1e-4 * max(1.0, r.abs().max().item())
        rel = err / max(r.abs().max().item(), 1e-30)
        if not err <= tol:
            raise AssertionError(f"[{label}] {what} {name}: {err:.3e} > {tol:.3e}")
        if worst is None or err / tol > worst[1] / worst[2]:
            worst = (name, err, tol, rel)
    log(f"[{label}] {what}: {len(got)} leaves within the gate; nearest its bound "
        f"{worst[0]} max|d|={worst[1]:.3e} (tol {worst[2]:.3e}, {worst[3]:.2e} of its max)")


def _grads(leaves: list) -> dict:
    return {str(i): p.grad for i, p in enumerate(leaves)}


def _timed_steps(run, batches: list, label: str, rows_per_step: int, smi: str,
                 captions_per_step=None) -> tuple[float, int]:
    """Two warm steps, then the rest timed by the host clock with the card
    synchronised, D's launches counted from 0 and the peak memory from the
    first timed step; (steps/s, D's launches)."""
    from patchioner_tpu_torch.ops import memory_projection as mp

    for b in batches[:2]:
        run(*b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mp.memory_project_streamed.launches = 0
    t0 = time.perf_counter()
    for b in batches[2:]:
        run(*b)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = mp.memory_project_streamed.launches
    steps = len(batches) - 2
    caps = (captions_per_step or rows_per_step) * steps
    log(f"[train {label}] {steps} steps in {secs:.3f} s: {steps / secs:.3f} steps/s, "
        f"{caps / secs:.1f} captions/s trained ({rows_per_step} rows a step), peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated, kernel D "
        f"{launches} launches; {smi}")
    return steps / secs, launches


def _decoder_gates(gcfg, features, tokens, bank, seed: int) -> None:
    """The --im_proj step with CapDec noise on the card against the same
    step on the CPU (the plain projection), same init, batches and noise:
    loss and accuracy each step, every gradient leaf after the first, the
    params after the third."""
    from patchioner_tpu_torch.models import decap
    from patchioner_tpu_torch.ops import memory_projection as mp
    from patchioner_tpu_torch.train import decoder_train as dt

    tcfg = dt.TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10, gaussian_noise=0.016)
    params = decap.init_decap(gcfg, features.shape[1],
                              torch.Generator(device="cuda").manual_seed(seed + 41), "cuda")
    ref = decap.DecapParams(*(_tree_copy(t, "cpu") for t in params))
    cpu_bank = mp.PreparedBank(bank.rows.cpu(), bank.inv_norm.cpu(), bank.num_real)
    sides = [(params, dt.make_optimizer(tcfg).init(params), bank),
             (ref, dt.make_optimizer(tcfg).init(ref), cpu_bank)]
    step = dt.make_train_step(gcfg, tcfg)
    gen = torch.Generator().manual_seed(seed + 42)
    n = TRAIN.batch
    for i in range(3):
        idx = slice(i * n, (i + 1) * n)
        noise = torch.randn(n, features.shape[1], generator=gen)
        metrics = []
        for (p, state, b), where in zip(sides, ("cuda", "cpu")):
            _, _, m = step(p, state, features[idx].to(where), tokens[idx].to(where),
                           bank=b, noise=noise.to(where))
            metrics.append(m)
        for k in ("loss", "acc"):
            _gate("train gate", metrics[0][k].reshape(1).cpu(), metrics[1][k].reshape(1),
                  f"step {i}, card vs CPU", k)
        if i == 0:
            _gate_leaves("train gate", _grads(sides[0][1].leaves), _grads(sides[1][1].leaves),
                         "every gradient leaf after one step, card vs CPU")
    _gate_leaves("train gate", dict(enumerate(sides[0][1].leaves)),
                 dict(enumerate(sides[1][1].leaves)), "the params after three steps")


def _prefix_phase(seed: int, smi: str) -> None:
    """ViECap's 8-layer mapping network and ClipCap's MLP mapper (prefix 10)
    trained on a frozen seeded GPT-2 base: steps timed at batch 80, then one
    step at `gate_rows` rows on the card against the CPU (loss, accuracy,
    every mapper gradient leaf)."""
    from patchioner_tpu_torch.io import checkpoints
    from patchioner_tpu_torch.models import clipcap, gpt2, patchioner, viecap
    from patchioner_tpu_torch.train import decoder_train as dt, prefix_cli, prefix_train as pt

    nl, nh, width, vocab = TRAIN.base
    base = gpt2.GPT2Config(n_layer=nl, n_head=nh, n_embd=width, vocab_size=vocab)
    gpt = gpt2.init_gpt2(base, torch.Generator(device="cuda").manual_seed(seed + 43), "cuda")
    gpt_cpu = _tree_copy(gpt, "cpu")
    n = TRAIN.prefix_batch * (TRAIN.timed_steps + 2)
    tok, mask = prefix_cli._tokenize(_train_captions(seed + 44, n),
                                     patchioner._get_gpt2_tokenizer(True), TRAIN.prefix_len)
    tokens, mask = torch.from_numpy(tok.astype(np.int64)), torch.from_numpy(mask)
    feats = torch.randn(n, D, generator=torch.Generator().manual_seed(seed + 45))
    vcfg = viecap.ViecapConfig(clip_hidden_size=D)
    mappers = {
        "viecap": (lambda g, where: viecap.init_mapping_network(vcfg, width, g, where),
                   lambda p, f: viecap.mapping_network_forward(p, f, vcfg, width), 0.016),
        "clipcap": (lambda g, where: clipcap.init_mlp_mapper(D, 10, width, g, where),
                    lambda p, f: clipcap.mlp_mapper_forward(p, f, 10, width), 0.0)}
    for name, (init, fn, noise) in mappers.items():
        tcfg = pt.PrefixTrainConfig(noise_variance=noise)
        tx = dt.AdamW(dt.linear_warmup_decay(tcfg.lr, tcfg.warmup_steps, tcfg.total_steps),
                      tcfg.weight_decay)
        step = pt.make_prefix_train_step(fn, base, tcfg)
        mapper = init(torch.Generator(device="cuda").manual_seed(seed + 46), "cuda")
        state = tx.init(mapper)
        gen = torch.Generator(device="cuda").manual_seed(seed + 47)
        b = TRAIN.prefix_batch
        batches = [tuple(t[i * b:(i + 1) * b].to("cuda") for t in (feats, tokens, mask))
                   for i in range(TRAIN.timed_steps + 2)]
        _timed_steps(lambda f, t, m: step(mapper, state, gpt, f, t, m, gen), batches,
                     f"{name} mapper", b, smi)
        # the gate: one step from the same init at gate_rows rows
        g = TRAIN.gate_rows
        noise_draw = torch.randn(g, D, generator=torch.Generator().manual_seed(seed + 48))
        metrics, grads = [], []
        fresh = init(torch.Generator(device="cuda").manual_seed(seed + 49), "cuda")
        for where, lm, mp_ in (("cuda", gpt, fresh), ("cpu", gpt_cpu, _tree_copy(fresh, "cpu"))):
            st = tx.init(mp_)
            _, st, m = step(mp_, st, lm, feats[:g].to(where), tokens[:g].to(where),
                            mask[:g].to(where), noise=noise_draw.to(where))
            metrics.append(m)
            grads.append(_grads(st.leaves))
        for k in ("loss", "acc"):
            _gate(f"{name} gate", metrics[0][k].reshape(1).cpu(), metrics[1][k].reshape(1),
                  f"{g} rows, card vs CPU", k)
        _gate_leaves(f"{name} gate", grads[0], grads[1],
                     f"every mapper gradient leaf after one step at {g} rows, card vs CPU")
        if any(leaf.grad is not None or leaf.requires_grad
               for _, leaf in checkpoints.flatten_tree(gpt)):
            raise AssertionError(f"[{name}] a gradient reached the frozen GPT-2")


def _train_then_serve(seed: int, smi: str, directory: str) -> None:
    """The decoder CLI trains 20 steps on a `--features` file and resumes;
    `from_config(decap_weights: <out_dir>)` serves 8 trace requests on the
    flagship (A, B, C, D and the decode graph asserted); the prefix CLI
    trains a ViECap and a ClipCap mapper, and each directory is served once
    through `weight_path`."""
    from patchioner_tpu_torch.io import checkpoints
    from patchioner_tpu_torch.train import cli, prefix_cli

    work = os.path.join(directory, "train")
    os.makedirs(work, exist_ok=True)
    corpus = os.path.join(work, "captions.json")
    with open(corpus, "w") as f:
        json.dump([{"image_id": i // 5, "caption": c} for i, c in
                   enumerate(_train_captions(seed + 52, TRAIN.cli_captions))], f)
    feats = os.path.join(work, "features.npy")
    np.save(feats, np.random.default_rng(seed + 53).standard_normal(
        (TRAIN.cli_captions, D)).astype(np.float32))
    out = os.path.join(work, "decap")
    nl, nh, width, vocab = TRAIN.decoder
    argv = ["--data", corpus, "--features", feats, "--out_dir", out, "--epochs", "2",
            "--bs", str(TRAIN.batch), "--seed", str(seed), "--device", "cuda",
            "--n_layer", str(nl), "--n_head", str(nh), "--n_embd", str(width),
            "--vocab_size", str(vocab), "--max_seq_len", str(TRAIN.max_seq_len)]
    epoch = TRAIN.cli_captions // TRAIN.batch  # an epoch's steps, 5 or more
    t0 = time.perf_counter()
    cli.main(argv + ["--limit_steps", str(epoch)])
    t1 = time.perf_counter()
    cli.main(argv + ["--resume", "--limit_steps", str(epoch + 5)])
    t2 = time.perf_counter()
    mgr = checkpoints.CheckpointManager(out)
    log(f"[train cli] {epoch} steps in {t1 - t0:.2f} s, then a resume to step "
        f"{mgr.latest_step()} in {t2 - t1:.2f} s (CLI wall, setup included); {smi}")
    if mgr.latest_step() != epoch + 5:
        raise AssertionError(f"[train cli] the resumed run ended at {mgr.latest_step()}")
    trained = mgr.restore()["params"]
    model = build_model(dict(FLAGSHIP_CONFIG, decap_weights=out), seed, "[trained]")
    if not torch.equal(model.decoder.clip_project["w"].cpu(), trained["clip_project"]["w"]):
        raise AssertionError("[trained] from_config did not load the trained decoder")
    phase_main_path(seed, smi, "trained", n_requests=B, model=model)
    del model
    torch.cuda.empty_cache()

    imgs, _ = _requests(B, seed + 54)
    for name, config, extra in (
            ("viecap", VIECAP_CONFIG, ["--num_layers", "8"]),
            ("clipcap", CLIPCAP_CONFIG, ["--prefix_length", "10"])):
        pdir = os.path.join(work, name)
        t0 = time.perf_counter()
        bl, bh, bw, bv = TRAIN.base
        prefix_cli.main(["--model", name, "--data", corpus, "--features", feats,
                         "--out_dir", pdir, "--bs", str(TRAIN.prefix_batch),
                         "--max_seq_len", str(TRAIN.prefix_len), "--n_layer", str(bl),
                         "--n_head", str(bh), "--n_embd", str(bw), "--vocab_size", str(bv),
                         "--limit_steps", "3", "--allow_random", "--device", "cuda", *extra])
        log(f"[train {name} cli] 3 steps in {time.perf_counter() - t0:.2f} s (CLI wall, "
            f"setup included)")
        block = dict(config[name], weight_path=pdir)
        model = build_model(dict(config, **{name: block}), seed, f"[trained {name}]")
        fam = model.viecap if name == "viecap" else model.clipcap
        key, leaf = ("linear", "w") if name == "viecap" else ("fc1", "w")
        params = fam.mapping_params if name == "viecap" else fam.mapper_params
        saved = checkpoints.CheckpointManager(pdir).restore()["params"]
        if not torch.equal(params[key][leaf].cpu(), saved[key][leaf]):
            raise AssertionError(f"[trained {name}] from_config did not load the trained mapper")
        caps = model.forward(imgs, get_cls_capt=True)["cls_capt"]
        log(f"[trained {name}] served through weight_path=<dir>: {len(caps)} whole-image "
            f"captions, caption 0 {caps[0][:60]!r}")
        if len(caps) != B or not all(isinstance(c, str) for c in caps):
            raise AssertionError(f"[trained {name}] the served captions are malformed")
        del model
        torch.cuda.empty_cache()
    import shutil

    shutil.rmtree(work)


def phase_training(seed: int, smi: str, directory: str) -> int:
    """Phase 10: decoder and prefix-mapper training on the card, f32 (TF32
    off), seeded weights and corpus. Returns kernel D's launches in the
    timed `--im_proj` steps."""
    from patchioner_tpu_torch.models import decap, gpt2
    from patchioner_tpu_torch.ops import memory_projection as mp
    from patchioner_tpu_torch.train import cli, data, decoder_train as dt, packing

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("phase 10 holds the card to the CPU in f32: TF32 must be off")
    nl, nh, width, vocab = TRAIN.decoder
    gcfg = gpt2.GPT2Config(n_layer=nl, n_head=nh, n_embd=width, vocab_size=vocab)
    steps = TRAIN.timed_steps + 2
    t0 = time.perf_counter()
    unique = _train_captions(seed + 40, 2000)
    toks = data.CaptionDataset(unique, max_len=TRAIN.max_seq_len).tokens
    log(f"[train] {len(unique)} seeded captions tokenized in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(seed + 40)
    n = TRAIN.batch * max(steps, 3)
    tokens = torch.from_numpy(toks[rng.integers(0, len(toks), n)].astype(np.int64))
    gen = torch.Generator(device="cuda").manual_seed(seed + 40)
    features = torch.randn(n, D, generator=torch.Generator().manual_seed(seed + 40))
    rows = torch.randn(TRAIN.bank_rows, D, generator=gen, device="cuda")
    bank = mp.prepare_bank(rows)
    del rows
    log(f"[train] decoder {nl}L/{nh}H/{width}, vocab {vocab}, prefix {D}, max_seq_len "
        f"{TRAIN.max_seq_len}, batch {TRAIN.batch}, f32; bank {bank.num_real} x "
        f"{bank.rows.shape[1]} f32 ({bank.rows.numel() * 4 / 1e9:.2f} GB)")

    # 10a: the reference CLI's step, plain and through the bank (kernel D)
    tcfg = dt.TrainConfig()
    step = dt.make_train_step(gcfg, tcfg)
    b = TRAIN.batch
    batches = [(features[i * b:(i + 1) * b].to("cuda"), tokens[i * b:(i + 1) * b].to("cuda"))
               for i in range(steps)]
    launches = {}
    for label, use in (("plain", None), ("--im_proj", bank)):
        params = decap.init_decap(gcfg, D, torch.Generator(device="cuda").manual_seed(seed), "cuda")
        state = dt.make_optimizer(tcfg).init(params)
        _, launches[label] = _timed_steps(
            lambda f, t: step(params, state, f, t, gen, use), batches, label, b, smi)
        del params, state
    if launches["plain"] or launches["--im_proj"] != TRAIN.timed_steps:
        raise AssertionError(f"[train] kernel D's launches {launches}: one a --im_proj step "
                             "and none without it expected")
    f64 = batches[0][0]
    d_ms = cuda_ms(lambda: mp.memory_project_streamed(f64, bank, normalize=True))
    plain_ms = cuda_ms(lambda: mp.memory_project_plain(f64, bank, normalize=True))
    got = mp.memory_project_streamed(f64, bank, normalize=True)
    want = mp.memory_project_plain(f64, bank, normalize=True)
    err = ((got - want).abs().max() / want.abs().max()).item()
    ops = 4 * b * bank.num_real * D
    nbytes = bank.rows.numel() * 4 + bank.inv_norm.numel() * 4 + 2 * f64.numel() * 4
    bound = max(ops / PEAK_FLOPS[torch.float32], nbytes / PEAK_BYTES_PER_S) * 1e3
    log(f"[train] kernel D at the step's {b} rows, f32 bank: {d_ms:.3f} ms (CUDA events, "
        f"median of 10), plain {plain_ms:.3f} ms, bound {bound:.3f} ms (f32 ops); "
        f"max|D - plain| / max|plain| = {err:.2e} (tol {TOLERANCE[torch.float32]:.0e}); {smi}")
    if not err <= TOLERANCE[torch.float32]:
        raise AssertionError(f"[train] kernel D differs from its plain version: {err:.2e}")
    d_launches = launches["--im_proj"]

    # 10b: packed rows, the chunked head and two micro-batches a step
    pool = _train_captions(seed + 55, 2000)
    ptoks = data.CaptionDataset(pool, max_len=TRAIN.max_seq_len).tokens
    # a caption is 8 tokens ([SOT] a <adj> <noun> in the <place> [EOT]), so
    # a row of 64 holds 8: enough captions for steps // 2 + 2 steps
    need = TRAIN.packed_rows * (steps // 2 + 2) * (TRAIN.pack_len // 8)
    all_toks = ptoks[np.random.default_rng(seed + 55).integers(0, len(ptoks), need)]
    pack = packing.pack_captions(all_toks, TRAIN.pack_len)
    pfeats = torch.randn(len(all_toks), D, generator=gen, device="cuda")
    pcfg = dt.TrainConfig(loss_chunk=TRAIN.loss_chunk, grad_accum=TRAIN.grad_accum)
    pstep = dt.make_packed_train_step(gcfg, pcfg)
    params = decap.init_decap(gcfg, D, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    state = dt.make_optimizer(pcfg).init(params)
    r = TRAIN.packed_rows
    pbatches = [(dt.pack_to_device(packing.PackedBatch(
        *(cli.microbatch(a[i * r:(i + 1) * r], TRAIN.grad_accum) for a in pack)), "cuda"),)
        for i in range(min(steps // 2 + 2, pack.targets.shape[0] // r))]
    per_step = int(pack.prefix_mask[:r].sum())
    log(f"[train packed] {len(all_toks)} captions packed into {pack.targets.shape[0]} rows of "
        f"{TRAIN.pack_len} ({packing.packing_efficiency(pack):.1%} of the slots score, "
        f"{pack.seg_feature_idx.shape[1]} segments at most a row), {per_step} captions in "
        f"a step's {r} rows; loss_chunk {TRAIN.loss_chunk}, grad_accum {TRAIN.grad_accum}")
    _timed_steps(lambda pk: pstep(params, state, pfeats, pk, gen), pbatches,
                 "packed", r, smi, captions_per_step=per_step)
    del params, state, pbatches, pfeats

    # 10c: card vs CPU on the --im_proj step
    _decoder_gates(gcfg, features, tokens, bank, seed)
    del bank
    torch.cuda.empty_cache()
    # 10d: the mappers; 10e: the CLIs, then serving what they trained
    _prefix_phase(seed, smi)
    torch.cuda.empty_cache()
    _train_then_serve(seed, smi, directory)
    return d_launches


# ------------------------------------------------------------------ phase 11


def phase_clip_served(seed: int, smi: str) -> int:
    """Phase 11a: DeCap on the CLIP ViT-B/16 tower at 592 px
    (configs/decap_B16_resize.k.yaml) in bf16, a random 500,000 x 512
    bank: 8 trace, 8 box and 8 whole-image requests served through
    `forward` after each kind's `warmup()`, D once a batch and a decode
    graph replayed, none captured; a whole-image batch's split and the
    encoder's kernels. Returns D's launches in the served runs."""
    model = build_model(CLIP_CONFIGS["decap_B16_resize"], seed, "[clip]")
    if (model.backbone_type != "CLIP" or model.supports_fused_trace_path()
            or model.vit_cfg.num_tokens != CLIP_TOKENS
            or tuple(model.bank.rows[:model.bank.num_real].shape) != (CLIP_BANK_ROWS, CLIP_D)):
        raise AssertionError("[clip] the model must be DeCap on the CLIP tower at 592 px over "
                             "the 500,000 x 512 bank, served through forward")
    imgs, requests = _kind_requests(B, seed + 40, model.crop_dim)
    launches = sum(c["memory_project"] for c in
                   _serve_each(model, requests, ("trace", "bbox", "cls"), "clip", smi).values())
    _whole_image_split(model, imgs, "clip", smi)
    _encoder_kernels(lambda: model.encode_images(imgs), smi)
    del model
    torch.cuda.empty_cache()
    return launches


def _whole_image_split(model, imgs, label: str, smi: str, patch_mean: bool = False) -> dict:
    """A whole-image batch apart, each stage by CUDA events (medians): the
    encoder, the projection of its CLS token (with `patch_mean`, of its
    patch mean) by D, the decode graph; and `forward` of the same batch
    (host clock). D must launch and no decode graph be captured. The
    stages' ms."""
    from patchioner_tpu_torch.ops import memory_projection as mp

    def whole(enc):
        return enc["x_norm_patchtokens"].mean(dim=1) if patch_mean else enc["x_norm_clstoken"]

    feats = whole(model.encode_images(imgs))
    prefix = model.project_features(feats)
    width = int(model.config["prefix_size"])
    if prefix.shape != (len(imgs), width) or not torch.isfinite(prefix).all():
        raise AssertionError(f"[{label}] the whole-image prefix is malformed: "
                             f"{tuple(prefix.shape)}")
    graphs = model.decode.captures
    d_before = mp.memory_project_streamed.launches
    ms = {"encoder": cuda_ms(lambda: model.encode_images(imgs), warmup=1, iters=5),
          "projection (D)": cuda_ms(lambda: model.project_features(feats)),
          "decode (graph)": cuda_ms(lambda: model.decode(prefix.float()))}
    forward_ms = _host_ms(lambda: model.forward(imgs, get_cls_capt=not patch_mean,
                                                get_avg_patch_capt=patch_mean))
    if model.decode.captures != graphs or mp.memory_project_streamed.launches == d_before:
        raise AssertionError(f"[{label}] the split captured a decode graph or skipped D")
    log(f"[{label}] a whole-image batch of {len(imgs)} at {model.crop_dim} px: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
        + f" (CUDA events, medians); forward {forward_ms:.1f} ms (host clock, median of 3); "
        f"{smi}")
    return ms


def _encoder_kernels(fn, smi: str, top: int = 6, label: str = "clip",
                     what: str = "encoder") -> None:
    """The device time by kernel in one call of fn() (torch.profiler; the
    plain CLIP tower by default): the total, the idle share of the call's
    wall, and the `top` kernels by time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    device = sum(e.self_device_time_total for e in events) / 1e3
    log(f"[{label}] {what} under the profiler: {device:.2f} ms of device time in "
        f"{sum(e.count for e in events)} kernels, wall {wall:.2f} ms, idle share "
        f"{max(0.0, 1 - device / wall):.3f}; {smi}")
    for e in events[:top]:
        log(f"[{label}]   {e.self_device_time_total / 1e3:8.3f} ms in {e.count:4d} x "
            f"{e.key[:90]}")


def _clip_f32_gate(label: str, config: dict, seed: int, boxes: bool = False) -> None:
    """Phase 11b, one model: f32 on the card against the same weights on
    the CPU (TF32 off), two images: the encoder's CLS and patch tokens and
    the projected prefix under the gate, the captions compared (reported);
    with `boxes` also AlphaCLIP's box path (4 boxes an image, one encoder
    pass each), its CLS features and their prefix."""
    from patchioner_tpu_torch.models.patchioner import Patchioner

    gpu = Patchioner.from_config(config, rng_seed=seed, allow_missing_weights=True,
                                 dtype=torch.float32, device="cuda")
    cpu = gpu.to("cpu")
    imgs, _ = _requests(2, seed + 41, gpu.crop_dim)
    got = {}
    for where, m in (("card", gpu), ("cpu", cpu)):
        t0 = time.perf_counter()
        enc = m.encode_images(imgs)
        prefix = m.project_features(enc["x_norm_clstoken"])
        tokens, _ = m.decode(prefix.float())
        got[where] = [t.float().cpu() for t in (enc["x_norm_clstoken"],
                                                enc["x_norm_patchtokens"], prefix, tokens)]
        log(f"[{label}] whole image on {where}: {time.perf_counter() - t0:.1f} s")
    for i, what in enumerate(("x_norm_clstoken", "x_norm_patchtokens", "projected prefix")):
        _gate(label, got["card"][i], got["cpu"][i], f"{what} {tuple(got['cpu'][i].shape)}, "
              "card vs CPU", "encoder" if i < 2 else "prefix")
    same = (got["card"][3] == got["cpu"][3]).all(-1).sum().item()
    log(f"[{label}] {gpu.backbone_type} at {gpu.crop_dim} px ({gpu.vit_cfg.num_tokens} "
        f"tokens): captions card vs CPU (reported, not asserted): {same}/2 equal")
    if boxes:
        sets = _query_boxes(2, seed + 43)
        pixel_boxes = _pixel_boxes(sets, [0, 0, 1, 1], gpu.crop_dim, max_boxes=4)
        seen, caps = {}, {}
        for where, m in (("card", gpu), ("cpu", cpu)):
            seen[where] = _recording(m)
            caps[where] = m.forward(imgs, get_cls_capt=False, bboxes=pixel_boxes)["bbox_capts"]
        for key in ("features", "decoder input"):
            _gate(label, seen["card"][key][0], seen["cpu"][key][0],
                  f"box path {tuple(seen['cpu'][key][0].shape)}, card vs CPU", key)
        flat = {w: [c for row in caps[w] for c in row] for w in caps}
        log(f"[{label}] box captions card vs CPU (reported, not asserted): "
            f"{sum(a == b for a, b in zip(flat['card'], flat['cpu']))}/{len(flat['cpu'])} equal")
    del gpu, cpu
    torch.cuda.empty_cache()


def phase_clip_f32(seed: int) -> None:
    """Phase 11b: each CLIP variant f32, card vs CPU."""
    for label, config, boxes in (
            ("f32 clip B/16", CLIP_CONFIGS["decap_B16"], False),
            ("f32 clip B/32", CLIP_CONFIGS["decap_B32"], False),
            ("f32 invite 592", CLIP_CONFIGS["INViTE_B16_1layer_bigResize"], False),
            ("f32 openclip", OPENCLIP_CONFIG, False),
            ("f32 denseclip 640", CLIP_CONFIGS["denseclip_B16_seg_40patches"], False),
            ("f32 alphaclip", CLIP_CONFIGS["alphaclip_B16_CLS"], True)):
        _clip_f32_gate(label, config, seed, boxes)


def phase_clip_families(seed: int, smi: str, directory: str) -> None:
    """Phase 11c: ViECap (configs/viecap.k.yaml, the copied CLIP-space COCO
    entity embeddings) and MeaCap (configs/meacap_invlm.k.yaml over a
    seeded 591,753-row memory) on the CLIP ViT-B/32 tower, random weights:
    one whole-image batch of 8 each, split inside the same `forward` calls;
    no kernel launched (a plain tower, no bank) and no DeCap graph."""
    import shutil

    from patchioner_tpu_torch.models import meacap, viecap

    for name in ("viecap", "meacap_invlm"):
        config, base = CLIP_CONFIGS[name], None
        if name == "meacap_invlm":
            vd = config["viecap"]
            base = write_meacap_memory(seed, directory, CLIP_D, vd["meacap"]["memory_id"])
            config = dict(config, viecap=dict(vd, meacap=dict(vd["meacap"],
                                                              memory_base_path=base)))
        tag = f"clip {name}"
        model = build_model(config, seed, f"[{tag}]")
        fam = model.viecap
        if name == "viecap":
            # the copied embeddings: the COCO entities, prompt ensemble, B/32
            rows = (len(fam.entities), fam.texts_embeddings.shape[1])
            ok = rows == (80, CLIP_D) and fam.texts_embeddings.std().item() > 0.01
            what = f"{rows[0]} entities x {rows[1]}"
        else:
            ok = (isinstance(fam, meacap.MeaCap) and len(fam.memory_captions) == MEMORY_ROWS
                  and fam.memory_clip_embeddings.shape[1] == CLIP_D)
            what = (f"memory {len(fam.memory_captions)} captions x "
                    f"{fam.memory_clip_embeddings.shape[1]}")
        if not ok or model.bank is not None or model.supports_fused_trace_path():
            raise AssertionError(f"[{tag}] the model must be {name} on the CLIP tower, "
                                 "without a bank")
        log(f"[{tag}] {type(fam).__name__}, {what}, GPT-2 {fam.gpt2_cfg.n_layer}L/"
            f"{fam.gpt2_cfg.n_embd} in {str(fam.gpt2_params['wte'].dtype)[6:]}")
        imgs, _ = _requests(B, seed + 42, model.crop_dim)
        parts = {"encoder": (model, "encode_images")}
        if name == "meacap_invlm":
            parts["retrieval"] = (meacap, "retrieve_memory_captions")
        parts[f"greedy search of {fam.cfg.max_len} tokens"] = (viecap, "run_search")
        wrappers = _wrappers()
        for fn in wrappers.values():
            fn.launches = 0
        graphs = model.decode.captures, model.decode.replays
        _forward_split(model, imgs, smi, tag, parts)
        counts = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
        if counts or (model.decode.captures, model.decode.replays) != graphs:
            raise AssertionError(f"[{tag}] kernels {counts} or the DeCap decoder ran")
        del model, fam
        torch.cuda.empty_cache()
        if base is not None:
            shutil.rmtree(base)


def phase_clip(seed: int, smi: str, directory: str) -> int:
    """Phase 11: the CLIP backbone family (11a served, 11b f32 gates, 11c
    ViECap and MeaCap); D's launches in 11a's served runs."""
    launches = phase_clip_served(seed, smi)
    phase_clip_f32(seed)
    phase_clip_families(seed, smi, directory)
    return launches


# ------------------------------------------------------------------ phase 12

# the five text spaces at full geometry: (checkpoint prefix, width, depth,
# context, projection). CLIP ViT-B/16's text tower is the one the flagship's
# bank is built with; DINO.txt's is the tet1280d20h24l release's; DenseCLIP's
# context is its config's (data/denseclip_configs)
TEXT_SPACES = {
    "clip": ("", 512, 12, 77, 512),
    "open_clip": ("", 512, 12, 77, 512),
    "regionclip": ("lang_encoder.", 512, 12, 77, 1024),
    "denseclip": ("text_encoder.", 512, 12, 13, 512),
    "dinotxt": ("text_model.", 1280, 24, 77, 2048),
}
# a quarter of the flagship's COCO support memory (591,753 rows): the build's
# captions/s is a steady state of 1,000-caption batches at either size, and
# the full build's ~150 s (PR 19) no longer fits the script's time limit
# beside phases 15 and 16 on a card whose host is slow
TEXT_BANK_ROWS = MEMORY_ROWS // 4
TEXT_BANK_BATCH = 1000  # the JAX bank mode's --bs
TEXT_GATE_ROWS = 256  # the clip space's f32 gate; the other spaces take 8
TEXT_TRAIN_CAPTIONS = 2048
TEXT_TRAIN_STEPS = 32  # one epoch at the reference CLI's batch 64
# a caption is 6-16 words of these: enough that the BPE and its cache see
# the shapes of real captions
BANK_WORDS = sum(MEMORY_WORDS, ()) + (
    "a", "the", "on", "with", "of", "and", "is", "next", "to", "near", "two", "three",
    "sitting", "standing", "holding", "playing", "riding", "eating", "looking", "at", "its",
    "while", "some", "people", "group", "front", "top", "under", "behind", "grass")


def _bank_captions(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    lengths = rng.integers(6, 17, n)
    words = np.asarray(BANK_WORDS)[rng.integers(0, len(BANK_WORDS), int(lengths.sum()))]
    ends = np.cumsum(lengths).tolist()
    return [" ".join(words[e - k:e]) for e, k in zip(ends, lengths.tolist())]


def _text_cfg(name: str):
    from patchioner_tpu_torch.models import clip

    _, width, depth, context, proj = TEXT_SPACES[name]
    return clip.ClipTextConfig(context_length=context, width=width, depth=depth,
                               heads=width // 64, proj_dim=proj)


def text_state_dict(tree: dict, prefix: str = "") -> dict:
    """A port text tower as an openai/CLIP-layout state dict under `prefix`,
    the inverse of `models.clip.port_openai_clip_text` (each `nn.Linear`
    (out, in); `text_projection` stays (D, proj))."""
    sd = {"token_embedding.weight": tree["token_embedding"],
          "positional_embedding": tree["pos_embed"],
          "ln_final.weight": tree["ln_final"]["scale"], "ln_final.bias": tree["ln_final"]["bias"],
          "text_projection": tree["text_projection"]} | _resblocks_state_dict(tree["blocks"])
    return _cpu({prefix + k: v for k, v in sd.items()})


def _resblocks_state_dict(blocks: list) -> dict:
    """A CLIP tower's blocks as openai/CLIP `transformer.resblocks.N` keys
    (each `nn.Linear` (out, in), `attn.in_proj_*` the fused qkv)."""
    sd = {}
    for i, blk in enumerate(blocks):
        q = f"transformer.resblocks.{i}"
        for key in ("ln_1", "ln_2"):
            sd[f"{q}.{key}.weight"] = blk[key]["scale"]
            sd[f"{q}.{key}.bias"] = blk[key]["bias"]
        sd[f"{q}.attn.in_proj_weight"] = blk["qkv"]["w"].t()
        sd[f"{q}.attn.in_proj_bias"] = blk["qkv"]["b"]
        for key, name in (("out_proj", "attn.out_proj"), ("fc1", "mlp.c_fc"),
                          ("fc2", "mlp.c_proj")):
            sd[f"{q}.{name}.weight"] = blk[key]["w"].t()
            sd[f"{q}.{name}.bias"] = blk[key]["b"]
    return sd


def write_text_checkpoints(seed: int, directory: str) -> dict:
    """Each text space's tower at full geometry (`TEXT_SPACES`), drawn on
    the card from a seed with `init_clip_text`'s distributions, biases and
    LayerNorms moved off their init so that they count, written with
    `torch.save` in the openai/CLIP layout under the space's prefix; and a
    Talk2DINO projection 512 -> 768. {space or 't2d': path}."""
    from patchioner_tpu_torch.models import clip

    paths = {}
    for i, name in enumerate(TEXT_SPACES):
        gen = torch.Generator(device="cuda").manual_seed(seed + 60 + i)
        tree = clip.init_clip_text(_text_cfg(name), gen, "cuda")
        for blk in tree["blocks"] + [tree]:
            for leaf in blk.values():
                if isinstance(leaf, dict):
                    for key, v in leaf.items():
                        if v.dim() == 1:
                            v += 0.02 * torch.randn(v.shape, generator=gen, device="cuda")
        paths[name] = os.path.join(directory, f"text_{name}.pt")
        torch.save(text_state_dict(tree, TEXT_SPACES[name][0]), paths[name])
        del tree
    gen = torch.Generator().manual_seed(seed + 66)
    paths["t2d"] = os.path.join(directory, "text_talk2dino.pth")
    torch.save(talk2dino_state_dict({"w": torch.randn(512, D, generator=gen) * 512 ** -0.5,
                                     "b": 0.1 * torch.randn(D, generator=gen)}), paths["t2d"])
    torch.cuda.empty_cache()
    return paths


def phase_text_bank(seed: int, smi: str, directory: str, paths: dict):
    """Phase 12a: a quarter of the flagship's support memory built on the card as
    `extract_features bank` builds it, without its HDF5 write (the card's
    machine has no h5py): `TEXT_BANK_ROWS` seeded captions through the
    `clip` space of the ViT-B/16 text file, Talk2DINO-projected to 768, in
    batches of `TEXT_BANK_BATCH`; (the bank, its captions)."""
    from patchioner_tpu_torch.train import extract_features as ef

    t0 = time.perf_counter()
    captions = _bank_captions(seed + 61, TEXT_BANK_ROWS)
    corpus = os.path.join(directory, "text_bank_corpus.json")
    with open(corpus, "w") as f:
        json.dump({"annotations": [{"caption": c, "image_id": i}
                                   for i, c in enumerate(captions)]}, f)
    log(f"[text bank] {len(captions)} seeded captions of 6-16 words written in "
        f"{time.perf_counter() - t0:.1f} s")
    args = ef.build_argparser().parse_args([
        "bank", "--data", corpus, "--size", str(TEXT_BANK_ROWS), "--no-sample",
        "--text-weights", paths["clip"], "--talk2dino", paths["t2d"],
        "--bs", str(TEXT_BANK_BATCH), "--device", "cuda"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bank, encoder = ef.make_bank(args, torch.device("cuda"))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tok, tower = encoder.seconds["tokenizer"], encoder.seconds["tower"]
    n = len(bank)
    cfg = encoder.space.cfg
    t, d = cfg.context_length, cfg.width
    # the tower's operations: per token and layer the qkv, out-projection
    # and MLP products (12 d^2 multiply-adds) and the causal attention's
    # q k^T and weights @ v over the full context (2 t d); then the pooled
    # row's projection and Talk2DINO's linear
    ops = 2 * n * (t * cfg.depth * (12 * d * d + 2 * t * d) + d * cfg.proj_dim
                   + cfg.proj_dim * D)
    bound = ops / PEAK_FLOPS[torch.float32]
    log(f"[text bank] {n} captions through the clip space ({d} wide, {cfg.depth} layers, "
        f"{cfg.heads} heads, context {t}, vocab {cfg.vocab_size}, projection "
        f"{cfg.proj_dim}; f32, TF32 off) and Talk2DINO {cfg.proj_dim} -> {D}, "
        f"{TEXT_BANK_BATCH} a batch: {wall:.1f} s in all, {n / wall:.0f} captions/s; "
        f"tokenizer {tok:.1f} s on the host ({n / tok:.0f} captions/s), tower and "
        f"projection {tower:.1f} s waited for ({n / tower:.0f} captions/s, "
        f"{ops / tower / 1e12:.1f} TFLOP/s against the f32 peak's bound {bound:.1f} s), "
        f"the rest {wall - tok - tower:.1f} s (the corpus read, the space built); peak "
        f"device memory {peak:.2f} GiB; {smi}")
    if bank.embeddings.shape != (TEXT_BANK_ROWS, D) or bank.texts != captions:
        raise AssertionError(f"[text bank] bank {bank.embeddings.shape} with "
                             f"{len(bank.texts)} texts")
    if not np.isfinite(bank.embeddings).all():
        raise AssertionError("[text bank] the bank has non-finite rows")
    return bank, captions


@torch.no_grad()
def phase_text_gates(paths: dict, captions: list, bank) -> None:
    """Phase 12b: each space built from its file on the card and on the CPU,
    f32 with TF32 off, under phase 5's gate: the `clip` space's raw output
    on `TEXT_GATE_ROWS` of the bank's captions and the bank's own rows
    (Talk2DINO-projected) against the CPU's projection; the other four on 8
    captions each, DINO.txt's raw 2048 columns and its patch-aligned half."""
    from patchioner_tpu_torch.train import text_spaces
    from patchioner_tpu_torch.train.extract_features import talk2dino_projection

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("phase 12 holds the card to the CPU in f32: TF32 must be off")
    for name in TEXT_SPACES:
        texts = captions[:TEXT_GATE_ROWS if name == "clip" else 8]
        out = {}
        for where in ("cuda", "cpu"):
            space = text_spaces.build_text_space(name, paths[name], device=where)
            toks = space.tokenize(texts)
            t0 = time.perf_counter()
            raw = space.encode_tokens_raw(toks)
            out[where] = (raw.cpu(), space.encode_tokens(toks).cpu())
            if where == "cpu" and name == "clip":
                out["projected"] = talk2dino_projection(paths["t2d"], "cpu")(raw)
            log(f"[text f32 {name}] {where}: {space.cfg.width} wide, {space.cfg.depth} layers, "
                f"context {space.cfg.context_length}, output {space.cfg.proj_dim}, prefix "
                f"{space.prefix_size}; {len(texts)} captions in "
                f"{time.perf_counter() - t0:.2f} s")
            del space
        what = f"{len(texts)} captions, card vs CPU"
        _gate(f"text f32 {name}", out["cuda"][0], out["cpu"][0], what, noun="tower output")
        if name == "dinotxt":
            _gate(f"text f32 {name}", out["cuda"][1], out["cpu"][1], what,
                  noun="patch-aligned half")
        if name == "clip":
            _gate(f"text f32 {name}", torch.from_numpy(bank.embeddings[:len(texts)]),
                  out["projected"], f"{what} (the built bank's rows)", noun="Talk2DINO row")
        torch.cuda.empty_cache()


def phase_text_served(seed: int, smi: str, bank) -> int:
    """Phase 12c: the flagship (bf16, `fusedqkv`) with the built bank as its
    support memory, handed in as phase 6 hands the CPU model the card's
    drawn bank; 8 trace requests served after `warmup()`, A, B, C and D and
    a decode-graph replay a batch asserted. D's launches."""
    from patchioner_tpu_torch.models.patchioner import Patchioner
    from patchioner_tpu_torch.ops import memory_projection as mp

    model = Patchioner.from_config(FLAGSHIP_CONFIG, rng_seed=seed, allow_missing_weights=True,
                                   random_bank_size=1, dtype=torch.bfloat16, device="cuda")
    rows = torch.from_numpy(bank.embeddings).to("cuda")
    model.bank = mp.prepare_bank(rows, dtype=torch.bfloat16)
    model.bank_texts = bank.texts
    del rows
    log(f"[text served] the flagship with the built bank: {model.bank.num_real} x "
        f"{model.bank.rows.shape[1]} {str(model.bank.rows.dtype)[6:]}")
    imgs, traces = _requests(B, seed + 62)
    captions, snap, batches, wall, counts = _serve(
        model, [(im, {"trace": tr}) for im, tr in zip(imgs, traces)], "[text served]")
    log(f"[text served] {len(captions)} captions in {batches} batch(es), mean request latency "
        f"{snap['mean_latency_ms']} ms, {len(captions) / wall:.3f} captions/s; caption 0: "
        f"{captions[0][:60]!r}; {smi}")
    del model
    torch.cuda.empty_cache()
    return counts["memory_project"]


def phase_text_training(seed: int, smi: str, directory: str, paths: dict, bank) -> int:
    """Phase 12d: `train.cli --encode_on_the_fly` with the clip file and
    Talk2DINO on `TEXT_TRAIN_CAPTIONS` seeded captions, `--im_proj` over the
    built bank in f32 (handed to the CLI's bank loader in memory: the
    card's machine has no h5py to read a bank file), the reference CLI's
    decoder, `TEXT_TRAIN_STEPS` steps. D's launches, one a step."""
    from patchioner_tpu_torch.io import memory_bank
    from patchioner_tpu_torch.train import cli

    work = os.path.join(directory, "text_train")
    os.makedirs(work, exist_ok=True)
    corpus = os.path.join(work, "captions.json")
    with open(corpus, "w") as f:
        json.dump([{"image_id": i // 5, "caption": c} for i, c in
                   enumerate(_bank_captions(seed + 63, TEXT_TRAIN_CAPTIONS))], f)
    handed = os.path.join(work, "built_bank.h5")  # never written
    read = memory_bank.load_bank

    def load_bank(path, dataset=None, *, dinotxt_slice=False):
        return bank if path == handed else read(path, dataset, dinotxt_slice=dinotxt_slice)

    d_kernel = _wrappers()["memory_project"]
    d_kernel.launches = 0
    memory_bank.load_bank = load_bank
    t0 = time.perf_counter()
    try:
        cli.main(["--data", corpus, "--encode_on_the_fly", "--text_weights", paths["clip"],
                  "--talk2dino_weights", paths["t2d"], "--im_proj", "--bank", handed,
                  "--out_dir", os.path.join(work, "decap"), "--epochs", "1", "--bs", "64",
                  "--limit_steps", str(TEXT_TRAIN_STEPS), "--seed", str(seed),
                  "--device", "cuda"])
    finally:
        memory_bank.load_bank = read
    wall = time.perf_counter() - t0
    with open(os.path.join(work, "decap", "train_log.csv")) as f:
        epoch, step, loss, acc, secs = f.read().split()[-1].split(",")
    launches = d_kernel.launches
    log(f"[text train] {TEXT_TRAIN_CAPTIONS} captions encoded on the fly (clip space, "
        f"Talk2DINO to {D}), decoder 4L/4H/768 vocab 50257, batch 64, --im_proj over the "
        f"built {len(bank)} x {D} f32 bank: {step} steps, loss {loss}, acc {acc}; the epoch's "
        f"loop {secs} s ({int(step) / max(float(secs), 1e-9):.1f} steps/s), the CLI "
        f"{wall:.1f} s with set-up; kernel D {launches} launches; {smi}")
    if int(step) != TEXT_TRAIN_STEPS or launches != TEXT_TRAIN_STEPS:
        raise AssertionError(f"[text train] {step} steps and {launches} launches of D, "
                             f"{TEXT_TRAIN_STEPS} each expected")
    if not np.isfinite(float(loss)):
        raise AssertionError(f"[text train] loss {loss}")
    import shutil

    shutil.rmtree(work)
    return launches


@torch.no_grad()
def phase_text_images(seed: int, smi: str, directory: str) -> None:
    """Phase 12e: `extract_features image` over 16 seeded images through the
    flagship config (f32, a hub DINOv2 file written here), `cls` and
    `avg_self_attn`, A, B and C 12 launches a run asserted; the first two
    images' features on the CPU, from the same file, under phase 5's gate."""
    from PIL import Image

    from patchioner_tpu_torch.models import vit
    from patchioner_tpu_torch.models.patchioner import Patchioner
    from patchioner_tpu_torch.train import extract_features as ef
    from patchioner_tpu_torch.utils import transforms

    work = os.path.join(directory, "text_images")
    folder = os.path.join(work, "images")
    os.makedirs(folder)
    gen = torch.Generator().manual_seed(seed + 64)
    tree = vit.init_vit(vit.config_for(FLAGSHIP_CONFIG["dino_model"]), gen)
    for blk in tree["blocks"]:
        blk["ls1"], blk["ls2"] = 1 + 0.1 * torch.randn(2, D, generator=gen)
    config = dict(FLAGSHIP_CONFIG, dino_weights=os.path.join(work, "dinov2.pth"))
    torch.save(hub_state_dict(tree), config["dino_weights"])
    config_path = os.path.join(work, "flagship.json")
    with open(config_path, "w") as f:
        json.dump(config, f)
    rng = np.random.default_rng(seed + 65)
    for i in range(16):
        Image.fromarray(rng.integers(0, 256, (IMG + 20, IMG + 60, 3), dtype=np.uint8)).save(
            os.path.join(folder, f"{i:02d}.png"))
    wrappers = _wrappers()
    card = {}
    for select in ("cls", "avg_self_attn"):
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        card[select] = ef.main(["image", "--config", config_path, "--images", folder,
                                "--out", os.path.join(work, f"{select}.npy"), "--select", select,
                                "--bs", "16", "--allow-random", "--device", "cuda"])
        counts = {name: fn.launches for name, fn in wrappers.items()}
        want = {name: 12 if name in ("ln_dense", "qkv_attention", "ln_mlp") else 0
                for name in wrappers}
        log(f"[text images] extract_features image --select {select}: "
            f"{card[select].shape} in {time.perf_counter() - t0:.1f} s (the model built "
            f"from its config included); launches {counts}")
        if counts != want:
            raise AssertionError(f"[text images] launches {counts} != {want}")
    model = Patchioner.from_config(config, allow_missing_weights=True, random_bank_size=1,
                                   device="cpu")
    names = sorted(os.listdir(folder))[:2]
    batch = np.stack([transforms.preprocess_pil_uint8(Image.open(os.path.join(folder, n)),
                                                      model.resize_dim, model.crop_dim)
                      for n in names])
    enc = model.encode_images(batch)
    for select, feats in card.items():
        _gate("text images", torch.from_numpy(feats[:2]), ef.select_features(enc, select),
              f"{select}, 2 images, card vs CPU", noun="feature")
    import shutil

    shutil.rmtree(work)


def phase_text_scores(seed: int, smi: str, paths: dict, captions: list) -> None:
    """Phase 12f: `ClipScorer` on CLIP ViT-B/16 (the vision tower at 224 px,
    seeded, and the clip text file) scores 8 captions against 8 images on
    the card and on the CPU: PAC-S and RefPAC-S (one candidate without
    references), each score within 1e-4."""
    from patchioner_tpu_torch.eval import pac_score
    from patchioner_tpu_torch.models import clip

    vcfg, tcfg = clip.ClipVisionConfig(), _text_cfg("clip")
    vparams = clip.init_clip_vision(vcfg, torch.Generator().manual_seed(seed + 67))
    tparams = clip.port_openai_clip_text(torch.load(paths["clip"], weights_only=True),
                                         tcfg.depth)
    pixels = np.random.default_rng(seed + 68).standard_normal(
        (8, vcfg.img_size, vcfg.img_size, 3)).astype(np.float32)
    candidates = captions[:8]
    references = [captions[8 + 2 * i:10 + 2 * i] for i in range(7)] + [[]]
    scores = {}
    for where in ("cuda", "cpu"):
        scorer = pac_score.ClipScorer(vparams, tparams, vcfg, tcfg, device=where)
        t0 = time.perf_counter()
        images = scorer.encode_images(pixels)
        pac, per, cand, _ = pac_score.pac_score(scorer, images, candidates)
        ref, ref_per = pac_score.ref_pac_score(scorer, references, cand)
        scores[where] = (pac, per, ref, ref_per)
        log(f"[text scores] {where}: PAC-S {pac:.6f}, RefPAC-S {ref:.6f} for 8 captions "
            f"against 8 images (ViT-B/16 at {vcfg.img_size} px, 14 reference captions) in "
            f"{time.perf_counter() - t0:.2f} s")
    (pac, per, ref, ref_per), (cpac, cper, cref, cref_per) = scores["cuda"], scores["cpu"]
    err = max(abs(pac - cpac), abs(ref - cref), float(np.abs(per - cper).max()),
              float(np.abs(ref_per - cref_per).max()))
    log(f"[text scores] PAC-S and RefPAC-S, card vs CPU: max|d| = {err:.3e} (tol 1e-4); "
        f"the candidate without references scores {ref_per[-1]}; {smi}")
    if not err <= 1e-4 or ref_per[-1] != 0.0:
        raise AssertionError(f"[text scores] card vs CPU {err:.3e}, no-reference score "
                             f"{ref_per[-1]}")


def phase_text(seed: int, smi: str, directory: str) -> tuple[int, int]:
    """Phase 12: the text towers (12a the flagship's bank built, 12b f32
    gates of the five spaces, 12c served from the built bank, 12d training
    on text features, 12e image features, 12f scoring); D's launches in
    12c's served run and in 12d's steps."""
    t0 = time.perf_counter()
    paths = write_text_checkpoints(seed, directory)
    sizes = ", ".join(f"{os.path.basename(p)} {os.path.getsize(p) / 1e9:.3f} GB"
                      for p in paths.values())
    log(f"[text files] wrote {sizes} in {time.perf_counter() - t0:.1f} s")
    bank, captions = phase_text_bank(seed, smi, directory, paths)
    phase_text_gates(paths, captions, bank)
    served = phase_text_served(seed, smi, bank)
    trained = phase_text_training(seed, smi, directory, paths, bank)
    del bank
    phase_text_images(seed, smi, directory)
    phase_text_scores(seed, smi, paths, captions)
    for path in paths.values():
        os.remove(path)
    return served, trained


# ------------------------------------------------------------------ phase 13

EVAL_IMAGES = 64
EVAL_SIZE = (640, 480)  # (width, height): COCO's most common size
EVAL_BATCH = 16  # configs/evaluation/*.json's batch_size
# the crop-and-caption baseline runs one encoder pass a 16 crops: its
# images are cut to one batch, 16 images of up to 16 boxes
EVAL_CROP_IMAGES = 16
EVAL_MODEL = "mlp.k"  # the flagship's name in configs/evaluation/main_table.json
EVAL_KERNELS = {"ln_dense": "A", "qkv_attention": "B", "ln_mlp": "C", "memory_project": "D"}


def _eval_caption(rng, lo: int = 6, hi: int = 14) -> str:
    return " ".join(rng.choice(BANK_WORDS, int(rng.integers(lo, hi))))


def _eval_boxes(rng, k: int, size=EVAL_SIZE) -> list:
    """k integer xyxy boxes of at least 8 px a side inside a `size` image."""
    w, h = size
    x1, y1 = rng.integers(0, w - 16, k), rng.integers(0, h - 16, k)
    x2 = np.minimum(x1 + rng.integers(8, w // 2, k), w - 1)
    y2 = np.minimum(y1 + rng.integers(8, h // 2, k), h - 1)
    return np.stack([x1, y1, x2, y2], -1).tolist()


def write_eval_dataset(directory: str, seed: int, n: int = EVAL_IMAGES,
                       size=EVAL_SIZE) -> dict:
    """The four tasks' seeded data in their published layouts: n JPEG
    images named by zero-filled COCO id (the loaders' `{id}.jpg`); a
    Localized-Narratives trace file `{id: {captions, traces}}` whose name
    holds `coco`, so that ids are zero-filled, 1-2 traces an image of
    50-400 points (a random walk in [0, 1]); a COCO dense file of 1-16
    boxes an image, stored xyxy as the loader reads them; a region-set file
    of 1-4 sets of 1-5 xyxy boxes an image; and a COCO captions file of 1-5
    references an image. Captions are words of `BANK_WORDS`. Returns the
    image folder and each file's path."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    folder = os.path.join(directory, "images")
    os.makedirs(folder)
    ids = list(range(1, n + 1))
    w, h = size
    for i in ids:
        # smooth colour fields plus noise, so that JPEG sees image-like content
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        phase = rng.uniform(0, 2 * np.pi, 3)
        freq = rng.uniform(0.005, 0.03, (3, 2))
        field = np.stack([127 + 100 * np.sin(freq[c, 0] * xx + freq[c, 1] * yy + phase[c])
                          for c in range(3)], -1)
        pixels = np.clip(field + rng.normal(0, 20, field.shape), 0, 255).astype(np.uint8)
        Image.fromarray(pixels).save(os.path.join(folder, f"{i:012d}.jpg"), quality=90)
    images = [{"id": i, "file_name": f"{i:012d}.jpg", "width": w, "height": h} for i in ids]

    def walk(k):
        steps = rng.normal(0, 0.02, (k, 2))
        pts = np.clip(rng.uniform(0.1, 0.9, 2) + np.cumsum(steps, 0), 0, 1)
        return [{"x": float(x), "y": float(y)} for x, y in pts]

    files = {
        "trace": {str(i): {"captions": [_eval_caption(rng) for _ in range(k)],
                           "traces": [walk(int(rng.integers(50, 401))) for _ in range(k)]}
                  for i in ids for k in [int(rng.integers(1, 3))]},
        "dense": {"images": images, "categories": [], "annotations": [
            {"id": 100 * i + j, "image_id": i, "caption": _eval_caption(rng, 3, 8), "bbox": box}
            for i in ids
            for j, box in enumerate(_eval_boxes(rng, int(rng.integers(1, 17)), size))]},
        "region_set": {str(i): {f"{_eval_caption(rng)} {s}": _eval_boxes(
            rng, int(rng.integers(1, 6)), size) for s in range(int(rng.integers(1, 5)))}
            for i in ids},
        "image": {"images": images, "categories": [], "annotations": [
            {"id": 100 * i + j, "image_id": i, "caption": _eval_caption(rng)}
            for i in ids for j in range(int(rng.integers(1, 6)))]},
    }
    paths = {"images": folder}
    for task, obj in files.items():
        paths[task] = os.path.join(directory, f"{task}_coco_test.json")
        with open(paths[task], "w") as f:
            json.dump(obj, f)
    return paths


def _eval_warmup(model, max_rows: int = EVAL_BATCH * MAX_BOXES) -> int:
    """Capture the decode graph of every power-of-two row bucket up to
    `max_rows` (an f32 prefix, as the projection gives) on this thread,
    which runs the evaluators; the number of buckets."""
    width = int(model.config["prefix_size"])
    rows = 1
    while rows <= max_rows:
        model.decode(torch.zeros(rows, width, device=model.device))
        rows *= 2
    torch.cuda.synchronize()
    return rows.bit_length() - 1


def _eval_run(model, label: str, evaluate, annotations: str, images: str, fused: bool,
              smi: str, **kw) -> dict:
    """One evaluator run at `EVAL_BATCH`, every launch counter zeroed
    first: the result, with its launches, the decode graphs' replays and
    captures and the wall time. Asserts that no graph was captured, that
    every encoder pass launched A, B and C once a layer (12 times on the
    flagship) and every projection D once and replayed one graph, and, for
    a fused run, one projection a batch."""
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    graphs = model.decode.captures, model.decode.replays
    t0 = time.perf_counter()
    result = evaluate(model, annotations, images, batch_size=EVAL_BATCH, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in wrappers.items()}
    captured = model.decode.captures - graphs[0]
    replayed = model.decode.replays - graphs[1]
    timing = result["timing"]
    phases = timing["phases"]
    n_batches = round(phases["inference"]["total_s"] / phases["inference"]["mean_batch_s"])
    preds = result["predictions"]
    items = len(preds["annotations"]) if isinstance(preds, dict) else len(preds)
    unit = {"trace": "traces", "image": "images", "dense": "boxes",
            "region_set": "box sets"}[label.split()[0]]
    loop_s = phases["preprocessing"]["total_s"] + phases["inference"]["total_s"]
    stall = phases["preprocessing"]["total_s"] / loop_s
    passes = counts["memory_project"]
    log(f"[eval {label}] {items} {unit} in {n_batches} batches of up to {EVAL_BATCH}: "
        f"{timing['images_per_sec_inference']:.2f} {unit}/s in inference, "
        f"{timing['images_per_sec_total']:.2f} in total ({wall:.2f} s wall); preprocessing "
        f"stall {phases['preprocessing']['total_s']:.3f} s = {100 * stall:.1f}% of the "
        f"loop's {loop_s:.3f} s; launches " + ", ".join(
            f"{EVAL_KERNELS[k]} {counts[k]}" for k in EVAL_KERNELS) +
        f"; decode graphs {replayed} replays, {captured} captures; {smi}")
    others = {k: v for k, v in counts.items() if k not in EVAL_KERNELS and v}
    depth = model.vit_cfg.depth
    want = {k: depth * passes if k != "memory_project" else passes for k in EVAL_KERNELS}
    if fused and passes != n_batches:
        raise AssertionError(f"[eval {label}] {passes} projections for {n_batches} fused "
                             "batches: each batch must be one step")
    if (passes == 0 or others or {k: counts[k] for k in EVAL_KERNELS} != want
            or replayed != passes or captured):
        raise AssertionError(f"[eval {label}] launches {counts}, expected {want} and no other; "
                             f"{replayed} decode replays for {passes} projections, "
                             f"{captured} captures (none allowed after the warm-up)")
    return dict(result=result, counts=counts, wall=wall, stall=stall, batches=n_batches)


def _eval_pixels(paths: list, model) -> np.ndarray:
    """The uint8 batch the evaluators' default loaders give for `paths`."""
    from PIL import Image

    from patchioner_tpu_torch.utils import transforms

    return np.stack([transforms.preprocess_pil_uint8(Image.open(p), model.resize_dim,
                                                     model.crop_dim) for p in paths])


def _eval_same(label: str, got: list, want: list) -> None:
    same = sum(a == b for a, b in zip(got, want))
    log(f"[eval {label}] the harness's captions against the direct call: "
        f"{same}/{len(want)} equal")
    if len(got) != len(want) or same != len(want):
        raise AssertionError(f"[eval {label}] the harness changed captions: {got[:3]} vs "
                             f"{want[:3]}")


def _eval_direct_checks(model, paths: dict, runs: dict) -> None:
    """The first trace batch, the first `cls` batch and the first dense
    fused batch, captioned by the fused calls directly on the same uint8
    pixels, padded points and padded boxes: equal to the harness's."""
    from patchioner_tpu_torch.eval import dense_captioning, trace_captioning
    from patchioner_tpu_torch.io.coco import CocoAnnotations
    from patchioner_tpu_torch.models.patchioner import trace_arrays
    from patchioner_tpu_torch.utils import geometry

    samples = trace_captioning.load_trace_dataset(paths["trace"], paths["images"])
    max_pts = max(len(t) for t in samples["traces"])
    pts, valid = trace_arrays(samples["traces"][:EVAL_BATCH], max_points=max_pts)
    direct = model.caption_traces_fused(_eval_pixels(samples["img_paths"][:EVAL_BATCH], model),
                                        pts, valid)
    _eval_same("trace patches", [p["pred"] for p in
                                 runs["trace patches"]["result"]["predictions"][:EVAL_BATCH]],
               [c.strip(" .") for c in direct])

    coco = CocoAnnotations(paths["image"])
    infos = coco.load_imgs(coco.image_ids[:EVAL_BATCH])
    files = [os.path.join(paths["images"], i["file_name"]) for i in infos]
    direct = model.caption_images_fused(_eval_pixels(files, model), caption_from="cls")
    _eval_same("image cls", [r["pred"] for r in
                             runs["image cls"]["result"]["predictions"][:EVAL_BATCH]],
               [c.strip(" .") for c in direct])

    coco = CocoAnnotations(paths["dense"])
    infos = coco.load_imgs(coco.image_ids[:EVAL_BATCH])
    files = [os.path.join(paths["images"], i["file_name"]) for i in infos]
    run_max = max(len(coco.img_to_anns[i]) for i in coco.image_ids)
    boxes, n_real = [], []
    for info in infos:
        anns = coco.img_to_anns[info["id"]]
        per = [geometry.adjust_bbox_for_transform(
            info["width"], info["height"], dense_captioning._normalize_xyxy(a["bbox"], info["id"]),
            model.resize_dim, model.crop_dim) for a in anns]
        n_real.append(len(per))
        boxes.append(per + [dense_captioning.DUMMY_BOX] * (run_max - len(per)))
    direct = model.caption_bboxes_fused(_eval_pixels(files, model),
                                        np.asarray(boxes, np.float32))
    want = [c.strip(" .") for row, k in zip(direct, n_real) for c in row[:k]]
    got = [a["caption"] for a in
           runs["dense patches"]["result"]["predictions"]["annotations"][:len(want)]]
    log(f"[eval dense patches] the first batch padded to the run's {run_max} boxes: "
        f"{EVAL_BATCH * run_max} rows a step")
    _eval_same("dense patches", got, want)


def _eval_runner(model, paths: dict, directory: str) -> None:
    """`ExperimentRunner` over a two-entry grid (trace and dense on the
    flagship, 32 samples each), its model built from the flagship's dict
    config (`model_builder`, here the model built once): the rows written,
    a second `run()` skipping every row, `ResultsCollector` reading them
    back."""
    from patchioner_tpu_torch.eval.collect_results import ResultsCollector
    from patchioner_tpu_torch.eval.runner import ExperimentRunner

    out = os.path.join(directory, "results")
    common = dict(image_roots=paths["images"], batch_size=EVAL_BATCH, limit=2 * EVAL_BATCH)
    grid = {"global_defaults": {"batch_size": EVAL_BATCH, "gaussian_variance": 1.0},
            "output_directory": out,
            "experiments": [{"model_name": EVAL_MODEL, "tasks": {
                "narratives": [dict(common, caption_from="patches",
                                    annotations_path=paths["trace"])],
                "dense_captioning": [dict(common, caption_from="patches",
                                          annotations_path=paths["dense"])]}}]}
    built = {EVAL_MODEL: model}
    t0 = time.perf_counter()
    rows = ExperimentRunner(grid, model_builder=lambda name, settings: built[name]).run()
    first_s = time.perf_counter() - t0
    again = ExperimentRunner(grid, model_builder=lambda name, settings: built[name]).run()
    grid_path = os.path.join(directory, "grid.json")
    with open(grid_path, "w") as f:
        json.dump(grid, f)
    collected = ResultsCollector(out).collect_from_config(grid_path)
    found = {task: [r["found"] for r in task_rows] for task, task_rows in collected.items()}
    log(f"[eval runner] {len(rows)} rows written in {first_s:.2f} s ("
        + "; ".join(f"{r['task']}: " + ", ".join(f"{k} {r[k]}" for k in ("CIDEr", "map_score")
                                                  if k in r) for r in rows)
        + f"), a second run() wrote {len(again)}, the collector found {found}")
    if (len(rows) != 2 or again or
            found != {"narratives": [True], "dense_captioning": [True]}):
        raise AssertionError(f"[eval runner] rows {rows}, second run {again}, found {found}")


def phase_eval(seed: int, smi: str, directory: str, served_rate: float) -> None:
    """Phase 13: the four tasks' evaluators on the flagship (bf16, the
    591,753-row bank, built once) over a seeded 640 x 480 dataset at the
    grid's batch of 16, after the decode graphs are warmed; the harness's
    captions held to the direct fused calls; the runner's rows, dedup and
    collector; the trace evaluator's rate beside phase 4's served one."""
    from patchioner_tpu_torch.eval import (dense_captioning, harness, image_captioning,
                                           region_set_captioning, trace_captioning)
    from patchioner_tpu_torch.eval.densecap_map import densecap_map

    t_phase = time.perf_counter()
    work = os.path.join(directory, "eval")
    t0 = time.perf_counter()
    paths = write_eval_dataset(work, seed + 130)
    log(f"[eval data] {EVAL_IMAGES} JPEG images of {EVAL_SIZE[0]} x {EVAL_SIZE[1]} and the "
        f"four tasks' files written in {time.perf_counter() - t0:.1f} s; the decode pool "
        f"has {harness.decode_pool_width()} threads on {os.cpu_count()} CPUs")
    model = build_model(FLAGSHIP_CONFIG, seed, "[eval]")
    t0 = time.perf_counter()
    buckets = _eval_warmup(model)
    log(f"[eval] warm-up: {buckets} decode graphs captured in {time.perf_counter() - t0:.2f} s")
    staged = harness.stage_to_device([np.zeros((2, 4), np.uint8)], model.device)[0]
    if staged.device.type != "cuda":
        raise AssertionError(f"[eval] the staged upload landed on {staged.device}")

    trace, image = paths["trace"], paths["image"]
    dense, region = paths["dense"], paths["region_set"]
    plan = {
        "trace patches": (trace_captioning, trace, True, dict(caption_from="patches",
                                                              measure_flops=True)),
        "trace gaussian": (trace_captioning, trace, False, dict(
            caption_from="patches", use_gaussian_weighting=True)),
        "image cls": (image_captioning, image, True, dict(caption_from="cls")),
        "image avg_self_attn": (image_captioning, image, True,
                                dict(caption_from="avg_self_attn")),
        "image patches": (image_captioning, image, True, dict(
            caption_from="patches", use_gaussian_weighting=True, gaussian_variance=100)),
        "dense patches": (dense_captioning, dense, True, dict(caption_from="patches")),
        "dense cls": (dense_captioning, dense, False, dict(caption_from="cls")),
        "dense cls_capt": (dense_captioning, dense, False, dict(
            caption_bboxes_type="cls_capt", limit=EVAL_CROP_IMAGES)),
        "region_set patches": (region_set_captioning, region, True,
                               dict(caption_from="patches")),
    }
    csv_dir = os.path.join(work, "csv")
    runs = {}
    for label, (mod, annotations, fused, kw) in plan.items():
        runs[label] = run = _eval_run(model, label, mod.evaluate, annotations, paths["images"],
                                      fused, smi, **kw)
        task = label.split()[0]
        row = {"model": EVAL_MODEL, "task": task, "variant": label}
        t0 = time.perf_counter()
        if task == "dense":
            anns = run["result"]["predictions"]["annotations"]
            scores = {"map_score": densecap_map(
                [{k: a[k] for k in ("image_id", "bbox", "caption", "score")} for a in anns],
                [{"image_id": a["image_id"], "bbox": a["bbox"],
                  "caption": a.get("gt_caption") or ""} for a in anns])["map"]}
            harness.append_results_csv(
                os.path.join(csv_dir, "dense.csv"),
                dict(row, **{k: f"{v:.4f}" for k, v in scores.items()}), list(row))
        else:
            scores = mod.compute_scores(run["result"], csv_path=os.path.join(
                csv_dir, f"{task}.csv"), config_row=row)
        log(f"[eval {label}] scores in {time.perf_counter() - t0:.2f} s: " + ", ".join(
            f"{k} {scores[k]:.4f}" for k in ("Bleu_4", "METEOR", "CIDEr", "SPICE", "map_score")
            if k in scores))
    flops = runs["trace patches"]["result"]["flops_per_image"]
    log(f"[eval trace patches] the first batch's encoder call: {flops / 1e9:.1f} GFLOP counted "
        f"on the plain path ({flops / 1e9 / EVAL_BATCH:.1f} GFLOP an image)")
    if not flops:
        raise AssertionError("[eval] the encoder's FLOP count read 0 or None")
    for name in os.listdir(csv_dir):
        with open(os.path.join(csv_dir, name)) as f:
            n_rows = sum(1 for _ in f) - 1
        log(f"[eval csv] {name}: {n_rows} rows")

    _eval_direct_checks(model, paths, runs)
    _eval_runner(model, paths, work)

    with harness.profile_trace(os.path.join(work, "profile")) as prof:
        model.caption_images_fused(np.zeros((EVAL_BATCH, IMG, IMG, 3), np.uint8))
        torch.cuda.synchronize()
    with open(prof.path) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    log(f"[eval profile] profile_trace wrote {len(events)} events, {kernels} of them kernels")
    if not kernels:
        raise AssertionError("[eval profile] the trace holds no kernel")

    rate = runs["trace patches"]["result"]["timing"]["images_per_sec_inference"]
    log(f"[eval] trace evaluator {rate:.3f} images/s in inference against phase 4's "
        f"{served_rate:.3f} captions/s through the server (ratio {rate / served_rate:.3f}, "
        f"reported, not asserted); {smi}")
    del model
    torch.cuda.empty_cache()
    import shutil

    shutil.rmtree(work)
    log(f"[eval] phase 13 took {time.perf_counter() - t_phase:.1f} s")

# ------------------------------------------------------------------ phase 14


def regionclip_state_dict(tree: dict, prefix: str = "backbone.") -> dict:
    """A port ModifiedResNet tree as a state dict under `prefix`, the
    inverse of `models.resnet_clip.port_clip_resnet` (convolutions OIHW as
    the port keeps them, each `nn.Linear` (out, in)); detectron's
    'backbone.' by default, as a RegionCLIP detection checkpoint stores it."""
    sd = {}

    def bn(name, p):
        sd.update({f"{name}.weight": p["w"], f"{name}.bias": p["b"],
                   f"{name}.running_mean": p["mean"], f"{name}.running_var": p["var"]})

    for i in (1, 2, 3):
        sd[f"conv{i}.weight"] = tree["stem"][f"conv{i}"]
        bn(f"bn{i}", tree["stem"][f"bn{i}"])
    for li, blocks in enumerate(tree["layers"]):
        for bi, blk in enumerate(blocks):
            q = f"layer{li + 1}.{bi}"
            for i in (1, 2, 3):
                sd[f"{q}.conv{i}.weight"] = blk[f"conv{i}"]
                bn(f"{q}.bn{i}", blk[f"bn{i}"])
            if "down_conv" in blk:
                sd[f"{q}.downsample.0.weight"] = blk["down_conv"]
                bn(f"{q}.downsample.1", blk["down_bn"])
    pool = tree["attnpool"]
    sd["attnpool.positional_embedding"] = pool["pos_embed"]
    for key in "qkvc":
        sd[f"attnpool.{key}_proj.weight"] = pool[key]["w"].t()
        sd[f"attnpool.{key}_proj.bias"] = pool[key]["b"]
    return _cpu({prefix + k: v for k, v in sd.items()})


def clip_vision_state_dict(tree: dict, prefix: str = "visual.") -> dict:
    """A port CLIP vision tower as an openai/CLIP-layout state dict under
    `prefix`, the inverse of `models.clip.port_openai_clip_vision`."""
    d = tree["class_embedding"].shape[-1]
    p = int(round((tree["patch_embed_w"].shape[0] // 3) ** 0.5))
    sd = {"conv1.weight": tree["patch_embed_w"].reshape(p, p, 3, d).permute(3, 2, 0, 1),
          "class_embedding": tree["class_embedding"].reshape(d),
          "positional_embedding": tree["pos_embed"][0], "proj": tree["proj"],
          "ln_pre.weight": tree["ln_pre"]["scale"], "ln_pre.bias": tree["ln_pre"]["bias"],
          "ln_post.weight": tree["ln_post"]["scale"], "ln_post.bias": tree["ln_post"]["bias"]}
    return _cpu({prefix + k: v for k, v in (sd | _resblocks_state_dict(tree["blocks"])).items()})


def _decap_file(seed: int, directory: str, prefix_size: int) -> str:
    """A seeded DeCap decoder at the reference CLI's size whose prefix
    linear takes `prefix_size` (wte scaled by 10, as in phase 6), written
    in the published layout; its path."""
    from patchioner_tpu_torch.models import decap, gpt2

    dec = decap.init_decap(gpt2.DECAP_DECODER_CONFIG, prefix_size,
                           torch.Generator(device="cuda").manual_seed(seed), "cuda")
    dec.gpt2["wte"] *= 10
    path = os.path.join(directory, f"decap_{prefix_size}.pt")
    torch.save(decap_state_dict(dec), path)
    return path


def write_backbone_checkpoints(seed: int, directory: str) -> dict:
    """Phase 14's files, seeded on the card, written with `torch.save` in
    the published layouts: a RegionCLIP RN50 detection checkpoint (the
    backbone under `model` and detectron's `backbone.`) whose attention
    pool was trained at 224 px (50 tokens: the 512 px config draws a new
    one), its batch norms away from the identity; an openai-layout CLIP
    ViT-B/16 and a hub DINOv2 ViT-B/14-reg (ProxyCLIP); a DINO.txt
    checkpoint, its ViT-L/14-reg under `visual_model.backbone.model.`
    (layerscale near 1 in both DINOv2 towers); and DeCap decoders whose
    prefix linear takes 1024 and 512. {name: path}."""
    from patchioner_tpu_torch.models import clip, resnet_clip, vit

    gen = torch.Generator(device="cuda").manual_seed(seed + 60)
    rn = resnet_clip.init_resnet_clip(resnet_clip.ResNetClipConfig(), gen, "cuda")

    def stats(node):
        for key, value in node.items():
            if key.startswith(("bn", "down_bn")):
                c = value["w"].shape[0]
                value.update(w=1 + 0.1 * torch.randn(c, generator=gen, device="cuda"),
                             b=0.1 * torch.randn(c, generator=gen, device="cuda"),
                             mean=0.1 * torch.randn(c, generator=gen, device="cuda"),
                             var=0.5 + torch.rand(c, generator=gen, device="cuda"))

    stats(rn["stem"])
    for blocks in rn["layers"]:
        for blk in blocks:
            stats(blk)
    towers = {}
    for variant in ("dinov2_vitb14_reg", "dinov2_vitl14_reg"):
        cfg = vit.config_for(variant)
        tree = vit.init_vit(cfg, gen, "cuda")
        for blk in tree["blocks"]:
            blk["ls1"], blk["ls2"] = 1 + 0.1 * torch.randn(2, cfg.embed_dim, generator=gen,
                                                           device="cuda")
        towers[variant] = tree
    clip_tree = clip.init_clip_vision(clip.ClipVisionConfig(), gen, "cuda")
    paths = {}
    for name, make in (
            ("regionclip", lambda: {"model": regionclip_state_dict(rn)}),
            ("clip_b16", lambda: clip_vision_state_dict(clip_tree)),
            ("dinov2_vitb14_reg", lambda: hub_state_dict(towers["dinov2_vitb14_reg"])),
            ("dinotxt", lambda: {f"visual_model.backbone.model.{k}": v for k, v in
                                 hub_state_dict(towers["dinov2_vitl14_reg"]).items()})):
        paths[name] = os.path.join(directory, f"{name}.pth")
        torch.save(make(), paths[name])
    paths["decap_1024"] = _decap_file(seed + 61, directory, LD)
    paths["decap_512"] = _decap_file(seed + 62, directory, CLIP_D)
    return paths


def _serve_each(model, requests: dict, kinds: tuple, label: str, smi: str) -> dict:
    """B requests of each of `kinds` served through `_serve` (launches and
    decode graphs asserted); captions/s and mean latency printed; each
    kind's launch counts."""
    counts = {}
    for kind in kinds:
        tag = f"[{label} {kind}]"
        results, snap, batches, wall, counts[kind] = _serve(model, requests[kind], tag, kind)
        flat = _flat(results)
        if not all(isinstance(c, str) for c in flat):
            raise AssertionError(f"{tag} a request did not resolve to caption strings")
        log(f"{tag} {len(flat)} captions from {len(results)} requests in {batches} batch(es): "
            f"{len(flat) / wall:.3f} captions/s, mean request latency "
            f"{snap['mean_latency_ms']} ms; result 0: {str(results[0])[:60]!r}; {smi}")
    return counts


def phase_regionclip(seed: int, smi: str, paths: dict) -> int:
    """Phase 14a: DeCap on RegionCLIP's RN50 at 512 px
    (configs/regionclip_resnet50_p32_512.k.yaml) from the detection
    checkpoint, its 224 px attention pool drawn anew at 512 (the same
    draw on the CPU, asserted), bf16, a random 500,000 x 1024 bank: 8
    trace, 8 box and 8 whole-image requests served through `forward`, D
    once a batch; a whole-image batch's split; the crop-and-caption
    baseline; `analyze_feature_compatibility` (D four times); f32 card
    against CPU. D's launches in the served runs."""
    from PIL import Image

    from patchioner_tpu_torch.ops import memory_projection as mp

    config = dict(REGIONCLIP_CONFIG, decap_weights=paths["decap_1024"], regionclip_config=dict(
        REGIONCLIP_CONFIG["regionclip_config"], checkpoint=paths["regionclip"]))
    model = build_model(config, seed, "[regionclip]")
    # the pool embedding drawn anew from a CPU generator seeded 0, N(0, 1/C)
    pos = model.vit_params["attnpool"]["pos_embed"].float().cpu()
    drawn = torch.randn(257, 2048, generator=torch.Generator().manual_seed(0)) / 2048 ** 0.5
    if (model.backbone_type != "RegionCLIP" or model.supports_fused_trace_path()
            or not torch.equal(pos, drawn.bfloat16().float())
            or tuple(model.bank.rows[:model.bank.num_real].shape) != (LBANK_ROWS, LD)):
        raise AssertionError("[regionclip] the model must be RegionCLIP at 512 px, its pool "
                             "embedding the CPU generator's draw, over the 500,000 x 1024 bank")
    imgs, requests = _kind_requests(B, seed + 70, model.crop_dim)
    launches = sum(c["memory_project"] for c in
                   _serve_each(model, requests, ("trace", "bbox", "cls"), "regionclip",
                               smi).values())
    _whole_image_split(model, imgs, "regionclip", smi)

    # the crop-and-caption baseline (the main table's dense row): 8 PIL
    # images of 640 x 480, 4 boxes each, one forward a chunk of 8 crops
    rng = np.random.default_rng(seed + 71)
    pil = [Image.fromarray(rng.integers(0, 256, (480, 640, 3), dtype=np.uint8))
           for _ in range(B)]
    lo = rng.uniform(0, 300, (B, 4, 2))
    boxes = np.concatenate([lo, rng.uniform(40, 300, (B, 4, 2))], -1).astype(np.float32)
    before = mp.memory_project_streamed.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.forward(pil, bboxes=boxes, caption_bboxes_type="cls_capt")
    wall = time.perf_counter() - t0
    crops = mp.memory_project_streamed.launches - before
    if [len(r) for r in out["bbox_capts"]] != [4] * B or crops != 4:
        raise AssertionError(f"[regionclip crop] {out!r:.200} with D launched {crops} times")
    log(f"[regionclip crop] the crop-and-caption baseline: {B * 4} boxes in {wall:.3f} s, "
        f"{B * 4 / wall:.3f} boxes/s (PIL crops and resize on the host), D {crops} launches; "
        f"{smi}")

    before = mp.memory_project_streamed.launches
    t0 = time.perf_counter()
    analysis = model.analyze_feature_compatibility(imgs)
    calls = mp.memory_project_streamed.launches - before
    if sorted(analysis) != ["layer3", "layer4"] or calls != 4 or not all(
            np.isfinite(v) for r in analysis.values() for v in r.values()
            if isinstance(v, float)):
        raise AssertionError(f"[regionclip] feature compatibility {analysis} (D {calls})")
    log(f"[regionclip] analyze_feature_compatibility in {time.perf_counter() - t0:.2f} s, D "
        f"{calls} launches: " + "; ".join(
            f"{k}: {r['spatial_resolution']}, patch max sim {r['patch_max_similarity']:.4f}, "
            f"efficiency {r['projection_efficiency']:.4f}" for k, r in analysis.items()))
    del model
    torch.cuda.empty_cache()
    _clip_f32_gate("f32 regionclip", config, seed)
    return launches


def _mosaic(n: int, seed: int, img: int, blocks: int = 4) -> np.ndarray:
    """n seeded uint8 images of blocks x blocks flat colours with a little
    noise: the patches of one block are alike, so ProxyCLIP's proxy
    affinity puts real weight off its diagonal (on noise it keeps the
    diagonal alone, and the mixing would be an identity)."""
    rng = np.random.default_rng(seed)
    cell = -(-img // blocks)
    tiles = np.repeat(np.repeat(rng.integers(0, 256, (n, blocks, blocks, 3)), cell, 1), cell, 2)
    return np.clip(tiles[:, :img, :img] + rng.integers(-20, 21, (n, img, img, 3)), 0,
                   255).astype(np.uint8)


def _proxyclip_f32_gate(label: str, config: dict, seed: int) -> None:
    """ProxyCLIP f32 on the card against the same weights on the CPU (TF32
    off), two mosaic images, the VFM's layerscale drawn near 1: the VFM's
    patch tokens (A, B and C against their plain versions) under the gate;
    every row of the CPU's affinity at least 10% off its diagonal, so that
    the mixing is what the gate compares; the affinity's masks compared,
    an entry differing only within 1e-4 of the mask's threshold (mean
    similarity times beta) and in at most 1% of the rows; the output tokens
    of every row whose mask agrees, and the prefix of each image's mean
    over those rows, under the gate."""
    from patchioner_tpu_torch.models import proxyclip, vit
    from patchioner_tpu_torch.models.patchioner import Patchioner

    gpu = Patchioner.from_config(config, rng_seed=seed, allow_missing_weights=True,
                                 dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 72)
    for blk in gpu.vit_params["vfm"]["blocks"]:
        for key in ("ls1", "ls2"):
            blk[key] = 1 + 0.1 * torch.randn(blk[key].shape, generator=gen, device="cuda")
    cpu = gpu.to("cpu")
    cfg = gpu.vit_cfg
    imgs = _mosaic(2, seed + 73, gpu.crop_dim)
    got = {}
    for where, m in (("card", gpu), ("cpu", cpu)):
        t0 = time.perf_counter()
        px = m._pixels(imgs)
        side = gpu.crop_dim // cfg.vfm.patch_size * cfg.vfm.patch_size
        feats = vit.vit_forward(m.vit_params["vfm"], px[:, :side, :side], cfg.vfm)[
            "x_norm_patchtokens"]
        unit = feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
        sim = torch.matmul(unit, unit.transpose(-1, -2)).float()
        affinity = proxyclip.proxy_affinity(feats, cfg.beta, cfg.gamma)
        got[where] = {"feats": feats.cpu(), "margin": (sim - sim.mean() * cfg.beta).cpu(),
                      "mask": (affinity > 0).cpu(),
                      "off": (1 - torch.diagonal(affinity, dim1=-2, dim2=-1)).cpu(),
                      "tokens": m.encode_images(imgs)["x_norm_patchtokens"]}
        log(f"[{label}] on {where}: {time.perf_counter() - t0:.1f} s")
    card, ref = got["card"], got["cpu"]
    _gate(label, card["feats"], ref["feats"],
          f"VFM patch tokens {tuple(ref['feats'].shape)}, card vs CPU", "encoder")
    log(f"[{label}] affinity weight off the diagonal, by row: CPU min "
        f"{ref['off'].min().item():.4f} mean {ref['off'].mean().item():.4f}, card min "
        f"{card['off'].min().item():.4f} mean {card['off'].mean().item():.4f}")
    if not ref["off"].min().item() >= 0.1:
        raise AssertionError(f"[{label}] a row of the affinity keeps "
                             f"{ref['off'].min().item():.4f} < 0.1 off its diagonal")
    flipped = card["mask"] != ref["mask"]
    rows = flipped.any(dim=-1)  # (B, N): rows whose mask differs
    near = ref["margin"].abs() <= 1e-4
    log(f"[{label}] affinity masks card vs CPU: {int(flipped.sum())} of {flipped.numel()} "
        f"entries differ, in {int(rows.sum())} of {rows.numel()} rows; "
        f"{float(ref['mask'].float().mean()):.4f} of the entries kept; {int(near.sum())} "
        "entries within 1e-4 of the threshold on the CPU")
    if (flipped & ~near).any():
        raise AssertionError(f"[{label}] {int((flipped & ~near).sum())} mask entries differ "
                             "farther than 1e-4 from the threshold")
    if rows.float().mean().item() > 0.01:
        raise AssertionError(f"[{label}] the affinity masks differ in {int(rows.sum())} rows")
    _gate(label, card["tokens"][~rows.cuda()].cpu(), ref["tokens"][~rows],
          f"patch tokens of the {int((~rows).sum())} rows whose mask agrees, card vs CPU",
          "encoder")
    prefix = {}
    for where, m in (("card", gpu), ("cpu", cpu)):
        keep = (~rows).to(got[where]["tokens"].device)
        means = torch.stack([t[k].mean(dim=0) for t, k in zip(got[where]["tokens"], keep)])
        prefix[where] = m.project_features(means).cpu()
    _gate(label, prefix["card"], prefix["cpu"],
          f"of each image's mean over the {int((~rows).sum())} rows whose mask "
          "agrees, card vs CPU")
    del gpu, cpu
    torch.cuda.empty_cache()


def phase_proxyclip(seed: int, smi: str, paths: dict) -> int:
    """Phase 14b: DeCap on ProxyCLIP B/16 with DINOv2 B/14-reg at 518 px
    (configs/proxyclip_b16_dinov2.k.yaml) from its CLIP and DINOv2 files,
    bf16, a random 500,000 x 512 bank: 8 trace and 8 box requests served
    through `forward`, A, B and C 12 launches and D one a batch; a
    whole-image request raises through the server, as in JAX, and the
    whole image is captioned from the patch mean; a whole-image batch's
    split; f32 card against CPU, and for configs/proxyclip_b16.k.yaml (the
    `dino` VFM at 296 px, random weights) too. D's served launches."""
    config = dict(PROXYCLIP_CONFIGS["proxyclip_b16_dinov2"], decap_weights=paths["decap_512"],
                  clip_weights=paths["clip_b16"], dino_weights=paths["dinov2_vitb14_reg"])
    model = build_model(config, seed, "[proxyclip]")
    if (model.backbone_type != "ProxyCLIP" or not model.mixes_batch
            or model.vit_cfg.grid_size != 37 or model.vit_cfg.vfm.num_registers != 4
            or tuple(model.bank.rows[:model.bank.num_real].shape) != (CLIP_BANK_ROWS, CLIP_D)):
        raise AssertionError("[proxyclip] the model must be ProxyCLIP on DINOv2 B/14-reg at "
                             "518 px over the 500,000 x 512 bank")
    imgs, requests = _kind_requests(B, seed + 74, model.crop_dim)
    counts = _serve_each(model, requests, ("trace", "bbox"), "proxyclip", smi)
    from patchioner_tpu_torch.serve import CaptionServer

    with CaptionServer(model, max_batch=B) as server:
        try:
            server.submit(imgs[0]).result(timeout=300)
        except ValueError as e:
            log(f"[proxyclip cls] a whole-image request raises through the server, as in "
                f"JAX: {e}")
        else:
            raise AssertionError("[proxyclip cls] a whole-image request returned a caption")
    caps = model.forward(imgs, get_cls_capt=False, get_avg_patch_capt=True)["avg_patch_capt"]
    if len(caps) != B or not all(isinstance(c, str) for c in caps):
        raise AssertionError(f"[proxyclip] avg_patch captions {caps!r:.200}")
    _whole_image_split(model, imgs, "proxyclip", smi, patch_mean=True)
    del model
    torch.cuda.empty_cache()
    _proxyclip_f32_gate("f32 proxyclip", config, seed)
    _proxyclip_f32_gate("f32 proxyclip dino 296", PROXYCLIP_CONFIGS["proxyclip_b16"], seed)
    return sum(c["memory_project"] for c in counts.values())


def phase_dinotxt(seed: int, smi: str, paths: dict) -> int:
    """Phase 14c: DeCap on DINO.txt's ViT-L/14-reg at 518 px
    (configs/dinotxt.yaml) from its checkpoint, bf16, a random 591,753 x
    1024 bank: 8 trace, 8 box, 8 region-set and 8 whole-image requests
    served on the fused steps, A, B and C 24 launches and D one a batch; a
    whole-image batch's split; f32 card against CPU at full width and 4
    layers. D's served launches."""
    config = dict(DINOTXT_CONFIG, decap_weights=paths["decap_1024"],
                  dino_weights=paths["dinotxt"])
    model = build_model(config, seed, "[dinotxt]")
    cfg = model.vit_cfg
    if (not model.supports_fused_trace_path() or (cfg.embed_dim, cfg.depth, cfg.num_heads,
                                                  cfg.num_registers) != (LD, 24, LHEADS, 4)
            or tuple(model.bank.rows[:model.bank.num_real].shape) != (MEMORY_ROWS, LD)):
        raise AssertionError("[dinotxt] the model must be the fused ViT-L/14-reg over the "
                             "591,753 x 1024 bank")
    imgs, requests = _kind_requests(B, seed + 75, model.crop_dim)
    counts = _serve_each(model, requests, ("trace", "bbox", "region_set", "cls"), "dinotxt",
                         smi)
    _whole_image_split(model, imgs, "dinotxt", smi)
    del model
    torch.cuda.empty_cache()
    phase_f32_crosscheck(seed, dict(DINOTXT_CONFIG, dino_geometry={"depth": 4}), "f32 dinotxt")
    return sum(c["memory_project"] for c in counts.values())


def phase_backbones(seed: int, smi: str, directory: str) -> dict:
    """Phase 14: RegionCLIP, ProxyCLIP and DINO.txt; D's served launches of
    each."""
    t0 = time.perf_counter()
    paths = write_backbone_checkpoints(seed, directory)
    log(f"[backbones] files written in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {os.path.getsize(p) / 1e6:.0f} MB" for k, p in paths.items()))
    launches = {"regionclip": phase_regionclip(seed, smi, paths),
                "proxyclip": phase_proxyclip(seed, smi, paths),
                "dinotxt": phase_dinotxt(seed, smi, paths)}
    for path in paths.values():
        os.remove(path)
    log(f"[backbones] phase 14 took {time.perf_counter() - t0:.1f} s")
    return launches


# ------------------------------------------------------------------ phase 15

# the convergence proof's gates, tests/test_convergence.py's thresholds:
# (name, the value's path in the proof's info, what it is held to)
PROOF_GATES = (
    ("align retrieval", ("align_retrieval_acc",), lambda v, i: v >= 0.85),
    ("decoder loss halves", ("decoder_last_epoch", "loss"),
     lambda v, i: v < 0.5 * i["decoder_first_epoch"]["loss"]),
    ("decoder accuracy", ("decoder_last_epoch", "acc"), lambda v, i: v >= 0.95),
    ("train exact", ("reconstruction", "train_exact_match"), lambda v, i: v >= 0.85),
    ("train token accuracy", ("reconstruction", "train_token_acc"), lambda v, i: v >= 0.9),
    ("held-out exact", ("reconstruction", "held_out_exact_match"), lambda v, i: v >= 0.5),
    ("held-out token accuracy", ("reconstruction", "held_out_token_acc"),
     lambda v, i: v >= 0.7),
    ("eval exact", ("eval_exact_match",), lambda v, i: v >= 0.5),
    ("CIDEr", ("eval_scores", "CIDEr"),
     lambda v, i: v >= 4.0 and v >= 3.0 * i["control_scores"]["CIDEr"]),
    ("Bleu_4 over the control's", ("eval_scores", "Bleu_4"),
     lambda v, i: v >= 2.0 * i["control_scores"]["Bleu_4"]),
    ("mapper loss falls", ("viecap_mapper", "last_epoch", "loss"),
     lambda v, i: v <= i["viecap_mapper"]["first_epoch"]["loss"] - 0.15),
    ("mapper accuracy", ("viecap_mapper", "last_epoch", "acc"),
     lambda v, i: v >= 1.5 * max(i["viecap_mapper"]["first_epoch"]["acc"], 0.05)),
    ("held-out images Bleu_1", ("held_out_image_scores", "Bleu_1"), lambda v, i: v >= 0.5),
)


class _PlainEncoder:
    """Kernels A, B and C swapped for their plain versions in the ViT while
    the block runs (the reference run of 15a: autograd differentiates
    them)."""

    def __enter__(self):
        from patchioner_tpu_torch.models import vit
        from patchioner_tpu_torch.ops import attention, mlp

        self.saved = (vit.fused_ln_dense, vit.fused_ln_mlp, attention.fused_qkv_attention)
        vit.fused_ln_dense, vit.fused_ln_mlp = mlp.ln_dense_plain, mlp.ln_mlp_plain
        attention.fused_qkv_attention = attention.qkv_attention_plain

    def __exit__(self, *exc):
        from patchioner_tpu_torch.models import vit
        from patchioner_tpu_torch.ops import attention

        vit.fused_ln_dense, vit.fused_ln_mlp, attention.fused_qkv_attention = self.saved


def _align_setup(seed: int):
    """The FULL proof's alignment config and one batch of its 64 train
    combos on the card: (config, pixels, masks, tokens)."""
    from patchioner_tpu_torch.models import clip, vit
    from patchioner_tpu_torch.train import align, synthetic
    from scripts import convergence_proof_torch as cp

    full = cp.FULL
    vcfg = vit.config_for("dinov2_vits14", img_size=cp.IMG_SIZE, **full.vit_geometry)
    acfg = align.AlignConfig(
        vit=vcfg, text=clip.ClipTextConfig(context_length=16, width=full.text_width,
                                           depth=full.text_depth, heads=full.text_heads,
                                           proj_dim=vcfg.embed_dim),
        steps=full.align_steps, batch=full.align_batch)
    combos, _ = synthetic.split_combos(synthetic.all_combos(), full.held_out, seed=seed)
    rng = np.random.default_rng(seed + 15)
    idx = rng.permutation(len(combos))[:acfg.batch]
    pixels = synthetic.render_training_batch([combos[i] for i in idx], rng, cp.IMG_SIZE)
    tokens, masks = align.tokens_and_masks(acfg, combos, vcfg.grid_size)
    return acfg, *(torch.from_numpy(a).to("cuda") for a in (pixels, masks[idx], tokens[idx]))


def _vit_leaf_errors(got: dict, ref: dict) -> dict:
    """{ViT leaf: (max|got - ref|, max|ref|)} over the ViT leaves of two
    {path: gradient} trees."""
    out = {}
    for name, g in got.items():
        if name.startswith("['vit']"):
            r = ref[name].float()
            out[name] = ((g.detach().cpu().float() - r).abs().max().item(),
                         r.abs().max().item())
    return out


def _over_own_gate(errors: dict) -> list:
    """The ViT leaves outside the gate on their own size, max|d| <= 1e-4 *
    max|ref| of the leaf (an all-zero reference leaf must match exactly)."""
    return [name for name, (err, size) in errors.items() if not err <= 1e-4 * size]


def _drop_ln_projection(gy, x_hat, rstd, scale):
    """LayerNorm's backward without its projection term, -x_hat *
    mean(gxh * x_hat): the mutant of A's backward in 15a."""
    gxh = gy * scale
    return rstd * (gxh - gxh.mean(-1, keepdim=True)), (gy * x_hat).sum(0), gy.sum(0)


def _backward_mutants():
    """(kernel, the term dropped, (module, attribute, replacement)) for each
    of A, B and C: a backward with one term of its derivative dropped,
    swapped in by attribute so that only that kernel's backward sees it."""
    import math

    from patchioner_tpu_torch.ops import attention, mlp

    real_dense = mlp.ln_dense_backward

    def dense_without_projection(*args, **kw):
        real, mlp._ln_backward = mlp._ln_backward, _drop_ln_projection
        try:
            return real_dense(*args, **kw)
        finally:
            mlp._ln_backward = real

    return (
        ("A", "LayerNorm's projection term",
         (mlp, "ln_dense_backward", dense_without_projection)),
        ("B", "softmax's row-sum term",
         (attention, "_softmax_backward", lambda p, gp: p * gp)),
        ("C", "GELU's h * phi(h) term",
         (mlp, "_gelu_grad", lambda h, approx: 0.5 * (1.0 + torch.erf(h / math.sqrt(2.0))))),
    )


def phase_align_gate(seed: int, smi: str) -> int:
    """Phase 15a: one FULL-width align batch of 64 through A, B and C's
    autograd Functions and through their plain versions under autograd, the
    same init with the layerscale drawn near 1: loss, accuracy and every
    leaf's gradient under the gate, every ViT leaf's gradient also within
    1e-4 of its own largest, finite, and every weight matrix's non-zero;
    A, B and C 12 launches each in the forward that the backward runs on;
    a backward of A, B or C with one term dropped failing the ViT leaves'
    gate; E refusing a grad-requiring call. Returns the layers'
    launches."""
    from patchioner_tpu_torch.io.checkpoints import flatten_tree
    from patchioner_tpu_torch.ops import mlp
    from patchioner_tpu_torch.train import align

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("phase 15 holds the kernels to the plain versions in f32: "
                             "TF32 must be off")
    acfg, pixels, masks, tokens = _align_setup(seed)
    batch = (pixels, masks, tokens)
    params = align.init_align(acfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    # init_vit's layerscale of 1e-5 scales every gradient inside a block by
    # about 1e-5, under the gate's floor of 1e-4; draw it per channel near 1
    # on both copies, as phase 5 does
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    for blk in params["vit"]["blocks"]:
        for key in ("ls1", "ls2"):
            blk[key] = 1 + 0.1 * torch.randn(blk[key].shape, generator=gen, device="cuda")
    for _, leaf in flatten_tree(params):
        leaf.requires_grad_(True)
    ref = _tree_copy(params, "cuda")
    for _, leaf in flatten_tree(ref):
        leaf.requires_grad_(True)
    wrappers = _wrappers()
    abc = ("ln_dense", "qkv_attention", "ln_mlp")

    def run(p):
        for _, leaf in flatten_tree(p):
            leaf.grad = None
        loss, acc = align.align_loss(p, *batch, acfg)
        loss.backward()
        return loss.detach(), acc

    for k in wrappers:
        wrappers[k].launches = 0
    loss, acc = run(params)
    torch.cuda.synchronize()
    counts = {k: w.launches for k, w in wrappers.items()}
    with _PlainEncoder():
        ref_loss, ref_acc = run(ref)
    torch.cuda.synchronize()
    if any(w.launches != counts[k] for k, w in wrappers.items()):
        raise AssertionError("[align grad] the plain run launched a kernel")
    depth = acfg.vit.depth
    if {k: counts[k] for k in abc} != dict.fromkeys(abc, depth) or \
            sum(counts.values()) != 3 * depth:
        raise AssertionError(f"[align grad] launches {counts}: {depth} each of A, B, C expected")
    log(f"[align grad] FULL batch of {acfg.batch} (ViT-S {acfg.vit.embed_dim} x "
        f"{depth}, {acfg.vit.num_tokens} tokens; text {acfg.text.width} x {acfg.text.depth}); "
        f"A, B, C {depth} launches each in the forward the backward ran on")
    _gate("align grad", loss[None], ref_loss[None], "loss, kernels vs plain", noun="align")
    _gate("align grad", acc[None], ref_acc[None], "batch accuracy, kernels vs plain",
          noun="align")
    got = {name: leaf.grad for name, leaf in flatten_tree(params)}
    want = {name: leaf.grad.cpu() for name, leaf in flatten_tree(ref)}
    _gate_leaves("align grad", got, want, "every gradient leaf, kernels vs plain")
    errors = _vit_leaf_errors(got, want)
    kinds = {}
    for name, (err, size) in errors.items():
        kind = "['blocks'][*]" + name.split("]", 3)[-1] if "['blocks']" in name else name
        kinds.setdefault(kind, []).append((err, size))
    for kind, rows in sorted(kinds.items()):
        log(f"[align grad] ViT {kind} ({len(rows)} leaves): max|ref| from "
            f"{min(r[1] for r in rows):.3e} to {max(r[1] for r in rows):.3e}, max|d|/max|ref| "
            f"at most {max(r[0] / max(r[1], 1e-30) for r in rows):.2e}")
    outside = _over_own_gate(errors)
    if outside:
        raise AssertionError(f"[align grad] ViT leaves outside 1e-4 of their own largest "
                             f"gradient: {outside}")
    log(f"[align grad] {len(errors)} ViT leaves within 1e-4 of their own largest gradient")
    vit_leaves = [(n, g) for n, g in got.items() if n.startswith("['vit']")]
    for name, g in vit_leaves:
        if g is None or not torch.isfinite(g).all():
            raise AssertionError(f"[align grad] ViT leaf {name} has no finite gradient")
        if g.dim() == 2 and not g.any():
            raise AssertionError(f"[align grad] ViT weight {name} has an all-zero gradient")
    log(f"[align grad] {len(vit_leaves)} ViT leaves with finite gradients, "
        f"{sum(g.dim() == 2 for _, g in vit_leaves)} weight matrices non-zero")
    # the gate's power: a backward with one term dropped must fail it
    for kernel, term, (module, attr, mutant) in _backward_mutants():
        real = getattr(module, attr)
        setattr(module, attr, mutant)
        try:
            run(params)
        finally:
            setattr(module, attr, real)
        errors = _vit_leaf_errors({n: leaf.grad for n, leaf in flatten_tree(params)}, want)
        outside = _over_own_gate(errors)
        if not outside:
            raise AssertionError(f"[align grad] {kernel}'s backward without {term} passed "
                                 f"the ViT leaves' gate")
        worst = max(outside, key=lambda n: errors[n][0] / max(errors[n][1], 1e-30))
        log(f"[align grad] {kernel}'s backward without {term}: {len(outside)} of "
            f"{len(errors)} ViT leaves fail the gate; worst {worst} max|d|/max|ref| = "
            f"{errors[worst][0] / max(errors[worst][1], 1e-30):.2e}")
    x = params["vit"]["blocks"][0]
    probe = torch.randn(2, 17, acfg.vit.embed_dim, device="cuda")
    out = mlp.fused_ln_dense(probe, x["norm1"]["scale"], x["norm1"]["bias"], x["qkv"]["w"],
                             x["qkv"]["b"], eps=acfg.vit.ln_eps)
    if type(out.grad_fn).__name__ != "_LnDenseBackward":
        raise AssertionError(f"[align grad] A's output has grad_fn {out.grad_fn}")
    try:
        mlp.fused_dense_residual(probe, probe, x["proj"]["w"], x["proj"]["b"], x["ls1"])
    except NotImplementedError as e:
        log(f"[align grad] E with a grad-requiring weight raises: {e}")
    else:
        raise AssertionError("[align grad] E returned a detached output from a grad-requiring "
                             "weight")
    kernel_ms = cuda_ms(lambda: run(params), warmup=2, iters=10)
    with _PlainEncoder():
        plain_ms = cuda_ms(lambda: run(ref), warmup=2, iters=10)
    opt_state = align.make_optimizer(acfg).init(params)
    step = align.make_align_step(acfg)
    step_ms = cuda_ms(lambda: step(params, opt_state, *batch), warmup=2, iters=10)
    log(f"[align grad] forward + backward of the batch: {kernel_ms:.3f} ms through A, B, C "
        f"and their backwards, {plain_ms:.3f} ms plain; a whole step with AdamW "
        f"{step_ms:.3f} ms ({1e3 / step_ms:.1f} steps/s without the host render) "
        f"(CUDA events, median of 10); {smi}")
    _encoder_kernels(lambda: step(params, opt_state, *batch), smi, top=8, label="align grad",
                     what="an align step (forward, backward, AdamW)")
    del params, ref, opt_state
    torch.cuda.empty_cache()
    return depth


def phase_proof(seed: int, smi: str, directory: str) -> dict:
    """Phase 15b: `scripts/convergence_proof_torch.run_proof` at FULL scale
    on the card, every gate of tests/test_convergence.py asserted; each
    stage's seconds and peak memory, align steps/s. Returns the kernels'
    launches in the run."""
    import shutil

    from scripts import convergence_proof_torch as cp

    wrappers = _wrappers()
    before = {k: w.launches for k, w in wrappers.items()}
    out = os.path.join(directory, "proof")
    info = cp.run_proof(out, cp.FULL, seed=seed, device="cuda", verbose=False)
    counts = {k: w.launches - before[k] for k, w in wrappers.items()}
    shutil.rmtree(out)
    for name, secs in info["stage_seconds"].items():
        log(f"[proof] {name}: {secs:.1f} s, peak {info['peak_memory_gib'][name]:.2f} GiB "
            f"allocated; {smi}")
    log(f"[proof] align {cp.FULL.align_steps} steps of {cp.FULL.align_batch}: "
        f"{info['align_steps_per_s']:.2f} steps/s after the first (host render included); "
        f"whole proof {info['total_seconds']:.1f} s; {smi}")
    failed = []
    for name, path, ok in PROOF_GATES:
        value = info
        for key in path:
            value = value[key]
        good = bool(ok(value, info))
        log(f"[proof] {name}: {value:.4f} {'ok' if good else 'FAILED'}")
        if not good:
            failed.append(name)
    cs = info["control_scores"]
    log(f"[proof] control CIDEr {cs['CIDEr']:.4f}, Bleu_4 {cs['Bleu_4']:.4f}; "
        f"launches in the run: " + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
    if failed:
        raise AssertionError(f"[proof] gates failed: {failed}")
    if not all(counts[k] for k in ("ln_dense", "qkv_attention", "ln_mlp", "memory_project")):
        raise AssertionError(f"[proof] A, B, C and D must each launch in the proof: {counts}")
    return counts


# ------------------------------------------------------------- phase 16

DD_CASES = ((True, "cls"), (True, "avg"), (False, "avg"), (True, "gaussian_avg"))


def _layerscale_near_one(params: dict, seed: int) -> None:
    """Every block's ls1 and ls2 drawn per channel near 1, in place: with
    init_vit's 1e-5 a block adds ~1e-5 of the stream, under every gate."""
    gen = torch.Generator(device=params["blocks"][0]["ls1"].device).manual_seed(seed)
    for blk in params["blocks"]:
        for key in ("ls1", "ls2"):
            blk[key] = (1 + 0.1 * torch.randn(blk[key].shape, generator=gen,
                                              device=blk[key].device)).to(blk[key].dtype)


def _dd_boxes(n: int, seed: int, k: int = MAX_BOXES, img: int = IMG) -> np.ndarray:
    """(n, k, 4) pixel boxes in the layout double-DINO reads, [x1, y1, x2,
    y2] (the reference's quirk), none empty."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0, 0.7, (n, k, 2))
    hi = np.minimum(lo + rng.uniform(0.05, 0.5, (n, k, 2)), 1.0)
    return (np.concatenate([lo, hi], -1) * (img - 1)).astype(np.float32)


def _rerun_inputs(model, imgs, boxes):
    """The re-run's (tokens, key mask) for `boxes` on `model`'s encoding of
    `imgs`, as `forward(double_DINO_for_bboxes=True)` builds them (the
    global tokens kept)."""
    return model._double_dino_rows(model.encode_images(imgs),
                                   torch.from_numpy(boxes).to(model.device), True)


def _rerun_gate(label: str, params: dict, cfg, tokens, mask) -> float:
    """The re-run through the kernels against its plain version on the
    card: the output, and the block's own delta (out - tokens), each within
    the type's tolerance of its largest; then the mutant, the kernels'
    re-run with the key mask dropped, must fail the delta's gate. Returns
    the kernels' re-run's max relative error."""
    from patchioner_tpu_torch.models import vit

    tol = TOLERANCE[tokens.dtype]
    got = vit.last_block_rerun(params, tokens, mask, cfg)
    ref = vit.last_block_rerun_plain(params, tokens, mask, cfg)
    delta_ref = (ref - tokens).float()
    err = ((got - ref).abs().max() / ref.abs().max()).item()
    derr = (((got - tokens).float() - delta_ref).abs().max() / delta_ref.abs().max()).item()
    mutant = vit.last_block_rerun(params, tokens, torch.ones_like(mask), cfg)
    merr = (((mutant - tokens).float() - delta_ref).abs().max()
            / delta_ref.abs().max()).item()
    log(f"[dd rerun] {label}: {tuple(tokens.shape)} {str(tokens.dtype)[6:]}, "
        f"{int(mask.sum())} of {mask.numel()} keys kept; max|d|/max|ref| {err:.3e}, the "
        f"block's delta {derr:.3e} (max|delta| {delta_ref.abs().max().item():.3e}; tol "
        f"{tol:.0e}); the mutant without the key mask {merr:.3e}")
    if not (err <= tol and derr <= tol):
        raise AssertionError(f"the re-run through the kernels differs from its plain "
                             f"version ({label}): {err:.3e}, {derr:.3e} > {tol:.0e}")
    if not merr > tol:
        raise AssertionError(f"the re-run gate is blind to the key mask ({label}): the "
                             f"mutant's {merr:.3e} <= {tol:.0e}")
    return err


def phase_encoder_options(seed: int, smi: str, qkv_rate: float) -> dict:
    """Phase 16: the encoder options from_config took last. 16a, the
    flagship with `attention_type: kkv` served (trace and box requests
    after `warmup()`), its f32 prefix and self_attn against the CPU; 16b,
    `softmax_f32: false` (attn_impl 'xla', the compute-type softmax)
    served, the encoder's ms beside the default route's, its f32 prefix
    against the default route's, its bf16 prefix's difference and caption
    agreement reported; 16c, double-DINO box captions through `forward`
    (8 images x 16 boxes, the four (use_cls, return_type) cases) with the
    launches counted, `_double_dino_features` card vs CPU at f32, the
    re-run through A and C against its plain version at 128 rows in both
    types and through G on a 4-layer giant, with a key-mask mutant, and the
    re-run's ms, chunk and peak memory. Returns the double-DINO forwards'
    launches of A, B and C."""
    from patchioner_tpu_torch import entry
    from patchioner_tpu_torch.models import vit
    from patchioner_tpu_torch.models.patchioner import Patchioner

    t_phase = time.perf_counter()
    wrappers = _wrappers()
    imgs, traces = _requests(B, seed + 16)
    pts, valid = _padded(traces)
    sets = _query_boxes(B, seed + 17)

    # 16a: kkv served
    kkv = dict(FLAGSHIP_CONFIG, attention_type="kkv")
    model = build_model(kkv, seed, "[kkv]")
    rates = {}
    phase_main_path(seed, smi, "kkv", model=model, n_requests=B, rates=rates)
    results, snap, _, wall, _ = _serve(model, [(im, {"bboxes": bs})
                                               for im, bs in zip(imgs, sets)],
                                       "[kkv bbox]", "bbox")
    if not all(isinstance(r, list) and len(r) == len(bs) and all(isinstance(c, str) for c in r)
               for r, bs in zip(results, sets)):
        raise AssertionError("[kkv bbox] a request did not resolve to a caption a box")
    n_boxes = sum(len(bs) for bs in sets)
    log(f"[kkv] served {rates['kkv']:.3f} trace captions/s against phase 4's qkv "
        f"{qkv_rate:.3f} (same run); box requests {n_boxes / wall:.3f} box captions/s, mean "
        f"request latency {snap['mean_latency_ms']} ms; {smi}")
    del model
    torch.cuda.empty_cache()

    # 16a, 16b at f32: the kkv flagship, layerscale near 1, card vs CPU
    gpu = Patchioner.from_config(kkv, rng_seed=seed, allow_missing_weights=True,
                                 dtype=torch.float32, device="cuda")
    _layerscale_near_one(gpu.vit_params, seed + 2)
    cpu = gpu.to("cpu")

    def prefix(m, vit_cfg, n=1):
        step = entry.make_prefix_step(vit_cfg, m.bank.num_real, use_attention=True,
                                      normalize=m.normalize)
        return step(m.state(), m.pixels_to_device(imgs[:n]),
                    *(torch.from_numpy(a[:n]).to(m.device) for a in (pts, valid)))

    _gate("kkv", prefix(gpu, gpu.vit_cfg).cpu(), prefix(cpu, cpu.vit_cfg), "card vs CPU")
    enc_gpu, enc_cpu = gpu.encode_images(imgs[:1]), cpu.encode_images(imgs[:1])
    # self_attn's rows are probabilities (~1 / 1369 each): held to its own
    # largest, not to the prefix gate's floor of 1
    top = enc_cpu["self_attn"].abs().max()
    _gate("kkv", enc_gpu["self_attn"].cpu() / top, enc_cpu["self_attn"] / top, "card vs CPU",
          "self_attn over its largest")
    # from_config draws the tower from the generator seeded rng_seed + 0
    plain_qkv = vit.init_vit(gpu.vit_cfg, torch.Generator(device="cuda").manual_seed(seed),
                             "cuda")["blocks"][-1]["qkv"]["w"]
    moved = (gpu.vit_params["blocks"][-1]["qkv"]["w"][:, :D]
             - plain_qkv[:, D:2 * D]).abs().max().item()
    log(f"[kkv] the rewired queries are the keys: max|d| {moved:.1e}; self_attn row 0 sums "
        f"to {enc_gpu['self_attn'][0].sum().item():.6f}")
    if moved != 0:
        raise AssertionError("attention_type kkv did not put the keys in the queries' place")
    del plain_qkv, enc_cpu
    soft = dataclasses.replace(gpu.vit_cfg, softmax_f32=False)
    _gate("softmax_f32 false", prefix(gpu, soft, 2), prefix(gpu, gpu.vit_cfg, 2),
          "vs the default route on the card")

    # 16b: softmax_f32 false served, bf16
    model = build_model(dict(FLAGSHIP_CONFIG, softmax_f32=False), seed, "[softmax_f32 false]")
    phase_main_path(seed, smi, "softmax_f32 false", model=model, n_requests=B, rates=rates)
    px = model.pixels_to_device(imgs)
    default = dataclasses.replace(model.vit_cfg, softmax_f32=True)
    enc_ms = {name: cuda_ms(lambda c=c: vit.vit_forward(model.vit_params, px, c), 2, 5)
              for name, c in (("softmax_f32 false", model.vit_cfg), ("default", default))}
    got, ref = prefix(model, model.vit_cfg, B), prefix(model, default, B)
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    agree = (model.decode(got)[0] == model.decode(ref)[0]).float().mean().item()
    log(f"[softmax_f32 false] served {rates['softmax_f32 false']:.3f} trace captions/s; "
        f"encoder of {B} images {enc_ms['softmax_f32 false']:.2f} ms by CUDA events against "
        f"{enc_ms['default']:.2f} for the default route (kernel B, f32 softmax); bf16 prefix "
        f"against the default's: max|d|/max|ref| {rel:.3e}, caption-token agreement "
        f"{agree:.4f} (reported, not asserted); {smi}")
    del model, got, ref
    torch.cuda.empty_cache()

    # 16c: double-DINO through forward, bf16, 8 images x 16 boxes
    model = build_model(FLAGSHIP_CONFIG, seed, "[double-DINO]")
    _layerscale_near_one(model.vit_params, seed + 3)
    boxes = _dd_boxes(B, seed + 18)
    launches = dict.fromkeys(("ln_dense", "qkv_attention", "ln_mlp"), 0)
    depth = model.vit_cfg.depth
    for use_cls, rtype in DD_CASES:
        kw = dict(get_cls_capt=False, bboxes=boxes, double_DINO_for_bboxes=True,
                  double_DINO_for_bboxes_return_type=rtype, double_DINO_use_cls=use_cls,
                  compute_scores=True)
        model.forward(imgs, **kw)  # first call: the decode graph's capture
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        outs = model.forward(imgs, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
        rerun = 0 if rtype == "gaussian_avg" else 1
        want = {"ln_dense": depth + rerun, "qkv_attention": depth, "ln_mlp": depth + rerun,
                "memory_project": 1}
        capts, scores = outs["bbox_capts"], outs["bbox_scores"]
        shaped = ([len(r) for r in capts] == [MAX_BOXES] * B
                  and all(isinstance(c, str) for r in capts for c in r)
                  and np.isfinite(np.asarray(scores, np.float64)).all())
        log(f"[double-DINO] use_cls={use_cls}, {rtype}: {B} x {MAX_BOXES} box captions in "
            f"{wall * 1e3:.1f} ms through forward (host clock); launches {counts}; caption "
            f"0: {capts[0][0][:60]!r}")
        if counts != want or not shaped:
            raise AssertionError(f"double-DINO forward ({use_cls}, {rtype}): launches "
                                 f"{counts} != {want}, or malformed captions and scores")
        for k in launches:
            launches[k] += counts[k]

    # the re-run alone: ms at 128 rows in bf16, its chunk and peak memory
    tokens, mask = _rerun_inputs(model, imgs, boxes)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    vit.last_block_rerun(model.vit_params, tokens, mask, model.vit_cfg)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    ms = cuda_ms(lambda: vit.last_block_rerun(model.vit_params, tokens, mask, model.vit_cfg),
                 2, 5)
    plain_ms = cuda_ms(lambda: vit.last_block_rerun_plain(model.vit_params, tokens, mask,
                                                          model.vit_cfg), 2, 5)
    log(f"[dd rerun] {tokens.shape[0]} rows x {tokens.shape[1]} tokens, bf16: {ms:.2f} ms "
        f"by CUDA events ({plain_ms:.2f} through the plain versions), chunk "
        f"{vit.RERUN_CHUNK} rows, peak {peak:.2f} GiB above the {base / 2 ** 30:.2f} GiB "
        f"held; {smi}")
    _rerun_gate("bf16, 128 rows, A and C", model.vit_params, model.vit_cfg, tokens, mask)
    del model, tokens, mask
    torch.cuda.empty_cache()

    # f32: the re-run gate at 128 rows, and _double_dino_features card vs CPU
    tokens, mask = _rerun_inputs(gpu, imgs, boxes)
    _rerun_gate("f32, 128 rows, A and C", gpu.vit_params, gpu.vit_cfg, tokens, mask)
    del tokens, mask
    small = boxes[:1, :3]
    enc_gpu = gpu.encode_images(imgs[:1])
    enc_cpu = {k: v.cpu() for k, v in enc_gpu.items()}
    for use_cls, rtype in DD_CASES:
        kw = dict(return_type=rtype, use_cls=use_cls)
        _gate("double-DINO", gpu._double_dino_features(enc_gpu, torch.from_numpy(small).cuda(),
                                                       **kw).cpu(),
              cpu._double_dino_features(enc_cpu, torch.from_numpy(small), **kw),
              f"({use_cls}, {rtype}) card vs CPU on the card's encoding", "features")
    del gpu, cpu, enc_gpu, enc_cpu
    torch.cuda.empty_cache()

    # the giant block (SwiGLU, G) at 4 layers, both types, 2 images x 16 boxes
    for dtype in (torch.bfloat16, torch.float32):
        gmodel = Patchioner.from_config(dict(GIANT_CONFIG, dino_geometry={"depth": 4}),
                                        rng_seed=seed, allow_missing_weights=True,
                                        random_bank_size=64, dtype=dtype, device="cuda")
        _layerscale_near_one(gmodel.vit_params, seed + 4)
        tokens, mask = _rerun_inputs(gmodel, imgs[:2], boxes[:2])
        wrappers["ln_swiglu"].launches = 0
        _rerun_gate(f"giant at 4 layers, {str(dtype)[6:]}, A and G", gmodel.vit_params,
                    gmodel.vit_cfg, tokens, mask)
        if not wrappers["ln_swiglu"].launches:
            raise AssertionError("the giant re-run did not launch G")
        del gmodel, tokens, mask
        torch.cuda.empty_cache()
    log(f"[time] phase 16 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------------------------------------- phase 17

CLEANING_GRID = tuple((ct, after, src) for ct in ("orthogonal_projection", "contrastive_mask")
                      for after in (True, False) for src in ("cls", "avg_self_attn"))


def _xywh_boxes(n: int, seed: int, k: int = MAX_BOXES, img: int = IMG) -> np.ndarray:
    """(n, k, 4) pixel `[x1, y1, w, h]` boxes, seeded, as phase 4g's."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, img / 2, (n, k, 2))
    wh = rng.uniform(14, img / 2, (n, k, 2))
    return np.concatenate([xy, wh], -1).astype(np.float32)


def _counted_forward(model, imgs, label: str, want: dict, **kw):
    """One `forward` with every launch counter zeroed just before it: (its
    outputs, its host-clock ms with the card synchronised, the card's peak
    memory above what was held, GiB); raises unless the kernels launched
    are exactly `want`."""
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = model.forward(imgs, **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    counts = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
    if counts != want:
        raise AssertionError(f"{label}: launches {counts} != {want}")
    return outs, ms, peak


def _nested(rows: list, shape: tuple) -> bool:
    """`rows` is a list of len(shape[0]) lists of shape[1] strings."""
    return ([len(r) for r in rows] == [shape[1]] * shape[0]
            and all(isinstance(c, str) for r in rows for c in r))


def _encoder_counts(model) -> dict:
    depth = model.vit_cfg.depth
    return {"ln_dense": depth, "qkv_attention": depth, "ln_mlp": depth}


def _capture_caption_inputs(model) -> list:
    """Make `model.caption_tokens` record the f32 CPU copy of each feature
    batch it is given and return empty captions (no decode): the inputs
    `forward` hands it. Undo with `del model.caption_tokens`."""
    seen = []

    def record(feats, project=True, return_n_best_sims=None, compute_scores=False):
        seen.append(feats.float().cpu())
        capts = [""] * feats.shape[0]
        return (capts, [0.0] * len(capts)) if compute_scores else capts

    model.caption_tokens = record
    return seen


def phase_forward_modes(seed: int, smi: str) -> dict:
    """Phase 17: the rest of `forward` on the flagship at full width (the
    module docstring's 17a-17e). Returns the D launches of its counted
    forwards."""
    from patchioner_tpu_torch import entry
    from patchioner_tpu_torch.models import decap
    from patchioner_tpu_torch.models.patchioner import Patchioner
    from patchioner_tpu_torch.ops import memory_projection as mp
    from patchioner_tpu_torch.ops import region_pooling as rp

    t_phase = time.perf_counter()
    imgs, traces = _requests(B, seed + 60)
    boxes = _xywh_boxes(B, seed + 61)
    n_patches = (IMG // 14) ** 2
    d_launches = 0

    # 17a: argmax-text, no decoder
    model = build_model(dict(FLAGSHIP_CONFIG, calculate_argmax_text=True), seed, "[argmax]")
    if model.decoder is not None or model.decode is not None or model.supports_fused_trace_path():
        raise AssertionError("[argmax] the argmax-text flagship built a decoder or a fused path")
    texts = set(model.bank_texts)
    kw = dict(get_cls_capt=True, get_avg_self_attn_capt=True, get_patch_capts=True,
              bboxes=boxes, return_n_best_sims=5)
    model.forward(imgs[:1], **dict(kw, bboxes=boxes[:1]))  # first call: each op's set-up
    outs, ms, peak = _counted_forward(model, imgs, "[argmax] forward", _encoder_counts(model),
                                      **kw)
    sims = np.asarray(outs["bbox_sims"], np.float64)
    shaped = (len(outs["cls_capt"]) == len(outs["avg_self_attn_capt"]) == B
              and _nested(outs["patch_tokens_capts"], (B, n_patches))
              and _nested(outs["bbox_capts"], (B, MAX_BOXES)) and sims.shape == (B, MAX_BOXES, 5)
              and np.isfinite(sims).all() and (np.diff(sims, axis=-1) <= 0).all()
              and all(c in texts for key in ("cls_capt", "avg_self_attn_capt")
                      for c in outs[key])
              and all(c in texts for key in ("patch_tokens_capts", "bbox_capts")
                      for r in outs[key] for c in r))
    if not shaped:
        raise AssertionError("[argmax] malformed captions or similarities")
    enc = model.encode_images(imgs)
    patches = enc["x_norm_patchtokens"].reshape(-1, D)
    rows = model._bank_real_rows()
    chunk = mp.SIM_CHUNK_BYTES // (4 * rows.shape[0])
    # the similarities' f32 GEMM (TF32 off) over the SIMT pipes' peak
    sim_bound = 2 * patches.shape[0] * D * rows.shape[0] / PEAK_FLOPS[torch.float32] * 1e3
    call_ms = {
        f"argmax {patches.shape[0]} rows": cuda_ms(lambda: mp.memory_argmax(patches, rows), 1, 3),
        f"argmax {B} rows": cuda_ms(lambda: mp.memory_argmax(enc["x_norm_clstoken"], rows), 1, 3),
        f"top-5 {B * MAX_BOXES} rows": cuda_ms(
            lambda: mp.memory_topk_sims(patches[:B * MAX_BOXES], rows, 5), 1, 3),
        "the bank's f32 rows": cuda_ms(model._bank_real_rows, 1, 3)}
    log(f"[argmax] forward of {B} images (cls, avg_self_attn, {B} x {MAX_BOXES} boxes with "
        f"top-5 sims, {patches.shape[0]} patch rows): {ms:.1f} ms (host clock), launches "
        f"{_encoder_counts(model)} and no D or H; peak {peak:.2f} GiB above what was held; "
        f"chunk {chunk} feature rows ({mp.SIM_CHUNK_BYTES / 2 ** 30:.0f} GiB of f32 sims); "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in call_ms.items())
        + f" (CUDA events, the bank's f32 copy and norms inside each call; the argmax's "
          f"similarity GEMM alone is bound by {sim_bound:.2f} ms of f32 operations); caption 0: "
          f"{outs['cls_capt'][0]!r}; {smi}")
    del enc, patches, rows
    results, snap, batches, wall, _ = _serve(
        model, [(im, {"trace": tr}) for im, tr in zip(imgs, traces)], "[argmax served]")
    if not all(isinstance(c, str) and c in texts for c in results):
        raise AssertionError("[argmax served] a trace request did not resolve to a bank text")
    log(f"[argmax served] {len(results) / wall:.3f} trace captions/s through forward, mean "
        f"request latency {snap['mean_latency_ms']} ms, {batches} batches; {smi}")
    del model
    torch.cuda.empty_cache()

    # 17b: n-best sims on the DeCap flagship, 8 x 16 boxes
    model = build_model(FLAGSHIP_CONFIG, seed, "[n-best]")
    want = dict(_encoder_counts(model), memory_project=1)
    kw = dict(get_cls_capt=False, bboxes=boxes, return_n_best_sims=5, compute_scores=True)
    model.forward(imgs, **kw)  # first call: the 128-row decode graph's capture
    outs, ms, _ = _counted_forward(model, imgs, "[n-best]", want, **kw)
    d_launches += 1
    sims = np.asarray(outs["bbox_sims"], np.float64)
    if not (_nested(outs["bbox_capts"], (B, MAX_BOXES)) and sims.shape == (B, MAX_BOXES, 5)
            and np.isfinite(sims).all() and (np.diff(sims, axis=-1) <= 0).all()):
        raise AssertionError("[n-best] malformed box captions or similarities")
    feats = rp.extract_bbox_features(model.encode_images(imgs)["x_norm_patchtokens"],
                                     torch.from_numpy(boxes).cuda(), patch_size=14).reshape(-1, D)
    topk_ms = cuda_ms(lambda: mp.memory_topk_sims(feats, model._bank_real_rows(), 5), 1, 3)
    log(f"[n-best] {B} x {MAX_BOXES} box captions with top-5 sims through forward: {ms:.1f} ms "
        f"(host clock), launches {want}; the top-5 of {feats.shape[0]} rows alone {topk_ms:.2f} "
        f"ms (CUDA events, the bank's f32 copy included); sims of box 0 "
        f"{np.round(sims[0, 0], 4).tolist()}; {smi}")

    # 17d: per-head captions, 8 x 16 rows
    outs, ms, _ = _counted_forward(model, imgs, "[heads]", want, get_cls_capt=False,
                                   get_attn_heads_capt=True, compute_scores=True)
    d_launches += 1
    heads = model.extract_heads
    if not (_nested(outs["attn_heads_capts"], (B, heads))
            and np.isfinite(np.asarray(outs["attn_heads_scores"], np.float64)).all()):
        raise AssertionError("[heads] malformed per-head captions or scores")
    log(f"[heads] {B} x {heads} per-head captions through forward: {ms:.1f} ms (host clock), "
        f"launches {want}; caption 0: {outs['attn_heads_capts'][0][0]!r}; {smi}")

    # 17c: the cleaning grid on 2 images, patch and box captions
    grid_ms = []
    for ct, after, src in CLEANING_GRID:
        want = dict(_encoder_counts(model), memory_project=2 if after else 1)
        kw = dict(get_cls_capt=False, get_patch_capts=True, bboxes=boxes[:2], cleaning_type=ct,
                  clean_after_projection=after, clean_from=src, alpha=0.7)
        outs, ms, _ = _counted_forward(model, imgs[:2], f"[cleaning] {ct}, {after}, {src}",
                                       want, **kw)
        d_launches += want["memory_project"]
        grid_ms.append(ms)
        if not (_nested(outs["patch_tokens_capts"], (2, n_patches))
                and _nested(outs["bbox_capts"], (2, MAX_BOXES))):
            raise AssertionError(f"[cleaning] {ct}, {after}, {src}: malformed captions")
    log(f"[cleaning] grid of {len(CLEANING_GRID)} (types x orders x sources), 2 images, "
        f"{2 * n_patches} patch and {2 * MAX_BOXES} box captions each: D 2 launches after the "
        f"projection, 1 before; {min(grid_ms):.1f}-{max(grid_ms):.1f} ms a forward (host "
        f"clock; the first captures its buckets' decode graphs); {smi}")
    before = model.decode.captures, model.decode.replays
    want = dict(_encoder_counts(model), memory_project=2)
    kw = dict(get_cls_capt=False, get_patch_capts=True, cleaning_type="orthogonal_projection",
              clean_after_projection=True, alpha=0.7)
    outs, ms, peak = _counted_forward(model, imgs, "[cleaning] 8 images", want, **kw)
    d_launches += 2
    if not _nested(outs["patch_tokens_capts"], (B, n_patches)):
        raise AssertionError("[cleaning] 8 images: malformed patch captions")
    captured = model.decode.captures - before[0]
    state = model.state()
    patches = model.encode_images(imgs)["x_norm_patchtokens"].reshape(-1, D)
    project = lambda: entry.project(state, patches, model.bank.num_real,  # noqa: E731
                                    normalize=True)
    got = project()
    # 64 rows spread over every image, the last row included: D's row tiles
    # from the first to the last at this row count
    held = torch.linspace(0, patches.shape[0] - 1, 64, device="cuda").long()
    ref = mp.memory_project_plain(patches[held], model.bank, normalize=True)
    err = ((got[held] - ref).abs().max() / ref.abs().max()).item()
    proj_ms = cuda_ms(project, 1, 3)
    # the library call for D's function at this row count: SDPA over the
    # bank (its backends never hold the (rows, bank) matrix)
    library = _bank_sdpa(patches, model.bank, _unit_rows(model.bank, torch.bfloat16),
                         torch.bfloat16)
    library_ms, backend = cuda_ms(library, 1, 3), library.backend
    del library
    # D's bound by operations: the scores and the weighted sum, each
    # 2 x rows x bank x D, at the bf16 tensor-core rate (phase 3's rule)
    proj_bound = 4 * patches.shape[0] * model.bank.num_real * D / PEAK_FLOPS[torch.bfloat16] * 1e3
    log(f"[cleaning] 8 images, orthogonal after the projection: {patches.shape[0]} patch rows "
        f"through D at unit norm then the decode graph of bucket "
        f"{decap.row_bucket(patches.shape[0])} ({captured} captured, "
        f"{model.decode.replays - before[1]} replayed): {ms:.1f} ms (host clock, the capture "
        f"included), peak {peak:.2f} GiB above what was held; "
        f"D at {patches.shape[0]} rows {proj_ms:.2f} ms (CUDA events; bound {proj_bound:.2f} "
        f"ms by operations; scaled_dot_product_attention bf16 over the bank, backend "
        f"{backend}, {library_ms:.2f} ms), 64 rows spread over the 8 images "
        f"against its plain version max|d|/max|ref| {err:.3e} (tol 1e-4); {smi}")
    if not err <= 1e-4:
        raise AssertionError(f"[cleaning] D at {patches.shape[0]} rows differs from its plain "
                             f"version: {err:.3e}")
    del model, state, patches, got, ref, feats
    torch.cuda.empty_cache()
    model = build_model(dict(FLAGSHIP_CONFIG, memory_bank_int8=True), seed, "[cleaning int8]")
    want = dict(_encoder_counts(model), memory_project_int8=2)
    outs, ms, _ = _counted_forward(model, imgs[:2], "[cleaning int8]", want,
                                   get_cls_capt=False, get_patch_capts=True, bboxes=boxes[:2],
                                   cleaning_type="contrastive_mask")
    if not (_nested(outs["patch_tokens_capts"], (2, n_patches))
            and _nested(outs["bbox_capts"], (2, MAX_BOXES))):
        raise AssertionError("[cleaning int8] malformed captions")
    log(f"[cleaning int8] contrastive_mask after the projection on the int8 bank, 2 images: "
        f"{ms:.1f} ms (host clock, the first call: its decode graphs captured), launches "
        f"{want}; {smi}")
    del model
    torch.cuda.empty_cache()

    # 17e: f32 gates, card vs CPU on the card's encoding, TF32 off
    gpu = Patchioner.from_config(FLAGSHIP_CONFIG, rng_seed=seed, allow_missing_weights=True,
                                 dtype=torch.float32, device="cuda")
    _layerscale_near_one(gpu.vit_params, seed + 5)
    enc = {k: v.cpu() for k, v in gpu.encode_images(imgs[:1]).items()}
    pick = torch.linspace(0, n_patches - 1, 16).long()
    patches, src = enc["x_norm_patchtokens"][0, pick], enc["x_norm_clstoken"]
    cpu_bank = mp.PreparedBank(gpu.bank.rows.cpu(), gpu.bank.inv_norm.cpu(), gpu.bank.num_real)

    def proj_cpu(x):
        return mp.memory_project_plain(x, cpu_bank, normalize=True)

    def unit(x):
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)

    seen = _capture_caption_inputs(gpu)
    for after in (True, False):
        seen.clear()
        gpu.forward(imgs[:1], get_cls_capt=False, get_patch_capts=True,
                    cleaning_type="orthogonal_projection", clean_after_projection=after,
                    alpha=0.7)
        if after:
            both = proj_cpu(torch.cat([patches, src]))
            ref = rp.ctx_cleaner(both[None, :16], both[16:], "orthogonal_projection", 0.7)[0]
        else:
            ref = proj_cpu(rp.ctx_cleaner(unit(patches)[None], unit(src),
                                          "orthogonal_projection", 0.7)[0])
        _gate("f32 modes", seen[0][pick], ref, f"clean_after_projection={after}, card vs CPU on "
              "the card's encoding, 16 rows", "cleaned patch features")
    seen.clear()
    gpu.forward(imgs[:1], get_cls_capt=False, get_attn_heads_capt=True)
    # x 1369: the attention-weighted sums, each row as large as a token, so
    # that the gate's floor of 1 does not hide a mean ~1e-3 large
    ref = torch.einsum("bhp,bpd->bhd", enc["self_attn_maps"], enc["x_norm_patchtokens"])[0]
    _gate("f32 modes", seen[0] * n_patches, ref, "card vs CPU on the card's encoding, x "
          f"{n_patches}", "per-head features")
    del gpu.caption_tokens
    rows_gpu = gpu._bank_real_rows()
    rows_cpu = rows_gpu.cpu()
    sims_gpu = mp.memory_topk_sims(patches.cuda(), rows_gpu, 5).cpu()
    sims_cpu = mp.memory_topk_sims(patches, rows_cpu, 5)
    idx_gpu = mp.memory_argmax(patches.cuda(), rows_gpu).cpu()
    idx_cpu = mp.memory_argmax(patches, rows_cpu)
    err = (sims_gpu - sims_cpu).abs().max().item()
    gap = sims_cpu[:, 0] - sims_cpu[:, 1]
    clear = gap > 1e-5
    wrong = int((idx_gpu != idx_cpu)[clear].sum())
    log(f"[f32 modes] top-5 sims of 16 patch rows against the {rows_cpu.shape[0]}-row bank, "
        f"card vs CPU: max|d| {err:.3e} (tol 1e-5); argmax {wrong} of {int(clear.sum())} rows "
        f"differ where the CPU's top-2 gap exceeds 1e-5, {int((~clear).sum())} rows inside "
        f"it (reported); smallest gap {gap.min().item():.3e}")
    if not err <= 1e-5 or wrong:
        raise AssertionError(f"[f32 modes] top-k sims {err:.3e} > 1e-5 or {wrong} argmax rows "
                             "differ outside the tie gap")
    del gpu, enc, cpu_bank, rows_gpu, rows_cpu
    torch.cuda.empty_cache()
    log(f"[time] phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return {"memory_project": d_launches}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    t_start = time.perf_counter()
    name, smi = phase_device()
    # Every bank here is drawn at random (no bank file is in the repository,
    # and the card's machine has no h5py to read one): the directory the
    # config's bank file is looked for in, and that phase 6 writes its
    # checkpoints to, is a new empty one of this run's.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as scratch:
        os.environ["IM2TXT_MEMORY_PATH"] = scratch
        kernels = run_phases(args.seed, smi, scratch)
    log(f"[done] {time.perf_counter() - t_start:.1f} s for the whole run")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


def run_phases(seed: int, smi: str, scratch: str) -> list:
    """Phases 2-17; the kernels' rows of the JSON summary."""
    t0 = time.perf_counter()

    def elapsed(phase):
        log(f"[time] {time.perf_counter() - t0:.1f} s when {phase} ended")

    phase_build()
    from patchioner_tpu_torch.ops import mlp

    mlp.fused_ln_mlp_w8.launches = 0
    summary = phase_kernels(seed)
    elapsed("phase 3")
    # (count, the run it was read from) for every kernel
    launches = {"ln_mlp_w8": (mlp.fused_ln_mlp_w8.launches,
                              "kernels (no model path reaches I)")}
    flagship = build_model(FLAGSHIP_CONFIG, seed, "[main]")
    served = {}
    counts, captions = phase_main_path(seed, smi, model=flagship, rates=served)
    launches.update({k: (counts[k], "main") for k in (
        "ln_dense", "qkv_attention", "ln_mlp", "memory_project")})
    # phase 4e: the other spatial queries on the same model; each kind's
    # launches were asserted batch by batch, the table keeps the trace run's
    phase_other_queries(flagship, seed, smi)
    phase_decode_graph(flagship, seed, smi)
    phase_decode_rows(flagship, seed, smi)
    del flagship
    torch.cuda.empty_cache()
    # phase 4b: the kernel each further configuration adds is read from its
    # own served run
    added = {"proj_fused": "dense_residual", "fusedqkv_proj": "qkv_attention_proj",
             "flash1p": "flash_attention_1pass", "flash": "flash_attention"}
    for label, opts in CONFIGS.items():
        counts, caps = phase_main_path(seed, smi, label, opts, n_requests=B,
                                       warm=label == "flash_builtin")
        if label in added:
            launches[added[label]] = (counts[added[label]], label)
        same = sum(a == b for a, b in zip(caps, captions))
        log(f"[{label}] bf16 captions equal to fusedqkv's (reported, not "
            f"asserted): {same}/{len(caps)}")
    # phase 4c, 4d: the paths of G and H, each read from its own served run,
    # and giant under fusedqkv_proj
    counts, _ = phase_main_path(seed, smi, "giant", n_requests=B, base=GIANT_CONFIG)
    launches["ln_swiglu"] = (counts["ln_swiglu"], "giant")
    phase_main_path(seed, smi, "giant_fusedqkv_proj", CONFIGS["fusedqkv_proj"],
                    n_requests=B, base=GIANT_CONFIG)
    counts, _ = phase_main_path(seed, smi, "int8_bank", {"memory_bank_int8": True},
                                n_requests=B)
    launches["memory_project_int8"] = (counts["memory_project_int8"], "int8_bank")
    phase_f32_crosscheck(seed, configs=CONFIGS, queries=True)
    phase_f32_crosscheck(seed, dict(FLAGSHIP_CONFIG, memory_bank_int8=True),
                         "f32 int8_bank")
    giant4 = dict(GIANT_CONFIG, dino_geometry={"depth": 4})
    phase_f32_crosscheck(seed, giant4, "f32 giant")
    phase_f32_crosscheck(seed, dict(giant4, **CONFIGS["fusedqkv_proj"]),
                         "f32 giant fusedqkv_proj",
                         {"fusedqkv_proj": CONFIGS["fusedqkv_proj"]})
    elapsed("phase 5")
    paths = phase_loaded(seed, smi, scratch)
    elapsed("phase 6")
    paths["viecap"] = phase_viecap(seed, smi, scratch, paths)
    elapsed("phase 7")
    phase_clipcap(seed, smi, scratch, paths)
    elapsed("phase 8")
    phase_meacap(seed, smi, scratch, paths)
    elapsed("phase 9")
    for path in paths.values():
        os.remove(path)
    trained = phase_training(seed, smi, scratch)
    elapsed("phase 10")
    clip = phase_clip(seed, smi, scratch)
    elapsed("phase 11")
    text_served, text_trained = phase_text(seed, smi, scratch)
    elapsed("phase 12")
    phase_eval(seed, smi, scratch, served["main"])
    elapsed("phase 13")
    backbones = phase_backbones(seed, smi, scratch)
    elapsed("phase 14")
    aligned = phase_align_gate(seed, smi)
    proof = phase_proof(seed, smi, scratch)
    elapsed("phase 15")
    double_dino = phase_encoder_options(seed, smi, served["main"])
    elapsed("phase 16")
    modes = phase_forward_modes(seed, smi)
    elapsed("phase 17")
    for key in ("ln_dense", "qkv_attention", "ln_mlp"):
        launches[key] = (launches[key][0], f"{launches[key][1]}; an align step (forward "
                         f"with backward): {aligned}; the FULL proof: {proof[key]}; the four "
                         f"double-DINO box forwards: {double_dino[key]}")
    launches["memory_project"] = (
        launches["memory_project"][0],
        f"main; training --im_proj: {trained} launches in its timed steps; CLIP DeCap "
        f"served: {clip} launches in its 3 served kinds; served from the bank built by "
        f"the text tower: {text_served}; text-feature training --im_proj: {text_trained}; "
        f"the backbone family served: " + ", ".join(f"{k} {v}" for k, v in backbones.items())
        + f"; the forward modes' counted forwards (n-best, per-head, cleaning): "
          f"{modes['memory_project']}")
    reference = sorted(m for m in sys.modules
                       if m.split(".")[0] in ("jax", "patchioner_tpu"))
    if reference:
        raise AssertionError(f"JAX or the JAX package was imported: {reference}")
    log("[imports] neither jax nor patchioner_tpu loaded")
    for key, row in summary.items():
        row["launches"], row["launched_in"] = launches[key]
        if not row["launches"]:
            raise AssertionError(f"{key} was never launched on its path")
    if len(summary) != len(_wrappers()):
        raise AssertionError(f"kernel rows {sorted(summary)} != {sorted(_wrappers())}")
    return [summary[k] for k in _wrappers()]


if __name__ == "__main__":
    main()
    sys.exit(0)
