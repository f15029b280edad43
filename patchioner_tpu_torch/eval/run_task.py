"""Single-task eval CLI — the per-task eval-script equivalent.

Twin of `patchioner_tpu/eval/run_task.py`, with `--device` (default cuda;
the CPU with `--device cpu`). `--config` takes a `.json` file (no PyYAML
needed) or a `.yaml` one.

Reference: the four `eval-*/eval_*.py` argparse CLIs. One entry point here:

  python -m patchioner_tpu_torch.eval.run_task trace \
      --config configs/mlp.k.yaml --annotations trace_capt_coco_test.json \
      --images /data/coco/val2017 [--batch-size 16] [--limit N] \
      [--out preds.json] [--csv results.csv] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

from patchioner_tpu_torch.utils.env import load_dotenv

TASKS = ("trace", "dense", "image", "region_set")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("task", choices=TASKS)
    p.add_argument("--config", required=True)
    p.add_argument("--annotations", required=True)
    p.add_argument("--images", required=True, nargs="+")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--csv", default=None)
    p.add_argument("--caption-from", default=None)
    p.add_argument("--gaussian", action="store_true")
    p.add_argument("--gaussian-variance", type=float, default=0.5)
    p.add_argument("--attention-weighting", action="store_true")
    p.add_argument("--allow-missing-weights", action="store_true")
    p.add_argument("--compute-scores", action="store_true")
    p.add_argument(
        "--allow-tokenizer-fallback", action="store_true",
        help="permit whitespace-fallback GPT-2 detokenization (NOT caption "
             "parity); by default a result-producing run fails fast",
    )
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    load_dotenv()
    from patchioner_tpu_torch.models.patchioner import (
        Patchioner, require_parity_tokenizer,
    )

    config = args.config
    if config.endswith(".json"):
        with open(config) as f:
            config = json.load(f)
    model = Patchioner.from_config(
        config, allow_missing_weights=args.allow_missing_weights,
        device=args.device,
    )
    require_parity_tokenizer(
        model, args.allow_tokenizer_fallback, f"run_task {args.task}"
    )
    row = {"model": args.config, "task": args.task}

    if args.task == "trace":
        from patchioner_tpu_torch.eval import trace_captioning as t

        result = t.evaluate(
            model, args.annotations, args.images,
            batch_size=args.batch_size,
            caption_from=args.caption_from or "trace",
            use_attention_weighting=args.attention_weighting,
            use_gaussian_weighting=args.gaussian,
            gaussian_variance=args.gaussian_variance,
            limit=args.limit, out_path=args.out,
        )
        scores = t.compute_scores(result, csv_path=args.csv, config_row=row)
    elif args.task == "image":
        from patchioner_tpu_torch.eval import image_captioning as t

        result = t.evaluate(
            model, args.annotations, args.images,
            batch_size=args.batch_size,
            caption_from=args.caption_from or "cls",
            use_gaussian_weighting=args.gaussian,
            gaussian_variance=args.gaussian_variance,
            limit=args.limit, out_path=args.out,
        )
        scores = t.compute_scores(result, csv_path=args.csv, config_row=row)
    elif args.task == "dense":
        from patchioner_tpu_torch.eval import dense_captioning as t
        from patchioner_tpu_torch.eval.densecap_map import densecap_map

        result = t.evaluate(
            model, args.annotations, args.images,
            batch_size=args.batch_size,
            use_gaussian_weighting=args.gaussian,
            gaussian_variance=args.gaussian_variance,
            compute_scores=args.compute_scores,
            limit=args.limit, out_path=args.out,
        )
        anns = result["predictions"]["annotations"]
        scores = densecap_map(
            [{"image_id": a["image_id"], "bbox": a["bbox"],
              "caption": a["caption"], "score": a.get("score", 1.0)}
             for a in anns],
            [{"image_id": a["image_id"], "bbox": a["bbox"],
              "caption": a.get("gt_caption") or ""} for a in anns],
        )
        scores = {"map_score": scores["map"]}  # reference CSV column name
    else:
        from patchioner_tpu_torch.eval import region_set_captioning as t

        result = t.evaluate(
            model, args.annotations, args.images,
            batch_size=args.batch_size,
            use_gaussian_weighting=args.gaussian,
            gaussian_variance=args.gaussian_variance,
            limit=args.limit, out_path=args.out,
        )
        scores = t.compute_scores(result, csv_path=args.csv, config_row=row)

    print(json.dumps({"task": args.task, "scores": scores,
                      "timing": result.get("timing")}, default=str))


if __name__ == "__main__":
    main()
