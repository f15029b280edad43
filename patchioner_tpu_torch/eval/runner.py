"""Experiment orchestrator — batch-runs model x task x config grids.

Twin of `patchioner_tpu/eval/runner.py`; the default model builder reads
`configs_dir/{model}.json` when there is one (no PyYAML needed), else the
`.yaml`, and builds on `device` (the card unless asked for the CPU).

Reference: evaluation/run_tasks.py (ExperimentRunner): a JSON config with
global defaults + per-experiment task settings, skip-if-results-exist
dedup, a task registry, and per-run logs. The reference launches GNU-screen
sessions with conda envs and picks GPUs by NVML free memory (:697-702,
utils.py:4-24); here runs are plain in-process calls on one device.

Grid config schema (evaluation/configs/*.json):
  {"global_defaults": {...}, "output_directory": "...",
   "experiments": [{"model": ..., "tasks": {"trace": {...}, ...}}]}
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Dict, Optional

from patchioner_tpu_torch.eval import harness

__all__ = ["TASK_REGISTRY", "ExperimentRunner", "variant_axis_keys",
           "variant_key_settings"]


def variant_axis_keys(variants) -> list:
    """The UNION of scalar setting keys across a task's variant list.

    Keying each CSV row by only its OWN settings lets a variant whose
    settings are a subset of an earlier one's (`{caption_from: patches}`
    after `{caption_from: patches, use_gaussian_weighting: ""}`) match that
    earlier row and be dedup-skipped; keying by the union records an
    explicit empty value for axes a variant does not set. The reference
    avoids the collision by encoding every flag into its output FILENAME
    (eval_trace_captioning.py:144-150); the union key is the CSV-shaped
    equivalent."""
    return sorted({
        k for v in variants for k, val in (v or {}).items()
        if not isinstance(val, dict)
    })


def variant_key_settings(variant, axis_keys) -> dict:
    """One variant's row-key settings over the task's full axis union:
    absent axes record '' and a PRESENT ''-valued setting records True —
    the reference's flag semantics (run_tasks.py:395-399: value '' means
    "pass the flag"), so flag-set and flag-absent rows cannot collide."""
    out = {}
    for k in axis_keys:
        if k in (variant or {}):
            val = variant[k]
            out[k] = True if val == "" else val
        else:
            out[k] = ""
    return out


def _eval_kwargs(evaluate_fn, settings):
    """Merge the nested `evaluate:` block with top-level scalar settings —
    grid configs put expanded variant axes (e.g. `use_gaussian_weighting:
    [true, false]` -> one scalar per variant, run_tasks.py:179-223) and
    flat reference-style keys at the TOP level of the task dict. Keys the
    evaluate() signature doesn't accept are logged and skipped so grid
    bookkeeping fields don't TypeError."""
    import inspect

    kw = dict(settings.get("evaluate", {}))
    params = set(inspect.signature(evaluate_fn).parameters) - {"model"}
    dropped = []
    for k, v in settings.items():
        if k in ("evaluate", "score") or isinstance(v, dict):
            continue
        if k in params:
            kw.setdefault(k, v)
        else:
            dropped.append(k)
    # reference flag semantics (run_tasks.py:395-404): a setting whose value
    # is the empty string means "pass the flag", i.e. True — the grids write
    # `"use_gaussian_weighting": ""`. Without this, "" is falsy and a
    # gaussian-weighting variant would silently run unweighted.
    kw = {k: (True if v == "" else v) for k, v in kw.items()}
    if dropped:
        logging.getLogger("patchioner_tpu_torch.runner").info(
            "task settings not consumed by evaluate(): %s", dropped
        )
    return kw


def _trace_task(model, settings):
    from patchioner_tpu_torch.eval import trace_captioning as t

    result = t.evaluate(model, **_eval_kwargs(t.evaluate, settings))
    return t.compute_scores(result, **settings.get("score", {}))


def _image_task(model, settings):
    from patchioner_tpu_torch.eval import image_captioning as t

    result = t.evaluate(model, **_eval_kwargs(t.evaluate, settings))
    return t.compute_scores(result, **settings.get("score", {}))


def _dense_task(model, settings):
    from patchioner_tpu_torch.eval import dense_captioning as t
    from patchioner_tpu_torch.eval.densecap_map import densecap_map

    result = t.evaluate(model, **_eval_kwargs(t.evaluate, settings))
    anns = result["predictions"]["annotations"]
    gts = [
        {"image_id": a["image_id"], "bbox": a["bbox"], "caption": a.get("gt_caption") or ""}
        for a in anns
    ]
    preds = [
        {
            "image_id": a["image_id"],
            "bbox": a["bbox"],
            "caption": a["caption"],
            "score": a.get("score", 1.0),
        }
        for a in anns
    ]
    # reference CSV column name (evaluation/collect_results.py:124)
    return {"map_score": densecap_map(preds, gts)["map"]}


def _region_set_task(model, settings):
    from patchioner_tpu_torch.eval import region_set_captioning as t

    result = t.evaluate(model, **_eval_kwargs(t.evaluate, settings))
    return t.compute_scores(result, **settings.get("score", {}))


TASK_REGISTRY: Dict[str, Callable] = {
    "trace_captioning": _trace_task,
    "image_captioning": _image_task,
    "dense_captioning": _dense_task,
    "region_set_captioning": _region_set_task,
    # reference grid-config task names (evaluation/configs/*.json,
    # run_tasks.py task registry) — aliases to the same adapters
    "narratives": _trace_task,
    "controllable_captioning": _region_set_task,
}


class ExperimentRunner:
    def __init__(
        self,
        grid_config: dict,
        *,
        model_builder: Optional[Callable] = None,
        logger: Optional[logging.Logger] = None,
        allow_tokenizer_fallback: bool = False,
        device="cuda",
    ):
        """model_builder(model_name, model_settings) -> model. Defaults to
        Patchioner.from_config on `configs_dir/{model}.json` when that file
        exists, else `configs_dir/{model}.yaml`, on `device`.

        `allow_tokenizer_fallback=False` (default) fails fast before the
        first task when a built model would detokenize GPT-2 captions
        through the whitespace fallback — grid CSVs must not silently carry
        non-parity caption strings (VERDICT r3 #5)."""
        self.config = grid_config
        self.defaults = grid_config.get("global_defaults", {})
        self.output_dir = grid_config.get("output_directory", "./results")
        self.experiments = grid_config.get("experiments", [])
        self.model_builder = model_builder or self._default_builder
        self.allow_tokenizer_fallback = allow_tokenizer_fallback
        self.device = device
        self.log = logger or logging.getLogger("patchioner_tpu_torch.runner")

    def _default_builder(self, model_name, settings):
        from patchioner_tpu_torch.models.patchioner import Patchioner

        configs_dir = settings.get("configs_dir", self.defaults.get(
            "configs_dir", "./configs"))
        path = os.path.join(configs_dir, f"{model_name}.json")
        if os.path.exists(path):
            with open(path) as f:
                config = json.load(f)
        else:
            config = os.path.join(configs_dir, f"{model_name}.yaml")
        return Patchioner.from_config(
            config,
            allow_missing_weights=settings.get("allow_missing_weights", False),
            device=self.device,
        )

    def _expand(self, task_settings: dict):
        """Dict-of-lists -> cartesian grid of dicts (run_tasks.py:179-223).
        Shared with collect_results.expand_grid so runner and collector
        always enumerate the same variant set."""
        from patchioner_tpu_torch.eval.collect_results import expand_grid

        yield from expand_grid(task_settings)

    def run(self, dry_run: bool = False) -> list:
        os.makedirs(self.output_dir, exist_ok=True)
        results_log = []
        for exp in self.experiments:
            # reference schema uses "model_name" (evaluation/configs/*.json);
            # "model" is the short form this runner documented first. Same
            # key PRIORITY as collect_results.collect_from_config:259 —
            # if the runner and collector resolved a both-keys experiment
            # differently, every row would silently collect as found=False
            model_name = exp.get("model_name") or exp.get("model")
            if not model_name:
                raise KeyError(
                    "experiment entry needs a 'model_name' (or 'model') key"
                )
            settings = {**self.defaults, **exp.get("settings", {})}
            model = None
            for task_name, task_settings in exp.get("tasks", {}).items():
                if task_name not in TASK_REGISTRY:
                    raise KeyError(f"unknown task: {task_name}")
                variants = (
                    task_settings if isinstance(task_settings, list)
                    else list(self._expand(task_settings))
                )
                axis_keys = variant_axis_keys(variants)
                for variant in variants:
                    row_key = {
                        "model": model_name,
                        "task": task_name,
                        **{
                            k: str(v)
                            for k, v in variant_key_settings(
                                variant, axis_keys).items()
                        },
                    }
                    csv_path = os.path.join(self.output_dir, f"{task_name}.csv")
                    if harness.result_exists(csv_path, row_key, list(row_key)):
                        self.log.info("skip (exists): %s", row_key)
                        continue
                    if dry_run:
                        results_log.append({"would_run": row_key})
                        continue
                    if model is None:
                        model = self.model_builder(model_name, settings)
                        from patchioner_tpu_torch.models.patchioner import (
                            require_parity_tokenizer,
                        )

                        require_parity_tokenizer(
                            model, self.allow_tokenizer_fallback,
                            f"runner model {model_name!r}",
                        )
                    t0 = time.time()
                    scores = TASK_REGISTRY[task_name](model, variant)
                    row = dict(row_key)
                    row.update({k: f"{v:.4f}" for k, v in scores.items()})
                    row["wall_s"] = f"{time.time() - t0:.1f}"
                    harness.append_results_csv(csv_path, row, list(row_key))
                    results_log.append(row)
                    self.log.info("done: %s", row)
        return results_log


def main(argv=None):
    """Grid launcher: `python -m patchioner_tpu_torch.eval.runner grid.json
    [--dry-run] [--device cpu]` (the reference's run_with_config.py
    surface)."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("grid_config")
    p.add_argument("--dry-run", action="store_true")
    p.add_argument(
        "--allow-tokenizer-fallback", action="store_true",
        help="permit whitespace-fallback GPT-2 detokenization (NOT caption "
             "parity); by default a result-producing run fails fast",
    )
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    with open(args.grid_config) as f:
        grid = json.load(f)
    results = ExperimentRunner(
        grid, allow_tokenizer_fallback=args.allow_tokenizer_fallback,
        device=args.device,
    ).run(dry_run=args.dry_run)
    print(json.dumps(results, default=str))


if __name__ == "__main__":
    main()
