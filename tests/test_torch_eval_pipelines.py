"""The port's evaluation layer (`patchioner_tpu_torch/eval/`) against the JAX
package's, on the CPU in f32 on the same bridged weights (the 56 px,
2-layer, 128-wide model of `tests/test_torch_modes.py`).

A seeded dataset in the published layouts (JPEG files named by zero-filled
COCO ids, a Localized-Narratives trace file, a COCO captions file, a COCO
dense file with stored-xyxy boxes and a region-set file) goes through each
of the four task evaluators of both packages with their default PIL
loaders, for every variant the shipped grids use, and the prediction
records must be equal, string for string. Besides: the crop-and-caption
baseline through `forward(caption_bboxes_type=...)`, `compute_scores`' rows
and CSV columns, the runner's grid, dedup and variant axes,
`collect_results`' tables, `run_task` on a JSON config, the FLOP count
against the analytic count of the encoder's products (and the trace
evaluator's report of it), `profile_trace`, a
staging failure raising, `require_parity_tokenizer`, the shipped grids'
keys, and no module of the port importing JAX or the JAX package.
"""

import csv
import functools
import inspect
import json
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from patchioner_tpu.eval import collect_results as jcollect
from patchioner_tpu.eval import dense_captioning as jdense
from patchioner_tpu.eval import image_captioning as jimage
from patchioner_tpu.eval import region_set_captioning as jregion
from patchioner_tpu.eval import runner as jrunner
from patchioner_tpu.eval import trace_captioning as jtrace
from patchioner_tpu_torch.eval import collect_results, dense_captioning, harness
from patchioner_tpu_torch.eval import image_captioning, region_set_captioning, run_task
from patchioner_tpu_torch.eval import runner, trace_captioning
from patchioner_tpu_torch.models import patchioner as pmod
from test_torch_modes import models  # noqa: F401  (the module fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IDS = (1, 2, 3, 4)
# (width, height) of each image: both orientations and a square, so that
# the shorter-side resize and the centre crop move boxes both ways
SIZES = ((96, 72), (72, 96), (80, 80), (100, 64))
WORDS = ("a", "dog", "cat", "man", "red", "car", "on", "the", "grass", "table", "two",
         "sitting", "riding", "horse", "near", "water", "white", "bird")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # the tiny model gains nothing from intra-op threads; beside the
    # suite's other parallel workers, each op's OpenMP team waits on busy
    # cores, and the evaluations ran many times slower than alone
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _caption(rng) -> str:
    return " ".join(rng.choice(WORDS, int(rng.integers(3, 9))))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The seeded dataset: 4 JPEG images and the four tasks' annotation
    files; each task's samples are a multiple of the batch size of 2."""
    from PIL import Image

    root = tmp_path_factory.mktemp("eval_data")
    rng = np.random.default_rng(7)
    for i, (w, h) in zip(IDS, SIZES):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            root / f"{i:012d}.jpg", quality=95)
    # 1-2 traces an image, 6 in all, of 3-12 points in [0, 1]
    per_image = (2, 1, 2, 1)
    traces = {str(i): {"captions": [_caption(rng) for _ in range(k)],
                       "traces": [[{"x": float(x), "y": float(y)}
                                   for x, y in rng.uniform(0, 1, (int(rng.integers(3, 13)), 2))]
                                  for _ in range(k)]}
              for i, k in zip(IDS, per_image)}
    images = [{"id": i, "file_name": f"{i:012d}.jpg", "width": w, "height": h}
              for i, (w, h) in zip(IDS, SIZES)]
    captions = {"images": images, "annotations": [
        {"id": 10 * i + j, "image_id": i, "caption": _caption(rng)}
        for i in IDS for j in range(int(rng.integers(1, 4)))], "categories": []}
    dense_anns = []
    for i, (w, h) in zip(IDS, SIZES):
        for j in range(int(rng.integers(1, 5))):
            x1, y1 = rng.integers(0, w - 12), rng.integers(0, h - 12)
            x2, y2 = rng.integers(x1 + 4, w), rng.integers(y1 + 4, h)
            dense_anns.append({"id": 10 * i + j, "image_id": i, "caption": _caption(rng),
                               "bbox": [int(x1), int(y1), int(x2), int(y2)]})  # stored xyxy
    dense = {"images": images, "annotations": dense_anns, "categories": []}
    regions = {}
    for i, (w, h) in zip(IDS, SIZES):
        sets = {}
        for _ in range(2 if i % 2 else 1):
            boxes = []
            for _ in range(int(rng.integers(1, 4))):
                x1, y1 = rng.integers(0, w - 12), rng.integers(0, h - 12)
                boxes.append([int(x1), int(y1), int(rng.integers(x1 + 4, w)),
                              int(rng.integers(y1 + 4, h))])
            sets[_caption(rng)] = boxes
        regions[str(i)] = sets
    paths = {}
    for name, obj in (("trace", traces), ("image", captions), ("dense", dense),
                      ("region_set", regions)):
        paths[name] = str(root / f"{name}_coco_test.json")
        with open(paths[name], "w") as f:
            json.dump(obj, f)
    return str(root), paths


# every variant of configs/evaluation/*.json the tiny model runs, and the
# trace Gaussian weighting the card runs too
VARIANTS = {
    "trace": [dict(caption_from="patches"), dict(caption_from="cls"),
              dict(caption_from="patches", use_gaussian_weighting=True)],
    "image": [dict(caption_from="cls"), dict(caption_from="avg_self_attn"),
              dict(caption_from="patches", use_gaussian_weighting=True),
              dict(caption_from="patches", use_gaussian_weighting=True, gaussian_variance=100)],
    "dense": [dict(caption_from="patches"),
              dict(caption_from="patches", use_gaussian_weighting=True),
              dict(caption_from="cls"), dict(caption_bboxes_type="cls_capt")],
    "region_set": [dict(caption_from="patches"),
                   dict(caption_from="patches", use_gaussian_weighting=True),
                   dict(caption_from="cls")],
}
MODULES = {"trace": (trace_captioning, jtrace), "image": (image_captioning, jimage),
           "dense": (dense_captioning, jdense),
           "region_set": (region_set_captioning, jregion)}
CASES = [(task, i) for task, vs in VARIANTS.items() for i in range(len(vs))]


@pytest.mark.parametrize("task,variant", CASES,
                         ids=[f"{t}-{'-'.join(f'{k}={v}' for k, v in VARIANTS[t][i].items())}"
                              for t, i in CASES])
def test_evaluators_give_the_jax_predictions(models, data, task, variant):  # noqa: F811
    jm, pm = models
    root, paths = data
    port, jax_mod = MODULES[task]
    kw = dict(VARIANTS[task][variant], batch_size=2)
    flops = {"measure_flops": True} if (task, variant) == ("trace", 0) else {}
    got = port.evaluate(pm, paths[task], root, **kw, **flops)
    want = jax_mod.evaluate(jm, paths[task], root, **kw)
    assert got["predictions"] == want["predictions"]
    if flops:  # the encoder's count on the first batch
        imgs = np.zeros((2, 56, 56, 3), np.uint8)
        assert got["flops_per_image"] == harness.encoder_flops(pm, imgs) > 0
    preds = got["predictions"]
    n = len(preds["annotations"]) if task == "dense" else len(preds)
    assert n == {"trace": 6, "image": 4, "region_set": 6,
                 "dense": len(json.load(open(paths["dense"]))["annotations"])}[task]
    timing = got["timing"]
    assert set(timing["phases"]) == {"preprocessing", "inference"}
    assert timing["images_per_sec_inference"] > 0 and timing["images_per_sec_total"] > 0


def test_crop_and_caption_equals_jax(models, data):  # noqa: F811
    from PIL import Image

    jm, pm = models
    root, _ = data
    imgs = [Image.open(os.path.join(root, f"{i:012d}.jpg")).convert("RGB") for i in IDS[:2]]
    boxes = np.asarray([[[3, 4, 40, 30], [0, 0, 96, 72], [10, 20, 1, 1]],
                        [[5, 5, 50, 60], [30, 40, 20, 20], [0, 0, 1, 1]]], np.float32)
    for kw in (dict(caption_bboxes_type="cls_capt"),
               dict(caption_bboxes_type="avg_self_attn_capt", compute_scores=True)):
        got, want = pm.forward(imgs, bboxes=boxes, **kw), jm.forward(imgs, bboxes=boxes, **kw)
        assert got["bbox_capts"] == want["bbox_capts"]
        assert [len(row) for row in got["bbox_capts"]] == [3, 3]
        if kw.get("compute_scores"):
            np.testing.assert_allclose(got["bbox_scores"], want["bbox_scores"], rtol=1e-4)


def test_forward_still_refuses_the_flags_not_ported(models):  # noqa: F811
    # the flags this test once showed refused are ported: on the
    # evaluators' model each gives the JAX outputs
    jm, pm = models
    imgs = np.random.default_rng(5).integers(0, 256, (2, 56, 56, 3), dtype=np.uint8)
    boxes = np.asarray([[[0, 0, 28, 28], [14, 14, 30, 30]], [[7, 7, 42, 42], [0, 0, 56, 20]]],
                       np.float32)
    for flag in (dict(cleaning_type="orthogonal_projection", get_patch_capts=True),
                 dict(get_attn_heads_capt=True, compute_scores=True),
                 dict(return_n_best_sims=3, bboxes=boxes)):
        got, want = pm.forward(imgs, **flag), jm.forward(imgs, **flag)
        assert sorted(got) == sorted(want)
        for key in want:
            if key.endswith(("_scores", "_sims")):
                np.testing.assert_allclose(got[key], want[key], rtol=1e-4)
            else:
                assert got[key] == want[key], key


def _csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_compute_scores_rows_equal_jax(models, data, tmp_path):  # noqa: F811
    # the same evaluator results through both packages' compute_scores:
    # the scores, the CSV's columns in order and its row
    pm = models[1]
    root, paths = data
    for task in ("trace", "image"):
        result = MODULES[task][0].evaluate(pm, paths[task], root, batch_size=2, limit=2)
        rows, scores = [], []
        for side, name in enumerate(("port", "jax")):
            path = str(tmp_path / name / f"{task}.csv")
            row = {"model": "tiny", "task": task}
            scores.append(MODULES[task][side].compute_scores(result, csv_path=path,
                                                             config_row=row))
            # the same config again is deduplicated
            MODULES[task][side].compute_scores(result, csv_path=path, config_row=row)
            rows.append(_csv(path))
        assert scores[0] == scores[1]
        assert len(rows[0]) == 1 and rows[0] == rows[1]
        assert list(rows[0][0]) == list(rows[1][0])  # the columns, in order
        assert {"METEOR_variant", "SPICE_variant", "CIDEr_std", "SPICE"} <= set(rows[0][0])
        if task == "trace":
            assert "images_per_sec_inference" in rows[0][0]


def _grid(data, out_dir):
    root, paths = data
    one = {"image_roots": root, "batch_size": 2, "limit": 2}
    return {
        "global_defaults": {"batch_size": 16, "gaussian_variance": 1.0},
        "output_directory": str(out_dir),
        "experiments": [{"model_name": "tiny", "tasks": {
            "narratives": {"caption_from": ["patches"],
                           "evaluate": dict(one, annotations_path=paths["trace"])},
            "dense_captioning": [
                dict(one, caption_from="patches", annotations_path=paths["dense"]),
                dict(one, caption_from="patches", use_gaussian_weighting="",
                     annotations_path=paths["dense"])],
        }}],
    }


def test_runner_grid_dedup_and_collector_equal_jax(models, data, tmp_path):  # noqa: F811
    jm, pm = models
    logs = {}
    for name, mod, model in (("port", runner, pm), ("jax", jrunner, jm)):
        grid = _grid(data, tmp_path / name)
        logs[name] = mod.ExperimentRunner(grid, model_builder=lambda n, s, m=model: m).run()
        # a second run skips every row
        assert mod.ExperimentRunner(grid, model_builder=lambda n, s, m=model: m).run() == []
        assert mod.ExperimentRunner(grid, model_builder=lambda n, s, m=model: m).run(
            dry_run=True) == []
    strip = [{k: v for k, v in row.items() if k != "wall_s"} for row in logs["port"]]
    assert len(strip) == 3
    assert strip == [{k: v for k, v in row.items() if k != "wall_s"} for row in logs["jax"]]
    # the dense rows carry the reference's mAP column; the two variants'
    # keys differ on the Gaussian axis ('' against True)
    dense = [r for r in strip if r["task"] == "dense_captioning"]
    assert [r["use_gaussian_weighting"] for r in dense] == ["", "True"]
    assert all("map_score" in r for r in dense)

    tables = {}
    for name, mod in (("port", collect_results), ("jax", jcollect)):
        grid_path = tmp_path / f"{name}_grid.json"
        grid_path.write_text(json.dumps(_grid(data, tmp_path / name)))
        collector = mod.ResultsCollector(str(tmp_path / name))
        results = collector.collect_from_config(str(grid_path))
        assert all(r["found"] for rows in results.values() for r in rows)
        tables[name] = (results, collector.summary_report(results),
                        collector.markdown("narratives"),
                        mod.latex_table(results["narratives"]),
                        mod.format_rows_with_std(results["narratives"]))
    assert tables["port"] == tables["jax"]


def test_runner_variant_axes_reach_evaluate(models, data, tmp_path, monkeypatch):  # noqa: F811
    pm = models[1]
    root, paths = data
    seen = []

    @functools.wraps(image_captioning.evaluate)  # keeps the signature the runner inspects
    def spy(model, *a, **kw):
        seen.append((kw.get("caption_from"), kw.get("use_gaussian_weighting"),
                     kw.get("gaussian_variance")))
        return {"predictions": [{"pred": "a dog", "refs": ["a dog on grass"]}]}

    monkeypatch.setattr(image_captioning, "evaluate", spy)
    grid = {"output_directory": str(tmp_path / "res"), "experiments": [{
        "model": "tiny", "tasks": {"image_captioning": [
            {"caption_from": "cls", "annotations_path": paths["image"], "image_roots": root},
            {"caption_from": "patches", "use_gaussian_weighting": "", "gaussian_variance": 100,
             "annotations_path": paths["image"], "image_roots": root}]}}]}
    logs = runner.ExperimentRunner(grid, model_builder=lambda n, s: pm).run()
    assert len(logs) == 2
    assert seen == [("cls", None, None), ("patches", True, 100)]
    assert runner.variant_axis_keys(grid["experiments"][0]["tasks"]["image_captioning"]) == [
        "annotations_path", "caption_from", "gaussian_variance", "image_roots",
        "use_gaussian_weighting"]


def test_runner_default_builder_reads_a_json_config(tmp_path, monkeypatch):
    built = []
    monkeypatch.setattr(pmod.Patchioner, "from_config",
                        classmethod(lambda cls, config, **kw: built.append((config, kw))))
    (tmp_path / "tiny.json").write_text(json.dumps({"prefix_size": 128}))
    r = runner.ExperimentRunner({"global_defaults": {"configs_dir": str(tmp_path)}},
                                device="cpu")
    r._default_builder("tiny", {})
    r._default_builder("other", {"allow_missing_weights": True})
    assert built == [({"prefix_size": 128}, dict(allow_missing_weights=False, device="cpu")),
                     (str(tmp_path / "other.yaml"),
                      dict(allow_missing_weights=True, device="cpu"))]
    assert inspect.signature(runner.ExperimentRunner).parameters["device"].default == "cuda"


def test_run_task_on_a_json_config(data, tmp_path, capsys):
    root, paths = data
    config = {"prefix_size": 128, "support_memory_size": 64, "dino_model": "dinov2_vits14_reg",
              "crop_dim": 56, "normalize": True, "projection_type": "coco",
              "dino_geometry": {"depth": 1, "embed_dim": 128, "num_heads": 2},
              "decap_arch": {"n_layer": 1, "n_head": 2, "n_embd": 32},
              "memory_bank_path": str(tmp_path / "absent.h5")}
    (tmp_path / "tiny.json").write_text(json.dumps(config))
    out_csv = tmp_path / "trace.csv"
    run_task.main(["trace", "--config", str(tmp_path / "tiny.json"), "--annotations",
                   paths["trace"], "--images", root, "--batch-size", "2", "--limit", "2",
                   "--csv", str(out_csv), "--allow-missing-weights", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["task"] == "trace" and "CIDEr" in printed["scores"]
    rows = _csv(out_csv)
    assert len(rows) == 1 and rows[0]["task"] == "trace"
    run_task.main(["dense", "--config", str(tmp_path / "tiny.json"), "--annotations",
                   paths["dense"], "--images", root, "--batch-size", "2", "--limit", "2",
                   "--allow-missing-weights", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed["scores"]) == {"map_score"}


def test_encoder_flops_equal_the_analytic_count(models):  # noqa: F811
    pm = models[1]
    b, n, d, hidden, depth = 2, 1 + 4 + 16, 128, 512, 2
    patch = 2 * b * 16 * d * 14 * 14 * 3
    layer = (2 * b * n * d * 3 * d  # qkv
             + 2 * 2 * b * n * n * d  # q k^T and p v over the heads
             + 2 * b * n * d * d  # out-projection
             + 2 * 2 * b * n * d * hidden)  # fc1, fc2
    extract = 2 * b * n * d  # the CLS query against every token, over the heads
    imgs = np.zeros((b, 56, 56, 3), np.uint8)
    assert harness.encoder_flops(pm, imgs) == patch + depth * layer + extract
    # the evaluators report it on the first batch
    assert harness.torch_flops(lambda x: x @ x, torch.ones(64, 64)) == 2 * 64 ** 3


def test_profile_trace_writes_a_chrome_trace(models, tmp_path):  # noqa: F811
    pm = models[1]
    with harness.profile_trace(str(tmp_path / "trace")) as prof:
        pm.caption_images_fused(np.zeros((2, 56, 56, 3), np.uint8))
    with open(prof.path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_profile_trace_raises_when_the_profiler_cannot_start(tmp_path, monkeypatch):
    import torch.profiler

    def refuse(*a, **kw):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(torch.profiler.profile, "__enter__", refuse)
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        with harness.profile_trace(str(tmp_path)):
            pass


def test_staging_failure_raises(models, data):  # noqa: F811
    root, paths = data

    def bad_loader(paths_):
        return np.empty((len(paths_), 56, 56, 3), dtype=object)  # no tensor type

    with pytest.raises(TypeError):
        trace_captioning.evaluate(models[1], paths["trace"], root, batch_size=2,
                                  loader=bad_loader)
    staged = harness.stage_to_device([np.ones((2, 3), np.float32)], "cpu")
    assert staged[0].device.type == "cpu" and staged[0].dtype == torch.float32


def test_require_parity_tokenizer():
    fallback = SimpleNamespace(viecap=SimpleNamespace(tokenizer=pmod._FallbackWordTokenizer()),
                               clipcap=None)
    clean = SimpleNamespace(viecap=None, clipcap=None)
    with pytest.raises(RuntimeError, match="GPT2_BPE_DIR"):
        pmod.require_parity_tokenizer(fallback, False, "ctx")
    pmod.require_parity_tokenizer(fallback, True, "ctx")
    pmod.require_parity_tokenizer(clean, False, "ctx")
    grid = {"output_directory": "unused", "experiments": [
        {"model": "tiny", "tasks": {"trace_captioning": [{"caption_from": "cls"}]}}]}
    with pytest.raises(RuntimeError, match="GPT2_BPE_DIR"):
        runner.ExperimentRunner(grid, model_builder=lambda n, s: fallback).run()


def test_shipped_grid_configs_resolve():
    """Every key of the shipped grids is a parameter of the port's
    evaluate(), and every task name is registered."""
    mods = {"narratives": trace_captioning, "trace_captioning": trace_captioning,
            "image_captioning": image_captioning, "dense_captioning": dense_captioning,
            "controllable_captioning": region_set_captioning,
            "region_set_captioning": region_set_captioning}
    assert set(runner.TASK_REGISTRY) == set(mods) == set(jrunner.TASK_REGISTRY)
    for name in ("main_table", "backbones_ablations"):
        with open(os.path.join(REPO, "configs", "evaluation", f"{name}.json")) as f:
            grid = json.load(f)
        for e in grid["experiments"]:
            for task, settings in e["tasks"].items():
                params = set(inspect.signature(mods[task].evaluate).parameters)
                for v in settings if isinstance(settings, list) else [settings]:
                    for k, val in v.items():
                        assert not isinstance(val, dict), (name, task, k)
                        assert k in params, (name, task, k)
    for port, jax_mod in MODULES.values():
        assert (list(inspect.signature(port.evaluate).parameters)
                == list(inspect.signature(jax_mod.evaluate).parameters))


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|patchioner_tpu)(?:[.\s]|$)", re.M)


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    found = []
    for folder, _, files in os.walk(os.path.join(REPO, "patchioner_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(folder, name)) as f:
                    found += [(name, m.group(0).strip()) for m in _IMPORT.finditer(f.read())]
    assert found == []
