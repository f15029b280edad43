"""Synthetic closed-vocabulary caption world for the convergence proof.

Twin of `patchioner_tpu/train/synthetic.py`, in numpy and PIL: the
caption grammar "a {color} {shape} in the {position}", the renderer of
the described scene, Localized-Narratives-style traces over the object,
the patch masks alignment pools under, and the on-disk trace-captioning
dataset. The same `np.random.Generator` seed gives the same pixels,
traces and files as the JAX module. `scripts/convergence_proof_torch.py`
aligns a ViT and a text tower on this world (`train/align.py`), trains
DeCap text-only through `train/cli.py`, builds a support memory and scores
the trace evaluator against a shuffled-caption control.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "COLORS", "SHAPES", "POSITIONS", "Combo", "all_combos", "split_combos",
    "caption_for", "render_combo", "trace_for", "patch_mask_for",
    "write_eval_dataset", "render_training_batch",
]

# color name -> RGB. Values chosen far apart so a 2-layer tower separates
# them from 14x14-pixel patches; background is mid-gray (see render_combo).
COLORS = {
    "red": (220, 40, 40),
    "green": (40, 180, 60),
    "blue": (50, 80, 220),
    "yellow": (230, 220, 50),
    "purple": (160, 60, 200),
    "orange": (240, 140, 40),
    "white": (245, 245, 245),
    "black": (15, 15, 15),
}

SHAPES = ("square", "circle", "triangle", "cross", "diamond")

# position name -> (row, col) quadrant of the patch grid
POSITIONS = {
    "top left": (0, 0),
    "top right": (0, 1),
    "bottom left": (1, 0),
    "bottom right": (1, 1),
}


@dataclasses.dataclass(frozen=True)
class Combo:
    color: str
    shape: str
    position: str

    @property
    def caption(self) -> str:
        return caption_for(self.color, self.shape, self.position)


def caption_for(color: str, shape: str, position: str) -> str:
    return f"a {color} {shape} in the {position}"


def all_combos(
    colors: Optional[Sequence[str]] = None,
    shapes: Optional[Sequence[str]] = None,
    positions: Optional[Sequence[str]] = None,
) -> List[Combo]:
    colors = list(colors or COLORS)
    shapes = list(shapes or SHAPES)
    positions = list(positions or POSITIONS)
    return [
        Combo(c, s, p) for c in colors for s in shapes for p in positions
    ]


def split_combos(
    combos: Sequence[Combo], held_out: int, seed: int = 0
) -> Tuple[List[Combo], List[Combo]]:
    """Deterministic train/held-out split over whole combos (the held-out
    captions are never seen by ANY training stage — alignment, decoder, or
    bank)."""
    order = np.random.default_rng(seed).permutation(len(combos))
    held = [combos[i] for i in order[:held_out]]
    train = [combos[i] for i in order[held_out:]]
    return train, held


def _shape_mask(shape: str, size: int) -> np.ndarray:
    """Boolean (size, size) mask of the shape at full extent."""
    y, x = np.mgrid[0:size, 0:size]
    c = (size - 1) / 2.0
    r = size / 2.0
    if shape == "square":
        return np.ones((size, size), bool)
    if shape == "circle":
        return (x - c) ** 2 + (y - c) ** 2 <= r**2
    if shape == "triangle":
        # upward triangle: width shrinks linearly toward the top row
        frac = y / max(size - 1, 1)
        return np.abs(x - c) <= frac * r
    if shape == "cross":
        bar = size // 3
        return (np.abs(x - c) <= bar / 2) | (np.abs(y - c) <= bar / 2)
    if shape == "diamond":
        return np.abs(x - c) + np.abs(y - c) <= r
    raise ValueError(f"unknown shape {shape!r}")


def render_combo(
    combo: Combo,
    rng: np.random.Generator,
    img_size: int = 56,
) -> np.ndarray:
    """-> uint8 (H, W, 3). The object fills most of its quadrant with a
    couple of pixels of positional jitter; the background is mid-gray with
    per-pixel noise so renderings of one caption are never bit-identical."""
    bg = rng.integers(110, 146, (img_size, img_size, 3))
    img = bg.astype(np.float32)
    q = img_size // 2
    obj = int(q * 0.8)
    row, col = POSITIONS[combo.position]
    jit_y, jit_x = rng.integers(-2, 3, 2)
    y0 = row * q + (q - obj) // 2 + int(jit_y)
    x0 = col * q + (q - obj) // 2 + int(jit_x)
    y0 = int(np.clip(y0, row * q, (row + 1) * q - obj))
    x0 = int(np.clip(x0, col * q, (col + 1) * q - obj))
    mask = _shape_mask(combo.shape, obj)
    color = np.asarray(COLORS[combo.color], np.float32)
    color = color + rng.uniform(-8, 8, 3)  # slight tone jitter
    patch = img[y0 : y0 + obj, x0 : x0 + obj]
    patch[mask] = np.clip(color, 0, 255)
    return np.clip(img, 0, 255).astype(np.uint8)


def trace_for(
    combo: Combo, rng: np.random.Generator, n_points: int = 12
) -> List[dict]:
    """LN-style trace: normalized {x, y} points scattered over the object's
    quadrant (eval-trace-captioning schema, eval_trace_captioning.py:187-211)."""
    row, col = POSITIONS[combo.position]
    xs = rng.uniform(0.12, 0.38, n_points) + 0.5 * col
    ys = rng.uniform(0.12, 0.38, n_points) + 0.5 * row
    return [{"x": float(x), "y": float(y)} for x, y in zip(xs, ys)]


def patch_mask_for(combo: Combo, grid: int) -> np.ndarray:
    """Boolean (grid*grid,) mask of the quadrant's patches — the pooling
    target for alignment training, matching what a trace over the object
    pools at eval time (ops/region_pooling)."""
    row, col = POSITIONS[combo.position]
    h = grid // 2
    m = np.zeros((grid, grid), bool)
    m[row * h : (row + 1) * h, col * h : (col + 1) * h] = True
    return m.reshape(-1)


def render_training_batch(
    combos: Sequence[Combo],
    rng: np.random.Generator,
    img_size: int = 56,
) -> np.ndarray:
    """uint8 (B, H, W, 3) — one fresh rendering per combo."""
    return np.stack([render_combo(c, rng, img_size) for c in combos])


def write_eval_dataset(
    out_dir: str,
    combos: Sequence[Combo],
    *,
    samples_per_combo: int = 1,
    img_size: int = 56,
    n_trace_points: int = 12,
    seed: int = 0,
    jpeg_quality: int = 95,
) -> str:
    """Write an on-disk trace-captioning dataset: `images/{id}.jpg` plus the
    LN-schema annotations JSON the real eval loader consumes
    (eval/trace_captioning.load_trace_dataset). Returns the annotation path.

    Filenames deliberately avoid the substring 'coco' (the loader zfills
    image ids for reference-COCO files)."""
    from PIL import Image

    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    ann = {}
    idx = 0
    for combo in combos:
        for _ in range(samples_per_combo):
            img_id = f"synth{idx:06d}"
            idx += 1
            img = render_combo(combo, rng, img_size)
            Image.fromarray(img).save(
                os.path.join(img_dir, f"{img_id}.jpg"), quality=jpeg_quality
            )
            ann[img_id] = {
                "captions": [combo.caption],
                "traces": [trace_for(combo, rng, n_trace_points)],
            }
    ann_path = os.path.join(out_dir, "synth_trace_test.json")
    with open(ann_path, "w") as f:
        json.dump(ann, f)
    return ann_path
