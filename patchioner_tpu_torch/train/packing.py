"""Sequence packing for decoder training (twin of
`patchioner_tpu/train/packing.py`, numpy).

Several captions are laid back to back in rows of fixed length with
segment-local causal attention (`models/gpt2.gpt2_hidden_packed`), so a
caption of l real tokens costs l positions:

  row:      [P a b c | P d e | P f g h i | 0 0 ...]
  inputs:    prefix_0, wte[a], wte[b], prefix_1, wte[d], prefix_2, ...
  targets:   a, b, c, d, e, f, ...                       (0 = ignore)

Position j of a segment inputs the prefix (j == 0) or the previous target
and predicts target j, the alignment of the unpacked DeCap loss. Prefix
features are indexed per segment (`seg_feature_idx`, (R, S)), so the
frozen input pipeline (projection, CapDec noise) runs once per caption.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from patchioner_tpu_torch.train.data import caption_lengths

__all__ = ["PackedBatch", "pack_captions", "packing_efficiency"]


class PackedBatch(NamedTuple):
    """Static-shape packed rows."""

    input_tokens: np.ndarray    # (R, L) token embedded at each slot (0 at prefix/pad)
    prefix_mask: np.ndarray     # (R, L) bool: the slot inputs a projected prefix
    targets: np.ndarray         # (R, L) target token id; 0 = pad/ignore
    segment_ids: np.ndarray     # (R, L) 1..S within a row; 0 = pad
    pos_ids: np.ndarray         # (R, L) position within the segment (for wpe)
    seg_feature_idx: np.ndarray  # (R, S) feature index per segment; 0-padded


def pack_captions(
    tokens: np.ndarray,
    row_len: int,
    feature_indices: Optional[np.ndarray] = None,
    order: Optional[np.ndarray] = None,
    max_segments: Optional[int] = None,
) -> PackedBatch:
    """Next-fit pack captions (N, T) into rows of length `row_len`.

    Caption i is tokens[i][:l_i], l_i from `data.caption_lengths`.
    feature_indices: per-caption index of its prefix feature (defaults to
      arange(N); the Mix dataset passes its same-image mapping).
    order: the order captions are packed in (an epoch's permutation).
    max_segments: cap on captions per row, which fixes the S axis across
      batches; defaults to the observed maximum.

    A caption longer than row_len raises ValueError.
    """
    tokens = np.asarray(tokens)
    n, t = tokens.shape
    lengths = caption_lengths(tokens)
    if feature_indices is None:
        feature_indices = np.arange(n, dtype=np.int64)
    if order is None:
        order = np.arange(n, dtype=np.int64)
    if lengths.max(initial=0) > row_len:
        raise ValueError(
            f"caption of {int(lengths.max())} tokens does not fit row_len={row_len}"
        )

    rows: list[list[int]] = []  # caption indices per row
    fill: list[int] = []        # used slots per row
    seg_cap = max_segments if max_segments is not None else row_len
    for ci in order:
        l = int(lengths[ci])
        if l == 0:
            continue
        if rows and fill[-1] + l <= row_len and len(rows[-1]) < seg_cap:
            rows[-1].append(int(ci))
            fill[-1] += l
        else:
            rows.append([int(ci)])
            fill.append(l)

    r = len(rows)
    s = max_segments if max_segments is not None else max(
        (len(c) for c in rows), default=1
    )
    input_tokens = np.zeros((r, row_len), np.int32)
    prefix_mask = np.zeros((r, row_len), bool)
    targets = np.zeros((r, row_len), np.int32)
    segment_ids = np.zeros((r, row_len), np.int32)
    pos_ids = np.zeros((r, row_len), np.int32)
    seg_feature_idx = np.zeros((r, s), np.int32)

    for ri, caps in enumerate(rows):
        at = 0
        for si, ci in enumerate(caps):
            l = int(lengths[ci])
            sl = slice(at, at + l)
            prefix_mask[ri, at] = True
            input_tokens[ri, at + 1 : at + l] = tokens[ci, : l - 1]
            targets[ri, sl] = tokens[ci, :l]
            segment_ids[ri, sl] = si + 1
            pos_ids[ri, sl] = np.arange(l)
            seg_feature_idx[ri, si] = feature_indices[ci]
            at += l

    return PackedBatch(
        input_tokens, prefix_mask, targets, segment_ids, pos_ids,
        seg_feature_idx,
    )


def packing_efficiency(batch: PackedBatch) -> float:
    """Fraction of slots carrying real targets (1.0 = no waste)."""
    return float((batch.targets != 0).mean())
