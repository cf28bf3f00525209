"""Ragged-batch packing: many variable-length sequences → few fixed rows.

≙ paddle_tpu/data/packing.py (numpy only, copied whole). The static-shape
translation of the reference's LoD ragged batches (reference
paddle/fluid/framework/lod_tensor.h:58, whose point is training without
padding): sequences are packed back to back into fixed-shape rows and a
segment-id plane keeps them from attending to / counting against each
other (flash kernel segment masking, ops/flash_attention.py; loss masking,
models/transformer.py packed=True).

Conventions: segment id 0 = padding; real sequences get 1..N per row.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def pack_sequences(seqs: Sequence[np.ndarray], max_len: int,
                   pad_value=0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """First-fit pack 1-D sequences into [B, max_len] rows.

    Returns (tokens [B, max_len], segments [B, max_len] int32, positions
    [B, max_len] int32 — position WITHIN the owning segment, so positional
    encodings are pack-placement-invariant). Sequences longer than max_len
    are truncated. Greedy first-fit: each sequence goes into the first row
    with room, a new row opens when none fits — O(n·rows), fine for
    batch-sized inputs.
    """
    rows: List[List[np.ndarray]] = []
    room: List[int] = []
    for s in seqs:
        s = np.asarray(s)[:max_len]
        placed = False
        for i, r in enumerate(room):
            if len(s) <= r:
                rows[i].append(s)
                room[i] -= len(s)
                placed = True
                break
        if not placed:
            rows.append([s])
            room.append(max_len - len(s))
    B = len(rows)
    dtype = np.asarray(seqs[0]).dtype if len(seqs) else np.int64
    tokens = np.full((B, max_len), pad_value, dtype=dtype)
    segments = np.zeros((B, max_len), np.int32)
    positions = np.zeros((B, max_len), np.int32)
    for b, row in enumerate(rows):
        off = 0
        for j, s in enumerate(row):
            tokens[b, off:off + len(s)] = s
            segments[b, off:off + len(s)] = j + 1
            positions[b, off:off + len(s)] = np.arange(len(s))
            off += len(s)
    return tokens, segments, positions


def pack_lm_batch(seqs: Sequence[np.ndarray], max_len: int,
                  pad_id: int = 0) -> Dict[str, np.ndarray]:
    """Pack sequences for models.transformer.transformer_lm(packed=True):
    feed dict of tokens / segments / next-token targets. The model itself
    masks out padding and segment-final tokens (whose successor belongs to
    another sequence) from the loss, in-graph from `segments`."""
    tokens, segments, positions = pack_sequences(seqs, max_len,
                                                 pad_value=pad_id)
    targets = np.full_like(tokens, pad_id)
    targets[:, :-1] = tokens[:, 1:]
    return {"tokens": tokens, "segments": segments,
            "positions": positions, "targets": targets}
