"""SelectedRows: a sparse set of rows of a [height, width] tensor.

≙ paddle_tpu/framework/selected_rows.py (reference framework/
selected_rows.h:32, {rows, value, height}). Two forms:

- `SelectedRows`, the host form over numpy (the parameter-service and
  checkpoint-delta exchange format), as in the JAX package;
- `TracedSelectedRows`, the step's sparse-gradient carrier: `rows` and
  `value` are device tensors, duplicate rows not yet merged. `run_vjp_region`
  makes one for an `is_sparse` embedding table; the sparse branches of the
  `sgd`, `momentum` and `adam` lowerings consume it and touch only the
  looked-up rows.

Nothing here waits for the card: the JAX package's fixed-size design
carries over (a sort, run heads and a cumsum where `jnp.unique(size=n)`
stands there), because `torch.unique`, `nonzero`, boolean-mask indexing and
`.item()` all synchronize the host with the stream. A row outside
[0, height) is dropped: its value is zeroed and it counts as untouched.
torch has no `mode="drop"` scatter, and an out-of-range index on a CUDA
tensor is a device-side assert, so such rows are sent to row 0 with a zero
value, or to the sentinel key `height` before the merge's sort.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.enforce import InvalidArgumentError, enforce


class TracedSelectedRows:
    """{rows [n] int, value [n, width], height}, rows unmerged (≙ the
    reference's SelectedRows from lookup_table_grad into the optimizers'
    SelectedRows kernels, operators/adam_op.h SparseAdamFunctor)."""

    __slots__ = ("rows", "value", "height", "_in_range")

    def __init__(self, rows: torch.Tensor, value: torch.Tensor, height: int):
        # ids in [-height, 0) index from the end, as the lookup reads them
        # and as jax's scatters normalize them
        self.rows = torch.where(rows < 0, rows + height, rows)
        self.value = value
        self.height = int(height)
        self._in_range = None

    def in_range(self):
        """(rows, value, valid): rows outside [0, height) sent to row 0
        with a zero value, and the [n] mask of those inside."""
        if self._in_range is None:
            r = self.rows
            valid = (r >= 0) & (r < self.height)
            self._in_range = (torch.where(valid, r, 0),
                              torch.where(valid[:, None], self.value, 0.0),
                              valid)
        return self._in_range

    def to_dense(self) -> torch.Tensor:
        """[height, width] with duplicate rows summed."""
        rows, value, _ = self.in_range()
        out = torch.zeros((self.height,) + tuple(self.value.shape[1:]),
                          dtype=self.value.dtype, device=self.value.device)
        return out.index_add_(0, rows, value)

    def merged(self):
        """Duplicate rows coalesced into a buffer of the static size n
        (≙ math::scatter::MergeAdd; the JAX package's `_merge_sparse_rows`).
        Returns (rows, value, n_valid):

        - `rows` [n]: the distinct valid rows in ascending order, then, at
          every position past them, the last of them again, so an
          index_copy_ of values that repeat likewise writes each row once
          over (with no valid row at all, some row in range: callers that
          copy mask by `n_valid`);
        - `value` [n, width]: each distinct row's summed gradient at its
          position, zeros past them (an index_add_ of it adds nothing to
          the repeated row);
        - `n_valid`: a device scalar, the number of distinct valid rows.

        Duplicates are summed in the order they were looked up (on the
        CPU; a card's index_add_ sums in no fixed order)."""
        r, n = self.rows, self.rows.shape[0]
        dev = r.device
        valid = (r >= 0) & (r < self.height)
        keyed = torch.where(valid, r, self.height)   # invalid rows sort last
        srt, perm = torch.sort(keyed)
        head = torch.ones(n, dtype=torch.bool, device=dev)
        head[1:] = srt[1:] != srt[:-1]
        slot = torch.cumsum(head, 0) - 1             # sorted entry -> its run
        inv = torch.empty_like(slot).scatter_(0, perm, slot)
        value = torch.zeros_like(self.value).index_add_(0, inv, self.value)
        # each run's key at its slot (a run's entries all write the same)
        keys = torch.full((n,), self.height, dtype=srt.dtype,
                          device=dev).scatter_(0, slot, srt)
        n_valid = (head & (srt < self.height)).sum()
        pos = torch.arange(n, device=dev)
        src = torch.minimum(pos, (n_valid - 1).clamp_min(0))
        rows = keys.gather(0, src).clamp_max(self.height - 1)
        value = torch.where((pos < n_valid)[:, None], value, 0.0)
        return rows, value, n_valid


class SelectedRows:
    """{rows, value, height} sparse row set on the host (≙
    selected_rows.h:32)."""

    def __init__(self, rows: Sequence[int], value, height: int):
        rows = np.asarray(rows, dtype=np.int64)
        value = np.asarray(value)
        enforce(rows.ndim == 1, "rows must be 1-D",
                exc=InvalidArgumentError)
        enforce(value.shape[0] == rows.shape[0],
                f"value rows {value.shape[0]} != len(rows) {rows.shape[0]}",
                exc=InvalidArgumentError)
        enforce(height >= 0, "height must be >= 0",
                exc=InvalidArgumentError)
        if rows.size:
            enforce(int(rows.min()) >= 0 and int(rows.max()) < height,
                    f"rows must lie in [0, {height}); got "
                    f"[{rows.min()}, {rows.max()}]",
                    exc=InvalidArgumentError)
        self.rows = rows
        self.value = value
        self.height = int(height)

    def to_dense(self) -> np.ndarray:
        """Materialize [height, width] with duplicate rows summed
        (≙ math::scatter::MergeAdd)."""
        out = np.zeros((self.height,) + self.value.shape[1:],
                       dtype=self.value.dtype)
        np.add.at(out, self.rows, self.value)
        return out

    @staticmethod
    def from_dense(dense: np.ndarray, nonzero_only: bool = True):
        dense = np.asarray(dense)
        if nonzero_only:
            mask = np.any(dense.reshape(dense.shape[0], -1) != 0, axis=1)
            rows = np.nonzero(mask)[0]
        else:
            rows = np.arange(dense.shape[0])
        return SelectedRows(rows, dense[rows], dense.shape[0])

    def merge_add(self) -> "SelectedRows":
        """Coalesce duplicate rows (≙ MergeAdd) keeping sparsity."""
        uniq, inv = np.unique(self.rows, return_inverse=True)
        val = np.zeros((uniq.shape[0],) + self.value.shape[1:],
                       dtype=self.value.dtype)
        np.add.at(val, inv, self.value)
        return SelectedRows(uniq, val, self.height)

    def __repr__(self):
        return (f"SelectedRows(rows={self.rows.tolist()}, "
                f"height={self.height}, value.shape={self.value.shape})")
