"""Host-side batches of the training slice.

Counterpart of :mod:`learningorchestra_tpu.runtime.data` for one card:
fixed-shape batches whose ragged tail is zero-padded and masked with a
per-sample 0/1 weight column (``MASK_KEY``), so losses and metrics stay
exact. The engine moves each batch to the card itself; there is no
prefetch thread and no data-parallel padding (the port trains on one
card). :func:`dataframe_to_arrays` is the catalog table feed.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence

import numpy as np

MASK_KEY = "__sample_weight__"


class ArrayBatcher:
    """Batches a dict of host numpy arrays into fixed-shape minibatches.

    The final ragged batch is zero-padded; ``MASK_KEY`` carries 1.0 for
    real samples (or their ``sample_weight``, keras's per-sample loss
    and metric weights) and 0.0 for padding. With ``shuffle`` every
    epoch draws its order from ``np.random.default_rng(seed + epoch)``,
    the order the JAX package's per-step feed uses.
    """

    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int, *,
                 shuffle: bool = False, seed: int = 0,
                 sample_weight: Optional[np.ndarray] = None):
        if not arrays:
            raise ValueError("empty feed")
        sizes = {k: len(v) for k, v in arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"mismatched array lengths: {sizes}")
        if int(batch_size) < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self._arrays = {k: np.asarray(v) for k, v in arrays.items()}
        self.num_samples = next(iter(sizes.values()))
        self._sample_weight = None
        if sample_weight is not None:
            sample_weight = np.asarray(sample_weight,
                                       np.float32).reshape(-1)
            if len(sample_weight) != self.num_samples:
                raise ValueError(
                    f"sample_weight has {len(sample_weight)} entries "
                    f"for {self.num_samples} samples")
            self._sample_weight = sample_weight
        self.batch_size = int(batch_size)
        self._shuffle = shuffle
        self._seed = seed

    @property
    def steps_per_epoch(self) -> int:
        return max(1, -(-self.num_samples // self.batch_size))

    def epoch(self, epoch_index: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        n = self.num_samples
        order = np.arange(n)
        if self._shuffle:
            rng = np.random.default_rng(self._seed + epoch_index)
            rng.shuffle(order)
        bs = self.batch_size
        for start in range(0, n, bs):
            idx = order[start:start + bs]
            pad = bs - len(idx)
            batch = {}
            for key, arr in self._arrays.items():
                take = arr[idx]
                if pad:
                    take = np.concatenate(
                        [take, np.zeros((pad,) + arr.shape[1:], arr.dtype)])
                batch[key] = take
            mask = np.zeros((bs,), np.float32)
            mask[:len(idx)] = 1.0 if self._sample_weight is None \
                else self._sample_weight[idx]
            batch[MASK_KEY] = mask
            yield batch


def _factorize(values: np.ndarray) -> np.ndarray:
    """Integer codes in order of first appearance; a missing value
    (None or NaN) is -1, as ``pandas.factorize`` gives them."""
    codes = np.empty(len(values), np.int64)
    seen: Dict = {}
    for i, v in enumerate(values.tolist()):
        if v is None or (isinstance(v, float) and v != v):
            codes[i] = -1
        else:
            codes[i] = seen.setdefault(v, len(seen))
    return codes


def _is_text(values: np.ndarray) -> bool:
    return values.dtype.kind in "OUS"


def dataframe_to_arrays(df, feature_columns: Optional[Sequence[str]] = None,
                        label_column: Optional[str] = None,
                        dtype=np.float32) -> Dict[str, np.ndarray]:
    """A catalog table as an x/(y) array feed, as the JAX package's
    ``runtime.data.dataframe_to_arrays`` makes it from a DataFrame: the
    ``_id`` column is dropped, text columns are factorized (label
    codes in order of first appearance, -1 for a missing value) and the
    rest cast to numbers with nulls as 0.

    ``df`` is a :class:`~learningorchestra_tpu_torch.catalog.store.Table`
    or anything with ``.columns`` whose items are column arrays (a
    pandas DataFrame works, but pandas is not needed)."""
    if feature_columns is None:
        feature_columns = [c for c in df.columns
                           if c != label_column and c != "_id"]
    cols = []
    for c in feature_columns:
        values = np.asarray(df[c])
        if _is_text(values):
            cols.append(_factorize(values).astype(dtype))
        else:
            if values.dtype.kind == "f":
                values = np.where(np.isnan(values), 0, values)
            cols.append(values.astype(dtype))
    out = {"x": np.stack(cols, axis=1) if cols else np.zeros((len(df), 0))}
    if label_column is not None:
        y = np.asarray(df[label_column])
        out["y"] = _factorize(y).astype(np.int32) if _is_text(y) else y
    return out
