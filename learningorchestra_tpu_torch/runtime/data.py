"""Host-side batches of the training slice.

Counterpart of :mod:`learningorchestra_tpu.runtime.data` for one card:
fixed-shape batches whose ragged tail is zero-padded and masked with a
per-sample 0/1 weight column (``MASK_KEY``), so losses and metrics stay
exact. The engine moves each batch to the card itself; there is no
prefetch thread and no data-parallel padding (the port trains on one
card). :func:`dataframe_to_arrays` is the catalog DataFrame feed.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence

import numpy as np

MASK_KEY = "__sample_weight__"


class ArrayBatcher:
    """Batches a dict of host numpy arrays into fixed-shape minibatches.

    The final ragged batch is zero-padded; ``MASK_KEY`` carries 1.0 for
    real samples and 0.0 for padding. With ``shuffle`` every epoch draws
    its order from ``np.random.default_rng(seed + epoch)``, the order the
    JAX package's per-step feed uses.
    """

    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int, *,
                 shuffle: bool = False, seed: int = 0):
        if not arrays:
            raise ValueError("empty feed")
        sizes = {k: len(v) for k, v in arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"mismatched array lengths: {sizes}")
        if int(batch_size) < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self._arrays = {k: np.asarray(v) for k, v in arrays.items()}
        self.num_samples = next(iter(sizes.values()))
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
            mask = np.ones((bs,), np.float32)
            if pad:
                mask[-pad:] = 0.0
            batch[MASK_KEY] = mask
            yield batch


def dataframe_to_arrays(df, feature_columns: Optional[Sequence[str]] = None,
                        label_column: Optional[str] = None,
                        dtype=np.float32) -> Dict[str, np.ndarray]:
    """A catalog DataFrame as an x/(y) array feed, as the JAX package's
    ``runtime.data.dataframe_to_arrays`` makes it: the ``_id`` column is
    dropped, non-numeric columns are factorized (label-encoded) and the
    rest coerced to numbers (unparseable values become 0)."""
    import pandas as pd

    if feature_columns is None:
        feature_columns = [c for c in df.columns
                           if c != label_column and c != "_id"]
    cols = []
    for c in feature_columns:
        s = df[c]
        if s.dtype == object or str(s.dtype).startswith("str"):
            codes, _ = pd.factorize(s)
            cols.append(codes.astype(dtype))
        else:
            cols.append(
                pd.to_numeric(s, errors="coerce").fillna(0).to_numpy(dtype))
    out = {"x": np.stack(cols, axis=1) if cols else np.zeros((len(df), 0))}
    if label_column is not None:
        y = df[label_column]
        if y.dtype == object or str(y.dtype).startswith("str"):
            codes, _ = pd.factorize(y)
            out["y"] = codes.astype(np.int32)
        else:
            out["y"] = y.to_numpy()
    return out
