"""Host-side batches of the training slice and their feed to the card.

Counterpart of :mod:`learningorchestra_tpu.runtime.data` for one card:
fixed-shape batches whose ragged tail is zero-padded and masked with a
per-sample 0/1 weight column (``MASK_KEY``), so losses and metrics stay
exact. A fit that fits ``LO_SCAN_FIT_MAX_BYTES`` stages
:meth:`ArrayBatcher.padded_arrays` on the card once (``runtime/engine.py``);
a larger one of more than one step an epoch is fed by
:func:`prefetch_to_device`, which copies the next batches on a side
stream while the current step runs. A sharded fit's batcher pads the batch
size to a multiple of the data-parallel size (``dp_multiple``), as the
JAX package's does.
:func:`dataframe_to_arrays` is the catalog table feed.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Any, Dict, Iterable, Iterator, Optional, Sequence

import numpy as np

from learningorchestra_tpu_torch.native import ops

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
                 shuffle: bool = False, seed: int = 0, dp_multiple: int = 1,
                 sample_weight: Optional[np.ndarray] = None,
                 cache_token=None, cache_tags: Sequence[str] = ()):
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
        if self.batch_size % dp_multiple:
            self.batch_size += dp_multiple - self.batch_size % dp_multiple
        self._shuffle = shuffle
        self._seed = seed
        # hashable content identity of ``arrays`` (dataset versions,
        # projection, dtype policy): with it the staged fit keeps its
        # tensors in the device arena between fits, ``cache_tags``
        # (collection names) driving their invalidation. A sample weight
        # changes the staged mask without being part of the token, so it
        # turns reuse off.
        if sample_weight is not None:
            cache_token = None
        self.cache_token = cache_token
        self.cache_tags = tuple(cache_tags)

    def array(self, key: str) -> np.ndarray:
        """The full host array for ``key``."""
        return self._arrays[key]

    @property
    def steps_per_epoch(self) -> int:
        return max(1, -(-self.num_samples // self.batch_size))

    def total_bytes(self) -> int:
        return sum(a.nbytes for a in self._arrays.values())

    @property
    def shuffles(self) -> bool:
        return self._shuffle

    def epoch_order(self, epoch_index: int = 0) -> np.ndarray:
        """The sample order of epoch ``epoch_index`` (what :meth:`epoch`
        batches)."""
        order = np.arange(self.num_samples)
        if self._shuffle:
            rng = np.random.default_rng(self._seed + epoch_index)
            rng.shuffle(order)
        return order

    def padded_arrays(self) -> Dict[str, np.ndarray]:
        """Every sample, padded with zero rows to ``steps_per_epoch *
        batch_size``, and the ``MASK_KEY`` column, in natural order: row
        ``i`` of an epoch's batch ``j`` is row ``order[j * batch_size +
        i]`` of these, padding rows past ``num_samples``."""
        n_total = self.steps_per_epoch * self.batch_size
        pad = n_total - self.num_samples
        out: Dict[str, np.ndarray] = {}
        for key, arr in self._arrays.items():
            if pad:
                arr = np.concatenate(
                    [arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)])
            out[key] = arr
        mask = np.zeros((n_total,), np.float32)
        mask[:self.num_samples] = 1.0 if self._sample_weight is None \
            else self._sample_weight
        out[MASK_KEY] = mask
        return out

    def epoch(self, epoch_index: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        n = self.num_samples
        order = self.epoch_order(epoch_index)
        bs = self.batch_size
        for start in range(0, n, bs):
            idx = order[start:start + bs]
            pad = bs - len(idx)
            batch = {}
            for key, arr in self._arrays.items():
                take = ops.gather_rows(arr, idx)
                if pad:
                    take = np.concatenate(
                        [take, np.zeros((pad,) + arr.shape[1:], arr.dtype)])
                batch[key] = take
            mask = np.zeros((bs,), np.float32)
            mask[:len(idx)] = 1.0 if self._sample_weight is None \
                else self._sample_weight[idx]
            batch[MASK_KEY] = mask
            yield batch


def _pinned_copy(value: np.ndarray, device, stream):
    """``value`` on ``device``: copied into a pinned host buffer, then to
    the card without blocking on ``stream``."""
    import torch

    host = torch.from_numpy(np.ascontiguousarray(value))
    pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
    pinned.copy_(host)
    with torch.cuda.stream(stream):
        return pinned.to(device, non_blocking=True)


def prefetch_to_device(iterator: Iterable[Dict[str, np.ndarray]], device,
                       buffer_size: Optional[int] = None, cancel=None,
                       ) -> Iterator[Dict[str, Any]]:
    """The batches of ``iterator`` on ``device``, ``buffer_size`` ahead of
    the consumer (``LO_PREFETCH_BUFFER`` when None).

    A producer thread copies each host batch into pinned buffers and
    issues non-blocking copies on a side stream, then records an event
    there. The consumer's stream waits on that event before it uses the
    batch, and each tensor is marked used on the consumer's stream
    (``record_stream``), so the caching allocator never hands its memory
    to another tensor while a step still reads it. ``cancel`` (by
    default the calling thread's installed token) is checked before each
    batch: a cancelled job's feed stops copying. Given a CPU device the
    batches come back unchanged."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        yield from iterator
        return
    if buffer_size is None:
        from learningorchestra_tpu_torch.config import Config

        buffer_size = Config().prefetch_buffer
    buffer_size = max(1, int(buffer_size))
    if cancel is None:
        # taken here, on the consumer's (the job's) thread: the producer
        # has no thread-local token
        from learningorchestra_tpu_torch.runtime import preempt

        cancel = preempt.current_cancel()
    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=buffer_size)
    end = object()
    err: list = []
    stop = threading.Event()  # set when the consumer leaves the feed
    side = torch.cuda.Stream(device)

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue_mod.Full:
                continue
        return False

    def producer() -> None:
        try:
            with torch.cuda.device(device):
                for batch in iterator:
                    if cancel is not None and cancel.cancelled():
                        return  # a cancelled job: stop filling the card
                    staged = {k: _pinned_copy(v, device, side)
                              for k, v in batch.items()}
                    ready = torch.cuda.Event()
                    ready.record(side)
                    if not put((staged, ready)):
                        return  # the consumer is gone
        except Exception as e:  # noqa: BLE001 — raised in the consumer
            err.append(e)
        finally:
            put(end)

    thread = threading.Thread(target=producer, name="lo-prefetch",
                              daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                if err:
                    raise err[0]
                return
            staged, ready = item
            current = torch.cuda.current_stream(device)
            current.wait_event(ready)
            for tensor in staged.values():
                tensor.record_stream(current)
            yield staged
    finally:
        # reached at the end and when the consumer drops the feed
        # mid-epoch (a step raised): unblock the producer, free its queue
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue_mod.Empty:
                break
        thread.join(timeout=5.0)


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
