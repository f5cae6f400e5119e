"""Checkpoint commits off the training thread (the port's copy of the JAX
package's ``runtime/async_ckpt.py``).

A synchronous :meth:`Checkpointer.save` encodes, hashes, writes and
fsyncs on the training thread. :class:`AsyncCheckpointManager` splits a
save in two:

1. **snapshot** (the caller's thread): every tensor of the saved tree is
   copied to host memory before ``save`` returns. The optimizer updates
   the params in place, so the tree's device tensors change as soon as
   the next step runs; the copy is complete (the device-to-host copies
   synchronize) when ``save`` returns. Its wall clock is the only stall
   the training thread pays (``checkpointSnapshot`` span,
   ``lo_checkpoint_snapshot_seconds``, :attr:`snapshots`). A tensor
   saved transposed (the flax layout of ``_saved_form``) is copied as the
   view it is, and made contiguous by the worker's encoder.
2. **commit** (one background worker): the host tree goes through a FIFO
   queue to the same atomic step-dir commit as the synchronous path
   (:meth:`Checkpointer._commit_host`), so a newer step never lands
   before an older one.

Semantics, as in the JAX package:

- the queue holds ``LO_CKPT_INFLIGHT`` snapshots: a ``save`` beyond that
  blocks until the oldest commit drains (backpressure);
- a failed commit is latched and re-raised as
  :class:`AsyncCheckpointError` on the next ``save``, ``save_meta`` or
  barrier; the worker keeps draining;
- every read (``latest_step``, ``restore``, ``restore_partial``,
  ``saved_metadata``, ``load_meta``) waits for the queue first;
- ``wait_until_finished()`` is the barrier at the end of a fit;
  ``close()`` drains without re-raising;
- the ``ckpt_async_commit`` fault site fires at the start of each queued
  item; each snapshot waiting for its commit is ledgered under the X-ray
  owner ``snapshot`` (host bytes).

The manager duck-types :class:`Checkpointer` (``commits`` and
``restores`` are the inner checkpointer's), so the engine and the health
sentinel run unchanged against either. :func:`wrap_checkpointer` picks
one from ``LO_CKPT_ASYNC``.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from learningorchestra_tpu_torch.runtime import locks
from learningorchestra_tpu_torch.runtime.checkpoint import Checkpointer

_SENTINEL = object()


def _observe(name: str, t0: float, end: float, ctx, **attrs) -> None:
    """A span against a trace context taken on the caller's thread (the
    worker has none of its own), and the phase's histogram."""
    try:
        from learningorchestra_tpu_torch.observability import hist, trace

        if ctx is not None:
            trace.add(name, ctx[0], t0, end, parent=ctx[1], **attrs)
        hist.observe(
            {"checkpointSnapshot": "lo_checkpoint_snapshot_seconds",
             "checkpointCommit": "lo_checkpoint_commit_seconds",
             }.get(name, f"lo_{name}_seconds"), end - t0)
    except Exception:  # noqa: BLE001 — observability is advisory
        pass


def _trace_ctx():
    try:
        from learningorchestra_tpu_torch.observability import trace

        return trace.current()
    except Exception:  # noqa: BLE001
        return None


def _to_host(tree: Any) -> Any:
    """``tree`` with every tensor copied to host memory (numpy leaves
    and Python scalars as they are)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _host_bytes(tree: Any) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_host_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_host_bytes(v) for v in tree)
    return int(getattr(tree, "nbytes", 0))


class AsyncCheckpointError(RuntimeError):
    """A background commit failed. The original exception is the
    ``__cause__``; raised on the training thread at the next save or
    barrier, so the failure lands on the job, not the worker."""


class AsyncCheckpointManager:
    """A :class:`Checkpointer` facade that commits on a background
    worker: ``save`` = host snapshot + enqueue; reads and
    ``wait_until_finished`` barrier; a failed commit latches. ``config``
    arms the worker's fault sites (else the one the caller's thread has
    installed, else ``LO_FAULT_INJECT``)."""

    def __init__(self, checkpointer: Checkpointer, inflight: int = 2,
                 config=None):
        from learningorchestra_tpu_torch.services import faults

        self._ckpt = checkpointer
        self._config = config if config is not None else \
            getattr(faults._tls, "config", None)
        # the queue bound is the most host snapshots alive at once
        self._queue: "queue.Queue" = queue.Queue(
            maxsize=max(1, int(inflight)))
        self._error: Optional[BaseException] = None
        self._error_lock = locks.make_lock("async_ckpt.error")
        self._closed = False
        # {"step", "seconds", "bytes"} of each snapshot: the training
        # thread's stall per save
        self.snapshots: List[Dict[str, Any]] = []
        self._worker = threading.Thread(
            target=self._drain, daemon=True, name="lo-ckpt-commit")
        self._worker.start()

    @property
    def commits(self) -> List[Dict[str, Any]]:
        return self._ckpt.commits

    @property
    def restores(self) -> List[Dict[str, Any]]:
        return self._ckpt.restores

    # -- the worker ----------------------------------------------------
    def _drain(self) -> None:
        from learningorchestra_tpu_torch.observability import xray
        from learningorchestra_tpu_torch.services import faults

        while True:
            item = self._queue.get()
            try:
                if item is _SENTINEL:
                    return
                kind, payload, ctx, t_enq = item
                t0 = time.monotonic()
                try:
                    with faults.use_config(self._config):
                        if kind == "save":
                            step, host, token = payload
                            try:
                                faults.maybe_inject("ckpt_async_commit")
                                self._ckpt._commit_host(step, host)
                            finally:
                                # committed or failed, the snapshot goes
                                xray.release("snapshot", token)
                            _observe("checkpointCommit", t0,
                                     time.monotonic(), ctx, step=int(step),
                                     async_=True,
                                     queued_seconds=round(t0 - t_enq, 6))
                        else:
                            # the progress sidecar rides the same FIFO, so
                            # it never runs ahead of its step's commit
                            faults.maybe_inject("ckpt_async_commit")
                            self._ckpt.save_meta(payload)
                except BaseException as exc:  # noqa: BLE001 — latch and
                    # keep draining: the error surfaces on the caller
                    with self._error_lock:
                        if self._error is None:
                            self._error = exc
            finally:
                self._queue.task_done()

    def _check_error(self) -> None:
        with self._error_lock:
            exc = self._error
        if exc is not None:
            raise AsyncCheckpointError(
                f"async checkpoint commit failed: {exc!r}") from exc

    # -- the write path ------------------------------------------------
    def save(self, step: int, tree: Any) -> None:
        """Copies ``tree`` to the host and queues its commit. Blocks for
        the copy (and while ``inflight`` commits are queued). A failed
        earlier commit raises first."""
        from learningorchestra_tpu_torch.observability import xray

        self._check_error()
        if self._closed:
            raise AsyncCheckpointError(
                "save() after close(): the manager is shut down")
        ctx = _trace_ctx()
        t0 = time.monotonic()
        host = _to_host(tree)
        end = time.monotonic()
        nbytes = _host_bytes(host)
        self.snapshots.append({"step": int(step), "seconds": end - t0,
                               "bytes": nbytes})
        _observe("checkpointSnapshot", t0, end, ctx, step=int(step))
        # ledgered while it waits for its commit; the worker releases it
        token = (id(self), int(step), id(host))
        xray.register("snapshot", token, nbytes, host=True,
                      name=ctx[0] if ctx else None)
        self._queue.put(("save", (int(step), host, token), ctx,
                         time.monotonic()))

    def save_meta(self, meta: dict) -> None:
        self._check_error()
        if self._closed:
            raise AsyncCheckpointError(
                "save_meta() after close(): the manager is shut down")
        self._queue.put(("meta", dict(meta), _trace_ctx(),
                         time.monotonic()))

    # -- the barrier -----------------------------------------------------
    def wait_until_finished(self, reraise: bool = True) -> None:
        """Blocks until every queued commit landed (or failed)."""
        self._queue.join()
        if reraise:
            self._check_error()

    # -- the read path (barriers first) ----------------------------------
    def latest_step(self) -> Optional[int]:
        self.wait_until_finished()
        return self._ckpt.latest_step()

    def restore(self, target: Any, step: Optional[int] = None) -> Any:
        self.wait_until_finished()
        return self._ckpt.restore(target, step)

    def restore_partial(self, target_subtree: Any,
                        step: Optional[int] = None) -> Any:
        self.wait_until_finished()
        return self._ckpt.restore_partial(target_subtree, step)

    def saved_metadata(self, step: Optional[int] = None) -> Any:
        self.wait_until_finished()
        return self._ckpt.saved_metadata(step)

    def load_meta(self) -> Optional[dict]:
        self.wait_until_finished()
        return self._ckpt.load_meta()

    # -- teardown ----------------------------------------------------------
    def close(self) -> None:
        """Drains (without re-raising: teardown must not mask the job's
        own error), stops the worker and closes the inner
        checkpointer."""
        if self._closed:
            return
        self._closed = True
        self._queue.join()
        self._queue.put(_SENTINEL)
        self._worker.join(timeout=30.0)
        self._ckpt.close()


def wrap_checkpointer(checkpointer: Checkpointer, config=None) -> Any:
    """``checkpointer``, or an :class:`AsyncCheckpointManager` over it
    when ``config.ckpt_async`` (``LO_CKPT_ASYNC``) is on, with
    ``config.ckpt_inflight`` (``LO_CKPT_INFLIGHT``) snapshots in flight.
    ``config`` defaults to one read from the environment."""
    if config is None:
        from learningorchestra_tpu_torch.config import Config

        config = Config()
    if not getattr(config, "ckpt_async", False):
        return checkpointer
    return AsyncCheckpointManager(
        checkpointer, inflight=int(getattr(config, "ckpt_inflight", 2)),
        config=config)
