"""Step checkpoints and pytree files of the port.

The msgpack half of :mod:`learningorchestra_tpu.runtime.checkpoint`
(the JAX package's layout off the TPU), written through the port's own
codec (:mod:`.serialization`):

- ``<dir>/<step>/checkpoint.msgpack`` holds the state's bytes and
  ``<dir>/<step>/manifest.json`` their sha256 and size, the step and a
  ``wallTime``;
- a step commits atomically: payload and manifest are written and
  fsynced into ``<step>.tmp/``, one ``os.replace`` renames it into
  place and the directory is fsynced. Leftover ``*.tmp`` dirs are swept
  when a :class:`Checkpointer` opens the directory, and the oldest steps
  beyond ``max_to_keep`` are deleted;
- :meth:`Checkpointer.latest_step` checks sizes only;
  :meth:`Checkpointer.restore` re-hashes. A torn or bit-flipped step
  moves to ``<dir>/.quarantine/`` (its newest ``LO_CKPT_QUARANTINE_KEEP``
  entries are kept) with a ``RuntimeWarning``, and restore falls back to
  the newest step that verifies; an explicit ``step`` raises
  :class:`CheckpointCorrupted` instead. A step dir without a manifest
  (the layout before manifests) restores unverified;
- ``progress.json`` (:meth:`Checkpointer.save_meta`) is written
  atomically too, and a torn one reads as None;
- the ``ckpt_write:*:corrupt[:n]`` fault (``services/faults.py``) flips
  the last bytes of a payload after its sha256 was taken, so the next
  restore exercises the quarantine; each quarantined step counts in
  :func:`~learningorchestra_tpu_torch.runtime.health.health_stats`.

Saves are synchronous, so :meth:`Checkpointer.wait_until_finished` and
:meth:`Checkpointer.close` have nothing to wait for; the JAX package's
asynchronous commit (``runtime/async_ckpt.py``) and its ``shards > 1``
layout are not ported.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
import warnings
from typing import Any, Dict, List, Optional

from learningorchestra_tpu_torch.observability import hist as obs_hist
from learningorchestra_tpu_torch.observability import trace as obs_trace
from learningorchestra_tpu_torch.runtime import health as health_lib
from learningorchestra_tpu_torch.runtime import serialization

_MSGPACK_NAME = "checkpoint.msgpack"
_MANIFEST_NAME = "manifest.json"
_QUARANTINE_DIR = ".quarantine"
_PROGRESS_NAME = "progress.json"


class CheckpointCorrupted(IOError):
    """A step dir failed manifest verification (missing payload, size
    or sha256 mismatch, unreadable manifest or payload)."""


def _chaos_corrupt(path: str) -> None:
    """The ``ckpt_write`` corrupt site: flips the last bytes of the
    payload just written, after its checksum was taken (bit rot that
    restore must catch)."""
    from learningorchestra_tpu_torch.services import faults

    nbytes = faults.corrupt_nbytes("ckpt_write")
    if not nbytes:
        return
    size = os.path.getsize(path)
    nbytes = min(nbytes, size)
    with open(path, "r+b") as f:
        f.seek(size - nbytes)
        chunk = f.read(nbytes)
        f.seek(size - nbytes)
        f.write(bytes(b ^ 0xFF for b in chunk))
        _fsync_file(f)


def _quarantine_keep() -> int:
    """How many quarantined step dirs to keep (newest first)."""
    from learningorchestra_tpu_torch.config import Config

    return max(0, int(Config().ckpt_quarantine_keep))


def _fsync_file(f) -> None:
    f.flush()
    os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    # the rename must reach the disk too, or a crash can forget a
    # committed step (POSIX: fsync the parent directory)
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class Checkpointer:
    """``save(step, tree)`` / ``latest_step()`` / ``restore(target)``
    over step dirs of msgpack bytes. ``tree`` is a nested dict of
    arrays, tensors and scalars (the engine passes a train state's saved
    form); ``restore`` gives the saved tree in ``target``'s structure.

    ``commits`` lists ``{"step", "seconds", "bytes"}`` of every save
    this object made: the wall time a commit held the caller (host
    copy, encoding, hashing, writes and fsyncs). ``restores`` lists
    ``{"step", "seconds"}`` of every restore that found a step: reading,
    re-hashing and decoding, quarantined steps included."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 shards: int = 1):
        if int(shards) != 1:
            raise ValueError(f"shards={shards} (the sharded step layout) is "
                             f"not yet ported to the PyTorch package")
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._max_to_keep = max_to_keep
        self.commits: List[Dict[str, Any]] = []
        self.restores: List[Dict[str, Any]] = []
        # a kill mid-save leaves a <step>.tmp dir that was never
        # committed: it holds no verified state
        for name in os.listdir(self._dir):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self._dir, name),
                              ignore_errors=True)

    # -- layout ----------------------------------------------------------
    def _step_dirs(self) -> List[int]:
        steps = []
        for name in os.listdir(self._dir):
            if not name.isdigit():
                continue
            step_dir = os.path.join(self._dir, name)
            if os.path.exists(os.path.join(step_dir, _MSGPACK_NAME)) or \
                    os.path.exists(os.path.join(step_dir, _MANIFEST_NAME)):
                steps.append(int(name))
        return sorted(steps)

    def _path(self, step: int, name: str) -> str:
        return os.path.join(self._dir, str(step), name)

    def _load_manifest(self, step: int) -> Optional[dict]:
        """The step's manifest; None for a dir without one."""
        path = self._path(step, _MANIFEST_NAME)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as exc:
            raise CheckpointCorrupted(
                f"step {step}: unreadable manifest: {exc}") from exc
        if not isinstance(manifest, dict) or \
                not isinstance(manifest.get("files"), dict):
            raise CheckpointCorrupted(
                f"step {step}: malformed manifest (no files map)")
        return manifest

    def _verify_sizes(self, step: int) -> None:
        manifest = self._load_manifest(step)
        if manifest is None:
            if not os.path.exists(self._path(step, _MSGPACK_NAME)):
                raise CheckpointCorrupted(f"step {step}: missing payload")
            return
        for name, meta in manifest["files"].items():
            path = self._path(step, name)
            if not os.path.exists(path):
                raise CheckpointCorrupted(
                    f"step {step}: manifest names missing file {name!r}")
            size = os.path.getsize(path)
            if size != meta.get("bytes"):
                raise CheckpointCorrupted(
                    f"step {step}: {name} is {size} bytes, manifest says "
                    f"{meta.get('bytes')} (torn write?)")

    def _read_verified(self, step: int) -> Any:
        """The step's saved tree, its payload re-hashed against the
        manifest (unverified for a dir without one)."""
        manifest = self._load_manifest(step)
        try:
            with open(self._path(step, _MSGPACK_NAME), "rb") as f:
                data = f.read()
        except OSError as exc:
            raise CheckpointCorrupted(
                f"step {step}: unreadable payload: {exc}") from exc
        if manifest is not None:
            meta = manifest["files"].get(_MSGPACK_NAME, {})
            if len(data) != meta.get("bytes"):
                raise CheckpointCorrupted(
                    f"step {step}: {_MSGPACK_NAME} is {len(data)} bytes, "
                    f"manifest says {meta.get('bytes')} (torn write?)")
            digest = hashlib.sha256(data).hexdigest()
            if digest != meta.get("sha256"):
                raise CheckpointCorrupted(
                    f"step {step}: {_MSGPACK_NAME} sha256 {digest[:12]}… "
                    f"does not match manifest "
                    f"{str(meta.get('sha256'))[:12]}… (bit rot?)")
        try:
            return serialization.msgpack_restore(data)
        except Exception as exc:  # noqa: BLE001 — undecodable bytes
            raise CheckpointCorrupted(
                f"step {step}: undecodable payload: {exc}") from exc

    def _quarantine(self, step: int, reason: str) -> None:
        """Moves a corrupt step dir aside, as evidence; the quarantine
        keeps its newest entries only."""
        src = os.path.join(self._dir, str(step))
        qdir = os.path.join(self._dir, _QUARANTINE_DIR)
        os.makedirs(qdir, exist_ok=True)
        dst = os.path.join(qdir, f"{step}-{int(time.time() * 1000)}")
        while os.path.exists(dst):
            dst += "x"
        try:
            os.replace(src, dst)
        except OSError:
            shutil.rmtree(src, ignore_errors=True)
        keep = _quarantine_keep()
        try:
            entries = sorted(
                os.listdir(qdir),
                key=lambda n: os.path.getmtime(os.path.join(qdir, n)))
        except OSError:
            entries = []
        for name in entries[:max(0, len(entries) - keep)]:
            shutil.rmtree(os.path.join(qdir, name), ignore_errors=True)
        health_lib.record("quarantined")
        warnings.warn(f"quarantined checkpoint step {step} -> {dst}: "
                      f"{reason}", RuntimeWarning, stacklevel=3)

    # -- save ------------------------------------------------------------
    def save(self, step: int, tree: Any) -> None:
        """Commits ``step`` atomically (see the module docstring). The
        commit wall clock — the training thread's checkpoint stall — is
        recorded as a ``checkpointCommit`` span on the current job trace
        and in the ``lo_checkpoint_commit_seconds`` histogram."""
        t0 = time.monotonic()
        try:
            self._save_impl(step, tree, t0)
        finally:
            _observe_commit(step, t0)

    def _save_impl(self, step: int, tree: Any, t0: float) -> None:
        parts = _parts(tree)
        final_dir = os.path.join(self._dir, str(step))
        tmp_dir = final_dir + ".tmp"
        shutil.rmtree(tmp_dir, ignore_errors=True)
        os.makedirs(tmp_dir)
        digest = hashlib.sha256()
        nbytes = 0
        with open(os.path.join(tmp_dir, _MSGPACK_NAME), "wb") as f:
            for part in parts:
                f.write(part)
                digest.update(part)
                nbytes += len(part)
            _fsync_file(f)
        _chaos_corrupt(os.path.join(tmp_dir, _MSGPACK_NAME))
        manifest = {"step": int(step), "wallTime": time.time(),
                    "files": {_MSGPACK_NAME: {
                        "sha256": digest.hexdigest(), "bytes": nbytes}}}
        with open(os.path.join(tmp_dir, _MANIFEST_NAME), "w") as f:
            json.dump(manifest, f)
            _fsync_file(f)
        if os.path.exists(final_dir):
            shutil.rmtree(final_dir, ignore_errors=True)
        os.replace(tmp_dir, final_dir)
        _fsync_dir(self._dir)
        for old in self._step_dirs()[:-self._max_to_keep]:
            shutil.rmtree(os.path.join(self._dir, str(old)),
                          ignore_errors=True)
        self.commits.append({"step": int(step), "bytes": nbytes,
                             "seconds": time.monotonic() - t0})

    # -- restore ---------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        """The newest step whose files have the manifest's sizes."""
        for step in reversed(self._step_dirs()):
            try:
                self._verify_sizes(step)
            except CheckpointCorrupted:
                continue
            return step
        return None

    def restore(self, target: Any, step: Optional[int] = None) -> Any:
        """The saved tree of ``step`` (default: the newest that
        verifies; None when none does) in ``target``'s structure.
        Raises ``ValueError`` where the saved tree lacks a key of
        ``target`` or a leaf's shape differs."""
        t0 = time.monotonic()
        step, restored = self._restore(target, step)
        if step is not None:
            self.restores.append({"step": step,
                                  "seconds": time.monotonic() - t0})
        return restored

    def _restore(self, target: Any, step: Optional[int]):
        """(step restored or None, its tree in ``target``'s structure)."""
        if step is not None:
            try:
                raw = self._read_verified(step)
            except CheckpointCorrupted as exc:
                # an explicitly requested step has no substitute
                self._quarantine(step, str(exc))
                raise
            return step, self._decode(raw, target)
        while True:
            candidates = self._step_dirs()
            if not candidates:
                return None, None
            step = candidates[-1]
            try:
                raw = self._read_verified(step)
            except CheckpointCorrupted as exc:
                self._quarantine(step, str(exc))
                continue
            return step, self._decode(raw, target)

    @staticmethod
    def _decode(raw: Any, target: Any) -> Any:
        restored = serialization.from_state_dict(target, raw)
        for got, want in zip(_leaves(restored), _leaves(target)):
            gs, ws = _shape(got), _shape(want)
            if gs is not None and ws is not None and gs != ws:
                raise ValueError(f"checkpoint leaf shape {gs} does not "
                                 f"match target shape {ws}")
        return restored

    def saved_metadata(self, step: Optional[int] = None) -> Any:
        """The saved tree of ``step`` (default: the latest), verified,
        as the codec reads it."""
        if step is None:
            step = self.latest_step()
        return None if step is None else self._read_verified(step)

    # -- progress sidecar --------------------------------------------------
    def save_meta(self, meta: dict) -> None:
        path = os.path.join(self._dir, _PROGRESS_NAME)
        with open(path + ".tmp", "w") as f:
            json.dump(meta, f)
            _fsync_file(f)
        os.replace(path + ".tmp", path)
        _fsync_dir(self._dir)

    def load_meta(self) -> Optional[dict]:
        path = os.path.join(self._dir, _PROGRESS_NAME)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            # the step checkpoints carry the state; progress is a hint
            return None
        return meta if isinstance(meta, dict) else None

    def wait_until_finished(self, reraise: bool = True) -> None:
        """Barrier for commits in flight: a save returns committed, so
        there are none."""
        del reraise

    def close(self) -> None:
        pass


def _observe_commit(step: int, t0: float) -> None:
    try:
        end = time.monotonic()
        cur = obs_trace.current()
        if cur is not None:
            obs_trace.add("checkpointCommit", cur[0], t0, end,
                          parent=cur[1], step=int(step))
        obs_hist.observe("lo_checkpoint_commit_seconds", end - t0)
    except Exception:  # noqa: BLE001 — observability is advisory
        pass


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for key in tree:
            yield from _leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _leaves(value)
    else:
        yield tree


def _shape(x: Any):
    shape = getattr(x, "shape", None)
    return None if shape is None else tuple(shape)


# ----------------------------------------------------------------------
# msgpack pytree files (artifact weights)
# ----------------------------------------------------------------------
def _parts(tree: Any) -> List[Any]:
    """``flax.serialization.to_bytes(tree)`` as the codec's parts, which
    view the arrays' buffers."""
    return serialization.encode_parts(serialization.to_state_dict(tree))


def save_pytree(tree: Any, path: str) -> None:
    with open(path, "wb") as f:
        for part in _parts(tree):
            f.write(part)


def load_pytree(path: str, target: Any) -> Any:
    with open(path, "rb") as f:
        data = f.read()
    return serialization.from_bytes(target, data)
