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

With ``shards > 1`` a step is N byte-balanced sub-files
``shard-00000-of-0000N.msgpack`` under one manifest, as the JAX package
writes them: the state dict flattened to ``{"a/b/c": leaf}`` (an empty
dict stays a leaf) and dealt greedily, largest leaf first, to the least
loaded shard; every sub-file verifies on its own and restore merges
them. A step dir of either layout, written by either package, restores
in both.

:meth:`Checkpointer.restore_partial` reads only the named subtrees of
the newest verified step (the engine's params-only migration), with the
same quarantine and fallback. Saves are synchronous, so
:meth:`Checkpointer.wait_until_finished` and :meth:`Checkpointer.close`
have nothing to wait for; ``runtime/async_ckpt.py`` commits off the
training thread through :meth:`Checkpointer._commit_host`, the commit of
a tree already in host memory.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from learningorchestra_tpu_torch.observability import hist as obs_hist
from learningorchestra_tpu_torch.observability import trace as obs_trace
from learningorchestra_tpu_torch.runtime import health as health_lib
from learningorchestra_tpu_torch.runtime import serialization

_MSGPACK_NAME = "checkpoint.msgpack"
_MANIFEST_NAME = "manifest.json"
_QUARANTINE_DIR = ".quarantine"
_PROGRESS_NAME = "progress.json"
_SHARD_PREFIX = "shard-"


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
        # sub-files per step (the JAX package's multi-host layout); 1 is
        # the single checkpoint.msgpack
        self._shards = max(1, int(shards))
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

    def _read_file_verified(self, step: int, name: str,
                            meta: Optional[dict]) -> bytes:
        """One payload file's bytes, re-hashed against its manifest entry
        (unverified where the dir has no manifest)."""
        try:
            with open(self._path(step, name), "rb") as f:
                data = f.read()
        except OSError as exc:
            raise CheckpointCorrupted(
                f"step {step}: unreadable payload: {exc}") from exc
        if meta is not None:
            if len(data) != meta.get("bytes"):
                raise CheckpointCorrupted(
                    f"step {step}: {name} is {len(data)} bytes, manifest "
                    f"says {meta.get('bytes')} (torn write?)")
            digest = hashlib.sha256(data).hexdigest()
            if digest != meta.get("sha256"):
                raise CheckpointCorrupted(
                    f"step {step}: {name} sha256 {digest[:12]}… does not "
                    f"match manifest {str(meta.get('sha256'))[:12]}… "
                    f"(bit rot?)")
        return data

    def _read_verified(self, step: int) -> Any:
        """The step's saved tree, every payload re-hashed against the
        manifest (unverified for a dir without one); a sharded step's
        sub-files merged."""
        manifest = self._load_manifest(step)
        files = manifest["files"] if manifest is not None else None
        shards = sorted(n for n in files or () if n.startswith(_SHARD_PREFIX))
        try:
            if not shards:
                data = self._read_file_verified(
                    step, _MSGPACK_NAME,
                    None if files is None else files.get(_MSGPACK_NAME, {}))
                return serialization.msgpack_restore(data)
            flat: Dict[str, Any] = {}
            for name in shards:
                part = serialization.msgpack_restore(
                    self._read_file_verified(step, name, files[name]))
                if not isinstance(part, dict):
                    raise CheckpointCorrupted(
                        f"step {step}: {name} is not a shard map")
                flat.update(part)
            return _unflatten_state(flat)
        except CheckpointCorrupted:
            raise
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
            self._commit_host(step, tree, t0)
        finally:
            _observe_commit(step, t0)

    def _payloads(self, tree: Any) -> Dict[str, List[Any]]:
        """``{file name: its bytes as parts}`` of one commit: the whole
        state dict, or its shard maps."""
        state = serialization.to_state_dict(tree)
        if self._shards <= 1 or not isinstance(state, dict) or not state:
            return {_MSGPACK_NAME: serialization.encode_parts(state)}
        flat = _flatten_state(state)
        n = min(self._shards, len(flat))
        bins: List[Dict[str, Any]] = [{} for _ in range(n)]
        loads = [0] * n
        for key in sorted(flat, key=lambda k: (-_leaf_nbytes(flat[k]), k)):
            i = loads.index(min(loads))
            bins[i][key] = flat[key]
            loads[i] += _leaf_nbytes(flat[key])
        # a shard map's keys sorted, as flax's encoder writes a dict
        return {f"{_SHARD_PREFIX}{i:05d}-of-{n:05d}.msgpack":
                serialization.encode_parts(
                    {k: bins[i][k] for k in sorted(bins[i])})
                for i in range(n)}

    def _commit_host(self, step: int, tree: Any,
                     t0: Optional[float] = None) -> None:
        """Commits ``step`` atomically from ``tree`` (device tensors are
        read as the encoder reaches them; the async manager passes a host
        copy): every payload file and the manifest written and fsynced
        into ``<step>.tmp/``, then one rename. Appends the commit to
        :attr:`commits`."""
        t0 = time.monotonic() if t0 is None else t0
        payloads = self._payloads(tree)
        final_dir = os.path.join(self._dir, str(step))
        tmp_dir = final_dir + ".tmp"
        shutil.rmtree(tmp_dir, ignore_errors=True)
        os.makedirs(tmp_dir)
        files = {}
        for name, parts in payloads.items():
            digest = hashlib.sha256()
            nbytes = 0
            with open(os.path.join(tmp_dir, name), "wb") as f:
                for part in parts:
                    f.write(part)
                    digest.update(part)
                    nbytes += len(part)
                _fsync_file(f)
            files[name] = {"sha256": digest.hexdigest(), "bytes": nbytes}
        _chaos_corrupt(os.path.join(tmp_dir, next(iter(payloads))))
        manifest = {"step": int(step), "wallTime": time.time(),
                    "files": files}
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
        self.commits.append({"step": int(step),
                             "bytes": sum(m["bytes"] for m in files.values()),
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
        as the codec reads it: the structure and shapes the engine's
        params-only migration compares with the live state."""
        if step is None:
            step = self.latest_step()
        return None if step is None else self._read_verified(step)

    def restore_partial(self, target_subtree: Dict[str, Any],
                        step: Optional[int] = None) -> Any:
        """Only the top-level subtrees named in ``target_subtree`` (such
        as ``params`` and ``step``, leaving a drifted ``opt_state``
        unread), each in its target's structure; None when no step
        verifies or the saved tree lacks one of them. Verified as
        :meth:`restore` is: a corrupt step is quarantined, and with
        ``step=None`` the next newest is read; an explicit ``step``
        raises."""
        t0 = time.monotonic()
        while True:
            explicit = step is not None
            if not explicit:
                step = self.latest_step()
            if step is None:
                return None
            try:
                raw = self._read_verified(step)
            except CheckpointCorrupted as exc:
                self._quarantine(step, str(exc))
                if explicit:
                    raise
                step = None
                continue
            break
        if not isinstance(raw, dict):
            return None
        out = {}
        for key, sub_target in target_subtree.items():
            if key not in raw:
                return None
            out[key] = serialization.from_state_dict(sub_target, raw[key])
        self.restores.append({"step": step, "seconds": time.monotonic() - t0})
        return out

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


def _flatten_state(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """A nested state dict as ``{"a/b/c": leaf}``; an empty dict stays a
    leaf (restoring into a target needs its key)."""
    if isinstance(tree, dict) and tree:
        out: Dict[str, Any] = {}
        for key in tree:
            joined = f"{prefix}/{key}" if prefix else str(key)
            out.update(_flatten_state(tree[key], joined))
        return out
    return {prefix: tree}


def _unflatten_state(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return out


def _leaf_nbytes(leaf: Any) -> int:
    """A leaf's weight in the shard packing: its array bytes, at least 1
    (the JAX package's measure)."""
    if isinstance(leaf, torch.Tensor):
        return max(1, leaf.numel() * leaf.element_size())
    try:
        return max(1, int(np.asarray(leaf).nbytes))
    except Exception:  # noqa: BLE001 — a non-array leaf ({} node)
        return 1


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
