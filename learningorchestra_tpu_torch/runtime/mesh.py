"""The logical mesh of the port: named axes over process-group ranks.

Counterpart of :mod:`learningorchestra_tpu.runtime.mesh`. The JAX
package lays its axes over devices; the port runs one process per card
(one rank is one card), so a mesh here lays the same axes over ranks of
the process group that :mod:`.distributed` forms. A world of one (no
group formed) is a mesh of one rank.

==========  =====================================================
axis        meaning
==========  =====================================================
``dcn``     cross-slice data parallel (outermost axis)
``dp``      data parallel (batch rows; gradients all-reduced)
``fsdp``    fully-sharded data parallel
``tp``      tensor parallel
``pp``      pipeline parallel
``sp``      sequence parallel (ring or Ulysses attention)
``ep``      expert parallel
==========  =====================================================

The port computes over ``dcn``, ``dp`` and ``sp``; a mesh whose ``tp``,
``fsdp``, ``ep`` or ``pp`` axis is above 1 is refused (ROADMAP Queue 1
item 10.2) wherever a mesh is built.

A train step of a sharded fit runs under :func:`sharded`: the engine
publishes the rank's :class:`Shard` (its data block, its sequence block
and the groups of both) on the step's thread, and the model reads it
(:func:`current_shard`) to place its rope positions and to choose ring
or Ulysses attention.
"""

from __future__ import annotations

import contextlib
import re
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from learningorchestra_tpu_torch.runtime import distributed as dist

DCN, DP, FSDP, TP, PP, SP, EP = \
    "dcn", "dp", "fsdp", "tp", "pp", "sp", "ep"
# axes the port does not compute over yet (ROADMAP Queue 1 item 10.2)
UNPORTED_AXES = (TP, FSDP, EP, PP)


class UnportedMeshAxis(ValueError):
    """A mesh asks for tensor, fully-sharded, expert or pipeline
    parallelism, which the port does not run yet."""


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """Parse ``"dp=2,tp=4"`` into an ordered axis->size dict."""
    out: Dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        m = re.fullmatch(r"([a-z_]+)\s*=\s*(-?\d+)", part)
        if not m:
            raise ValueError(f"bad mesh spec element: {part!r}")
        out[m.group(1)] = int(m.group(2))
    if not out:
        raise ValueError(f"empty mesh spec: {spec!r}")
    return out


def check_supported(sizes: Dict[str, int]) -> None:
    """Raise :class:`UnportedMeshAxis` for a ``tp``, ``fsdp``, ``ep`` or
    ``pp`` axis above 1 (or left at ``-1``, to take the other ranks)."""
    for axis in UNPORTED_AXES:
        if sizes.get(axis, 1) > 1 or sizes.get(axis) == -1:
            raise UnportedMeshAxis(
                f"mesh axis {axis}={sizes[axis]} is not ported to the "
                f"PyTorch package yet (tensor, fully-sharded, expert and "
                f"pipeline parallelism are ROADMAP Queue 1 item 10.2); "
                f"the port computes over dcn, dp and sp")


def check_spec(spec: str) -> None:
    """Refuse, before any group exists, a spec the port cannot run
    (``"auto"`` always runs)."""
    if spec != "auto":
        check_supported(parse_mesh_spec(spec))


class Mesh:
    """Named axes over ranks: ``ranks`` is an array of global ranks
    shaped by the axis sizes (the JAX mesh's ``devices``). Two meshes
    over the same ranks with the same axes compare equal. The process
    group of a rank's block along some axes is formed on first use by
    :meth:`group`, which every member of the block calls."""

    def __init__(self, sizes: Dict[str, int], ranks: Sequence[int]):
        self.axis_names: Tuple[str, ...] = tuple(sizes)
        self.shape: Dict[str, int] = {a: int(s) for a, s in sizes.items()}
        self.ranks = np.asarray(list(ranks), dtype=np.int64).reshape(
            tuple(self.shape.values()))
        self._groups: Dict[Tuple[str, ...], Any] = {}

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh)
                and self.axis_names == other.axis_names
                and self.shape == other.shape
                and np.array_equal(self.ranks, other.ranks))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={list(self.ranks.flat)})"

    def coords(self, rank: int) -> Optional[Dict[str, int]]:
        """The axis indices of ``rank``, None outside the mesh."""
        hit = np.argwhere(self.ranks == int(rank))
        if not len(hit):
            return None
        return dict(zip(self.axis_names, (int(i) for i in hit[0])))

    def _blocks(self, axes: Tuple[str, ...]) -> List[List[int]]:
        """Every set of ranks that differ only along ``axes``, in a fixed
        order."""
        keep = [i for i, a in enumerate(self.axis_names) if a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in keep]
        moved = np.transpose(self.ranks, rest + keep)
        width = int(np.prod([self.ranks.shape[i] for i in keep] or [1]))
        return [list(int(r) for r in row)
                for row in moved.reshape(-1, width)]

    def axis_ranks(self, axes, rank: int) -> List[int]:
        """The ranks that share every coordinate of ``rank`` except
        along ``axes`` (a name or a tuple of names), in mesh order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for block in self._blocks(axes):
            if int(rank) in block:
                return block
        raise ValueError(f"rank {rank} is not in {self!r}")

    def group(self, axes=None):
        """The process group of this rank's block along ``axes`` (all
        axes by default; None without a formed group). Formed at first
        use by the block's members alone, all of whom must ask for it
        (:func:`.distributed.group_of`)."""
        axes = self.axis_names if axes is None else (
            (axes,) if isinstance(axes, str) else tuple(axes))
        if not dist.is_initialized():
            return None
        key = tuple(a for a in self.axis_names if a in axes)
        if key not in self._groups:
            self._groups[key] = dist.group_of(
                self.axis_ranks(key, dist.rank()))
        return self._groups[key]


def build_mesh(spec: str = "auto",
               devices: Optional[Sequence[int]] = None) -> Mesh:
    """Build a mesh over ``devices`` (ranks; the whole world by default).

    ``"auto"`` = 1-D data parallel over every rank. An explicit spec
    like ``"dp=2,sp=4"`` may leave one axis as ``-1`` to absorb the
    remaining ranks; ``dcn`` must come first; a mesh smaller than the
    world is legal (it takes the first ranks)."""
    ranks = list(devices) if devices is not None else \
        list(range(dist.world_size()))
    n = len(ranks)
    if spec == "auto":
        return Mesh({DP: n}, ranks)
    sizes = parse_mesh_spec(spec)
    if DCN in sizes and next(iter(sizes)) != DCN:
        raise ValueError(
            f"dcn must be the OUTERMOST (first) mesh axis: {spec!r}")
    unknown = [a for a, s in sizes.items() if s == -1]
    if len(unknown) > 1:
        raise ValueError("at most one -1 axis allowed")
    known = int(np.prod([s for s in sizes.values() if s != -1]))
    if unknown:
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[unknown[0]] = n // known
    total = int(np.prod(list(sizes.values())))
    if total > n:
        raise ValueError(
            f"mesh {sizes} needs {total} devices, have {n}")
    check_supported(sizes)
    return Mesh(sizes, ranks[:total])


_default_mesh: Optional[Mesh] = None


def get_default_mesh() -> Mesh:
    """The process-wide mesh from ``LO_MESH_SHAPE`` over the world
    (cached until :func:`reset_default_mesh`)."""
    global _default_mesh
    if _default_mesh is None:
        from learningorchestra_tpu_torch.config import Config

        _default_mesh = build_mesh(Config().mesh_shape)
    return _default_mesh


def reset_default_mesh() -> None:
    global _default_mesh
    _default_mesh = None


def slice_mesh(devices: Sequence[int], spec: str = "auto") -> Mesh:
    """A mesh over an explicit subset of ranks (the same axis naming as
    :func:`build_mesh`, so two slices of the same ranks compare equal)."""
    return build_mesh(spec, devices=list(devices))


def sub_meshes(mesh: Mesh, k: int) -> list:
    """``mesh`` cut into ``k`` disjoint equal 1-D dp meshes of
    contiguous ranks (the remainder left out)."""
    ranks = [int(r) for r in mesh.ranks.flat]
    k = max(1, min(k, len(ranks)))
    per = len(ranks) // k
    return [slice_mesh(ranks[i * per:(i + 1) * per]) for i in range(k)]


# -- per-job mesh override ------------------------------------------------
_mesh_override = threading.local()


def current_mesh() -> Mesh:
    """The mesh this thread computes on: the scope of :func:`use_mesh`,
    else the default mesh."""
    mesh = getattr(_mesh_override, "mesh", None)
    return mesh if mesh is not None else get_default_mesh()


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Scope :func:`current_mesh` to ``mesh`` on this thread (None is a
    no-op)."""
    if mesh is None:
        yield None
        return
    previous = getattr(_mesh_override, "mesh", None)
    _mesh_override.mesh = mesh
    try:
        yield mesh
    finally:
        _mesh_override.mesh = previous


def set_current_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """Swap this thread's override in place; returns the previous one."""
    previous = getattr(_mesh_override, "mesh", None)
    _mesh_override.mesh = mesh
    return previous


def mesh_for_slice(device_indices: Optional[Sequence[int]]) -> Mesh:
    """A grant of indices into the default mesh's flat rank order as a
    mesh; None or a full cover is the default mesh object itself."""
    base = get_default_mesh()
    if device_indices is None:
        return base
    ranks = [int(r) for r in base.ranks.flat]
    indices = sorted(int(i) for i in device_indices)
    if len(indices) >= len(ranks):
        return base
    return slice_mesh([ranks[i] for i in indices])


def mesh_fraction(mesh: Mesh) -> float:
    """``mesh``'s share of the default mesh; 1.0 when the default mesh
    cannot be formed or is smaller."""
    try:
        base = get_default_mesh()
        return min(1.0, float(mesh.size) / max(1, int(base.size)))
    except Exception:  # noqa: BLE001 — no default mesh formed yet
        return 1.0


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Axes the batch rows are sharded over (dcn outermost)."""
    return tuple(a for a in (DCN, DP, FSDP) if a in mesh.axis_names)


def data_parallel_size(mesh: Mesh) -> int:
    size = 1
    for a in data_axes(mesh):
        size *= mesh.shape[a]
    return size


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


# -- the batch placement of one rank ------------------------------------
class Shard:
    """One rank's place in a sharded step: ``data_index`` of
    ``data_size`` row blocks, ``seq_index`` of ``seq_size`` sequence
    blocks (``seq_size`` 1 unless the fit shards the sequence), and the
    groups the step reduces over: ``group`` every rank of the mesh (the
    gradients and the metric sums), ``seq_group`` the rank's ``sp``
    block (ring and Ulysses)."""

    def __init__(self, mesh: Mesh, rank: int, seq_parallel: bool):
        coords = mesh.coords(rank)
        if coords is None:
            raise ValueError(f"rank {rank} is not in {mesh!r}")
        self.mesh = mesh
        self.rank = int(rank)
        data = data_axes(mesh)
        self.data_size = data_parallel_size(mesh)
        index = 0
        for a in data:
            index = index * mesh.shape[a] + coords[a]
        self.data_index = index
        sp = mesh.shape.get(SP, 1)
        self.seq_size = sp if seq_parallel else 1
        self.seq_index = coords.get(SP, 0) if seq_parallel else 0
        self.group = mesh.group()
        self.seq_group = mesh.group(SP) if self.seq_size > 1 else None
        self.seq_ranks = (mesh.axis_ranks(SP, rank)
                          if self.seq_size > 1 else [self.rank])
        # the index of this rank's (data, sequence) block: what its
        # random draws fold in
        self.row_index = self.data_index * self.seq_size + self.seq_index

    @property
    def size(self) -> int:
        return self.mesh.size

    def rows(self, n: int) -> slice:
        """This rank's block of ``n`` batch rows (``n`` a multiple of
        :attr:`data_size`)."""
        per = n // self.data_size
        return slice(self.data_index * per, (self.data_index + 1) * per)

    def columns(self, s: int) -> slice:
        per = s // self.seq_size
        return slice(self.seq_index * per, (self.seq_index + 1) * per)


_shard = threading.local()


def current_shard() -> Optional[Shard]:
    """The :class:`Shard` of the step running on this thread, or None."""
    return getattr(_shard, "value", None)


@contextlib.contextmanager
def sharded(shard: Optional[Shard]) -> Iterator[Optional[Shard]]:
    previous = getattr(_shard, "value", None)
    _shard.value = shard
    try:
        yield shard
    finally:
        _shard.value = previous
