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

The batch rows lie over the data axes (``dcn``, ``dp``, ``fsdp``), the
sequence over ``sp`` where the fit splits it; the batch is replicated
over ``tp``, ``ep`` and ``pp``, as the JAX mesh leaves it.

A train step of a sharded fit runs under :func:`sharded`: the engine
publishes the rank's :class:`Shard` (its data block, its sequence block,
its tensor, expert, fully-sharded and pipeline coordinates, and the
groups of each) on the step's thread, and the model reads it
(:func:`current_shard`) to place its rope positions, to choose ring or
Ulysses attention and to run its sharded projections.
"""

from __future__ import annotations

import contextlib
import itertools
import re
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from learningorchestra_tpu_torch.runtime import distributed as dist

DCN, DP, FSDP, TP, PP, SP, EP = \
    "dcn", "dp", "fsdp", "tp", "pp", "sp", "ep"
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


def _check_sizes(spec: str, sizes: Dict[str, int]) -> None:
    """The checks of a spec that need no ranks: ``dcn`` outermost, at
    most one ``-1``."""
    if DCN in sizes and next(iter(sizes)) != DCN:
        raise ValueError(
            f"dcn must be the OUTERMOST (first) mesh axis: {spec!r}")
    if sum(1 for s in sizes.values() if s == -1) > 1:
        raise ValueError("at most one -1 axis allowed")


def check_spec(spec: str) -> None:
    """Refuse, before any group exists, a spec no world can run: the
    checks the JAX ``build_mesh`` makes before it counts devices
    (``"auto"`` always runs)."""
    if spec != "auto":
        _check_sizes(spec, parse_mesh_spec(spec))


class Mesh:
    """Named axes over ranks: ``ranks`` is an array of global ranks
    shaped by the axis sizes (the JAX mesh's ``devices``). Two meshes
    over the same ranks with the same axes compare equal. The process
    groups of the mesh's blocks are formed together, at the first
    :meth:`group` of a member; every rank of the world forms them at the
    same point of its program, a rank outside a smaller mesh through
    :meth:`form_groups`."""

    def __init__(self, sizes: Dict[str, int], ranks: Sequence[int]):
        self.axis_names: Tuple[str, ...] = tuple(sizes)
        self.shape: Dict[str, int] = {a: int(s) for a, s in sizes.items()}
        self.ranks = np.asarray(list(ranks), dtype=np.int64).reshape(
            tuple(self.shape.values()))
        self._groups: Optional[Dict[Tuple[str, ...], Any]] = None

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

    def form_groups(self) -> None:
        """Form the process group of every block along every combination
        of the axes above 1, in one fixed order. torch names a group by
        the count of groups formed before it, so every rank of the world
        calls this for the same meshes in the same order: a member
        through its first :meth:`group`, a rank outside the mesh
        itself."""
        if self._groups is not None or not dist.is_initialized():
            return
        axes = [a for a in self.axis_names if self.shape[a] > 1]
        me = dist.rank()
        groups = {}
        for n in range(1, len(axes) + 1):
            for key in itertools.combinations(axes, n):
                for block in self._blocks(key):
                    group = dist.group_of(block)
                    if me in block:
                        groups[key] = group
        self._groups = groups

    def group(self, axes=None):
        """The process group of this rank's block along ``axes`` (all
        axes by default); None without a process group or for a block
        of one rank."""
        axes = self.axis_names if axes is None else (
            (axes,) if isinstance(axes, str) else tuple(axes))
        key = tuple(a for a in self.axis_names
                    if a in axes and self.shape[a] > 1)
        if not dist.is_initialized() or not key:
            return None
        self.form_groups()
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
    _check_sizes(spec, sizes)
    unknown = [a for a, s in sizes.items() if s == -1]
    known = int(np.prod([s for s in sizes.values() if s != -1]))
    if unknown:
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[unknown[0]] = n // known
    total = int(np.prod(list(sizes.values())))
    if total > n:
        raise ValueError(
            f"mesh {sizes} needs {total} devices, have {n}")
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
    blocks (``seq_size`` 1 unless the fit shards the sequence), and its
    coordinate, size, ranks and group along each model axis (``tp``,
    ``ep``, ``fsdp``, ``pp``: ``tp_index``, ``tp_size``, ``tp_ranks``,
    ``tp_group`` and so on; a group is None at size 1).

    The groups a step reduces over: ``group`` every rank of the mesh
    (launch counts, barriers), ``row_group`` the ranks that hold this
    rank's model coordinates over every (data, sequence) block (the
    gradient and metric sums, the MoE routing), ``seq_group`` the rank's
    ``sp`` block (ring and Ulysses), ``model_group`` its ``ep`` by ``tp``
    block (the expert layer's combine). The ranks of one row block that
    differ along ``tp``, ``ep``, ``pp`` (or ``sp`` where the fit does
    not split the sequence) hold the same rows."""

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
        # the groups (the mesh forms all of them at the first)
        self.group = mesh.group()
        self.seq_group = mesh.group(SP) if self.seq_size > 1 else None
        self.seq_ranks = (mesh.axis_ranks(SP, rank)
                          if self.seq_size > 1 else [self.rank])
        self.row_axes = data + ((SP,) if self.seq_size > 1 else ())
        self.row_ranks = mesh.axis_ranks(self.row_axes, rank)
        self.row_group = (mesh.group(self.row_axes)
                          if len(self.row_ranks) > 1 else None)
        # the (data, sequence) block of each row rank, in rank order
        self.row_blocks = [self._block_of(mesh.coords(r), data)
                           for r in self.row_ranks]
        for axis in (TP, EP, FSDP, PP):
            size = mesh.shape.get(axis, 1)
            setattr(self, axis + "_size", size)
            setattr(self, axis + "_index", coords.get(axis, 0))
            setattr(self, axis + "_ranks", mesh.axis_ranks(axis, rank)
                    if axis in mesh.axis_names else [self.rank])
            setattr(self, axis + "_group",
                    mesh.group(axis) if size > 1 else None)
        # the data axes but fsdp: what an fsdp-sharded leaf's gradient
        # still sums over after its reduce-scatter
        rest = tuple(a for a in self.row_axes if a != FSDP)
        self.rest_ranks = mesh.axis_ranks(rest, rank) if rest else \
            [self.rank]
        self.rest_group = (mesh.group(rest)
                           if len(self.rest_ranks) > 1 else None)
        model = tuple(a for a in (EP, TP) if mesh.shape.get(a, 1) > 1)
        self.model_size = int(np.prod([mesh.shape[a] for a in model]
                                      or [1]))
        self.model_group = mesh.group(model) if self.model_size > 1 \
            else None
        # the index of this rank's (data, sequence) block: what its
        # random draws fold in (the same on every rank of the block)
        self.row_index = self.data_index * self.seq_size + self.seq_index
        # torch param name -> the dimension fsdp shards (set by the
        # engine for a fit whose leaves it shards)
        self.fsdp_dims: Dict[str, int] = {}

    def _block_of(self, coords: Dict[str, int], data) -> Tuple[int, int]:
        index = 0
        for a in data:
            index = index * self.mesh.shape[a] + coords[a]
        return index, (coords.get(SP, 0) if self.seq_size > 1 else 0)

    @property
    def size(self) -> int:
        return self.mesh.size

    @property
    def row_size(self) -> int:
        return len(self.row_ranks)

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
