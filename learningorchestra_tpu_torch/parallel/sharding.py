"""Sharding rules of the port: the batch placement, the parameter rule
table, and each rank's shard of the parameters, as functions over a
:class:`~..runtime.mesh.Mesh`.

Counterpart of :mod:`learningorchestra_tpu.parallel.sharding`. A
partition spec is :class:`P`, a tuple with one entry per dimension: an
axis name, a tuple of names, or None (replicated). The batch half
(:func:`batch_spec`) places every sharded fit; the rule table
(:data:`TRANSFORMER_RULES`, :func:`spec_for`) says where each parameter
of the transformer lives under tensor, expert and fully-sharded data
parallelism. The parameter half is the counterpart of
``param_shardings`` and ``shard_params`` over ranks:
:func:`param_specs` gives every leaf of a flax-named ``state_dict`` its
spec in the torch layout, and a :class:`ParamLayout` of them cuts a
rank's slice of each (:func:`local_slice`: its shape the per-device
shard shape of the JAX ``NamedSharding`` of the same leaf and mesh) and
gathers the whole tree back from the ranks' slices
(:func:`gather_params`).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Sequence, Tuple

import torch

from learningorchestra_tpu_torch.runtime import distributed as dist

from learningorchestra_tpu_torch.runtime import mesh as mesh_lib
from learningorchestra_tpu_torch.runtime.mesh import Mesh


class P(tuple):
    """A partition spec: ``P(None, "tp")``. A one-name tuple entry is
    that name, as in JAX's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            (e[0] if len(e) == 1 else tuple(e))
            if isinstance(e, (tuple, list)) else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


Rule = Tuple[str, P]

# column-parallel in-projections, row-parallel out-projections, the
# embedding and lm head split over their model dimension, the experts
# over ep (first match wins; paths are flax's, ``/``-separated)
TRANSFORMER_RULES: Sequence[Rule] = (
    (r".*(q_proj|k_proj|v_proj|qkv_proj|wi|gate|gate_up|up_proj)"
     r"/kernel$",
     P(None, mesh_lib.TP)),
    (r".*(o_proj|wo|down_proj)/kernel$", P(mesh_lib.TP, None)),
    (r".*embed/embedding$", P(None, mesh_lib.TP)),
    (r".*lm_head/kernel$", P(None, mesh_lib.TP)),
    (r".*experts/(wi|gate)$", P(mesh_lib.EP, None, mesh_lib.TP)),
    (r".*experts/wo$", P(mesh_lib.EP, mesh_lib.TP, None)),
    (r".*(bias|scale)$", P()),
)


def _axes_in_mesh(spec: P, mesh: Mesh) -> P:
    """Drop rule axes the mesh lacks or holds at size 1 (one rule set
    serves every mesh; a missing axis means replicated there)."""
    def keep(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in mesh.axis_names
                         and mesh.shape[a] > 1)
            return kept if kept else None
        return entry if entry in mesh.axis_names and \
            mesh.shape[entry] > 1 else None

    return P(*(keep(e) for e in spec))


def _fsdp_spec(shape: Tuple[int, ...], base: P, mesh: Mesh) -> P:
    """``base`` with the largest unsharded dimension that the fsdp axis
    divides sharded over it."""
    if mesh_lib.FSDP not in mesh.axis_names or \
            mesh.shape[mesh_lib.FSDP] <= 1:
        return base
    fsdp_size = mesh.shape[mesh_lib.FSDP]
    entries = list(base) + [None] * (len(shape) - len(base))
    candidates = [(dim, i) for i, (dim, e) in enumerate(zip(shape, entries))
                  if e is None and dim % fsdp_size == 0 and dim >= fsdp_size]
    if not candidates:
        return base
    _, idx = max(candidates)
    entries[idx] = mesh_lib.FSDP
    return P(*entries)


def _axes_size(entry, mesh: Mesh) -> int:
    axes = entry if isinstance(entry, (tuple, list)) else (entry,)
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return size


def _drop_non_divisible(base: P, shape: Tuple[int, ...],
                        mesh: Mesh) -> P:
    """Replicate any rule-sharded dimension its axes do not divide."""
    entries = []
    for i, entry in enumerate(base):
        if entry is not None and i < len(shape) and \
                shape[i] % _axes_size(entry, mesh):
            entry = None
        entries.append(entry)
    return P(*entries)


def spec_for(path: str, shape: Tuple[int, ...], mesh: Mesh,
             rules: Sequence[Rule] = TRANSFORMER_RULES,
             fsdp: bool = True) -> P:
    """The spec of the parameter at flax ``path`` with ``shape``."""
    base = P()
    for pattern, spec in rules:
        if re.match(pattern, path):
            base = _drop_non_divisible(
                _axes_in_mesh(spec, mesh), shape, mesh)
            break
    return _fsdp_spec(shape, base, mesh) if fsdp else base


def batch_spec(mesh: Mesh, seq_axis: bool = False) -> P:
    """Batch activations: rows over the data axes, and the sequence over
    ``sp`` when ``seq_axis`` and the mesh has ``sp`` above 1."""
    data = mesh_lib.data_axes(mesh)
    first = data if data else None
    if seq_axis and mesh_lib.SP in mesh.axis_names and \
            mesh.shape[mesh_lib.SP] > 1:
        return P(first, mesh_lib.SP)
    return P(first)


# ----------------------------------------------------------------------
# the parameter half: a rank's shard of every leaf
# ----------------------------------------------------------------------
def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, outermost first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def torch_spec(spec: P, ndim: int, transposed: bool) -> P:
    """A flax leaf's spec on its torch tensor: padded to ``ndim`` and
    reversed where the torch tensor is the flax kernel's transpose."""
    entries = list(spec) + [None] * (ndim - len(spec))
    return P(*(entries[::-1] if transposed else entries))


def param_specs(shapes: Dict[str, Tuple[int, ...]], mesh: Mesh,
                layout_path: Callable, rules: Sequence[Rule]
                = TRANSFORMER_RULES, fsdp: bool = True) -> Dict[str, P]:
    """The torch-layout spec of every param: ``shapes`` maps torch names
    to torch shapes, ``layout_path(name)`` gives ``(flax path parts,
    transposed)``. A rule wider than its tensor replicates, as in
    ``param_shardings``."""
    out = {}
    for name, shape in shapes.items():
        path, transposed = layout_path(name)
        flax_shape = tuple(shape)[::-1] if transposed else tuple(shape)
        spec = spec_for("/".join(path), flax_shape, mesh, rules, fsdp)
        if len(spec) > len(flax_shape):
            spec = P()
        out[name] = torch_spec(spec, len(shape), transposed)
    return out


def is_sharded(spec: P) -> bool:
    return any(e is not None for e in spec)


def _place(entry, mesh: Mesh, coords: Dict[str, int]) -> Tuple[int, int]:
    """``(index, count)`` of a rank's block along one spec entry."""
    index, count = 0, 1
    for a in entry_axes(entry):
        index = index * mesh.shape[a] + coords[a]
        count *= mesh.shape[a]
    return index, count


def local_slice(t: torch.Tensor, spec: P, mesh: Mesh,
                rank: int) -> torch.Tensor:
    """``rank``'s block of ``t`` under ``spec`` (a view)."""
    coords = mesh.coords(rank)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        index, count = _place(entry, mesh, coords)
        width = t.shape[dim] // count
        t = t.narrow(dim, index * width, width)
    return t


def local_shape(shape: Tuple[int, ...], spec: P,
                mesh: Mesh) -> Tuple[int, ...]:
    """The shard shape of a leaf of ``shape`` under ``spec``."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        if entry is not None:
            out[dim] //= _place(entry, mesh, {
                a: 0 for a in mesh.axis_names})[1]
    return tuple(out)


def gather_tensor(t: torch.Tensor, spec: P, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from every rank's shard ``t`` (every rank of the
    mesh calls this, for the same leaves in the same order)."""
    for dim, entry in enumerate(spec):
        group = mesh.group(entry_axes(entry))
        if group is not None:
            t = torch.cat(dist.all_gather(t, group), dim=dim)
    return t


def gather_params(local: Dict[str, torch.Tensor], specs: Dict[str, P],
                  mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The whole params from the ranks' shards, in sorted name order."""
    return {k: gather_tensor(local[k].detach(), specs[k], mesh)
            if is_sharded(specs[k]) else local[k].detach()
            for k in sorted(local)}


def full_shape(shape: Tuple[int, ...], spec: P,
               mesh: Mesh) -> Tuple[int, ...]:
    """The whole shape of a leaf whose shard has ``shape``."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        if entry is not None:
            out[dim] *= _place(entry, mesh, {
                a: 0 for a in mesh.axis_names})[1]
    return tuple(out)


class ParamLayout:
    """Where a sharded fit keeps each param: the torch-layout ``specs``
    over ``mesh``, seen from ``rank``."""

    def __init__(self, specs: Dict[str, P], mesh: Mesh, rank: int):
        self.specs = dict(specs)
        self.mesh = mesh
        self.rank = int(rank)

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        spec = self.specs.get(name)
        return t if spec is None else local_slice(t, spec, self.mesh,
                                                  self.rank)

    def gather(self, tensors: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """Whole tensors from this rank's shards of params (or of slots
        keyed like them); every rank calls it together."""
        return gather_params(tensors, {k: self.specs.get(k, P())
                                       for k in tensors}, self.mesh)

    def full_shape(self, name: str,
                   shape: Tuple[int, ...]) -> Tuple[int, ...]:
        spec = self.specs.get(name)
        return tuple(shape) if spec is None else \
            full_shape(shape, spec, self.mesh)

    def shards(self, name: str) -> int:
        """How many distinct shards the leaf has over the mesh."""
        count = 1
        for entry in self.specs.get(name, P()):
            for a in entry_axes(entry):
                count *= self.mesh.shape[a]
        return count

    def fsdp_dims(self) -> Dict[str, int]:
        """The dimension fsdp shards, of every leaf it shards."""
        out = {}
        for name, spec in self.specs.items():
            for dim, entry in enumerate(spec):
                if mesh_lib.FSDP in entry_axes(entry):
                    out[name] = dim
        return out
