"""Sharding rules of the port: the batch placement and the parameter
rule table, as pure functions over a :class:`~..runtime.mesh.Mesh`.

Counterpart of :mod:`learningorchestra_tpu.parallel.sharding`. A
partition spec is :class:`P`, a tuple with one entry per dimension: an
axis name, a tuple of names, or None (replicated). The batch half
(:func:`batch_spec`) places every sharded fit; the rule table
(:data:`TRANSFORMER_RULES`, :func:`spec_for`) says where each parameter
of the transformer would live under tensor and fully-sharded data
parallelism. Applying it to parameters is ROADMAP Queue 1 item 10.2:
until then a mesh with a ``tp`` or ``fsdp`` axis above 1 is refused
(:func:`..runtime.mesh.check_supported`) and every parameter is
replicated.
"""

from __future__ import annotations

import re
from typing import Sequence, Tuple

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
