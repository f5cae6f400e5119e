"""The process group of the port: one process per card.

Counterpart of :mod:`learningorchestra_tpu.runtime.distributed`. The JAX
package runs one process per host over the pod's devices; the port runs
one process per card, as PyTorch does: rank ``r`` of a world of ``n``
computes on card ``r`` modulo the host's card count. The same program
starts on every rank (:func:`initialize`); rank 0 serves REST and
publishes every job on the :class:`HostBridge`, and the other ranks
follow it and replay the job, so every collective of a sharded step has
all its members.

    # rank 0 (coordinator; serves REST)
    python -m learningorchestra_tpu_torch --coordinator 10.0.0.1:8476 \
        --num-hosts 2 --host-id 0
    # rank 1 (follows the coordinator)
    python -m learningorchestra_tpu_torch --coordinator 10.0.0.1:8476 \
        --num-hosts 2 --host-id 1

Environment forms: ``LO_COORDINATOR``, ``LO_NUM_HOSTS``, ``LO_HOST_ID``
(the arguments win). A finite timeout (``COLLECTIVE_TIMEOUT``, 300 s)
bounds every collective of the compute group, so a lost peer fails the
step instead of hanging it; the bridge's own group waits without bound
(an idle worker waits for the next job).

The backend is a fixed rule, not a knob: NCCL where every rank has a
card of its own, gloo for CPU ranks and for several ranks sharing one
card (NCCL refuses two ranks on one device). Under gloo every collective
of CUDA tensors crosses host memory. The ones gloo cannot run on CUDA
tensors (``send``/``recv``, ``all_gather``, ``all_to_all``) are copied
here, as transport only. ``all_reduce`` and ``broadcast`` gloo stages
itself through pinned host memory, and it sums an ``all_reduce`` on the
host: the gradient and metric sums of a sharded step are the one
computation that leaves the card under gloo. :func:`staged_bytes` counts
the bytes of all of them, each way.

Worker liveness rides a UDP side channel one port above the coordinator
(``LO_HEARTBEAT_INTERVAL``, ``LO_HEARTBEAT_TIMEOUT``, ``LO_HEARTBEAT_PORT``):
a dead peer makes collectives fail or hang, so they cannot carry it.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import socket
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as tdist

from learningorchestra_tpu_torch.runtime import locks

_initialized = False
_backend: Optional[str] = None
_platform: Optional[str] = None
_bridge_group = None
_groups: Dict[tuple, Any] = {}
_monitor: Optional["HeartbeatMonitor"] = None
_sender_stop: Optional[threading.Event] = None
# serializes the (length, payload) broadcast pair of each publish so
# concurrent publishers (a job thread and the shutdown path) cannot
# interleave their collectives
_publish_lock = locks.make_lock("distributed.publish")
_state_lock = locks.make_lock("distributed.state")
_staged = {"toHost": 0, "toDevice": 0}

HEARTBEAT_INTERVAL = float(os.environ.get("LO_HEARTBEAT_INTERVAL", "1.0"))
HEARTBEAT_TIMEOUT = float(os.environ.get(
    "LO_HEARTBEAT_TIMEOUT", str(10 * HEARTBEAT_INTERVAL)))
# the bridge waits for the next job without bound
_BRIDGE_TIMEOUT = datetime.timedelta(days=365)


COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=300)
_timeout = COLLECTIVE_TIMEOUT


def choose_backend(device_type: str, ranks_on_host: int,
                   cards: int) -> str:
    """``nccl`` when the ranks compute on cards and each has its own,
    else ``gloo``."""
    if device_type == "cuda" and cards >= ranks_on_host:
        return "nccl"
    return "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: str = "cuda",
               timeout: Optional[datetime.timedelta] = None) -> bool:
    """Join (or form) the process group. Returns True when a group was
    formed, False for a single process (nothing configured). Safe to
    call twice. ``device`` is the entry point's (``cuda`` or ``cpu``):
    CUDA ranks take card ``rank % device_count``. ``timeout`` bounds each
    collective of the compute group (``COLLECTIVE_TIMEOUT`` when None)."""
    global _initialized, _backend, _platform, _bridge_group, _timeout
    if _initialized:
        return True
    coordinator_address = coordinator_address or \
        os.environ.get("LO_COORDINATOR")
    if num_processes is None and os.environ.get("LO_NUM_HOSTS"):
        num_processes = int(os.environ["LO_NUM_HOSTS"])
    if process_id is None and os.environ.get("LO_HOST_ID"):
        process_id = int(os.environ["LO_HOST_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None:
        raise ValueError("a process group needs the coordinator's "
                         "host:port (--coordinator or LO_COORDINATOR)")
    world = int(num_processes or 1)
    me = int(process_id or 0)
    if not 0 <= me < world:
        raise ValueError(f"host id {me} outside a pod of {world}")
    device_type = str(device).split(":")[0]
    cards = torch.cuda.device_count() if device_type == "cuda" else 0
    if device_type == "cuda":
        if not cards:
            raise RuntimeError("device 'cuda' requested but no CUDA "
                               "device is available")
        torch.cuda.set_device(me % cards)
    host = coordinator_address.rpartition(":")[0]
    local = host in ("127.0.0.1", "localhost", socket.gethostname())
    backend = choose_backend(device_type, world if local else 1, cards)
    _timeout = timeout or COLLECTIVE_TIMEOUT
    tdist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=world, rank=me, timeout=_timeout)
    _bridge_group = tdist.new_group(backend="gloo",
                                    timeout=_BRIDGE_TIMEOUT)
    _backend, _platform = backend, device_type
    _initialized = True
    if world > 1:
        _start_heartbeats(coordinator_address, me, world)
    return True


def is_initialized() -> bool:
    """True once :func:`initialize` formed a group in this process."""
    return _initialized


def rank() -> int:
    if not _initialized:
        return 0
    return tdist.get_rank()


def world_size() -> int:
    if not _initialized:
        return 1
    return tdist.get_world_size()


def backend() -> Optional[str]:
    return _backend


def is_coordinator() -> bool:
    """Rank 0 owns the REST control plane; the other ranks follow it."""
    return rank() == 0


def group_of(ranks: Sequence[int]):
    """The process group over ``ranks`` (two or more): the world itself
    when it is all of it, else one formed at first use. torch names a
    group by the count of groups formed before it, so every rank of the
    world asks for every group, member or not, in one order
    (:meth:`.mesh.Mesh.form_groups`); a rank outside ``ranks`` gets
    torch's ``NON_GROUP_MEMBER``."""
    key = tuple(sorted(int(r) for r in ranks))
    if key == tuple(range(world_size())):
        return tdist.group.WORLD
    if key not in _groups:
        _groups[key] = tdist.new_group(list(key), timeout=_timeout)
    return _groups[key]


# ----------------------------------------------------------------------
# collectives
# ----------------------------------------------------------------------
def staged_bytes() -> Dict[str, int]:
    """Bytes of CUDA tensors that crossed host memory for a collective
    under gloo, each way."""
    with _state_lock:
        return dict(_staged)


def reset_staged_bytes() -> None:
    with _state_lock:
        for k in _staged:
            _staged[k] = 0


def _to_host(t):
    """``(host tensor, device or None)``: a CUDA tensor under gloo is
    copied to host memory (and counted); anything else passes."""
    if _gloo_stages(t):
        _count("toHost", t)
        return t.cpu(), t.device
    return t, None


def _back(t, device):
    if device is None:
        return t
    _count("toDevice", t)
    return t.to(device)


def _count(way: str, t) -> None:
    with _state_lock:
        _staged[way] += t.numel() * t.element_size()


def _gloo_stages(t) -> bool:
    return _backend == "gloo" and t.is_cuda


@contextlib.contextmanager
def _collective():
    """Marks an error raised by a collective (a lost peer closes its
    socket or lets the timeout lapse), so :func:`is_collective_error`
    can tell it from the job's own."""
    try:
        yield
    except RuntimeError as exc:
        exc.lo_collective = True
        raise


def is_collective_error(exc: BaseException) -> bool:
    """True when ``exc``, or an error it was raised from, came out of a
    collective: one of torch.distributed's own errors, or any raised
    inside this module's collectives."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, tdist.DistError) or \
                getattr(exc, "lo_collective", False):
            return True
        exc = exc.__cause__ or exc.__context__
    return False


def all_reduce(t, group=None):
    """In-place sum over ``group``. NCCL sums on the card; gloo copies a
    CUDA tensor to pinned host memory, sums there and copies it back,
    and both copies are counted."""
    if _gloo_stages(t):
        _count("toHost", t)
        _count("toDevice", t)
    with _collective():
        tdist.all_reduce(t, group=group)
    return t


def broadcast(t, src: int = 0, group=None):
    """``src``'s ``t`` on every member. Under gloo a CUDA tensor leaves
    the card on ``src`` and comes back to it on every other member."""
    if _gloo_stages(t):
        _count("toHost" if rank() == src else "toDevice", t)
    with _collective():
        tdist.broadcast(t, src=src, group=group)
    return t


def barrier(group=None) -> None:
    with _collective():
        if _backend == "nccl":
            tdist.barrier(group=group,
                          device_ids=[torch.cuda.current_device()])
        else:
            tdist.barrier(group=group)


def all_gather(t, group=None) -> list:
    """Every member's ``t``, in group rank order."""
    src, device = _to_host(t.contiguous())
    n = tdist.get_world_size(group)
    out = [torch.empty_like(src) for _ in range(n)]
    with _collective():
        tdist.all_gather(out, src, group=group)
    return [_back(o, device) for o in out]


def _all_to_all(buf, group):
    """``out[j]`` = member ``j``'s ``buf[i]`` on member ``i``: ``buf``'s
    first dimension is the group size."""
    src, device = _to_host(buf.contiguous())
    out = torch.empty_like(src)
    with _collective():
        tdist.all_to_all_single(out, src, group=group)
    return _back(out, device)


def _exchange(buf, dst: int, src: int, group):
    """Send ``buf`` to global rank ``dst`` and receive one like it from
    ``src``."""
    host, device = _to_host(buf.contiguous())
    out = torch.empty_like(host)
    with _collective():
        if _backend == "nccl":
            works = tdist.batch_isend_irecv([
                tdist.P2POp(tdist.isend, host, dst, group),
                tdist.P2POp(tdist.irecv, out, src, group)])
            for w in works:
                w.wait()
        else:
            send = tdist.isend(host, dst, group=group)
            tdist.recv(out, src, group=group)
            send.wait()
    return _back(out, device)


def _flat(tensors):
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(buf, likes):
    out, at = [], 0
    for t in likes:
        out.append(buf[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


class _RingShift(torch.autograd.Function):
    """Send the tensors to the next member of ``ranks`` and take the
    previous member's, as one message; the backward sends the
    gradients the other way."""

    @staticmethod
    def forward(ctx, ranks, group, *tensors):
        me = ranks.index(rank())
        ctx.ranks, ctx.group, ctx.me = ranks, group, me
        ctx.likes = [(t.shape, t.dtype, t.device) for t in tensors]
        n = len(ranks)
        buf = _exchange(_flat(tensors), ranks[(me + 1) % n],
                        ranks[(me - 1) % n], group)
        return tuple(_unflat(buf, tensors))

    @staticmethod
    def backward(ctx, *grads):
        ranks, me, n = ctx.ranks, ctx.me, len(ctx.ranks)
        grads = [torch.zeros(shape, dtype=dtype, device=device)
                 if g is None else g
                 for g, (shape, dtype, device) in zip(grads, ctx.likes)]
        buf = _exchange(_flat(grads), ranks[(me - 1) % n],
                        ranks[(me + 1) % n], ctx.group)
        return (None, None) + tuple(_unflat(buf, grads))


class _AllToAll(torch.autograd.Function):
    """:func:`_all_to_all` of several ``(n, ...)`` tensors as one
    message; the exchange is its own adjoint."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        ctx.likes = [(t.shape, t.dtype, t.device) for t in tensors]
        n = tensors[0].shape[0]
        buf = torch.cat([t.reshape(n, -1) for t in tensors], dim=1)
        out = _all_to_all(buf, group)
        return tuple(_split_cols(out, tensors))

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(shape, dtype=dtype, device=device)
                 if g is None else g
                 for g, (shape, dtype, device) in zip(grads, ctx.likes)]
        n = grads[0].shape[0]
        buf = torch.cat([g.reshape(n, -1) for g in grads], dim=1)
        out = _all_to_all(buf, ctx.group)
        return (None,) + tuple(_split_cols(out, grads))


class _Tie(torch.autograd.Function):
    """``out`` unchanged, with ``tensors`` in its graph at zero
    gradient: a rank that skips a ring hop still runs the backward
    of that hop's rotation, which its neighbours wait for."""

    @staticmethod
    def forward(ctx, out, *tensors):
        ctx.likes = [(t.shape, t.dtype, t.device) for t in tensors]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        return (grad,) + tuple(
            torch.zeros(shape, dtype=dtype, device=device)
            for shape, dtype, device in ctx.likes)


def _split_cols(buf, likes):
    out, at = [], 0
    for t in likes:
        width = t[0].numel()
        out.append(buf[:, at:at + width].reshape(t.shape))
        at += width
    return out


def ring_shift(tensors, ranks: Sequence[int], group) -> tuple:
    """Differentiable rotation of ``tensors`` (one dtype) one step along
    ``ranks``: each member takes its predecessor's."""
    return _RingShift.apply(tuple(int(r) for r in ranks), group,
                                 *tensors)


def tie(out, tensors):
    """``out`` with ``tensors`` kept in its backward graph (zero
    gradient to them)."""
    return _Tie.apply(out, *tensors)


def all_to_all(tensors, group) -> tuple:
    """Differentiable all-to-all of ``(n, ...)`` tensors (one dtype):
    member ``i`` receives every member's slice ``i``, stacked in member
    order."""
    return _AllToAll.apply(group, *tensors)


# ----------------------------------------------------------------------
# tensor, fully-sharded and pipeline parallelism
# ----------------------------------------------------------------------
def _summed(t, group):
    """``t`` summed over ``group``, out of place."""
    return all_reduce(t.contiguous().clone(), group)


def _cat_f32(tensors):
    return torch.cat([t.float().reshape(-1) for t in tensors])


def _split_like(buf, likes):
    """``buf`` (float32) cut into tensors of ``likes``' shapes and
    dtypes."""
    out, at = [], 0
    for shape, dtype, _ in likes:
        n = int(np.prod(shape)) if len(shape) else 1
        out.append(buf[at:at + n].view(shape).to(dtype))
        at += n
    return out


class _CopyTo(torch.autograd.Function):
    """Megatron's ``f``: the tensors unchanged, their gradients summed
    over ``group`` in one all-reduce."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        ctx.likes = [(t.shape, t.dtype, t.device) for t in tensors]
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(shape, dtype=dtype, device=device)
                 if g is None else g
                 for g, (shape, dtype, device) in zip(grads, ctx.likes)]
        buf = _summed(_cat_f32(grads), ctx.group)
        return (None,) + tuple(_split_like(buf, ctx.likes))


class _ReduceFrom(torch.autograd.Function):
    """Megatron's ``g``: the sum over ``group`` (one all-reduce), the
    gradient passed through as it is (every member's is the same)."""

    @staticmethod
    def forward(ctx, group, t):
        return _summed(t, group)

    @staticmethod
    def backward(ctx, grad):
        return None, grad


class _GatherFrom(torch.autograd.Function):
    """Every member's block of ``dim``, concatenated in member order;
    the backward takes this member's block of the gradient, which is the
    same on every member (the gathered tensor feeds replicated work)."""

    @staticmethod
    def forward(ctx, group, dim, t):
        parts = all_gather(t, group)
        ctx.dim, ctx.index, ctx.width = dim, group_rank(group), t.shape[dim]
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.index * ctx.width
        return None, None, grad.narrow(ctx.dim, start,
                                       ctx.width).contiguous()


class _ScatterTo(torch.autograd.Function):
    """This member's block of ``dim`` of a replicated tensor; the
    backward gathers the members' blocks of the gradient."""

    @staticmethod
    def forward(ctx, group, dim, t):
        width = t.shape[dim] // tdist.get_world_size(group)
        ctx.group, ctx.dim = group, dim
        return t.narrow(dim, group_rank(group) * width, width).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return None, None, torch.cat(all_gather(grad, ctx.group),
                                     dim=ctx.dim)


class _ShardGather(torch.autograd.Function):
    """FSDP's gather: every member's shard of ``dim`` concatenated; the
    backward is the reduce-scatter, each member keeping the sum over the
    group of its own shard's gradient."""

    @staticmethod
    def forward(ctx, group, dim, t):
        ctx.group, ctx.dim = group, dim
        return torch.cat(all_gather(t, group), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return None, None, reduce_scatter(grad, ctx.group, ctx.dim)


def group_rank(group) -> int:
    """This process's index in ``group`` (its members in rank order)."""
    return tdist.get_rank(group)


def reduce_scatter(t, group, dim: int = 0):
    """This member's block of ``dim`` of ``t`` summed over ``group``.
    NCCL reduce-scatters; gloo, which has no reduce-scatter, sums the
    whole tensor (staged through the host like any all-reduce) and keeps
    the block."""
    n = tdist.get_world_size(group)
    width = t.shape[dim] // n
    me = group_rank(group)
    if _backend == "nccl":
        src = t.movedim(dim, 0).contiguous()
        out = torch.empty((width,) + tuple(src.shape[1:]), dtype=t.dtype,
                          device=t.device)
        with _collective():
            tdist.reduce_scatter_tensor(out, src, group=group)
        return out.movedim(0, dim).contiguous()
    return _summed(t, group).narrow(dim, me * width, width).contiguous()


def copy_to(tensors, group) -> tuple:
    """The tensors as they are, their gradients summed over ``group``
    (one message): the input of column-parallel work."""
    return _CopyTo.apply(group, *tensors)


def reduce_from(t, group):
    """``t`` summed over ``group``, the gradient passed through: the
    output of row-parallel work."""
    return _ReduceFrom.apply(group, t)


def gather_from(t, group, dim: int = -1):
    """The members' blocks of ``dim`` concatenated; the backward keeps
    this member's block."""
    return _GatherFrom.apply(group, dim % t.dim(), t)


def scatter_to(t, group, dim: int = -1):
    """This member's block of ``dim``; the backward gathers."""
    return _ScatterTo.apply(group, dim % t.dim(), t)


def shard_gather(t, group, dim: int):
    """FSDP's gather of a parameter shard, reduce-scattered backward."""
    return _ShardGather.apply(group, dim, t)


def pipeline_exchange(sends, recvs, group) -> list:
    """One step of point-to-point traffic: ``sends`` is ``[(tensor,
    global dst)]``, ``recvs`` ``[(like, global src)]``; returns the
    received tensors, in ``recvs``' order. NCCL posts them as one group;
    gloo posts the sends, then waits on each receive (a send never
    waits for its receive), staging CUDA tensors through the host."""
    if not sends and not recvs:
        return []
    outs, device = [], None
    if _backend == "nccl":
        ops = [tdist.P2POp(tdist.isend, t.contiguous(), dst, group)
               for t, dst in sends]
        for like, src in recvs:
            out = torch.empty_like(like)
            outs.append(out)
            ops.append(tdist.P2POp(tdist.irecv, out, src, group))
        with _collective():
            for w in tdist.batch_isend_irecv(ops):
                w.wait()
        return outs
    works, held = [], []
    with _collective():
        for t, dst in sends:
            host, _ = _to_host(t.contiguous())
            held.append(host)
            works.append(tdist.isend(host, dst, group=group))
        for like, src in recvs:
            device = like.device if _gloo_stages(like) else None
            out = torch.empty(like.shape, dtype=like.dtype)
            tdist.recv(out, src, group=group)
            outs.append(_back(out, device))
        for w in works:
            w.wait()
    return outs


# ----------------------------------------------------------------------
# worker liveness
# ----------------------------------------------------------------------
def _heartbeat_address(coordinator_address: str):
    host, _, port = coordinator_address.rpartition(":")
    hb_port = int(os.environ.get("LO_HEARTBEAT_PORT", int(port) + 1))
    return host or "127.0.0.1", hb_port


class HeartbeatMonitor:
    """Coordinator-side liveness: workers datagram their rank every
    ``HEARTBEAT_INTERVAL``; one silent for ``timeout`` is reported lost.
    Loss is not sticky: resumed heartbeats clear it (a pause must not
    wedge a healthy pod)."""

    def __init__(self, address, expected: List[int],
                 timeout: float = HEARTBEAT_TIMEOUT):
        self._timeout = timeout
        now = time.monotonic()
        self._last_seen = {int(h): now for h in expected}
        self._lock = locks.make_lock("distributed.state")
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind(address)
        self._sock.settimeout(0.5)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._recv_loop,
                                        daemon=True,
                                        name="lo-heartbeat-monitor")
        self._thread.start()

    def _recv_loop(self) -> None:
        while not self._stop.is_set():
            try:
                data, _addr = self._sock.recvfrom(512)
            except socket.timeout:
                continue
            except OSError:
                if self._stop.is_set():
                    return
                continue
            try:
                host_id = int(json.loads(data.decode("utf-8"))["hostId"])
            except Exception:  # noqa: BLE001 — unauthenticated socket:
                continue  # junk must not kill the loop
            with self._lock:
                if host_id in self._last_seen:
                    self._last_seen[host_id] = time.monotonic()

    def lost_workers(self) -> List[int]:
        now = time.monotonic()
        with self._lock:
            return sorted(h for h, seen in self._last_seen.items()
                          if now - seen > self._timeout)

    @property
    def timeout(self) -> float:
        return self._timeout

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass


def _start_heartbeats(coordinator_address: str, me: int,
                      world: int) -> None:
    """Rank 0: the monitor. The others: a sender thread."""
    global _monitor, _sender_stop
    address = _heartbeat_address(coordinator_address)
    if me == 0:
        if _monitor is None:
            try:
                _monitor = HeartbeatMonitor(
                    address, expected=list(range(1, world)))
            except OSError as exc:  # port taken: degrade loudly
                print(f"heartbeat monitor disabled: {exc}", flush=True)
        return
    if _sender_stop is not None:
        return
    _sender_stop = threading.Event()
    payload = json.dumps({"hostId": me}).encode("utf-8")

    def send_loop(stop: threading.Event) -> None:
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        while not stop.is_set():
            try:
                sock.sendto(payload, address)
            except OSError:
                pass
            stop.wait(HEARTBEAT_INTERVAL)
        sock.close()

    threading.Thread(target=send_loop, args=(_sender_stop,),
                     daemon=True, name="lo-heartbeat-sender").start()


def pod_failure() -> Optional[str]:
    """A description of a lost worker, or None while the pod is whole
    (clears when its heartbeats resume)."""
    if _monitor is None:
        return None
    lost = _monitor.lost_workers()
    if not lost:
        return None
    return (f"worker host(s) {lost} stopped heartbeating "
            f"(> {_monitor.timeout:.1f}s silent); in-flight sharded "
            f"collectives cannot complete and new card jobs are refused "
            f"until heartbeats resume or the pod re-forms")


def shutdown() -> None:
    global _initialized, _monitor, _sender_stop, _bridge_group, _backend
    if _monitor is not None:
        _monitor.close()
        _monitor = None
    if _sender_stop is not None:
        _sender_stop.set()
        _sender_stop = None
    if not _initialized:
        return
    tdist.destroy_process_group()
    _groups.clear()
    _bridge_group = None
    _backend = None
    _initialized = False


def host_info(device: Optional[str] = None) -> Dict[str, Any]:
    """Topology for /health: one rank is one card, so the process count
    is the card count of the pod."""
    world = world_size()
    platform = _platform or (str(device).split(":")[0]
                             if device is not None else None)
    return {"processIndex": rank(), "processCount": world,
            "localDevices": 1, "globalDevices": world,
            "platform": platform, "backend": _backend,
            "stagedBytes": staged_bytes()}


# ----------------------------------------------------------------------
# coordinator -> workers control channel
# ----------------------------------------------------------------------
class HostBridge:
    """JSON messages from rank 0 to every other rank over the group:
    a length broadcast, then the payload's. Rank 0 ``publish``es;
    the others ``follow`` until ``{"op": "shutdown"}``. Every publish
    must meet every worker inside ``follow``, as any collective."""

    def publish(self, message: Dict[str, Any]) -> None:
        with _publish_lock:
            self._exchange(message)

    def _exchange(self, message: Optional[Dict[str, Any]]
                  ) -> Dict[str, Any]:
        payload = b"" if message is None else \
            json.dumps(message).encode("utf-8")
        length = torch.tensor([len(payload)], dtype=torch.int64)
        with _collective():
            tdist.broadcast(length, src=0, group=_bridge_group)
            n = int(length[0])
            buf = torch.zeros((n,), dtype=torch.uint8)
            if message is not None:
                buf[:] = torch.from_numpy(np.frombuffer(payload, np.uint8))
            tdist.broadcast(buf, src=0, group=_bridge_group)
        return json.loads(buf.numpy().tobytes().decode("utf-8"))

    def recv(self) -> Dict[str, Any]:
        return self._exchange(None)

    def follow(self, handler) -> None:
        """Worker loop: ``{"op": "run", "target": "pkg.mod:fn",
        "kwargs": {...}}`` calls the target (the job manager's replay),
        any other op goes to ``handler``, until ``shutdown``."""
        while True:
            msg = self.recv()
            op = msg.get("op")
            if op == "shutdown":
                return
            if op == "ping":
                continue
            # a failing replay must not kill the worker: the coordinator
            # records the (same) failure, and a dead worker would fail
            # every later collective of the pod
            try:
                if op == "run":
                    _run_target(msg["target"], msg.get("kwargs") or {})
                else:
                    handler(msg)
            except Exception:  # noqa: BLE001
                traceback.print_exc()


def _run_target(target: str, kwargs: Dict[str, Any]) -> Any:
    import importlib

    module_path, _, fn_name = target.partition(":")
    module = importlib.import_module(module_path)
    return getattr(module, fn_name)(**kwargs)
