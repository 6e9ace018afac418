"""Data parallelism over ``torch.distributed`` (counterpart of
``tpudet/runtime/mesh.py``).

tpudet shards the batch over a ``('data',)`` device mesh, or ``('dcn',
'data')`` across hosts, and XLA inserts the collectives of one global-batch
program. Here one process is one rank, and a tpudet device is a rank:

  * ``data_parallel_size`` is the world size;
  * a tpudet process (host) is a node: ``process_count`` is the number of
    nodes, ``world // LOCAL_WORLD_SIZE`` under ``torchrun``, else 1;
  * ``dcn_size`` defaults to the node count and must divide the world size;
    the mesh is ``('dcn', 'data')`` with the ranks in node-major order, as
    ``torchrun`` numbers them.

The program stays tpudet's global-batch one. Each rank holds rows ``[r *
per, (r + 1) * per)`` of the device batch; BatchNorm statistics and every
loss denominator are sums over all ranks (:func:`all_reduce_sum`, whose
backward sums the gradient over the ranks, as ``psum``'s transpose does);
each rank's loss is its share of the global loss, and the parameters'
gradients are summed over the ranks in one flat buffer. The layers read the
mesh of the step in flight from :func:`over`.

Without an initialised process group everything is world size 1 and no
collective runs. Every process group is made with a 60 s timeout, so a rank
that is gone ends the others instead of hanging them.
"""

from __future__ import annotations

import contextlib
import contextvars
import multiprocessing.connection
import os
import sys
import time
from dataclasses import dataclass
from datetime import timedelta
from pathlib import Path
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tpudet_torch import device as device_lib

DATA_AXIS = "data"
DCN_AXIS = "dcn"
TIMEOUT = timedelta(seconds=60)

_nodes = 1  # set by initialize()
_device = torch.device("cpu")  # this rank's device, set by initialize()
_active = contextvars.ContextVar("mesh", default=None)  # the step's mesh (see over())


@dataclass(frozen=True)
class Mesh:
    """A data-parallel layout: ``world`` ranks on ``nodes`` nodes, this
    process being ``rank``, split ``dcn`` ways across nodes. ``group`` is the
    process group its collectives run on; None means none run, which is
    right only at world size 1 (a mesh of more ranks without a group is a
    layout, e.g. to draw one rank's index stream)."""

    world: int = 1
    rank: int = 0
    nodes: int = 1
    dcn: int = 1
    group: Any = None

    def __post_init__(self):
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} is outside a world of {self.world}")
        if self.world % self.nodes:
            raise ValueError(f"{self.world} ranks do not divide over {self.nodes} nodes")
        if self.world % self.dcn:
            raise ValueError(
                f"{self.world} devices do not divide into dcn_size={self.dcn} groups")

    @property
    def axis_names(self) -> tuple:
        return (DCN_AXIS, DATA_AXIS) if self.dcn > 1 else (DATA_AXIS,)

    @property
    def shape(self) -> dict:
        if self.dcn > 1:
            return {DCN_AXIS: self.dcn, DATA_AXIS: self.world // self.dcn}
        return {DATA_AXIS: self.world}

    @property
    def ranks_per_node(self) -> int:
        return self.world // self.nodes

    @property
    def local_rank(self) -> int:
        """This rank's place among its node's ranks."""
        return self.rank % self.ranks_per_node


def initialize(backend: Optional[str] = None, *, init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               device: str | torch.device | None = None, nodes: Optional[int] = None,
               timeout: timedelta = TIMEOUT) -> torch.device:
    """Join the process group (the counterpart of ``jax.distributed.initialize``)
    and return this rank's device, which is made the current CUDA device.

    Defaults come from ``torchrun``'s environment: ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``). ``device`` defaults to ``cuda:LOCAL_RANK``; ``backend``
    is ``"nccl"`` for a CUDA device and ``"gloo"`` for the CPU unless given
    (gloo also reduces CUDA tensors, through the host). ``nodes`` defaults to
    ``world_size // LOCAL_WORLD_SIZE``, or 1."""
    global _nodes, _device
    env = os.environ
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
    rank = int(env.get("RANK", 0)) if rank is None else rank
    local_rank = int(env.get("LOCAL_RANK", rank))
    dev = device_lib.resolve(f"cuda:{local_rank}" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if nodes is None:
        nodes = world_size // int(env.get("LOCAL_WORLD_SIZE", world_size))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, timeout=timeout)
    _nodes, _device = nodes, dev
    return dev


def local_device() -> torch.device:
    """This rank's device (``initialize``'s); the CPU before it."""
    return _device


def shutdown():
    """Leave the process group (if any)."""
    global _nodes, _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _nodes, _device = 1, torch.device("cpu")


def data_mesh(num_devices: Optional[int] = None, dcn_size: Optional[int] = None) -> Mesh:
    """The mesh of every rank of the process group: 1-D ``('data',)``, or
    ``('dcn', 'data')`` when ``dcn_size > 1`` (default: the node count).
    Without a group it is one rank. ``num_devices`` must be the world size
    (a rank cannot leave the group's collectives)."""
    if dist.is_initialized():
        world, rank, nodes, group = (dist.get_world_size(), dist.get_rank(), _nodes,
                                     dist.group.WORLD)
    else:
        world, rank, nodes, group = 1, 0, 1, None
    if num_devices is not None and num_devices != world:
        raise ValueError(f"the mesh spans all {world} ranks of the process group; "
                         f"num_devices={num_devices}")
    if dcn_size is None:
        dcn_size = nodes if nodes > 1 else 1
    return Mesh(world, rank, nodes, max(dcn_size, 1), group)


def batch_axes(mesh: Mesh) -> tuple:
    """Mesh axes the batch dimension is sharded over (dcn outermost)."""
    return mesh.axis_names


def data_parallel_size(mesh: Mesh) -> int:
    """Total way-ness of batch sharding: the world size."""
    return mesh.world


def device_batch(mesh: Mesh, batch_size: int) -> int:
    """tpudet's device batch: ``batch_size`` padded up to a multiple of the
    world size."""
    return -(-batch_size // mesh.world) * mesh.world


def sample_weight(mesh: Mesh, batch_size: int) -> Optional[np.ndarray]:
    """tpudet's float32 ``[device_batch]`` mask of real rows, or None when the
    batch needs no padding. Each node pads its own share of the batch, so
    rows ``[p*local_db, p*local_db + local_bs)`` are real for every node p."""
    db = device_batch(mesh, batch_size)
    if db == batch_size:
        return None
    local_db, local_bs = db // mesh.nodes, batch_size // mesh.nodes
    return np.tile(np.arange(local_db) < local_bs, mesh.nodes).astype(np.float32)


def rank_rows(mesh: Mesh, rows: int) -> slice:
    """This rank's block of a batch of ``rows`` over the whole mesh."""
    per = rows // mesh.world
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(mesh: Mesh, *arrays):
    """This rank's rows of its node's batch (numpy arrays or tensors, batch
    first): with ``per`` rows a rank, rows ``[l*per, (l+1)*per)`` for the
    rank's place ``l`` on its node. On one node that is the rank's block of
    the device batch."""
    out = []
    for a in arrays:
        per = a.shape[0] // mesh.ranks_per_node
        out.append(a[mesh.local_rank * per:(mesh.local_rank + 1) * per])
    return tuple(out) if len(out) > 1 else out[0]


# ------------------------------------------------------------------ collectives
def _group(mesh: Optional[Mesh]):
    """The group to reduce over, or None for the identity."""
    if mesh is None or mesh.group is None:
        if mesh is not None and mesh.world > 1:
            raise RuntimeError(f"a mesh of {mesh.world} ranks without a process group "
                               "runs no collective")
        return None
    return mesh.group


class _AllReduceSum(torch.autograd.Function):
    """``y = Σ_ranks x``; the backward sums the cotangent over the ranks (the
    transpose of ``psum``): each rank's objective is its share of the
    global one, so the gradient of a global sum is every rank's cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``x`` summed over the ranks of ``mesh`` (default: the active one),
    with a gradient; ``x`` itself where no group runs."""
    group = _group(_active.get() if mesh is None else mesh)
    return x if group is None else _AllReduceSum.apply(x, group)


def all_reduce_(mesh: Mesh, flat: torch.Tensor) -> torch.Tensor:
    """Sum ``flat`` over the ranks in place, without a gradient."""
    group = _group(mesh)
    if group is not None:
        dist.all_reduce(flat, group=group)
    return flat


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def _unflat(flat: torch.Tensor, like: Sequence[torch.Tensor]):
    parts = torch.split(flat, [t.numel() for t in like])
    return [p.view(t.shape).to(t.dtype) for p, t in zip(parts, like)]


def reduce_flat(mesh: Mesh, tensors: Sequence[torch.Tensor]):
    """``tensors`` summed over the ranks in one flat float32 buffer; the
    tensors themselves where no group runs."""
    if _group(mesh) is None:
        return list(tensors)
    return _unflat(all_reduce_(mesh, _flat(tensors)), tensors)


def replicate_tree(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> None:
    """Copy rank 0's values into ``tensors`` on every rank (one broadcast of a
    flat buffer)."""
    group = _group(mesh)
    if group is None or not tensors:
        return
    flat = _flat(tensors)
    dist.broadcast(flat, 0, group=group)
    with torch.no_grad():
        for t, v in zip(tensors, _unflat(flat, tensors)):
            t.copy_(v)


def check_replicated(mesh: Mesh, tensors: Sequence[torch.Tensor], what: str) -> None:
    """Raise unless ``tensors`` hold rank 0's values bit for bit on every rank
    (a seeded init and a shared checkpoint give every rank the same)."""
    if not tensors:
        return
    group = _group(mesh)
    if group is None:
        return
    mine = _flat(tensors)
    ref = mine.clone()
    dist.broadcast(ref, 0, group=group)
    differ = torch.tensor([0.0 if torch.equal(mine, ref) else 1.0], device=mine.device)
    dist.all_reduce(differ, group=group)
    if differ.item():
        raise RuntimeError(f"{what} differ between the ranks ({int(differ.item())} of "
                           f"{mesh.world} ranks differ from rank 0)")


def barrier(mesh: Mesh, device: torch.device) -> None:
    """Wait for every rank (a one-element all-reduce on ``device``)."""
    if _group(mesh) is not None:
        all_reduce_(mesh, torch.zeros(1, device=device))


@contextlib.contextmanager
def over(mesh: Optional[Mesh]):
    """Make ``mesh`` the active mesh: BatchNorm in train mode and the loss
    denominators then reduce over its ranks."""
    token = _active.set(mesh)
    try:
        yield mesh
    finally:
        _active.reset(token)


def reduces() -> bool:
    """Whether the active mesh sums over ranks (a process group runs)."""
    return _group(_active.get()) is not None


def active_world() -> int:
    """The active mesh's world size (1 with none)."""
    mesh = _active.get()
    return 1 if mesh is None else mesh.world


# ------------------------------------------------------------------ launching
def _child(fn, rank, world, nodes, store, backend, device, threads, out, args):
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # one host: the loopback
    if threads is not None:
        torch.set_num_threads(threads)
    initialize(backend, init_method=f"file://{store}", world_size=world, rank=rank,
               device=device, nodes=nodes)
    try:
        result = fn(rank, *args)
    finally:
        shutdown()
    torch.save(result, out)
    # The result is saved: leave without the interpreter's teardown, where a
    # finished rank has aborted (exit -6, "terminate called without an active
    # exception") after its work was done.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def _raise_if_failed(procs) -> None:
    """Raise ``launch``'s one ``RuntimeError`` if any rank has exited with an
    error."""
    codes = [p.exitcode for p in procs]
    failed = [r for r, code in enumerate(codes) if code not in (None, 0)]
    if failed:
        raise RuntimeError(f"rank(s) {failed} of {len(procs)} failed: exit codes {codes}")


def launch(fn: Callable, world: int, workdir: str | Path, *args, backend: str,
           devices: Sequence[str], timeout: float = 600.0, threads: Optional[int] = None,
           nodes: int = 1) -> list:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes of one host, each
    rank joined to a group of ``backend`` through a ``FileStore`` in
    ``workdir`` and on ``devices[rank]``; return each rank's return value (saved
    with ``torch.save``, so keep it on the CPU). ``nodes`` > 1 lays the ranks
    out as that many nodes (a multi-node layout tried on one host);
    ``threads`` sets each rank's CPU threads (default: the host's cores
    shared out among CPU ranks).

    Raises ``RuntimeError`` once a rank has exited with an error, the ranks
    still running killed: ``rank(s) [r, ...] of W failed: exit codes [c,
    ...]``, naming every rank whose exit code is neither 0 nor None (still
    running when the parent looked) and every rank's exit code. The parent
    may see a failed rank while another still runs, or only after every rank
    has ended (a loaded host wakes it late); the message has this one form
    either way, and names the ranks that had failed by then. Raises
    ``TimeoutError`` when the ranks have not all ended after ``timeout``
    seconds. ``fn`` must be importable by name (a module-level function of a
    module that the child can import). A rank leaves without the
    interpreter's teardown once its result is saved."""
    if threads is None and all(torch.device(d).type == "cpu" for d in devices):
        threads = max(1, (os.cpu_count() or 1) // world)
    import torch.multiprocessing as mp

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    store = workdir / f"store-{os.getpid()}-{time.monotonic_ns()}"
    outs = [workdir / f"{store.name}-rank{r}.pt" for r in range(world)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(fn, r, world, nodes, str(store), backend,
                                              devices[r], threads, str(outs[r]), args),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            _raise_if_failed(procs)
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world} ranks did not end within {timeout} s")
            multiprocessing.connection.wait([p.sentinel for p in procs if p.is_alive()],
                                            min(left, 1.0))
        _raise_if_failed(procs)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    results = [torch.load(o, weights_only=False) for o in outs]
    for path in [store, *outs]:
        path.unlink(missing_ok=True)
    return results
