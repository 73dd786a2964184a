"""Device meshes as ``torch.distributed`` process groups: the counterpart
of ``bibfs_tpu/parallel/mesh.py`` (its 1D and 2D meshes; the multi-host
job of the reference's pod comes later).

The JAX package runs one SPMD program under ``shard_map`` from a single
controller. Here a mesh is a process group with one rank per device, each
rank a process that runs the same code on its own ``torch.device``, and
:func:`launch` is the single controller: it spawns the ranks on one host,
runs a function on each and returns rank 0's value.

The placement decides the transport, explicitly, and :attr:`Mesh.transport`
names it for results and logs:

- ranks on distinct cards (``torch.cuda.device_count() >= ranks``):
  ``nccl``, collectives on the cards;
- ranks on the CPU: ``gloo``;
- ranks that share one card: ``gloo-staged``, gloo with each collective's
  operand copied through a pinned host buffer (NCCL refuses two ranks on
  one card, and gloo's collectives take host tensors).

A failed NCCL start raises; nothing swaps it for gloo. The process group
and the launcher both have a timeout, and a rank that raises or dies makes
the launcher terminate the others and raise, so no call hangs on a lost
rank.

:func:`make_2d_mesh` is a rank's view of an ``R x C`` grid over the same
ranks (rank ``r C + c`` at row ``r``, column ``c``): besides the world it
holds two sub-groups, the row axis (the ``R`` ranks of its column, the
reference's ``r`` axis) and the column axis (the ``C`` ranks of its row,
the ``c`` axis). Every rank creates every sub-group, in the same order.
:func:`launch` runs one call on ranks that end with it; a
:class:`~bibfs_tpu_torch.parallel.pool.MeshPool` keeps its ranks up across
calls. Both join the group through :func:`_join`.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0

_REDUCE_OPS = {
    "sum": dist.ReduceOp.SUM,
    "max": dist.ReduceOp.MAX,
    "min": dist.ReduceOp.MIN,
}


class Mesh:
    """This rank's view of a 1D mesh: its index (``rank``), the mesh size,
    its device, and the transport of its collectives (module docstring).
    ``all_gather`` and ``all_reduce`` are the two collectives every
    helper of :mod:`bibfs_tpu_torch.parallel.collectives` is made of."""

    def __init__(self, rank: int, size: int, device, backend: str,
                 staged: bool = False, group=None, ranks=None):
        self.rank = int(rank)
        self.size = int(size)
        self.device = torch.device(device)
        self.backend = backend
        self.staged = bool(staged)
        # a sub-group (None: the world) and the world ranks of its members
        # in group order; each group keeps its own pinned buffers
        self.group = group
        self.ranks = list(range(self.size)) if ranks is None else list(ranks)
        self._pinned: dict = {}

    @property
    def transport(self) -> str:
        return f"{self.backend}-staged" if self.staged else self.backend

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Mesh(rank {self.rank}/{self.size}, {self.device}, "
                f"{self.transport})")

    def _host(self, key: str, shape, dtype) -> torch.Tensor:
        """A pinned host buffer of this shape and type, kept for reuse."""
        k = (key, tuple(shape), dtype)
        buf = self._pinned.get(k)
        if buf is None:
            buf = self._pinned[k] = torch.empty(shape, dtype=dtype,
                                                pin_memory=True)
        return buf

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked in rank order: ``[size, *x.shape]``,
        on this rank's device."""
        x = x.contiguous()
        if self.size == 1:
            return x[None].clone()
        if not self.staged:
            out = torch.empty((self.size * x.numel(),), dtype=x.dtype,
                              device=x.device)
            dist.all_gather_into_tensor(out, x.view(-1), group=self.group)
            return out.view(self.size, *x.shape)
        src = self._host("in", (x.numel(),), x.dtype)
        src.copy_(x.view(-1))  # waits for the stream that made x
        out = self._host("out", (self.size * x.numel(),), x.dtype)
        dist.all_gather_into_tensor(out, src, group=self.group)
        return out.to(x.device, non_blocking=True).view(self.size, *x.shape)

    def all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        """``x`` reduced over the ranks by ``op`` (``sum``, ``max`` or
        ``min``), as a new tensor on this rank's device."""
        out = x.clone().contiguous()
        if self.size == 1:
            return out
        if not self.staged:
            dist.all_reduce(out, op=_REDUCE_OPS[op], group=self.group)
            return out
        buf = self._host("red", tuple(out.shape), out.dtype)
        buf.copy_(out)
        dist.all_reduce(buf, op=_REDUCE_OPS[op], group=self.group)
        return buf.to(x.device, non_blocking=True)

    def permute(self, x: torch.Tensor, perm) -> torch.Tensor:
        """The reference's ``ppermute`` over this group: ``perm`` holds
        ``(source, target)`` group ranks, each rank at most once on each
        side; this rank sends ``x`` to its target and returns what its
        source sent (zeros where no rank sends to it). Point-to-point
        sends through :func:`torch.distributed.batch_isend_irecv`, so each
        rank ships exactly its ``x`` once (a rank mapped to itself
        copies)."""
        x = x.contiguous()
        dst = next((t for s, t in perm if s == self.rank), None)
        src = next((s for s, t in perm if t == self.rank), None)
        if src is None and dst is None:
            return torch.zeros_like(x)
        if src == self.rank and dst == self.rank:
            return x.clone()
        if self.staged:
            send = self._host("p2p_in", tuple(x.shape), x.dtype)
            send.copy_(x)
            recv = self._host("p2p_out", tuple(x.shape), x.dtype)
        else:
            send, recv = x, torch.empty_like(x)
        ops = []
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, send, self.ranks[dst],
                                  group=self.group))
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, recv, self.ranks[src],
                                  group=self.group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if src is None:
            return torch.zeros_like(x)
        return recv.to(x.device, non_blocking=True) if self.staged else recv

    def barrier(self) -> None:
        """Return once every rank has reached this point and this rank's
        device has finished its work (one small all-reduce, read on the
        host)."""
        self.all_reduce(torch.zeros(1, dtype=torch.int32, device=self.device),
                        "sum").item()

    def all_gather_object(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order (set-up and
        results only: it pickles through the host)."""
        out = [None] * self.size
        if self.size == 1:
            return [obj]
        dist.all_gather_object(out, obj, group=self.group)
        return out


class Mesh2D:
    """This rank's view of an ``R x C`` grid (module docstring): its world
    :class:`Mesh` (``rank = row * C + col``), and the two axes as
    sub-group meshes, ``row_axis`` (the ranks of its column, indexed by
    row: the reference's ``r`` axis, which the frontier is gathered over)
    and ``col_axis`` (the ranks of its row, indexed by column: the ``c``
    axis, which parent candidates are max-reduced over). Whole-grid
    collectives go through the world mesh."""

    def __init__(self, world: Mesh, rows: int, cols: int, row_axis: Mesh,
                 col_axis: Mesh):
        self.world = world
        self.R = int(rows)
        self.C = int(cols)
        self.row_axis = row_axis
        self.col_axis = col_axis

    rank = property(lambda self: self.world.rank)
    size = property(lambda self: self.world.size)
    device = property(lambda self: self.world.device)
    staged = property(lambda self: self.world.staged)
    transport = property(lambda self: self.world.transport)
    row = property(lambda self: self.world.rank // self.C)
    col = property(lambda self: self.world.rank % self.C)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Mesh2D({self.R}x{self.C}, rank {self.rank} at "
                f"({self.row}, {self.col}), {self.device}, {self.transport})")

    def all_gather(self, x):
        return self.world.all_gather(x)

    def all_reduce(self, x, op: str):
        return self.world.all_reduce(x, op)

    def barrier(self) -> None:
        self.world.barrier()


class DistributedContext:
    """What :func:`init_distributed` joined: this process's index, the job
    size, the devices it sees and the rendezvous address, as the
    reference's; plus the rank's device and transport."""

    __slots__ = ("process_index", "process_count", "local_device_count",
                 "global_device_count", "coordinator_address", "device",
                 "backend", "staged")

    def __init__(self, process_index, process_count, local_device_count,
                 global_device_count, coordinator_address, device=None,
                 backend="gloo", staged=False):
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.local_device_count = int(local_device_count)
        self.global_device_count = int(global_device_count)
        self.coordinator_address = coordinator_address
        self.device = torch.device(device if device is not None else "cpu")
        self.backend = backend
        self.staged = bool(staged)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"DistributedContext(process {self.process_index}/"
                f"{self.process_count}, {self.device}, {self.backend})")


_JOINED: DistributedContext | None = None
_GRIDS: dict = {}  # (rows, cols) -> this rank's Mesh2D, its groups made once


def placement(num_ranks: int, device="cuda") -> tuple[list, str, bool]:
    """``(devices, backend, staged)`` for ``num_ranks`` ranks on one host:
    one card each over NCCL when there are enough cards, else all on card
    0 over staged gloo; on the CPU, gloo. Raises without a card for
    ``cuda``."""
    if num_ranks < 1:
        raise ValueError(f"a mesh needs at least one rank, got {num_ranks}")
    kind = torch.device(device).type
    if kind == "cpu":
        return ["cpu"] * num_ranks, "gloo", False
    if kind != "cuda":
        raise ValueError(f"unsupported mesh device {device!r}")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("a CUDA mesh needs a CUDA card (pass device='cpu' "
                           "for gloo ranks on the host)")
    if count >= num_ranks:
        return [f"cuda:{r}" for r in range(num_ranks)], "nccl", False
    return ["cuda:0"] * num_ranks, "gloo", True


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *, device=None,
                     backend: str | None = None, staged: bool = False,
                     timeout_s: float = DEFAULT_TIMEOUT_S
                     ) -> DistributedContext:
    """Join a process group and report what was joined. The rendezvous is
    explicit (``tcp://host:port`` or ``file://path``, with the job size and
    this process's index): a bare call raises :class:`ValueError`, as the
    reference's does, instead of waiting for peers that never come.
    ``device`` is this rank's device (a card is made current), ``backend``
    defaults to ``nccl`` on a card and ``gloo`` on the CPU; ``staged``
    marks ranks sharing one card (gloo through pinned host buffers). The
    group's collectives time out after ``timeout_s``. NCCL is started
    here, by one small collective, so a transport that cannot start
    raises now."""
    global _JOINED
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "init_distributed needs a coordinator_address (tcp:// or "
            "file://), num_processes and process_id; on one host, "
            "launch() starts the ranks and joins them"
        )
    dev = torch.device(device if device is not None else "cpu")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" and not staged else "gloo"
    if backend == "nccl" and (dev.type != "cuda" or staged):
        raise ValueError("nccl needs one card per rank")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(
        backend, init_method=coordinator_address,
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs,
    )
    ctx = DistributedContext(
        process_index=dist.get_rank(), process_count=dist.get_world_size(),
        local_device_count=torch.cuda.device_count() if dev.type == "cuda" else 1,
        global_device_count=dist.get_world_size(),
        coordinator_address=coordinator_address, device=dev,
        backend=backend, staged=staged,
    )
    _JOINED = ctx
    mesh = make_1d_mesh()
    # one collective now: a transport that cannot start fails the join
    mesh.all_reduce(torch.ones(1, dtype=torch.int32, device=dev), "sum")
    return ctx


def make_1d_mesh(num_devices: int | None = None) -> Mesh:
    """This rank's 1D mesh over every rank of the joined process group
    (:func:`init_distributed`); ``num_devices``, when given, must be the
    group's size. Vertex arrays are 1D-sharded over it, rank ``r`` owning
    rows ``[r * n_loc, (r + 1) * n_loc)``."""
    if _JOINED is None:
        raise RuntimeError("no process group: call init_distributed (or run "
                           "under launch()) first")
    size = _JOINED.process_count
    if num_devices is not None and num_devices != size:
        raise ValueError(f"requested {num_devices} devices, have {size}")
    return Mesh(_JOINED.process_index, size, _JOINED.device, _JOINED.backend,
                _JOINED.staged)


def make_2d_mesh(rows: int, cols: int) -> Mesh2D:
    """This rank's view of a ``rows x cols`` grid over every rank of the
    joined process group (``rows * cols`` must be its size): the world,
    and the row-axis and column-axis sub-groups (:class:`Mesh2D`). Every
    rank must call it with the same shape: each call on a new shape
    creates all ``cols + rows`` sub-groups, the row-axis groups (one per
    column) first, in the same order on every rank; a shape is made once
    per process group."""
    if _JOINED is None:
        raise RuntimeError("no process group: call init_distributed (or run "
                           "under launch()) first")
    rows, cols = int(rows), int(cols)
    size = _JOINED.process_count
    if rows < 1 or cols < 1 or rows * cols != size:
        raise ValueError(f"requested {rows}x{cols} mesh, have {size} devices")
    if (rows, cols) in _GRIDS:
        return _GRIDS[rows, cols]
    world = make_1d_mesh()
    me = world.rank
    r, c = divmod(me, cols)
    axes = {}
    for col in range(cols):  # the row axis of each column
        members = [row * cols + col for row in range(rows)]
        grp = dist.new_group(members)
        if col == c:
            axes["row"] = Mesh(r, rows, world.device, world.backend,
                               world.staged, group=grp, ranks=members)
    for row in range(rows):  # the column axis of each row
        members = [row * cols + col for col in range(cols)]
        grp = dist.new_group(members)
        if row == r:
            axes["col"] = Mesh(c, cols, world.device, world.backend,
                               world.staged, group=grp, ranks=members)
    grid = _GRIDS[rows, cols] = Mesh2D(world, rows, cols, axes["row"],
                                       axes["col"])
    return grid


def rank_info(mesh) -> list:
    """Every rank's placement (a rank body for :func:`launch`): its
    index, device, transport, whether its card reaches each other rank's
    card directly (``torch.cuda.can_device_access_peer``; ``None`` off the
    card or on a shared card) and the top-level modules it has loaded."""
    import sys

    peers = None
    if mesh.device.type == "cuda" and not mesh.staged:
        mine = mesh.device.index
        peers = [torch.cuda.can_device_access_peer(mine, r)
                 for r in range(mesh.size) if r != mine]
    info = {"rank": mesh.rank, "device": str(mesh.device),
            "transport": mesh.transport, "peer_access": peers,
            "modules": sorted({m.split(".")[0] for m in sys.modules})}
    return mesh.all_gather_object(info)


def _join(rank: int, size: int, tmp: str, devices: list, backend: str,
          staged: bool, timeout_s: float) -> Mesh:
    """A spawned rank's set-up, for :func:`launch` and the rank pool: one
    intra-op thread (the ranks share the host's cores), join the group
    through the rendezvous file in ``tmp``, and return the 1D mesh."""
    torch.set_num_threads(1)
    init_distributed(f"file://{os.path.join(tmp, 'rendezvous')}", size, rank,
                     device=devices[rank], backend=backend, staged=staged,
                     timeout_s=timeout_s)
    return make_1d_mesh()


def _leave() -> None:
    """Leave the process group (and forget its grids)."""
    global _JOINED
    _GRIDS.clear()
    _JOINED = None
    dist.destroy_process_group()


def _rank_main(rank: int, size: int, tmp: str, devices: list, backend: str,
               staged: bool, timeout_s: float, fn, args) -> None:
    """One spawned rank of :func:`launch`: join (:func:`_join`), run
    ``fn(mesh, *args)``, and rank 0 writes the value for the launcher."""
    mesh = _join(rank, size, tmp, devices, backend, staged, timeout_s)
    try:
        out = fn(mesh, *args)
        if rank == 0:
            with open(os.path.join(tmp, "result.pkl.tmp"), "wb") as f:
                pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(os.path.join(tmp, "result.pkl.tmp"),
                       os.path.join(tmp, "result.pkl"))
        dist.barrier()
    finally:
        _leave()


def launch(fn, num_ranks: int, *args, device="cuda",
           timeout_s: float = DEFAULT_TIMEOUT_S):
    """Run ``fn(mesh, *args)`` on ``num_ranks`` ranks spawned on this host
    (:func:`placement` for ``device``) and return rank 0's value. ``fn``
    and ``args`` are pickled to each rank, so ``fn`` must be importable
    from a module of this package. A rank that raises, dies or outlasts
    ``timeout_s`` fails the call: the others are terminated and the
    launcher raises. The rendezvous is a file in a private temporary
    directory, so concurrent launches never share one."""
    import torch.multiprocessing as mp

    devices, backend, staged = placement(num_ranks, device)
    with tempfile.TemporaryDirectory(prefix="bibfs-mesh-") as tmp:
        ctx = mp.start_processes(
            _rank_main, nprocs=num_ranks, join=False, start_method="spawn",
            args=(num_ranks, tmp, devices, backend, staged, timeout_s, fn,
                  args),
        )
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"mesh launch of {num_ranks} ranks "
                                   f"outlasted {timeout_s:.0f} s")
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)
