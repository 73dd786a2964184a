"""1D device meshes as ``torch.distributed`` process groups: the
counterpart of ``bibfs_tpu/parallel/mesh.py`` (its 1D half).

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
                 staged: bool = False):
        self.rank = int(rank)
        self.size = int(size)
        self.device = torch.device(device)
        self.backend = backend
        self.staged = bool(staged)
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
            dist.all_gather_into_tensor(out, x.view(-1))
            return out.view(self.size, *x.shape)
        src = self._host("in", (x.numel(),), x.dtype)
        src.copy_(x.view(-1))  # waits for the stream that made x
        out = self._host("out", (self.size * x.numel(),), x.dtype)
        dist.all_gather_into_tensor(out, src)
        return out.to(x.device, non_blocking=True).view(self.size, *x.shape)

    def all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        """``x`` reduced over the ranks by ``op`` (``sum``, ``max`` or
        ``min``), as a new tensor on this rank's device."""
        out = x.clone().contiguous()
        if self.size == 1:
            return out
        if not self.staged:
            dist.all_reduce(out, op=_REDUCE_OPS[op])
            return out
        buf = self._host("red", tuple(out.shape), out.dtype)
        buf.copy_(out)
        dist.all_reduce(buf, op=_REDUCE_OPS[op])
        return buf.to(x.device, non_blocking=True)

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
        dist.all_gather_object(out, obj)
        return out


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


def _rank_main(rank: int, size: int, tmp: str, devices: list, backend: str,
               staged: bool, timeout_s: float, fn, args) -> None:
    """One spawned rank: one intra-op thread (the ranks share the host's
    cores), join the group through the rendezvous file, run ``fn(mesh,
    *args)``, and rank 0 writes the value for the launcher."""
    torch.set_num_threads(1)
    init_distributed(f"file://{os.path.join(tmp, 'rendezvous')}", size, rank,
                     device=devices[rank], backend=backend, staged=staged,
                     timeout_s=timeout_s)
    try:
        out = fn(make_1d_mesh(), *args)
        if rank == 0:
            with open(os.path.join(tmp, "result.pkl.tmp"), "wb") as f:
                pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(os.path.join(tmp, "result.pkl.tmp"),
                       os.path.join(tmp, "result.pkl"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


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
