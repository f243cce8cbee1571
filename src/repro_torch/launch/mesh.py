"""Serving meshes of the port: one process (or, in the CPU tests, one
thread) per mesh position, each holding its own process groups.

The JAX package serves a ``data`` x ``model`` (x ``pod``) mesh from one
program over many devices. The port runs the same mesh SPMD, the way
PyTorch runs multi-GPU work: one rank per position, rank-major over the
axes (``model`` fastest), each with a :class:`Mesh` that carries its
coordinate, its device and one process group per axis. Nothing uses the
default process group or other state of the process, so two engines on
two meshes stay independent (the JAX package keeps them apart with
ContextVars), and the CPU tests can run every rank of a mesh as a thread
of the test process (:func:`run_mesh_threads`).

The collective backend is an explicit argument of the mesh, chosen from
the topology before anything runs and never switched after a failure:
``nccl`` where every rank has a card of its own, ``gloo`` where ranks
share a card (NCCL refuses two ranks of one communicator on one device)
or run on the CPU.

* :func:`parse_mesh_spec` reads ``--mesh`` with the JAX launcher's rules.
* :func:`make_serving_mesh` builds this process's :class:`Mesh` from the
  ``torchrun`` environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``, ``MASTER_PORT``); :func:`spawn_ranks` starts a mesh's
  ranks with that environment when the caller is not under ``torchrun``.
* :func:`make_local_mesh` is a one-rank mesh with the production axis
  names; :func:`run_mesh_threads` runs a function on every rank of a mesh
  as threads of this process over ``ProcessGroupGloo`` and one
  ``HashStore`` (the CPU tests).
"""
from __future__ import annotations

import datetime
import math
import os
import socket
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.runtime import resolve_device

#: what a collective waits before it raises (and a rank thread is joined)
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)

#: the ``ServingConfig.mesh_axes`` default and the axes of ``--mesh DxM``
SERVING_AXES = ("data", "model")


def parse_mesh_spec(spec: str):
    """Parse a ``--mesh`` value as the JAX launcher does: "4x2" -> ((4, 2),
    ("data", "model")); "2x2x2" -> ((2, 2, 2), ("pod", "data", "model"));
    "4" -> ((4, 1), ("data", "model")) (a data-only mesh keeps a model axis
    of 1: the sharding rules address ``model`` by name); "" or "1x1" ->
    None (one device, no mesh)."""
    if not spec:
        return None
    shape = tuple(int(x) for x in spec.lower().split("x"))
    if math.prod(shape) == 1:
        return None
    if len(shape) == 1:
        shape = (shape[0], 1)
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(shape))
    if axes is None:
        raise ValueError(f"--mesh {spec!r}: expected 1-3 'x'-separated dims")
    return shape, axes


class Mesh:
    """This rank's view of a serving mesh: ``axes`` and their sizes
    (``shape``, a dict in axis order), this rank's ``coord``, its
    ``device`` and the collective ``backend``, and one process group per
    axis of size > 1 (``group(axis)``; None for an axis of size 1). The
    ``data`` domain is ``pod`` x ``data`` (:meth:`data_index`,
    :meth:`data_size`), as in the sharding rules. Collectives over an axis
    are ``distributed.collectives``'; each waits at most ``timeout``."""

    def __init__(self, dims: Sequence[int], axes: Sequence[str], rank: int,
                 store, *, backend: str, device, timeout=DEFAULT_TIMEOUT):
        if len(dims) != len(axes):
            raise ValueError(f"mesh dims {tuple(dims)} vs axes {tuple(axes)}")
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"collective backend {backend!r}: gloo or nccl")
        self.axes = tuple(axes)
        self.dims = tuple(int(d) for d in dims)
        self.rank = int(rank)
        # the store the groups rendezvous on (a second mesh over the same
        # ranks takes a PrefixStore of it)
        self.store = store
        self.backend = backend
        self.device = torch.device(device)
        self.timeout = timeout
        strides = [math.prod(self.dims[i + 1:]) for i in range(len(dims))]
        self.coord = {a: (self.rank // s) % d
                      for a, s, d in zip(self.axes, strides, self.dims)}
        self._groups: Dict[str, object] = {}
        for a, d in zip(self.axes, self.dims):
            if d == 1:
                continue
            # the ranks that differ from this one only along `a`
            key = ",".join(f"{b}{self.coord[b]}" for b in self.axes if b != a)
            prefixed = dist.PrefixStore(f"mesh/{a}/{key}", store)
            if backend == "gloo":
                pg = dist.ProcessGroupGloo(prefixed, self.coord[a], d,
                                           timeout)
            else:
                # each collective's wait carries the timeout
                pg = dist.ProcessGroupNCCL(prefixed, self.coord[a], d)
            self._groups[a] = pg

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axes, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        return self.coord.get(axis, 0)

    def group(self, axis: str):
        return self._groups.get(axis)

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in ("pod", "data") if a in self.shape)

    def data_size(self) -> int:
        return math.prod(self.axis_size(a) for a in self.data_axes)

    def data_index(self) -> int:
        """This rank's block along pod x data (pod major)."""
        i = 0
        for a in self.data_axes:
            i = i * self.axis_size(a) + self.axis_index(a)
        return i

    def describe(self) -> str:
        dims = "x".join(str(d) for d in self.dims)
        return (f"mesh {dims} ({', '.join(self.axes)}) over {self.size} "
                f"ranks, collectives over {self.backend}, rank {self.rank} "
                f"on {self.device}")

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, {self.backend})"


def choose_backend(device: torch.device, world_size: int) -> str:
    """The collective backend of a mesh of ``world_size`` ranks on
    ``device``'s kind, from the topology alone: ``nccl`` when every rank
    has a CUDA card of its own, else ``gloo`` (CPU ranks, or ranks that
    share cards)."""
    if device.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def rank_device(device, local_rank: int) -> torch.device:
    """``cuda:(local_rank % device_count)`` for a CUDA rank; the CPU as it
    is."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def make_serving_mesh(shape, axes=SERVING_AXES, *, device="cuda") -> Mesh:
    """This process's :class:`Mesh` from the ``torchrun`` environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``; :func:`spawn_ranks` sets them), its backend
    :func:`choose_backend`'s. Raises when the environment names no rank or
    a world of another size than the mesh."""
    n = math.prod(shape)
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise RuntimeError(
            f"mesh {tuple(shape)} needs {n} ranks: start them with "
            "`python -m repro_torch.launch.serve --mesh ...` (which spawns "
            "them) or under torchrun")
    world = int(os.environ["WORLD_SIZE"])
    if world != n:
        raise RuntimeError(f"mesh {tuple(shape)} needs {n} ranks, the "
                           f"environment has WORLD_SIZE={world}")
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = rank_device(resolve_device(device), local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.TCPStore(os.environ.get("MASTER_ADDR", "127.0.0.1"),
                          int(os.environ["MASTER_PORT"]), world, rank == 0,
                          timeout=DEFAULT_TIMEOUT)
    return Mesh(shape, axes, rank, store,
                backend=choose_backend(dev, world), device=dev)


def make_local_mesh(device="cpu") -> Mesh:
    """A one-rank mesh with the production axis names (``data`` 1 x
    ``model`` 1): no process group, no collective."""
    return Mesh((1, 1), SERVING_AXES, 0, dist.HashStore(), backend="gloo",
                device=device)


def run_mesh_threads(shape, fn: Callable[[Mesh], object], axes=None, *,
                     device="cpu", timeout: float = 120.0) -> List[object]:
    """Run ``fn(mesh)`` on every rank of a ``shape`` mesh, each rank a
    thread of this process with its own :class:`Mesh` over gloo and one
    shared ``HashStore`` (the CPU tests: no process is spawned). Returns
    the ranks' results in rank order. A rank's exception is re-raised
    here as soon as it is raised; a rank still running after
    ``timeout`` seconds raises ``TimeoutError`` (its collectives time out
    on their own soon after, so the thread does not outlive the run by
    long)."""
    axes = SERVING_AXES if axes is None and len(shape) == 2 else axes
    if axes is None:
        axes = ("pod", "data", "model")
    n = math.prod(shape)
    store = dist.HashStore()
    results: List[object] = [None] * n
    errors: List[Optional[BaseException]] = [None] * n
    wait = datetime.timedelta(seconds=timeout)

    def rank_main(r: int) -> None:
        try:
            mesh = Mesh(shape, axes, r, store, backend="gloo", device=device,
                        timeout=wait)
            results[r] = fn(mesh)
        except BaseException as e:   # re-raised in the caller's thread
            errors[r] = e

    threads = [threading.Thread(target=rank_main, args=(r,), daemon=True,
                                name=f"mesh-rank-{r}") for r in range(n)]
    for t in threads:
        t.start()
    # a failed rank ends the wait at once: its peers would otherwise sit
    # in a collective until it times out
    deadline = time.monotonic() + timeout
    for t in threads:
        while t.is_alive() and not any(errors):
            t.join(min(0.05, max(0.0, deadline - time.monotonic())))
            if time.monotonic() >= deadline:
                break
    for e in errors:
        if e is not None:
            raise e
    stuck = [r for r, t in enumerate(threads) if t.is_alive()]
    if stuck:
        raise TimeoutError(f"mesh ranks {stuck} still running after "
                           f"{timeout:g} s")
    return results


def free_port() -> int:
    """A free TCP port on localhost (the rank store's)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(local_rank: int, world: int, port: int, fn, args) -> None:
    os.environ.update(RANK=str(local_rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(local_rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    if local_rank != 0:
        sys.stdout = open(os.devnull, "w")
    # the ranks share the host's cores
    torch.set_num_threads(max(1, torch.get_num_threads() // world))
    try:
        fn(*args)
    except BaseException:
        # the launcher names only the first rank it sees fail (often a
        # peer whose collective broke): each rank says its own error
        print(f"[rank {local_rank}] failed:\n{traceback.format_exc()}",
              file=sys.stderr, flush=True)
        raise


def spawn_ranks(world: int, fn: Callable, args: tuple = ()) -> None:
    """Start ``world`` processes (``spawn``) that each run ``fn(*args)``
    with the ``torchrun`` environment of its rank, and wait for all of
    them. Only rank 0 prints to standard output. Raises
    (``torch.multiprocessing.ProcessRaisedException`` or
    ``ProcessExitedException``) when any rank fails; the others are then
    stopped. ``fn`` must be importable by name (a module-level
    function)."""
    import torch.multiprocessing as mp
    mp.start_processes(_rank_main,
                       args=(world, free_port(), fn, args),
                       nprocs=world, join=True, start_method="spawn")
