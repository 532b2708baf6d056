"""Device meshes over ``torch.distributed``, and a launcher of rank processes.

JAX drives every device of a mesh from one process.  Here each rank of the
mesh is a process of its own: :func:`run_ranks` starts ``k`` of them (forked
from a fork server that has imported torch, joined through a ``FileStore``,
every wait bounded by a timeout), each joins
the process group with :func:`init_ranks` and builds the same
:class:`~torch.distributed.device_mesh.DeviceMesh`, whose named dims
(``"pod"``, ``"data"``, ``"model"``) play the JAX mesh's axes.

The backend is always explicit: ``nccl`` for tensors on the card, ``gloo``
for the CPU, and ``gloo`` over card tensors only when the caller asks for it
(its collectives then carry the tensors through host memory,
``core/distributed.py``).  A backend that fails to start raises, naming the
backend that was asked for; nothing switches to another one.  Rank ``r``
takes ``cuda:{r % device_count}``.

A dry run (``launch/dryrun.py``, ``launch/dryrun_join.py``) plays rank 0
of a production mesh in one process: :func:`fake_ranks` starts torch's
``fake`` backend, whose collectives return at once and move nothing, so
one rank's program runs, and is metered, as it would at 256 or 512 ranks.
Nothing else starts that backend.

Defined as functions, so importing this module starts no process and
touches no device.
"""

from __future__ import annotations

import atexit
import datetime
import os
import shutil
import signal
import tempfile
import time
import traceback
from contextlib import contextmanager
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

AXES = ("pod", "data", "model")


def backend_for(device, dist_backend: Optional[str] = None) -> str:
    """The process-group backend for tensors on ``device``: ``nccl`` on the
    card unless ``dist_backend='gloo'`` asks for gloo, ``gloo`` on the CPU."""
    kind = torch.device(device).type
    if dist_backend is None:
        return "nccl" if kind == "cuda" else "gloo"
    if dist_backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {dist_backend!r}")
    if dist_backend == "nccl" and kind != "cuda":
        raise ValueError("the nccl backend needs tensors on a CUDA card")
    return dist_backend


def check_device(device, who: str) -> str:
    """The name of ``device`` for a launcher's report.  Raises without a
    card unless the caller asked for the CPU: a launcher never falls back
    to it."""
    if torch.device(device).type != "cuda":
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA card; pass --device cpu to run "
                           f"on the CPU")
    return torch.cuda.get_device_name(torch.device(device))


def init_ranks(rank: int, world: int, *, backend: str, device,
               store_path: str, timeout_s: float) -> torch.device:
    """Join the default process group as ``rank`` of ``world``; returns the
    device this rank's tensors live on (``cuda:{rank % device_count}`` on
    the card).  The group's first collective runs here, so a backend that
    cannot start (NCCL with two ranks on one card, say) raises now."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("mesh: no CUDA card for a mesh on the card")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        probe = torch.ones(1, device=dev if backend == "nccl" else "cpu")
        dist.all_reduce(probe)
        if int(probe.item()) != world:
            raise RuntimeError(f"all_reduce over {world} ranks gave "
                               f"{probe.item()}")
    except Exception as e:  # noqa: BLE001 (re-raised with the backend named)
        raise RuntimeError(f"mesh: backend {backend!r} failed to start on "
                           f"{dev} (rank {rank} of {world}): {e}") from e
    return dev


def check_group_order(mesh) -> None:
    """Every dim's group must rank its members in the dim's index order,
    which the all_gathers and all_to_alls of ``core/distributed.py`` rely
    on (a received block's position is its sender's index on the axis)."""
    coord = mesh.get_coordinate()
    for i, name in enumerate(mesh.mesh_dim_names):
        group = mesh.get_group(name)
        index = list(coord)
        index[i] = slice(None)
        want = mesh.mesh[tuple(index)].tolist()
        got = dist.get_process_group_ranks(group)
        if got != want or dist.get_rank(group) != coord[i]:
            raise RuntimeError(f"mesh: dim {name!r} groups ranks {got} "
                               f"(this rank {dist.get_rank(group)}), the "
                               f"mesh says {want} (index {coord[i]})")


@contextmanager
def fake_ranks(world: int):
    """Rank 0 of ``world`` ranks on torch's ``fake`` backend, for the
    block; the group is destroyed on the way out.  Its collectives check
    shapes and return without moving a byte (their outputs are left as
    they were), so a dry run meters rank 0's program at the size of a
    cluster.  Raises if a default group exists, and names the module when
    this torch lacks the backend: nothing switches to another one."""
    if dist.is_initialized():
        raise RuntimeError("fake_ranks: a default process group already "
                           "exists")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("fake_ranks: this torch has no "
                           "torch.testing._internal.distributed.fake_pg "
                           f"({e}); a dry run needs its fake backend") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(shape: Sequence[int], names: Sequence[str]):
    from torch.distributed.device_mesh import init_device_mesh
    # the mesh's device type only places DTensors, which nothing here uses;
    # it follows the backend so that every dim's group is of the same kind
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(names))
    check_group_order(mesh)
    return mesh


def make_host_mesh(dp: int = 1, tp: int = 1):
    """``(data, model)`` mesh over the ranks of the default group (tests,
    one host); ``dp`` and ``tp`` are cut to the ranks there are."""
    n = dist.get_world_size()
    dp = min(dp, n)
    tp = min(tp, max(n // dp, 1))
    return _mesh((dp, tp), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False):
    """Single-pod ``(16, 16)`` = 256 ranks, or 2 pods x 256 = 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = AXES if multi_pod else ("data", "model")
    return _mesh(shape, names)


def data_axes(mesh) -> tuple:
    """The data-parallel axes present in this mesh (pod included when
    multi-pod)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def _rank_main(fn, rank, world, args, backend, device, mesh_shape, store,
               timeout_s, out_path, err_path):
    # the ranks share the host's cores: k ranks each starting a thread per
    # core over-subscribe it (2 CPU ranks served 10x slower so)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        dev = init_ranks(rank, world, backend=backend, device=device,
                         store_path=store, timeout_s=timeout_s)
        mesh = make_host_mesh(*mesh_shape)
        result = fn(mesh, dev, *args)
        torch.save(result, out_path)
    except BaseException:  # noqa: BLE001 (reported to the parent, exit 1)
        with open(err_path, "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)
    # leave without waiting on the other ranks' teardown: the parent joins
    # every rank, and an NCCL destroy can block on a rank that failed
    dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, args: tuple = (), *,
              backend: str, device="cpu",
              mesh_shape: Optional[Sequence[int]] = None,
              timeout_s: float = 120.0,
              workdir: Optional[str] = None) -> list:
    """Run ``fn(mesh, device, *args)`` on ``world`` new ranks; returns
    each rank's result, in rank order.

    The ranks fork from multiprocessing's fork server, a fresh process
    that imports torch once (no CUDA context: each rank makes its own), so
    a rank starts in a fraction of a second where a spawned one spends
    seconds importing torch; the server lives until :func:`stop_rank_server`,
    which runs at this process's exit at the latest.

    The ranks meet through a ``FileStore`` in a fresh directory under
    ``workdir`` (the system's temporary directory by default), the process
    group's collectives time out after ``timeout_s`` and so does the whole
    run: a rank that raises, exits non-zero or outlives the deadline fails
    the run with its traceback, and the other ranks are killed, never left
    waiting.  Each rank takes an equal share of the host's cores for its
    torch threads.  ``fn`` and ``args`` are pickled (``fn`` by its import
    path); results come back through ``torch.save``.
    """
    import torch.multiprocessing as mp
    mesh_shape = tuple(mesh_shape or (world, 1))
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", "repro_torch.launch.mesh"])
    atexit.unregister(stop_rank_server)
    atexit.register(stop_rank_server)
    tmp = tempfile.mkdtemp(prefix="mesh-", dir=workdir)
    store = os.path.join(tmp, "store")
    outs = [os.path.join(tmp, f"out{r}.pt") for r in range(world)]
    errs = [os.path.join(tmp, f"err{r}.txt") for r in range(world)]
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, r, world, args, backend, device, mesh_shape, store, timeout_s,
        outs[r], errs[r])) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s + 30.0
    try:
        while any(p.is_alive() for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.exitcode not in (None, 0)]
            if bad or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        bad = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        if bad:
            # a rank's failure makes the others fail too (their peer is
            # gone): report the first traceback of each rank that left one
            time.sleep(1.0)
            msgs = [f"rank {r}: {open(e).read()}" for r, e in enumerate(errs)
                    if os.path.exists(e)]
            raise RuntimeError(f"run_ranks: rank {bad[0]} of {world} exited "
                               f"with {procs[bad[0]].exitcode}:\n"
                               + "\n".join(msgs))
        if late:
            raise TimeoutError(f"run_ranks: ranks {late} of {world} still "
                               f"running after {timeout_s + 30.0:.0f} s")
        return [torch.load(o, weights_only=False) for o in outs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=60)
        shutil.rmtree(tmp, ignore_errors=True)


def _serve_from_rank0(mesh, device, fn, kw):
    from repro_torch.runtime.join_serve import (close_mesh_workers,
                                                serve_mesh_worker)
    if dist.get_rank() != 0:
        return serve_mesh_worker(mesh, device)
    try:
        return fn(mesh=mesh, device=str(device), **kw)
    finally:
        close_mesh_workers()


def run_on_mesh(fn: Callable, world: int, kw: dict, *, device="cuda",
                dist_backend: Optional[str] = None, who: str,
                timeout_s: float = 600.0):
    """A launcher's ``fn(mesh=..., device=..., **kw)`` on rank 0 of
    ``world`` new ranks over ``dist_backend`` (NCCL on the card unless
    ``'gloo'`` is asked for, gloo on the CPU), the other ranks running the
    mesh servers' worker loop until rank 0 closes it; returns rank 0's
    result.  Without a card it fails before it starts a rank, unless
    ``device`` is the CPU."""
    check_device(device, who)
    backend = backend_for(device, dist_backend)
    return run_ranks(_serve_from_rank0, world, (fn, kw), backend=backend,
                     device=device, timeout_s=timeout_s)[0]


def _end_helper(pid: Optional[int], alive_fd: Optional[int],
                timeout_s: float) -> None:
    # a multiprocessing helper leaves when the write end of its "alive"
    # pipe closes in every process that holds it; one that has not left
    # within the timeout (still importing torch, say) is killed
    if alive_fd is not None:
        os.close(alive_fd)
    if pid is None:
        return
    deadline = time.monotonic() + timeout_s
    while os.waitpid(pid, os.WNOHANG) == (0, 0):
        if time.monotonic() > deadline:
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
            return
        time.sleep(0.05)


def stop_rank_server(timeout_s: float = 10.0) -> None:
    """Stop the fork server that :func:`run_ranks` starts, and
    multiprocessing's resource tracker, and wait until both have left, so
    that a program leaves no process behind when it ends (on their own
    they leave some time after it: the server only once it has finished
    importing torch).  Call it when no rank runs any more; a later
    :func:`run_ranks` starts a new server.  Idempotent."""
    from multiprocessing import forkserver, resource_tracker, util
    server = forkserver._forkserver
    with server._lock:
        pid, server._forkserver_pid = server._forkserver_pid, None
        fd, server._forkserver_alive_fd = server._forkserver_alive_fd, None
        address, server._forkserver_address = server._forkserver_address, None
        _end_helper(pid, fd, timeout_s)
        if address and not util.is_abstract_socket_namespace(address):
            try:
                os.unlink(address)
            except FileNotFoundError:
                pass
    tracker = resource_tracker._resource_tracker
    with tracker._lock:
        pid, tracker._pid = tracker._pid, None
        fd, tracker._fd = tracker._fd, None
        _end_helper(pid, fd, timeout_s)
