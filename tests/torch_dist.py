"""Rank functions and a spawn helper for the port's mesh tests.

``spawn`` runs a function on ``k`` gloo ranks (``launch/mesh.run_ranks``)
with its ``FileStore`` under the test's ``tmp_path``, every wait bounded.
The rank functions below import only torch and ``repro_torch``, so the
spawned ranks never load JAX; each returns plain Python values and numpy
arrays, which the test process compares with both packages.  Each spawn
runs many cases, since starting the ranks costs seconds.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import run_ranks

TIMEOUT_S = 120


def spawn(fn, world: int, args: tuple, tmp_path, mesh_shape=None,
          device="cpu", backend="gloo") -> list:
    """``fn(mesh, device, *args)`` on ``world`` ranks; each rank's result."""
    return run_ranks(fn, world, args, backend=backend, device=device,
                     mesh_shape=mesh_shape, timeout_s=TIMEOUT_S,
                     workdir=str(tmp_path))


def _rels(data, dev):
    from repro_torch.core.relation import relation
    return [relation(k, v, valid, device=dev) for k, v, valid in data]


def _np(rel):
    return tuple(x.cpu().numpy() for x in rel)


def _surface(r):
    return tuple(float(getattr(r, f))
                 for f in ("estimate", "error_bound", "count", "dof"))


def join_rank(mesh, dev, data, configs, shuffle_cases, join_cases):
    """Per rank and (mesh shape, join axes) of ``configs`` (a shape other
    than the run's gets a mesh of its own over the same ranks):
    ``shuffle_by_key`` of this rank's block of the first relation for each
    (cap, seed) (cap 0: the block's rows, which no bucket can overflow),
    the OR-reduced filter of each relation, and ``distributed_approx_join``
    for each case (kwargs)."""
    from repro_torch.core import bloom
    from repro_torch.core import distributed as D
    from repro_torch.core.relation import shard_to_mesh
    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    rels = _rels(data, dev)
    nb = bloom.num_blocks_for(rels[0].capacity, 0.01)
    meshes = {tuple(mesh.mesh.shape): mesh}
    out = []
    for shape, axes in configs:
        m = meshes.get(tuple(shape))
        if m is None:
            m = meshes[tuple(shape)] = make_host_mesh(*shape)
        k = D.mesh_size(m, axes)
        local = shard_to_mesh(rels[0], m, axes)
        shuffles = []
        for cap, seed in shuffle_cases:
            got, sent, ovf = D.shuffle_by_key(local, k, cap or local.capacity,
                                              m, axes, seed)
            shuffles.append((_np(got), int(sent), int(ovf)))
        words = []
        for r in rels:
            lr = shard_to_mesh(r, m, axes)
            words.append(D.or_reduce(
                bloom.build(lr.keys, lr.valid, nb, 3).words, m,
                axes).cpu().numpy())
        joins = []
        for case in join_cases:
            r = D.distributed_approx_join(m, rels, join_axes=axes, **case)
            joins.append(dict(surface=_surface(r),
                              shuffled=float(r.shuffled_tuple_bytes),
                              per_rank=r.device_shuffled_bytes.tolist(),
                              overflow=int(r.bucket_overflow),
                              dropped=r.device_dropped.tolist(),
                              draws=float(r.sample_draws)))
        out.append(dict(rank=dist.get_rank(),
                        block=D.combined_axis_index(m, axes),
                        shuffles=shuffles, words=words, joins=joins))
    return out


def serve_rank(mesh, dev, data, script):
    """Rank 0 serves ``script`` (see ``run_script``) on mesh JoinServers,
    one after another; the other ranks are their workers (each worker loop
    returns when its server shuts down)."""
    from repro_torch.runtime.join_serve import JoinServer, serve_mesh_worker

    torch.set_num_threads(1)
    rels = _rels(data, dev)
    if dist.get_rank() != 0:
        return [serve_mesh_worker(mesh, dev) for _ in script]
    return run_script(lambda **kw: JoinServer(mesh=mesh, **kw), rels, script)


def run_script(make_server, rels, script):
    """Serve ``script``, a list of (server kwargs, [request kwargs per
    step-run]), one server each; returns per server its results
    (estimate, bound, count, dof, dropped) by request, sigma table, the
    diagnostics' snapshot after each run and the requests' shape-class
    keys.  The requests name the dataset ``"ds"`` (``rels``)."""
    from repro_torch.core.budget import QueryBudget
    from repro_torch.runtime.join_serve import JoinRequest

    out = []
    for server_kw, runs in script:
        server_kw = dict(server_kw)
        step_once = server_kw.pop("step_once", False)
        srv = make_server(**server_kw)
        srv.register_dataset("ds", rels)
        res, snaps, classes = [], [], []
        for reqs in runs:
            qs = []
            for kw in reqs:
                kw = dict(kw)
                kw["budget"] = QueryBudget(*kw.get("budget", (None, 0.5)))
                qs.append(srv.submit(JoinRequest(dataset="ds", **kw)))
            if step_once:
                srv.step()
            else:
                srv.run()
            res += [(*_surface(q.result),
                     float(q.result.diagnostics.dist_dropped_tuples),
                     q.result.strata.keys.cpu().numpy(),
                     q.result.diagnostics.live_counts.cpu().numpy())
                    for q in qs]
            classes += [tuple(q._class) for q in qs]
            snaps.append(srv.diagnostics.snapshot())
        out.append(dict(results=res, sigma=srv.sigma.table, snaps=snaps,
                        classes=classes))
        if getattr(srv, "mesh", None) is not None:
            srv.shutdown()
    return out


def routed_bytes(data, k: int, seed: int, filter_stage: bool = True):
    """What the data says each of ``k`` blocks puts into the key shuffle
    of a join of filter seed ``seed``: TUPLE_BYTES for each live row of
    the block whose key routes to another block (rows past a bucket
    included, as the shuffle meters them), a live row being one that the
    single-device joint filter passes.  ``[k]`` float64."""
    from repro_torch.core import bloom
    from repro_torch.core.hashing import hash2
    from repro_torch.core.join import TUPLE_BYTES

    rels = _rels(data, "cpu")
    nb = bloom.num_blocks_for(max(r.capacity for r in rels), 0.01)
    jf = bloom.intersect_all([bloom.build(r.keys, r.valid, nb, seed)
                              for r in rels])
    per = np.zeros(k)
    for r in rels:
        live = r.valid & bloom.contains(jf, r.keys) if filter_stage \
            else r.valid
        block = torch.arange(r.capacity) // (r.capacity // k)
        off = live & (hash2(r.keys, seed + 101) % k != block)
        per += off.view(k, -1).sum(1).numpy()
    return per * TUPLE_BYTES


def fail_rank(mesh, dev, bad_rank):
    """Rank ``bad_rank`` raises; the others wait in a collective on it."""
    if dist.get_rank() == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    x = torch.ones(1)
    dist.all_reduce(x)
    return float(x)
