"""Device meshes over ``torch.distributed`` ranks, and a launcher.

Counterpart of ``python_audio_mastering_tpu.parallel.mesh``.  A JAX mesh
is an array of devices that one process drives; here each position of the
mesh is one process, a rank of ``torch.distributed``'s default group,
driving one device.  A :class:`Mesh` names its axes, knows this rank's
coordinates and device, and carries the collectives that sequence
parallelism (``parallel.sequence``) and data parallelism (the album of
``parallel.batch``, the automaster's step) need along an axis:

* :meth:`Mesh.all_gather` of tensors (stacked on a new leading axis in
  axis order) and :meth:`Mesh.all_gather_object` of picklable objects;
* :meth:`Mesh.from_prev` / :meth:`Mesh.from_next`: the neighbour's tensor
  one step down / up the axis, zeros at the edge (JAX's ``ppermute`` with
  the pairs ``(i, i+1)`` / ``(i+1, i)``), built on ``all_gather``: every
  halo of the chain is small (at most ``2·look + khalf`` frames), and
  gloo sends no CUDA tensor;
* :meth:`Mesh.psum` and :meth:`Mesh.pmax`.

The backend follows the devices: NCCL when each rank has a card of its
own, gloo on the CPU or when ranks share a card.  Gloo moves a CUDA
tensor through the host (its transport); the tensors handed back are on
the caller's device either way.  Every collective is a
``utils.tracing.span`` named ``collective/<op>``, which is how a run reads
the collectives' host time (inside ``utils.tracing.recording``).

The default group comes from ``torchrun`` (``--nproc-per-node N`` on N
cards) or from :func:`launch`, which spawns one process per mesh device
over a ``file://`` store in a temporary directory (no network) and is how
the tests and ``chip_smoke.py`` run the mesh on the CPU or on one card.

:func:`tracks_sharding` and :func:`replicated_sharding` are the port's
form of JAX's ``NamedSharding(mesh, P("tracks"))`` and ``P()``: a
:class:`Sharding` says which rows of a leading tracks axis each rank holds
(its :meth:`Sharding.shard` takes this rank's), which is how the album
(``parallel.batch``) and the automaster (``models.automaster``) shard
their tracks over the ranks (data parallelism).
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import pickle
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from python_audio_mastering_tpu_torch.utils.tracing import span

__all__ = ["Mesh", "make_mesh", "make_mesh_2d", "launch", "call_each",
           "default_device", "mesh_device", "Sharding", "tracks_sharding",
           "replicated_sharding"]

# the device a launched rank was given (launch sets it in the child)
_LAUNCHED_DEVICE = None
# how long a collective may wait for the other ranks
COLLECTIVE_TIMEOUT_S = 900
# meshes built in this process, by (axis names, shape, device): building
# one creates process groups, a collective call of every rank
_MESHES = {}


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's view of a device mesh: axis names and sizes, its
    coordinates, its process group along each axis, its device and the
    default group's backend."""

    axis_names: tuple
    shape: tuple
    coords: tuple
    groups: tuple
    device: torch.device
    backend: str

    def _axis(self, axis):
        if axis not in self.axis_names:
            raise ValueError(f"no axis {axis!r} in mesh {self.axis_names}")
        return self.axis_names.index(axis)

    def size(self, axis=None) -> int:
        """Ranks along ``axis`` (all of them when None)."""
        if axis is None:
            return math.prod(self.shape)
        return self.shape[self._axis(axis)]

    def index(self, axis) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[self._axis(axis)]

    def _group(self, axis):
        return dist.group.WORLD if axis is None else \
            self.groups[self._axis(axis)]

    def _staged(self, t):
        """``t`` where the backend takes it: gloo on the host, NCCL on
        this rank's card."""
        t = t.contiguous()
        if self.backend == "gloo" and t.device.type != "cpu":
            return t.cpu()
        if self.backend == "nccl" and t.device != self.device:
            return t.to(self.device)
        return t

    def all_gather(self, t, axis=None):
        """``(size(axis), *t.shape)``: every rank's ``t`` along ``axis``
        (along every axis, in rank order, when None), on ``t``'s device."""
        n = self.size(axis)
        if n == 1:
            return t[None]
        with span("collective/all_gather"):
            src = self._staged(t)
            out = [torch.empty_like(src) for _ in range(n)]
            dist.all_gather(out, src, group=self._group(axis))
            return torch.stack(out).to(t.device)

    def all_gather_object(self, obj, axis=None):
        """Every rank's picklable ``obj`` along ``axis`` (along every axis
        when None), a list in rank order."""
        n = self.size(axis)
        if n == 1:
            return [obj]
        with span("collective/all_gather_object"):
            out = [None] * n
            dist.all_gather_object(out, obj, group=self._group(axis))
            return out

    def from_prev(self, t, axis):
        """The previous rank's ``t`` along ``axis``; zeros on the first."""
        i = self.index(axis)
        if self.size(axis) == 1:
            return torch.zeros_like(t)
        got = self.all_gather(t, axis)
        return got[i - 1] if i > 0 else torch.zeros_like(t)

    def from_next(self, t, axis):
        """The next rank's ``t`` along ``axis``; zeros on the last."""
        i, n = self.index(axis), self.size(axis)
        if n == 1:
            return torch.zeros_like(t)
        got = self.all_gather(t, axis)
        return got[i + 1] if i + 1 < n else torch.zeros_like(t)

    def _reduce(self, t, axis, op, name):
        if self.size(axis) == 1:
            return t.clone()
        with span(f"collective/{name}"):
            buf = self._staged(t).clone()
            dist.all_reduce(buf, op=op, group=self._group(axis))
            return buf.to(t.device)

    def psum(self, t, axis=None):
        """Sum of ``t`` over the ranks along ``axis``."""
        return self._reduce(t, axis, dist.ReduceOp.SUM, "psum")

    def pmax(self, t, axis=None):
        """Max of ``t`` over the ranks along ``axis``."""
        return self._reduce(t, axis, dist.ReduceOp.MAX, "pmax")


def mesh_device(dev, mesh) -> torch.device:
    """An entry point's device on this rank: a bare ``"cuda"`` is the
    mesh's card."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return (mesh.device if mesh.device.type == "cuda"
                else torch.device("cuda", torch.cuda.current_device()))
    return dev


def default_device() -> torch.device:
    """This rank's device: the one :func:`launch` gave it, else
    ``cuda:{LOCAL_RANK}`` where there is a card, else the CPU."""
    if _LAUNCHED_DEVICE is not None:
        return _LAUNCHED_DEVICE
    if torch.cuda.is_available():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return torch.device("cpu")


def _rank_device(devices):
    if devices is None:
        return default_device()
    devices = list(devices)
    if len(devices) != dist.get_world_size():
        raise ValueError(f"{len(devices)} devices for "
                         f"{dist.get_world_size()} ranks")
    return torch.device(devices[dist.get_rank()])


def _require_group():
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs torch.distributed's default process group: run "
            "under torchrun, or through parallel.mesh.launch")


def make_mesh(axis_name: str = "tracks", devices=None) -> Mesh:
    """A 1-D mesh over every rank of the default group.  ``devices``: one
    device per rank (this rank takes its own), :func:`default_device`
    when None."""
    _require_group()
    device = _rank_device(devices)
    key = ((axis_name,), (dist.get_world_size(),), device)
    if key not in _MESHES:
        _MESHES[key] = Mesh((axis_name,), (dist.get_world_size(),),
                            (dist.get_rank(),), (dist.group.WORLD,), device,
                            dist.get_backend())
    return _MESHES[key]


def make_mesh_2d(tracks: int = 0, axis_names=("tracks", "seq"),
                 devices=None) -> Mesh:
    """A 2-D (tracks × frames) mesh over every rank: rank ``r`` sits at
    ``(r // S, r % S)`` of a ``tracks × S`` grid.

    ``tracks``: the tracks axis' size (0 = the largest divisor of the rank
    count ≤ its square root, e.g. 8 ranks → 2×4, as the JAX package picks
    it).  Builds one process group per row (the ``seq`` axis) and per
    column (the ``tracks`` axis); every rank must call it.
    """
    _require_group()
    n, rank = dist.get_world_size(), dist.get_rank()
    if tracks <= 0:
        tracks = max(d for d in range(1, int(n ** 0.5) + 1) if n % d == 0)
    if n % tracks:
        raise ValueError(f"{n} ranks not divisible by tracks={tracks}")
    seq = n // tracks
    device = _rank_device(devices)
    key = (tuple(axis_names), (tracks, seq), device)
    if key not in _MESHES:
        rows = [dist.new_group([r * seq + j for j in range(seq)])
                for r in range(tracks)]
        cols = [dist.new_group([r * seq + j for r in range(tracks)])
                for j in range(seq)]
        _MESHES[key] = Mesh(tuple(axis_names), (tracks, seq),
                            (rank // seq, rank % seq),
                            (cols[rank % seq], rows[rank // seq]), device,
                            dist.get_backend())
    return _MESHES[key]


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Which rows of a leading (tracks) axis each rank of ``mesh`` holds:
    split evenly along ``axis`` in rank order (JAX ``P(axis)``), or every
    row on every rank when ``axis`` is None (JAX ``P()``)."""

    mesh: Mesh
    axis: str | None = None

    def _rows(self, coords, n):
        if self.axis is None:
            return range(n)
        d = self.mesh.size(self.axis)
        if n % d:
            raise ValueError(
                f"{n} tracks do not split evenly over the {d} ranks of axis "
                f"{self.axis!r}")
        i = coords[self.mesh._axis(self.axis)]
        return range(i * (n // d), (i + 1) * (n // d))

    def devices_indices_map(self, shape) -> dict:
        """``{rank: index}`` for an array of ``shape``: each rank's slice
        of the leading axis, the other axes whole, as JAX's
        ``NamedSharding.devices_indices_map`` gives it per device."""
        rest = (slice(None),) * (len(shape) - 1)
        out = {}
        for rank in range(self.mesh.size()):
            rows = self._rows(np.unravel_index(rank, self.mesh.shape),
                              shape[0])
            lead = (slice(None) if self.axis is None
                    else slice(rows.start, rows.stop))
            out[rank] = (lead,) + rest
        return out

    def rows(self, n: int) -> range:
        """The rows of an ``n``-row axis this rank holds."""
        return self._rows(self.mesh.coords, n)

    def shard(self, x):
        """This rank's rows of ``x`` (numpy, a tensor or a list)."""
        rows = self.rows(len(x))
        return x[rows.start:rows.stop]


def tracks_sharding(mesh: Mesh, axis_name: str = "tracks") -> Sharding:
    """Shard the leading (tracks) axis over ``axis_name``; the rest whole."""
    mesh._axis(axis_name)
    return Sharding(mesh, axis_name)


def replicated_sharding(mesh: Mesh) -> Sharding:
    """Every rank holds every row."""
    return Sharding(mesh, None)


def call_each(calls):
    """Run ``(fn, args, kwargs)`` calls in order; returns their results.
    Hand it to :func:`launch` to run several calls in one set of
    processes."""
    return [fn(*args, **kwargs) for fn, args, kwargs in calls]


def _launch_devices(world, devices):
    if devices is not None:
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for {world} ranks")
        return [str(torch.device(d)) for d in devices]
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        return [f"cuda:{r % n}" for r in range(world)]
    return ["cpu"] * world


def _rank_main(rank, world, store, backend, devices, fn, args, kwargs,
               out_dir):
    """A launched rank: join the group, run ``fn``, pickle its result into
    ``out_dir``."""
    global _LAUNCHED_DEVICE
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    dev = _LAUNCHED_DEVICE = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(
        backend, init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
        **({"device_id": dev} if backend == "nccl" else {}))
    try:
        result = fn(*args, **kwargs)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f, protocol=pickle.HIGHEST_PROTOCOL)


def launch(fn, world: int, args=(), kwargs=None, *, devices=None):
    """Run ``fn(*args, **kwargs)`` on ``world`` new processes, one per
    mesh device, each a rank of a fresh default process group; returns
    the ranks' results in rank order.

    ``fn`` must be picklable, a module-level function of a module that
    imports no ``jax`` (each process imports it).  ``devices``: one per
    rank; by default rank ``r`` takes card ``r mod cards`` where there
    are cards, else the CPU (a CPU rank takes its share of the cores).
    The backend is NCCL when every rank has a card of its own, gloo
    otherwise.

    The kernel library is built here, once, before the ranks start, so
    that they load one build.  The ranks run under
    ``torch.multiprocessing.spawn``: a rank that fails stops the others,
    and the launch raises with that rank's traceback.  A collective that
    waits longer than ``COLLECTIVE_TIMEOUT_S`` fails its rank.
    """
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    devices = _launch_devices(world, devices)
    cuda = [d for d in devices if d.startswith("cuda")]
    backend = ("nccl" if len(cuda) == world and len(set(cuda)) == world
               else "gloo")
    if cuda:
        from python_audio_mastering_tpu_torch.ops import _kernels

        _kernels.library()
    with tempfile.TemporaryDirectory(prefix="pam_mesh_") as tmp:
        ranks = mp.spawn(_rank_main, args=(
            world, os.path.join(tmp, "store"), backend, devices, fn,
            tuple(args), dict(kwargs or {}), tmp), nprocs=world, join=False)
        try:
            while not ranks.join():
                pass
        except ProcessException as e:
            # every rank's own traceback: the first to exit may only have
            # lost its peer
            why = [f"launch: rank {r} of {world} failed:\n"
                   + pickle.load(open(f, "rb"))
                   for r, f in enumerate(ranks.error_files)
                   if os.path.exists(f)]
            raise RuntimeError("\n".join(why) or str(e)) from e
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
