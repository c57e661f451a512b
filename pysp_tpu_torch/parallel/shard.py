"""The shard runner: ``jax.shard_map`` and the ``lax`` collectives on a mesh of
torch devices, in one process.

``shard_map(fn, mesh, in_specs, out_specs)(*args)``:

1. splits each input by its partition spec (``P``) onto the device of each
   mesh position, in the calling thread;
2. runs ``fn`` once for each position, each in a thread of its own, with the
   position's device current (``torch.cuda.device``) and, on a CUDA device,
   a stream of its own current (the position's, kept from call to call), so
   shards that share a card overlap there;
3. gathers the outputs by their specs onto the mesh's first device: a
   dimension split over an axis is concatenated along it, and over an axis
   that a spec does not name, the outputs of that axis' position 0 are taken
   (the others are replicas, as under ``shard_map``).

Inside ``fn``, ``axis_index``, ``psum``, ``pmean``, ``pmin``, ``pmax``,
``all_gather`` and ``ppermute`` take an axis name, as ``lax``'s do, and read
the calling thread's shard. As under ``shard_map`` every position runs one
program: each collective is a rendezvous of all positions, and every
position must call the same collectives in the same order. Each reduces its
group (the positions that differ from the caller only along the axis) in
axis-index order, so the group's members get the same bits; ``psum`` stacks
the group's values and sums along the stack in one reduction. ``ppermute``
leaves a position that receives nothing zero-filled, as ``lax.ppermute``.

Tensors that cross threads or devices: a shard records an event on its
stream after the value it hands over; the reader waits on that event on its
own stream before it reads or copies the value, and marks the memory as used
by its stream (``Tensor.record_stream``), so the caching allocator does not
hand it out again while the reader's work is queued. The caller's stream on
each device waits on every shard's stream before the outputs are gathered.

A shard that raises aborts the rendezvous, so the others fail at their next
collective instead of waiting; every thread is joined, and the caller gets a
``ShardError`` naming the first shard that raised (by flat index, batch-major)
and its mesh position, chained to the shard's exception. A collective that
some shard never reaches fails every shard after ``BARRIER_TIMEOUT`` seconds. No
shard's work is re-run elsewhere.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from numbers import Number
from typing import Callable, List, Sequence

import torch

from .mesh import AXIS_NAMES, BATCH_AXIS, SPATIAL_AXIS, Mesh

Tensor = torch.Tensor

# How long a shard waits at a collective for the others, in seconds.
BARRIER_TIMEOUT = 600.0


class P(tuple):
    """A partition spec: for each leading dimension of a tensor, the mesh
    axis it is split over, or None; ``P()`` replicates the tensor."""

    def __new__(cls, *axes):
        for axis in axes:
            if axis is not None and axis not in AXIS_NAMES:
                raise ValueError(f"unknown mesh axis {axis!r}; the axes are {AXIS_NAMES}")
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


class ShardError(RuntimeError):
    """A shard's block raised. ``index`` is the shard's flat index (batch-major)
    and ``position`` its mesh position; the shard's exception is the cause."""

    def __init__(self, index: int, position: dict, cause: BaseException):
        self.index, self.position = index, dict(position)
        where = ", ".join(f"{axis} {i}" for axis, i in position.items())
        super().__init__(
            f"shard {index} (mesh position {where}) raised {type(cause).__name__}: {cause}"
        )


_streams = {}
_streams_lock = threading.Lock()


def _stream_for(device: torch.device, index: int):
    """The CUDA stream of mesh position ``index`` on ``device``: the same one
    at every call, so that the caching allocator's blocks for it are reused
    (a new stream a call would start with none and allocate every tensor)."""
    with _streams_lock:
        if (device, index) not in _streams:
            _streams[device, index] = torch.cuda.Stream(device=device)
        return _streams[device, index]


class _Shard:
    """One mesh position of one ``shard_map`` call: what the collectives read."""

    def __init__(self, mesh: Mesh, batch: int, spatial: int, rendezvous: "_Rendezvous"):
        self.mesh = mesh
        self.position = {BATCH_AXIS: batch, SPATIAL_AXIS: spatial}
        self.index = batch * mesh.shape[SPATIAL_AXIS] + spatial
        self.device = mesh.device_at(batch, spatial)
        self.rendezvous = rendezvous
        self.stream = _stream_for(self.device, self.index) if self.device.type == "cuda" else None

    def group(self, axis: str) -> List[int]:
        """Flat indices of the positions that differ from this one only along
        ``axis``, in axis-index order."""
        _check_axis(axis)
        n_sp = self.mesh.shape[SPATIAL_AXIS]
        if axis == BATCH_AXIS:
            return [b * n_sp + self.position[SPATIAL_AXIS] for b in range(self.mesh.shape[axis])]
        return [self.position[BATCH_AXIS] * n_sp + s for s in range(n_sp)]

    @contextlib.contextmanager
    def context(self):
        """The device and the stream this shard runs on."""
        if self.stream is None:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            yield


class _Rendezvous:
    """The meeting point of one call's shards: a slot for each and a barrier."""

    def __init__(self, n: int, timeout: float):
        self.slots = [None] * n
        self.barrier = threading.Barrier(n, timeout=timeout)


_local = threading.local()


def _current() -> _Shard:
    shard = getattr(_local, "shard", None)
    if shard is None:
        raise RuntimeError("a collective was called outside a shard_map block")
    return shard


def _check_axis(axis: str) -> None:
    if axis not in AXIS_NAMES:
        raise ValueError(f"unknown mesh axis {axis!r}; the axes are {AXIS_NAMES}")


def _record(value):
    """An event after ``value`` on its device's current stream (None off CUDA)."""
    if isinstance(value, Tensor) and value.device.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(value.device))
        return event
    return None


def _fetch(value, event, device: torch.device):
    """``value``, which another thread made (``event`` recorded after it),
    on ``device`` and safe to read on this thread's current stream."""
    if not isinstance(value, Tensor):
        return value
    if value.device.type == "cuda":
        stream = torch.cuda.current_stream(value.device)
        stream.wait_event(event)
        value.record_stream(stream)
    return value.to(device)


def _collect(leaves: Sequence, axis: str, sources=None) -> List[list]:
    """Rendezvous: hands this shard's ``leaves`` to the others and returns the
    leaves of its ``axis`` group's members, in axis-index order, on its
    device (only of the members at the axis indices ``sources``, when
    given)."""
    shard = _current()
    rv = shard.rendezvous
    rv.slots[shard.index] = [(leaf, _record(leaf)) for leaf in leaves]
    rv.barrier.wait()
    group = shard.group(axis)
    members = group if sources is None else [group[s] for s in sources]
    got = [[_fetch(leaf, ev, shard.device) for leaf, ev in rv.slots[i]] for i in members]
    rv.barrier.wait()  # nobody refills a slot before every shard has read it
    return got


def _leaves(x):
    return (list(x), type(x)) if isinstance(x, (tuple, list)) else ([x], None)


def _rebuild(values: list, kind):
    return values[0] if kind is None else kind(values)


def _reduce(x, axis_name: str, op: Callable):
    """``op`` of the group's values (a list in axis-index order) for each
    leaf of ``x``."""
    leaves, kind = _leaves(x)
    leaves = [v.to(torch.int32) if isinstance(v, Tensor) and v.dtype == torch.bool else v
              for v in leaves]
    members = _collect(leaves, axis_name)
    return _rebuild([op([m[k] for m in members]) for k in range(len(leaves))], kind)


def _sum(values: list):
    """The values stacked and summed along the stack in one reduction, the
    same one a stacked burst's ``sum(dim=0)`` takes: a group of one frame a
    shard gets the bits of the unsharded sum over the frames."""
    if isinstance(values[0], Tensor):
        return torch.stack(values).sum(dim=0, dtype=values[0].dtype)
    return sum(values)


def axis_index(axis_name: str) -> int:
    """This shard's index along ``axis_name``."""
    _check_axis(axis_name)
    return _current().position[axis_name]


def axis_size(axis_name: str) -> int:
    """The mesh's size along ``axis_name``."""
    _check_axis(axis_name)
    return _current().mesh.shape[axis_name]


def psum(x, axis_name: str):
    """Sum over the ``axis_name`` group of a tensor, a number or a tuple of
    them (bool tensors count as int32, as in ``lax.psum``). Python numbers,
    the same on every shard as under ``shard_map``, are multiplied by the
    axis size without a rendezvous, as ``lax.psum(1, axis)`` is."""
    leaves, kind = _leaves(x)
    if all(isinstance(v, Number) for v in leaves):
        n = axis_size(axis_name)
        return _rebuild([v * n for v in leaves], kind)
    return _reduce(x, axis_name, _sum)


def pmean(x, axis_name: str):
    """Mean over the ``axis_name`` group: ``psum(x) / n``, as ``lax.pmean``."""
    n = axis_size(axis_name)
    leaves, kind = _leaves(psum(x, axis_name))
    return _rebuild([v / n for v in leaves], kind)


def _minimum(values: list):
    if isinstance(values[0], Tensor):
        return functools.reduce(torch.minimum, values)
    return min(values)


def _maximum(values: list):
    if isinstance(values[0], Tensor):
        return functools.reduce(torch.maximum, values)
    return max(values)


def pmin(x, axis_name: str):
    """Elementwise minimum over the ``axis_name`` group."""
    return _reduce(x, axis_name, _minimum)


def pmax(x, axis_name: str):
    """Elementwise maximum over the ``axis_name`` group."""
    return _reduce(x, axis_name, _maximum)


def all_gather(x: Tensor, axis_name: str, axis: int = 0, tiled: bool = False) -> Tensor:
    """The group's ``x`` stacked along a new dimension ``axis`` in axis-index
    order, or with ``tiled`` concatenated along ``axis``."""
    parts = [m[0] for m in _collect([x], axis_name)]
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts, dim=axis)


def ppermute(x: Tensor, axis_name: str, perm) -> Tensor:
    """``x`` of the position that sends to this one along ``axis_name``
    (``perm``: (source, destination) pairs of axis indices); zeros where no
    position sends here."""
    perm = [(int(s), int(d)) for s, d in perm]
    if len({s for s, _ in perm}) != len(perm) or len({d for _, d in perm}) != len(perm):
        raise ValueError(f"ppermute needs distinct sources and destinations, got {perm}")
    me = axis_index(axis_name)
    sources = [s for s, d in perm if d == me]
    got = _collect([x], axis_name, sources=sources)
    return got[0][0] if got else torch.zeros_like(x)


# --- the runner -----------------------------------------------------------------


def _split(x, spec, position: dict, mesh: Mesh):
    """This position's piece of the argument ``x`` under ``spec``."""
    if x is None:
        return None
    if not isinstance(spec, P):
        if not isinstance(x, (tuple, list)) or len(x) != len(spec):
            raise ValueError(f"argument {type(x).__name__} does not match its specs {spec}")
        return type(x)(_split(xi, si, position, mesh) for xi, si in zip(x, spec))
    if not isinstance(x, Tensor):
        if any(axis is not None for axis in spec):
            raise ValueError(f"only a tensor splits over a mesh axis, got {type(x).__name__}")
        return x
    if len(spec) > x.ndim:
        raise ValueError(f"spec {spec} names more dimensions than the tensor's {tuple(x.shape)}")
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.shape[axis]
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split into "
                             f"{n} equal parts over the {axis} axis")
        step = x.shape[dim] // n
        x = x.narrow(dim, position[axis] * step, step)
    return x


def _to(x, device: torch.device):
    if isinstance(x, (tuple, list)):
        return type(x)(_to(xi, device) for xi in x)
    if isinstance(x, Tensor):
        return x.contiguous().to(device)
    return x


def _gather(spec, outputs: list, mesh: Mesh, device: torch.device):
    """The outputs of every position (by flat index) assembled by ``spec`` on
    ``device``."""
    if not isinstance(spec, P):
        return type(spec)(_gather(si, [o[k] for o in outputs], mesh, device)
                          for k, si in enumerate(spec))
    named = [(dim, axis) for dim, axis in enumerate(spec) if axis is not None]
    n_sp = mesh.shape[SPATIAL_AXIS]

    def assemble(k: int, position: dict):
        if k == len(named):
            value = outputs[position[BATCH_AXIS] * n_sp + position[SPATIAL_AXIS]]
            return value.to(device) if isinstance(value, Tensor) else value
        dim, axis = named[k]
        return torch.cat([assemble(k + 1, {**position, axis: i})
                          for i in range(mesh.shape[axis])], dim=dim)

    return assemble(0, {BATCH_AXIS: 0, SPATIAL_AXIS: 0})


def _mark_read_by(x, streams: dict) -> None:
    """Hand the outputs of a shard's stream to the caller's stream."""
    if isinstance(x, (tuple, list)):
        for xi in x:
            _mark_read_by(xi, streams)
    elif isinstance(x, Tensor) and x.device.type == "cuda":
        x.record_stream(streams[x.device])


_linalg_lock = threading.Lock()
_linalg_loaded = False


def _load_cuda_linalg() -> None:
    """Load PyTorch's CUDA linear-algebra library from the calling thread.
    Its first call swaps in the real kernels and may run only once: two shard
    threads making the first call (the develop's matrix inverse) at once
    fail with "lazy wrapper should be called at most once"."""
    global _linalg_loaded
    with _linalg_lock:
        if not _linalg_loaded:
            torch.linalg.inv(torch.eye(1, device="cuda"))
            _linalg_loaded = True


def shard_map(fn: Callable, mesh: Mesh, in_specs, out_specs):
    """``fn`` mapped over ``mesh``: the returned callable splits its arguments
    by ``in_specs`` (one spec, or a tuple of specs for a tuple argument, for
    each argument; None arguments pass through), runs ``fn`` on every
    position's pieces in a thread of its own and gathers the results by
    ``out_specs`` (a spec, or a tuple of specs for a tuple result) onto the
    mesh's first device."""
    in_specs = tuple(in_specs)

    def run(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} arguments for {len(in_specs)} in_specs")
        n_b, n_sp = mesh.shape[BATCH_AXIS], mesh.shape[SPATIAL_AXIS]
        timeout = BARRIER_TIMEOUT
        rv = _Rendezvous(mesh.size, timeout)
        shards = [_Shard(mesh, b, s, rv) for b in range(n_b) for s in range(n_sp)]
        inputs = [_to(_split(args, in_specs, sh.position, mesh), sh.device) for sh in shards]
        if any(sh.stream is not None for sh in shards):
            _load_cuda_linalg()
        for sh in shards:
            if sh.stream is not None:
                sh.stream.wait_stream(torch.cuda.current_stream(sh.device))
        results, errors = [None] * len(shards), [None] * len(shards)

        def work(i: int) -> None:
            shard, done = shards[i], False
            _local.shard = shard
            try:
                with shard.context():
                    results[i] = fn(*inputs[i])
                done = True
            except Exception as exc:  # handed to the caller below, named
                errors[i] = exc
            finally:
                _local.shard = None
                if not done:
                    rv.barrier.abort()

        threads = [threading.Thread(target=work, args=(i,), name=f"shard-{i}", daemon=True)
                   for i in range(len(shards))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        caller = {}
        for sh in shards:
            if sh.stream is not None:
                caller.setdefault(sh.device, torch.cuda.current_stream(sh.device))
                caller[sh.device].wait_stream(sh.stream)
        failed = [(i, e) for i, e in enumerate(errors) if e is not None]
        if failed:
            real = [(i, e) for i, e in failed if not isinstance(e, threading.BrokenBarrierError)]
            i, exc = (real or failed)[0]
            if not real:
                exc = TimeoutError(f"a collective's rendezvous was not complete within "
                                   f"{timeout} s")
            raise ShardError(i, shards[i].position, exc) from errors[i]
        for out in results:
            _mark_read_by(out, caller)
        return _gather(out_specs, results, mesh, mesh.devices[0])

    return run


__all__ = [
    "P",
    "ShardError",
    "all_gather",
    "axis_index",
    "axis_size",
    "pmax",
    "pmean",
    "pmin",
    "ppermute",
    "psum",
    "shard_map",
]
