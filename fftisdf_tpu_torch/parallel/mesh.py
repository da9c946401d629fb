"""The device mesh of the port: one process per device on a process group.

Counterpart of ``fftisdf_tpu/parallel/mesh.py``.  The JAX package is one
program over a ``Mesh`` of devices (axis ``"d"``) whose sharding
constraints XLA turns into collectives.  Here each rank is a process
(``torchrun`` or :func:`fftisdf_tpu_torch.parallel.dryrun.spawn` starts
them), all run the same Python, and the collectives are explicit calls on
the mesh's process group.  Axis ``"d"`` is the rank.

Layouts are index helpers, not sharding objects: :func:`split` says which
contiguous block of an axis (grid points, canonical sectors, images, rows)
a rank owns; blocks may be uneven, so no axis is padded.

Collectives carry complex tensors as their ``torch.view_as_real`` float
views (NCCL has no complex type).  The mesh never changes backend or
device on its own: gloo takes every collective it calls (all-reduce,
broadcast, all-to-all) on CUDA tensors as well, which serves several
ranks on one card, where NCCL refuses.
"""
from __future__ import annotations

import os
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from fftisdf_tpu_torch.utils.device import resolve_device

def split(n, size):
    """Offsets (size + 1,) of the balanced contiguous split of ``n`` items
    over ``size`` ranks: rank r owns [off[r], off[r + 1])."""
    base, extra = divmod(int(n), int(size))
    counts = [base + (r < extra) for r in range(size)]
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


class DeviceMesh:
    """A 1D mesh (axis ``"d"``) over the ranks of a process group.

    ``rank``/``size`` are the rank's place in the group, ``device`` its
    ``torch.device``.  The collective methods take and return tensors on
    ``device`` in any dtype, complex included.  ``a2a_bytes`` and
    ``a2a_s`` count the bytes this rank sent and the seconds it spent in
    all-to-all exchanges (the exchange waits for the device before its
    clock stops)."""

    axis_names = ("d",)

    def __init__(self, group, device, backend):
        self.group = group
        self.device = device
        self.backend = backend
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.a2a_bytes = 0
        self.a2a_s = 0.0

    def owned(self, n):
        """This rank's [start, stop) of an axis of ``n`` items."""
        off = split(n, self.size)
        return int(off[self.rank]), int(off[self.rank + 1])

    # ---------------------------------------------------------- helpers
    @staticmethod
    def _flat(t):
        """Contiguous real 1-D view of ``t`` (a complex tensor's float
        pairs)."""
        t = t.resolve_conj().contiguous()
        return (torch.view_as_real(t) if t.is_complex() else t).reshape(-1)

    # ------------------------------------------------------ collectives
    def all_reduce(self, t):
        """Sum of ``t`` over the ranks (a new tensor)."""
        out = self._flat(t.clone())
        dist.all_reduce(out, group=self.group)
        return (torch.view_as_complex(out.view(*t.shape, 2))
                if t.is_complex() else out.view(t.shape))

    def broadcast(self, t, src=0):
        """``t`` of rank ``src`` on every rank; ``t`` gives the shape and
        dtype elsewhere (a new tensor)."""
        out = self._flat(t.clone())
        dist.broadcast(out, src=dist.get_global_rank(self.group, src)
                       if self.group is not None else src, group=self.group)
        return (torch.view_as_complex(out.view(*t.shape, 2))
                if t.is_complex() else out.view(t.shape))

    def exchange(self, pieces, recv_shapes):
        """All-to-all: ``pieces[j]`` (any shape) goes to rank j, and the
        list of what each rank j sent here comes back, shaped
        ``recv_shapes[j]``.  One ``all_to_all_single`` on the flat real
        views.  A mesh of one rank returns its own piece: the copy would
        double the chunk's planes for nothing."""
        if self.size == 1:
            return [pieces[0].reshape(recv_shapes[0])]
        t0 = time.perf_counter()
        ref = pieces[self.rank]
        cplx = ref.is_complex()
        send = torch.cat([self._flat(p) for p in pieces])
        per = 2 if cplx else 1
        s_counts = [int(p.numel()) * per for p in pieces]
        r_counts = [int(np.prod(s)) * per for s in recv_shapes]
        recv = torch.empty(sum(r_counts), dtype=send.dtype,
                           device=send.device)
        dist.all_to_all_single(recv, send, output_split_sizes=r_counts,
                               input_split_sizes=s_counts, group=self.group)
        del send
        if recv.device.type == "cuda":
            torch.cuda.synchronize(recv.device)
        self.a2a_bytes += (sum(s_counts) - s_counts[self.rank]) \
            * recv.element_size()
        self.a2a_s += time.perf_counter() - t0
        out = []
        for piece, shape in zip(recv.split(r_counts), recv_shapes):
            out.append(torch.view_as_complex(piece.view(*shape, 2)) if cplx
                       else piece.view(shape))
        return out

    def all_gather(self, t, counts):
        """Concatenation along axis 0 of every rank's ``t``, rank r's
        holding ``counts[r]`` rows (an exchange that sends ``t`` to
        everyone)."""
        if self.size == 1:
            return t
        shapes = [(int(c),) + tuple(t.shape[1:]) for c in counts]
        return torch.cat(self.exchange([t] * self.size, shapes))


def check_mesh(mesh):
    """``mesh`` itself when it is None or a :class:`DeviceMesh`; TypeError
    otherwise (the JAX package's ``jax.sharding.Mesh`` does not serve
    here)."""
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"expected a parallel.mesh.DeviceMesh (from "
                        f"make_device_mesh), got {type(mesh).__name__}")
    return mesh


def _local_rank():
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def resolve_device_backend(device=None, backend=None):
    """(device, backend) of a rank: ``cuda`` with ``nccl`` unless the
    caller names others (raises without CUDA: nothing falls back to the
    CPU); ``"gloo"`` is the default on the CPU, and gloo on CUDA devices
    is allowed.  The device's index is left for :func:`make_device_mesh`
    to fill in from the local rank."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_device_mesh: CUDA is not available; "
                               "pass device='cpu' to build a host mesh")
        device = "cuda"
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs CUDA devices")
    return dev, backend


def make_device_mesh(n_devices=None, *, backend=None, device=None,
                     init_method=None):
    """The mesh over the first ``n_devices`` ranks (all when None).

    ``device``: the rank's device, ``cuda:<local rank>`` by default (raises
    without CUDA: nothing falls back to the CPU); ``"cpu"`` runs on the
    host.  ``backend``: ``"nccl"`` by default on CUDA and ``"gloo"`` on the
    CPU; gloo on CUDA devices is allowed (it serves several ranks on one
    card, which NCCL refuses).

    When no process group exists one is made from ``init_method``
    (``env://`` by default: the RANK / WORLD_SIZE / MASTER_ADDR /
    MASTER_PORT that ``torchrun`` sets).  A group whose backend differs
    from ``backend`` gets a subgroup of that backend.  Every rank of the
    default group must call this; a rank outside the first ``n_devices``
    gets None."""
    dev, backend = resolve_device_backend(device, backend)
    if not dist.is_initialized():
        dist.init_process_group(backend=backend,
                                init_method=init_method or "env://",
                                timeout=timedelta(minutes=30))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _local_rank() % torch.cuda.device_count())
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"n_devices={n_devices} outside 1..{world}")
    group = None
    if n < world or dist.get_backend() != backend:
        group = dist.new_group(ranks=list(range(n)), backend=backend)
    if dist.get_rank() >= n:
        return None
    return DeviceMesh(group, dev, backend)


# ------------------------------------------------- collectives in autograd
# The sharded differentiable state (``isdf.autodiff.isdf_state_fn(
# dev_mesh=)``) runs its loss on every rank alike.  A replicated tensor
# enters the ranks' shares of the work through :func:`enter` (whose
# backward sums the shares' gradients over the ranks), the grid-split RHS
# goes to the sector split through :func:`grid_to_sector` (whose backward
# is the reverse exchange), and the ranks' sectors leave through
# :func:`gather_rows` (whose backward keeps this rank's rows of a gradient
# that every rank holds alike).  Every rank must build the same graph of
# these calls, so that the backward passes meet in the same collectives.
class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g), None


class _GridToSector(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mesh, q_off, g_off):
        ctx.mesh, ctx.q_off, ctx.g_off = mesh, q_off, g_off
        return _grid_to_sector(y, mesh, q_off, g_off)

    @staticmethod
    def backward(ctx, g):
        mesh, q_off, g_off = ctx.mesh, ctx.q_off, ctx.g_off
        r, size = mesh.rank, mesh.size
        tail = tuple(g.shape[2:])
        recv = mesh.exchange(
            [g[:, g_off[j]:g_off[j + 1]] for j in range(size)],
            [(q_off[j + 1] - q_off[j], g_off[r + 1] - g_off[r]) + tail
             for j in range(size)])
        return torch.cat(recv), None, None, None


def _grid_to_sector(y, mesh, q_off, g_off):
    r, size = mesh.rank, mesh.size
    tail = tuple(y.shape[2:])
    recv = mesh.exchange(
        [y[q_off[j]:q_off[j + 1]] for j in range(size)],
        [(q_off[r + 1] - q_off[r], g_off[j + 1] - g_off[j]) + tail
         for j in range(size)])
    return torch.cat(recv, dim=1)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, counts):
        ctx.mesh, ctx.off = mesh, np.concatenate([[0], np.cumsum(counts)])
        return mesh.all_gather(t, counts)

    @staticmethod
    def backward(ctx, g):
        r = ctx.mesh.rank
        return g[int(ctx.off[r]):int(ctx.off[r + 1])], None, None


def enter(t, mesh):
    """``t`` (replicated) as the input of this rank's share of a sum over
    the ranks: the identity, whose backward all-reduces the gradient."""
    return t if mesh is None or mesh.size == 1 else _Enter.apply(t, mesh)


def grid_to_sector(y, mesh, q_off, g_off):
    """(nq, ngrid_loc, ...) with this rank's grid points [g_off[r],
    g_off[r + 1]) -> (nq_loc, ngrid, ...) with its sectors [q_off[r],
    q_off[r + 1]): one exchange, differentiable."""
    if mesh is None or mesh.size == 1:
        return y
    return _GridToSector.apply(y, mesh, q_off, g_off)


def gather_rows(t, mesh, counts):
    """Every rank's ``t`` (rank r's holding ``counts[r]`` rows)
    concatenated on every rank, differentiable."""
    if mesh is None or mesh.size == 1:
        return t
    return _GatherRows.apply(t, mesh, [int(c) for c in counts])
