"""The fused GEMV+AllReduce and its companions on ``torch.distributed``.

Port of ``repro/distributed/collectives.py``.  The reference builds each
function with ``shard_map`` over a mesh axis; here every function is called
by each rank of a process group with that rank's shard, and returns what the
reference's per-device body returns on that device.

``fused_gemv_allreduce`` is the paper's measured kernel (Fig. 3): the
reduction dim of ``y = x @ w`` is sharded; each rank computes its partial
output in row tiles issued remote-first (``kernels.gemv_tiles``), then a ring
reduce-scatter leaves rank r with the fully reduced tile r, and an all-gather
of the owned tiles gives every rank the whole product.  ``psum_matmul`` is
the unfused baseline: the local product (``kernels.gemv``), then
``all_reduce``.

Where the exchange happens follows from the group's backend: gloo takes only
host tensors, so for a gloo group each exchanged tensor is copied to the host
and the result back to the tensor's device, explicitly; any other backend
exchanges on the tensor's own device.  The arithmetic (the products and the
ring's additions) always runs on the tensors' device.

The sharded substrate's exchanges follow the same rule.  They take a bound
mesh (``launch/mesh.py``) and the axes to exchange over, and do nothing where
this rank is alone along them.  The differentiable ones are the
tensor-parallel regions' pairs, each the other's transpose:
:func:`copy_in` (identity; backward all-reduce) at the entry of a region
where each rank computes a part, :func:`reduce_out` (all-reduce; backward
identity) at its exit, :func:`gather` (all-gather; backward this rank's
slice, or with ``partial`` a reduce-scatter) and :func:`split` (this rank's
slice; backward all-gather), and
:func:`all_to_all` (backward: the exchange back).  ``EXCHANGED`` adds up, by
collective, the bytes of the buffers this rank hands to them.

Every exchange passes through ``_all_reduce``, ``_all_gather``,
``_reduce_scatter``, ``_all_to_all`` or ``_ring_shift``, and each reports what it is handed to
the active ``core.capture.capture_collectives`` with its group's size and
mesh axes (``Mesh.bind`` names its groups' axes here).  A
``core.capture.CaptureGroup`` (``Mesh.bind_abstract``: a rank with no world)
takes the same path but for the exchange itself: the op is recorded and the
result is a copy of the right shape and dtype, on the tensor's own device.
A real process group is never a ``CaptureGroup``, so it always exchanges.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable

import torch
import torch.distributed as dist

from ..core.capture import CaptureGroup, record
from ..kernels import ops

__all__ = [
    "psum_matmul",
    "fused_gemv_allreduce",
    "ring_allreduce",
    "compressed_psum",
    "overlap_grad_allreduce",
    "copy_in",
    "reduce_out",
    "gather",
    "split",
    "all_to_all",
    "raw_all_reduce",
    "raw_all_gather",
    "EXCHANGED",
]

EXCHANGED: Counter = Counter()  # bytes handed to each collective by this rank
_GROUP_AXES: dict = {}  # process group -> the mesh axes it spans (Mesh.bind)


def name_group(group, axes) -> None:
    """Record that process ``group`` spans the mesh ``axes`` (for the capture)."""
    _GROUP_AXES[group] = tuple(axes)


def _size(group) -> int:
    return group.size if isinstance(group, CaptureGroup) else dist.get_world_size(group)


def _rank(group) -> int:
    return group.rank if isinstance(group, CaptureGroup) else dist.get_rank(group)


def _count(name: str, t: torch.Tensor, group) -> None:
    """Count and record that this rank hands ``t`` to exchange ``name``."""
    EXCHANGED[name] += t.numel() * t.element_size()
    axes = group.axes if isinstance(group, CaptureGroup) else _GROUP_AXES.get(group, ())
    record(name, t, _size(group), axes)


def exchange_device(t: torch.Tensor, group=None) -> torch.device:
    """The host for a gloo group, else ``t``'s own device (a capture group's
    too: nothing leaves it)."""
    if isinstance(group, CaptureGroup):
        return t.device
    return torch.device("cpu") if dist.get_backend(group) == "gloo" else t.device


def _peer(group, group_rank: int) -> int:
    """The global rank of ``group_rank`` (P2P ops address global ranks)."""
    return group_rank if group is None else dist.get_global_rank(group, group_rank)


def _all_reduce(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    buf = t.detach().to(exchange_device(t, group), copy=True)
    _count("all_reduce", buf, group)
    if isinstance(group, CaptureGroup):
        return buf
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(t.device)


def _all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` stacked in rank order: ``[world, *t.shape]``."""
    src = t.detach().to(exchange_device(t, group)).contiguous()
    _count("all_gather", src, group)
    if isinstance(group, CaptureGroup):
        return src.unsqueeze(0).expand(group.size, *src.shape).clone()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(t.device)


def _reduce_scatter(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The sum of every rank's ``t`` over the group, this rank's chunk of it
    along ``dim``."""
    src = t.detach().to(exchange_device(t, group)).contiguous()
    _count("reduce_scatter", src, group)
    if isinstance(group, CaptureGroup):
        return _own(src, group, dim).clone()
    chunks = [c.contiguous() for c in src.chunk(dist.get_world_size(group), dim=dim)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    return out.to(t.device)


def _all_to_all(t: torch.Tensor, group=None) -> torch.Tensor:
    """Chunk i of ``t [world, ...]`` goes to rank i; chunk i of the result
    came from rank i (``all_to_all`` with split and concat axis 0)."""
    src = t.detach().to(exchange_device(t, group)).contiguous()
    _count("all_to_all", src, group)
    if isinstance(group, CaptureGroup):
        return src.clone()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(t.device)


def _ring_shift(t: torch.Tensor, group=None, offset: int = 1) -> torch.Tensor:
    """Send ``t`` to rank + offset and return what rank - offset sent
    (``ppermute`` i -> i+1 for the offset 1; -1 is its reverse)."""
    send = t.detach().to(exchange_device(t, group)).contiguous()
    _count("ring_shift", send, group)
    if isinstance(group, CaptureGroup):
        return send.clone()
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, _peer(group, (rank + offset) % n), group),
        dist.P2POp(dist.irecv, recv, _peer(group, (rank - offset) % n), group),
    ])
    for req in reqs:
        req.wait()
    return recv.to(t.device)


def psum_matmul(x: torch.Tensor, w: torch.Tensor, group=None) -> torch.Tensor:
    """``y = AllReduce(x_shard @ w_shard)``: the unfused two-step baseline.

    x: the rank's [B, K / n] slice, w: its [K / n, N] slice; returns [B, N]
    in w's dtype.  The local product is ``kernels.gemv(w.T, x.T)``: a view of
    w and a small copy of x, so the weight shard is never copied.
    """
    y = ops.gemv(w.T, x.T.contiguous()).T.contiguous()
    return _all_reduce(y, group)


def fused_gemv_allreduce(x: torch.Tensor, w: torch.Tensor, group=None):
    """Fused GEMV+AllReduce; returns ``(y [B, N], owner_served)``.

    x: the rank's [B, K / n] slice, w: its [K / n, N] slice, N divisible by
    the world size n.  The partial products go through ``kernels.gemv_tiles``
    in remote-first owner order (``owner_served`` is its schedule).  Then the
    reference's ring reduce-scatter: at step k rank r adds its partial of
    tile ``(r - k - 1) mod n`` to what it received, in the output dtype, and
    sends the sum to rank r + 1; after n - 1 steps it adds its own partial of
    tile r, and an all-gather of the owned tiles gives y.  Values equal
    :func:`psum_matmul`'s up to the order of the additions.
    """
    n, r = _size(group), _rank(group)
    B = x.shape[0]
    yt, owner_served = ops.gemv_tiles(w.T, x.T.contiguous(), n_dev=n, my_dev=r)  # [N, B]
    N = yt.shape[0]
    if N % n:
        raise ValueError(f"fused_gemv_allreduce needs N divisible by the world size, "
                         f"got N = {N}, world {n}")
    tiles = yt.view(n, N // n, B)  # tiles[t] = y[:, t * N/n:(t + 1) * N/n].T
    acc = torch.zeros_like(tiles[0])
    for k in range(n - 1):
        acc = _ring_shift(acc + tiles[(r - k - 1) % n], group)
    mine = acc + tiles[r]  # the fully reduced tile r
    y = _all_gather(mine, group).reshape(N, B).T.contiguous()
    return y, owner_served


def ring_allreduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Naive ring all-reduce: n - 1 shifts to rank + 1, each added to the sum."""
    acc, cur = x, x
    for _ in range(_size(group) - 1):
        cur = _ring_shift(cur, group)
        acc = acc + cur
    return acc


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-quantized all-reduce with a shared per-tensor scale.

    ``scale = max over ranks of max|x| / 127``; ``q = round(x / scale)``
    (half to even, as ``jnp.round``) clipped to [-127, 127] and summed in
    int32 across ranks; returns ``sum * scale`` in x's dtype.  The
    reference's ``bits`` argument takes only 8, so the port has none.
    """
    x32 = x.float()
    amax = _all_reduce(x32.abs().max().reshape(1), group, op=dist.ReduceOp.MAX)
    scale = torch.clamp(amax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int32)
    total = _all_reduce(q, group)
    return (total.float() * scale).to(x.dtype)


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def overlap_grad_allreduce(grads, group=None, *, compress: bool = False):
    """Sum every leaf of ``grads`` (dicts, lists and tuples of tensors) over the
    group, leaf by leaf, optionally through :func:`compressed_psum`."""
    if compress:
        return _tree_map(lambda g: compressed_psum(g, group), grads)
    return _tree_map(lambda g: _all_reduce(g, group), grads)


# ---------------------------------------------------------------------------
# the sharded substrate's exchanges over the axes of a bound mesh
# ---------------------------------------------------------------------------


def raw_all_reduce(t: torch.Tensor, mesh, axes, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce over the mesh's ``axes`` (no autograd); ``t`` itself where
    this rank is alone along them."""
    group = mesh.group(axes)
    return t if group is None else _all_reduce(t, group, op)


def raw_all_gather(t: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """The chunks of every rank along ``axes`` joined on ``dim`` in order (no
    autograd)."""
    group = mesh.group(axes)
    if group is None:
        return t
    parts = _all_gather(t, group)
    return torch.cat(parts.unbind(0), dim=dim)


def _own(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    step = t.shape[dim] // _size(group)
    return t.narrow(dim, _rank(group) * step, step)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return torch.cat(_all_gather(x, group).unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.group, ctx.dim).contiguous(), None, None


class _GatherPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return torch.cat(_all_gather(x, group).unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _own(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(_all_gather(g, ctx.group).unbind(0), dim=ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def copy_in(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``axes``: the entry of a
    region where each rank along them computes a part of what follows."""
    group = mesh.group(axes)
    return x if group is None else _CopyIn.apply(x, group)


def reduce_out(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of ``x`` over ``axes``; the gradient passes as it is: the exit
    of a partitioned region, into compute that every rank repeats."""
    group = mesh.group(axes)
    return x if group is None else _ReduceOut.apply(x, group)


def gather(x: torch.Tensor, mesh, axes, dim: int = 0, *, partial: bool = False) -> torch.Tensor:
    """Every rank's ``x`` along ``axes`` joined on ``dim``; the gradient is
    this rank's slice (what follows is the same on every rank), or with
    ``partial`` (each rank along ``axes`` uses a part of the whole) the sum
    of every rank's gradient, this rank's slice of it: one reduce-scatter."""
    group = mesh.group(axes)
    if group is None:
        return x
    return (_GatherPartial if partial else _Gather).apply(x, group, dim)


def split(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """This rank's slice of ``x`` on ``dim`` (the same ``x`` on every rank
    along ``axes``); the gradient is every rank's slice joined."""
    group = mesh.group(axes)
    return x if group is None else _Split.apply(x, group, dim)


def all_to_all(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Chunk i of ``x [n, ...]`` to the i-th rank along ``axes``; the
    gradient goes back the same way."""
    group = mesh.group(axes)
    return x if group is None else _AllToAll.apply(x, group)
