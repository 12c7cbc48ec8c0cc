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
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..kernels import ops

__all__ = [
    "psum_matmul",
    "fused_gemv_allreduce",
    "ring_allreduce",
    "compressed_psum",
    "overlap_grad_allreduce",
]


def exchange_device(t: torch.Tensor, group=None) -> torch.device:
    """The host for a gloo group, else ``t``'s own device."""
    return torch.device("cpu") if dist.get_backend(group) == "gloo" else t.device


def _peer(group, group_rank: int) -> int:
    """The global rank of ``group_rank`` (P2P ops address global ranks)."""
    return group_rank if group is None else dist.get_global_rank(group, group_rank)


def _all_reduce(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    buf = t.detach().to(exchange_device(t, group), copy=True)
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(t.device)


def _all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` stacked in rank order: ``[world, *t.shape]``."""
    src = t.detach().to(exchange_device(t, group)).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(t.device)


def _ring_shift(t: torch.Tensor, group=None) -> torch.Tensor:
    """Send ``t`` to rank + 1 and return what rank - 1 sent (``ppermute`` i -> i+1)."""
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    send = t.detach().to(exchange_device(t, group)).contiguous()
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, _peer(group, (rank + 1) % n), group),
        dist.P2POp(dist.irecv, recv, _peer(group, (rank - 1) % n), group),
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
    n, r = dist.get_world_size(group), dist.get_rank(group)
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
    for _ in range(dist.get_world_size(group) - 1):
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
