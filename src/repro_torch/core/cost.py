"""The costs of one rank's traced step (port of ``repro/core/hlo_analyzer.py``).

The reference reads a step's FLOPs and bytes out of XLA's compiled HLO (with
its own trip counts for ``while`` bodies).  The port's step is eager Python:
:func:`count_cost` runs it under dispatch modes that see every aten op it
issues, forward and backward, on real tensors or on the dry run's ``meta``
tensors (``Model.abstract``), and counts:

- **dot FLOPs** through ``torch.utils.flop_counter.FlopCounterMode`` (the
  products: ``mm``, ``bmm``, ``addmm``, attention, convolution), with a
  formula added for ``aten._grouped_mm``, which its table lacks:
  2 · rows · K · N, rows the padded row count of the first operand (every
  row, also those past the last offset), as the card computes them.  The
  kernels' operators (``repro_torch::rmsnorm`` and its backward) are given
  a formula of 0: they do no products, as XLA's dot count does not count
  ``rms_norm``; nor do ``repro_torch::decode_attention`` and its partial
  entry, which XLA's dot count does see (the reference's decode attends in
  einsums), so a decode cell's attention products are not in the port's
  dot FLOPs.  ``repro_torch::mamba_decode`` is given the products of the
  plain decode it replaces, the conv window's taps and the state's read
  (2 · B · (K · C + H · d_head · d_state)), so a decode cell's dot FLOPs are
  the same on either path;
- **bytes**: the operands plus the results of each aten op, the eager
  port's HBM traffic at one kernel an op, where the reference's is XLA's
  proxy.  A view, an allocation and an op whose results only alias its
  inputs move nothing; a gather counts its whole table;
- **argument bytes**: the tensors handed in as the step's arguments
  (parameters, optimizer state, inputs), from their shapes;
- **peak live bytes**: the arguments plus every storage an op makes, each
  from its making to its release (a weak reference on the storage), at its
  largest (torch's own ``MemTracker`` is private API, and the port needs
  only this sum);
- **output bytes**: the storages of the step's outputs that are not
  arguments;
- **kernel calls**: the calls to each of the port's kernels, one a call of
  its operators (``decode_attention_partial`` is an entry of the
  ``decode_attention`` kernel and counts as one of its calls).

The port's loops run in Python, so every iteration is counted: there is no
``while``-trip problem.
"""

from __future__ import annotations

import contextlib
import weakref
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

# importing the kernels' modules registers their operators
from ..kernels import decode_attention as _attention  # noqa: F401
from ..kernels import mamba_decode as _mamba  # noqa: F401
from ..kernels import rmsnorm as _rmsnorm  # noqa: F401

__all__ = ["StepCost", "count_cost", "output_bytes", "grouped_mm_flop", "mamba_decode_flop",
           "tensor_bytes"]

KERNEL_NAMESPACE = "repro_torch"
KERNEL_OF = {"decode_attention_partial": "decode_attention"}  # operator -> its kernel

_ALLOCATIONS = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
                torch.ops.aten.empty_strided.default, torch.ops.aten.new_empty.default,
                torch.ops.aten.new_empty_strided.default}


def tensor_bytes(tensors: Iterable) -> int:
    """The bytes of every tensor in ``tensors`` (numel times element size)."""
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def grouped_mm_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """FLOPs of ``aten._grouped_mm(a, b, offs)``: 2 · M · K · N summed over the
    groups, every row of ``a`` counted (the padded count).  2D x 3D: rows of
    a against each group's [K, N]; 2D x 2D: the groups cut K; 3D x 2D: the
    groups cut N; 3D x 3D: a batch of products."""
    if len(a_shape) == 2 and len(b_shape) == 3:
        return 2 * a_shape[0] * a_shape[1] * b_shape[2]
    if len(a_shape) == 2 and len(b_shape) == 2:
        return 2 * a_shape[0] * a_shape[1] * b_shape[1]
    if len(a_shape) == 3 and len(b_shape) == 2:
        return 2 * a_shape[1] * a_shape[2] * b_shape[1]
    return 2 * a_shape[0] * a_shape[1] * a_shape[2] * b_shape[2]


def _no_dot(*args, out_shape=None, **kwargs) -> int:
    return 0


def mamba_decode_flop(proj_shape, conv_shape, h_shape, conv_w_shape, *args, out_shape=None,
                      **kwargs) -> int:
    """The products of the plain Mamba2 decode that ``repro_torch::mamba_decode``
    replaces: the window's ``einsum("bkc,kc->bc")`` and the state's read
    ``einsum("bhds,bs->bhd")``."""
    B, H, dh, ds = h_shape
    K, C = conv_w_shape
    return 2 * B * (K * C + H * dh * ds)


@dataclass
class StepCost:
    dot_flops: int = 0
    bytes: int = 0
    ops: int = 0
    argument_bytes: int = 0
    peak_live_bytes: int = 0
    output_bytes: int = 0
    kernel_calls: Dict[str, int] = field(default_factory=dict)


class _Live:
    """Bytes of the storages alive, by storage; each released by a weak
    reference's callback."""

    def __init__(self):
        self.bytes = self.peak = 0
        self._refs: Dict[int, weakref.ref] = {}

    def add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._refs:
            return
        n = st.nbytes()
        self._refs[key] = weakref.ref(st, lambda _, key=key, n=n: self._release(key, n))
        self.bytes += n
        self.peak = max(self.peak, self.bytes)

    def _release(self, key: int, n: int) -> None:
        if self._refs.pop(key, None) is not None:
            self.bytes -= n


class _CostMode(TorchDispatchMode):
    def __init__(self, cost: StepCost, live: _Live, calls: Counter):
        super().__init__()
        self.cost, self.live, self.calls = cost, live, calls

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.cost.ops += 1
        if func.namespace == KERNEL_NAMESPACE:
            self.calls[KERNEL_OF.get(func._opname, func._opname)] += 1
        ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        in_storages = {t.untyped_storage()._cdata for t in ins}
        aliases = not func._schema.is_mutable and all(
            t.untyped_storage()._cdata in in_storages for t in outs)
        if not (func.is_view or func in _ALLOCATIONS or aliases):
            self.cost.bytes += tensor_bytes(ins) + tensor_bytes(outs)
        for t in outs:
            self.live.add(t)
        return out


@contextlib.contextmanager
def count_cost(arguments: Iterable[torch.Tensor] = ()) -> Iterator[StepCost]:
    """Count the costs (the module's list) of what runs within it; the
    yielded :class:`StepCost` is complete on leaving (but ``output_bytes``,
    which :func:`output_bytes` gives).  ``arguments``: the step's argument
    tensors."""
    cost, live, calls = StepCost(), _Live(), Counter()
    for t in arguments:
        live.add(t)
    cost.argument_bytes = live.bytes
    custom = {torch.ops.aten._grouped_mm: grouped_mm_flop,
              torch.ops.repro_torch.rmsnorm: _no_dot,
              torch.ops.repro_torch.rmsnorm_bwd: _no_dot,
              torch.ops.repro_torch.decode_attention: _no_dot,
              torch.ops.repro_torch.decode_attention_partial: _no_dot,
              torch.ops.repro_torch.mamba_decode: mamba_decode_flop}
    flops = FlopCounterMode(display=False, custom_mapping=custom)
    with flops, _CostMode(cost, live, calls):
        yield cost
    cost.dot_flops = flops.get_total_flops()
    cost.peak_live_bytes = live.peak
    cost.kernel_calls = dict(calls)


def output_bytes(out, arguments: Iterable[torch.Tensor] = ()) -> int:
    """The bytes of the storages of the tensors in ``out`` that are not
    those of ``arguments``, each storage once."""
    seen = {t.untyped_storage()._cdata for t in arguments}
    n = 0
    for t in tree_flatten(out)[0]:
        if isinstance(t, torch.Tensor) and t.untyped_storage()._cdata not in seen:
            seen.add(t.untyped_storage()._cdata)
            n += t.untyped_storage().nbytes()
    return n
