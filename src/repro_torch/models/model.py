"""Model assembly: layer-stack plans, blocks, forward / prefill / decode
(port of ``repro.models.model``).

``build_plan`` gives the reference's stages (``scan`` of homogeneous layers,
``single``, ``shared``).  The reference stacks a scan stage's parameters on a
leading ``layers`` dim; the port keeps one block module per layer in an
``nn.ModuleList`` (:class:`DenseBlock`, :class:`MoEBlock`,
:class:`MambaBlock`, :class:`XLSTMBlock`), and ``models/convert.py`` unstacks
the reference's tree.  zamba2's shared dense block is one module,
``Model.shared``, kept once as the reference keeps ``params["shared"]`` and
applied after each group of Mamba layers.  :func:`layer_blocks` walks the
plan as the reference's ``_layer_blocks`` does, one entry per applied block
(zamba2-2.7b: 63, of which 9 are the shared block); the entry index is what
the caches and ``is_global_attn`` receive.  ``forward``, ``prefill`` and
``decode_step`` walk the entries in a Python loop; ``prefill`` and
``decode_step`` run under ``torch.no_grad()``, ``forward`` records for
autograd, and ``loss_fn`` is the reference's training loss on it.  Remat
(the reference's ``jax.checkpoint`` around each scanned block under a named
policy) is ``distributed/remat.py``'s ``maybe_remat`` around each entry.

A model bound to a mesh (``distributed.sharding.shard_params``) holds each
rank's parameter shards and computes on this rank's batch rows: attention
and MLP tensor-parallel where their specs allow (``models/attention.py``,
``models/mlp.py``), MoE expert-parallel where ``ep_applicable``
(``models/moe_ep.py``), a vocab-parallel embedding (a masked lookup in the
rank's vocabulary slice, summed over ``model``) and head, and a
vocab-parallel cross-entropy whose [B, S] statistics are summed over
``model``, so no rank holds [B, S, vocab] logits.  The loss is the whole
batch's on every rank: each rank's gradients are its rows' part, for the
train step to sum over the batch axes.  Mamba2 blocks, mLSTM cells and MLA
attention compute the rank's heads where ``model`` divides them
(``models/ssm.py``, ``models/xlstm.py``, ``models/attention.py``); sLSTM
cells, and blocks whose heads ``model`` does not divide, run whole on every
rank from gathered weights (:meth:`Model.unpartitioned` lists them).

Serving runs under a mesh too.  A batch's rows are cut over the batch axes
where they divide it, else every rank holds every row
(``distributed.sharding.rows_spec``); :meth:`Model.cache_specs` places each
cache tensor (``cache_leaf_spec``: rows, KV heads over ``model`` under
head-parallel attention, MLA latents' slots over ``model``, the slots over
``data`` where the rows are not cut, and a head-parallel block's recurrent
state over ``model`` on its heads).  :meth:`Model.init_caches`,
:meth:`Model.abstract_caches` and ``prefill`` give this rank's shards as a
:class:`Caches` list that carries those specs and the ``w_k`` / ``w_v``
columns its head-parallel attention reads (``attention.kv_columns``,
gathered once for the batch), and ``decode_step`` reads them: each block decodes with its norms through ``_Block.norm``, its
attention head-parallel and, over a cut cache, sequence-parallel
(``models/attention.py``), its MLP and MoE as in ``forward`` (the MoE's
expert-parallel gather path at decode), its recurrence on its heads, and
the logits gathered over ``model`` where the head is vocab-parallel.

:meth:`Model.abstract` builds the model on the ``meta`` device: parameters
with their shapes and dtypes and no data, the counterpart of the reference's
``Model.abstract_params``.  The dry run (``launch/dryrun.py``) traces a
rank's step on it; nothing can compute on it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.distributed
from torch import nn

from .. import tracing
from ..device import resolve_device
from ..distributed.collectives import copy_in, raw_all_gather, raw_all_reduce, reduce_out
from ..distributed.remat import POLICIES, maybe_remat
from ..distributed.sharding import (CACHE_DEVIATIONS, cache_leaf_spec, param_shardings,
                                   shard_params, shard_tensor, use_full, use_params)
from .attention import (attention_apply, attention_decode, attention_specs, head_parallel,
                        init_kv_cache, kv_columns, kv_heads_read)
from .common import ModelConfig, ParamSpec, count_params, fill_, rms_norm
from .mlp import col_parallel, mlp_apply, mlp_specs
from .moe import moe_apply, moe_specs
from .moe_ep import ep_applicable, ep_specs, moe_apply_ep
from .ssm import init_ssm_state, mamba_apply, mamba_decode, mamba_head_parallel, mamba_specs
from .xlstm import (init_mlstm_state, init_slstm_state, mlstm_apply, mlstm_decode,
                    mlstm_head_parallel, mlstm_specs, slstm_apply, slstm_decode, slstm_specs)

__all__ = ["Stage", "build_plan", "layer_blocks", "DenseBlock", "MoEBlock", "MambaBlock",
           "XLSTMBlock", "Model", "Caches", "param_specs", "init_caches", "cache_specs",
           "decode_launches"]

AUX_KEYS = ("moe_load_balance", "moe_z", "moe_dropped")


@dataclass(frozen=True)
class Stage:
    kind: str          # scan | single | shared
    block: str         # dense | moe | mamba | xlstm_m | xlstm_s
    n: int             # layers in this stage (1 for single/shared)
    layer_offset: int  # absolute index of the first layer in this stage


def build_plan(cfg: ModelConfig) -> List[Stage]:
    L = cfg.n_layers
    if cfg.family == "hybrid" and cfg.attn_block_every > 0:
        stages: List[Stage] = []
        off = 0
        while off < L:
            n = min(cfg.attn_block_every, L - off)
            stages.append(Stage("scan", "mamba", n, off))
            off += n
            if off < L or n == cfg.attn_block_every:
                # zamba2: the SAME transformer block after every mamba group
                stages.append(Stage("shared", "dense", 1, off))
        return stages
    if cfg.family == "ssm" and cfg.xlstm_pattern:
        return [
            Stage("single", "xlstm_" + cfg.xlstm_pattern[i % len(cfg.xlstm_pattern)], 1, i)
            for i in range(L)
        ]
    if cfg.n_experts > 0:
        fd = cfg.first_dense_layers
        stages = []
        if fd:
            stages.append(Stage("scan", "dense", fd, 0))
        stages.append(Stage("scan", "moe", L - fd, fd))
        return stages
    return [Stage("scan", "dense", L, 0)]


def layer_blocks(cfg: ModelConfig) -> List[Tuple[str, bool]]:
    """``(block kind, shared?)`` of each applied block, in order: one entry a
    layer of a ``scan`` or ``single`` stage and one each time the ``shared``
    block is applied, as the reference's ``Model._layer_blocks``."""
    return [(st.block, st.kind == "shared") for st in build_plan(cfg) for _ in range(st.n)]


def _block_specs(cfg: ModelConfig, block: str) -> Dict[str, ParamSpec | Dict[str, ParamSpec]]:
    d, pd = cfg.d_model, cfg.param_dtype
    ln = ParamSpec((d,), ("embed",), pd, init="zeros")
    if block == "dense":
        return {"ln1": ln, "attn": attention_specs(cfg), "ln2": ln, "mlp": mlp_specs(cfg)}
    if block == "moe":
        return {"ln1": ln, "attn": attention_specs(cfg), "ln2": ln, "moe": moe_specs(cfg)}
    if block == "mamba":
        return {"ln1": ln, "mamba": mamba_specs(cfg)}
    if block == "xlstm_m":
        return {"ln1": ln, "cell": mlstm_specs(cfg)}
    if block == "xlstm_s":
        return {"ln1": ln, "cell": slstm_specs(cfg)}
    raise ValueError(f"unknown block {block!r}")


def _prefixed(prefix: str, specs) -> Dict[str, ParamSpec]:
    out = {}
    for name, s in specs.items():
        if isinstance(s, ParamSpec):
            out[f"{prefix}.{name}"] = s
        else:
            out.update({f"{prefix}.{name}.{k}": v for k, v in s.items()})
    return out


def param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """``{state_dict name: ParamSpec}`` of :class:`Model`, in registration order.

    A block of its own is ``blocks.<i>.*``, i counting those blocks in order
    (the layer index); the shared block, however often it is applied, is
    ``shared.*`` once.
    """
    specs = {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                           cfg.param_dtype, init="embed", scale=0.02),
        "final_norm": ParamSpec((cfg.d_model,), ("embed",), cfg.param_dtype,
                                init="zeros"),
    }
    entries = layer_blocks(cfg)
    own = [block for block, shared in entries if not shared]
    for i, block in enumerate(own):
        specs.update(_prefixed(f"blocks.{i}", _block_specs(cfg, block)))
    if any(shared for _, shared in entries):
        specs.update(_prefixed("shared", _block_specs(cfg, "dense")))
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab"),
                                     cfg.param_dtype, scale=0.02)
    return specs


def decode_launches(cfg: ModelConfig) -> Dict[str, int]:
    """Launches of each kernel in one ``decode_step`` on the card, counted
    over the applied blocks (:func:`layer_blocks`).

    ``rmsnorm``: the final norm, two in an attention block (plus MLA's latent
    norm, and its query norm where the query is compressed), one in a Mamba
    or xLSTM block.  ``decode_attention``: one a GQA block; MLA attends in
    plain torch.  zamba2-2.7b: 54 + 9 x 2 + 1 = 73 and 9; xlstm-125m: 13 and 0.
    """
    mla = cfg.attn_kind == "mla"
    rms, att = 1, 0
    for block, _ in layer_blocks(cfg):
        if block in ("dense", "moe"):
            rms += 2 + (1 + bool(cfg.mla_q_rank) if mla else 0)
            att += not mla
        else:
            rms += 1
    return {"rmsnorm": rms, "decode_attention": att}


_STATES = {"mamba": init_ssm_state, "xlstm_m": init_mlstm_state,
           "xlstm_s": lambda cfg, batch, device, parts=1: init_slstm_state(cfg, batch, device)}


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device: torch.device) -> List:
    """One cache an entry of :func:`layer_blocks`: a KV cache (or MLA latents)
    in the param dtype for an attention block, the float32 recurrent state for
    a Mamba or xLSTM block.  ``device="meta"`` gives the shapes alone."""
    return [init_kv_cache(cfg, batch, max_len, li, device) if block in ("dense", "moe")
            else _STATES[block](cfg, batch, device)
            for li, (block, _) in enumerate(layer_blocks(cfg))]


class Caches(list):
    """A model's caches, one entry of :func:`layer_blocks` each (``{name:
    tensor}``), with ``specs``: the placement of each entry's tensors on the
    model's mesh as :func:`cache_specs` gives it, and ``kv``: each entry's
    :func:`~.attention.kv_columns`, taken once for the batch (both None
    without a mesh)."""

    def __init__(self, entries=(), specs: Optional[List[Dict[str, tuple]]] = None,
                 kv: Optional[List[Optional[Dict[str, torch.Tensor]]]] = None):
        super().__init__(entries)
        self.specs = specs
        self.kv = kv


def _cache_role(cfg: ModelConfig, block: str, name: str) -> str:
    """The role of cache tensor ``name`` of a ``block`` entry in ``cache_leaf_spec``."""
    if block not in ("dense", "moe"):
        return "conv" if name == "conv" else "state"
    return "latent" if cfg.attn_kind == "mla" else "kv"


# each block kind's head-parallel rule, and the part of the block whose specs
# it reads: attention's query heads, a Mamba2 mixer's heads, an mLSTM cell's
# (an sLSTM cell always runs whole: models/xlstm.py)
_HEAD_PARALLEL = {"dense": ("attn", head_parallel), "moe": ("attn", head_parallel),
                  "mamba": ("mamba", mamba_head_parallel), "xlstm_m": ("cell", mlstm_head_parallel)}


def _head_parallel(cfg: ModelConfig, mesh, shardings: Dict[str, tuple], block: str) -> bool:
    """Whether the entries of kind ``block`` (all alike) compute their own
    heads under ``shardings`` (:data:`_HEAD_PARALLEL`)."""
    if block not in _HEAD_PARALLEL:
        return False
    part, parallel = _HEAD_PARALLEL[block]
    own = [b for b, shared in layer_blocks(cfg) if not shared]
    prefix = f"blocks.{own.index(block)}.{part}." if block in own else f"shared.{part}."
    specs = {k[len(prefix):]: _effective(v, mesh) for k, v in shardings.items()
             if k.startswith(prefix)}
    return parallel(cfg, specs, mesh)


def cache_specs(cfg: ModelConfig, mesh, batch: int, max_len: int,
                shardings: Optional[Dict[str, tuple]] = None
                ) -> Tuple[List[Dict[str, tuple]], List[str]]:
    """``(specs, deviations)``: each cache tensor's spec on ``mesh`` for a
    batch of ``batch`` rows and ``max_len`` slots (``cache_leaf_spec``; the
    attention's parameter specs, ``shardings`` or the default rules', say
    whether it is head-parallel), and each deviation from the reference's
    placement once, named (``CACHE_DEVIATIONS``).  Each entry's blocks
    (all of a kind alike) say whether they are head-parallel."""
    if shardings is None:
        shardings, _ = param_shardings(param_specs(cfg), mesh)
    plan = layer_blocks(cfg)
    parallel = {block: _head_parallel(cfg, mesh, shardings, block) for block, _ in plan}
    specs, log = [], {}
    for (block, _), entry in zip(plan, init_caches(cfg, batch, max_len, torch.device("meta"))):
        specs.append({})
        for name, t in entry.items():
            role = _cache_role(cfg, block, name)
            spec, devs = cache_leaf_spec(t.shape, mesh, batch, role,
                                         head_parallel=parallel[block])
            specs[-1][name] = spec
            log.update({(name, d): f"cache {name} ({role}) [{d}]: {CACHE_DEVIATIONS[d]}"
                        for d in devs})
    return specs, list(log.values())


def _param(spec: ParamSpec, device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(spec.shape, dtype=spec.dtype, device=device),
                        requires_grad=False)


def _zero_aux(device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros((), dtype=torch.float32, device=device) for k in AUX_KEYS}


def _effective(spec: tuple, mesh) -> tuple:
    """``spec`` without the mesh's axes of size 1, trailing Nones trimmed."""
    out = []
    for part in spec:
        axes = tuple(a for a in mesh.axes_in_order(part) if mesh.shape[a] > 1)
        out.append(None if not axes else axes[0] if len(axes) == 1 else axes)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


class _Block(nn.Module):
    """A pre-norm residual block; its parameters as ``_block_specs`` names them.

    ``mesh`` and ``specs`` (``{name: spec}`` of its own parameters, ``attn.w_q``
    and so on) are set when the model is bound to a mesh."""

    kind = ""
    mesh = None
    specs: Dict[str, tuple] = {}

    def __init__(self, cfg: ModelConfig, device: torch.device, kind: str | None = None):
        super().__init__()
        self.cfg = cfg
        self.kind = kind or type(self).kind
        for name, s in _block_specs(cfg, self.kind).items():
            setattr(self, name, _param(s, device) if isinstance(s, ParamSpec) else
                    nn.ParameterDict({k: _param(v, device) for k, v in s.items()}))

    def sub_specs(self, part: str) -> Dict[str, tuple]:
        """The effective specs of ``part``'s parameters, by their names in it
        (none on a block that is not bound to a mesh)."""
        n = len(part) + 1
        return {k[n:]: _effective(v, self.mesh) for k, v in self.specs.items()
                if k.startswith(part + ".")}

    def norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        gamma = getattr(self, name)
        if self.mesh is not None:
            gamma = use_full(gamma, self.specs[name], self.mesh)
        return rms_norm(x, gamma, self.cfg.norm_eps)

    def part(self, name: str):
        """Parameters of ``name`` as a compute that runs whole takes them."""
        p = getattr(self, name)
        return p if self.mesh is None else use_params(p, self.sub_specs(name), self.mesh)

    def unpartitioned(self) -> List[str]:
        """The parts this block computes whole on every rank of ``model``."""
        return []

    def head_parallel(self) -> bool:
        """Whether it computes the rank's heads (its kind's rule in
        :data:`_HEAD_PARALLEL`; never without a mesh)."""
        if self.mesh is None or self.kind not in _HEAD_PARALLEL:
            return False
        part, parallel = _HEAD_PARALLEL[self.kind]
        return parallel(self.cfg, self.sub_specs(part), self.mesh)

    def own_or_whole(self, name: str):
        """``(parameters, mesh)`` of part ``name`` for its family's functions:
        the rank's shards and the mesh where the block is head-parallel, else
        the whole parameters (:meth:`part`) and None."""
        if self.head_parallel():
            return getattr(self, name), self.mesh
        return self.part(name), None


class DenseBlock(_Block):
    """Pre-norm attention + gated MLP, both residual."""

    kind = "dense"

    def ffn(self, h: torch.Tensor, aux: bool = True):
        """``(y, aux losses)`` of the block's feed-forward half."""
        y = mlp_apply(self.cfg, self.mlp, h, mesh=self.mesh, specs=self.sub_specs("mlp"))
        return y, _zero_aux(h.device) if aux else None

    def forward(self, x: torch.Tensor, positions: torch.Tensor, layer_idx: int):
        """Full causal pass: ``(x, aux losses, cache entry)``."""
        cfg = self.cfg
        a, kv = attention_apply(cfg, self.attn, self.norm("ln1", x), positions,
                                is_global=cfg.is_global_attn(layer_idx), mesh=self.mesh,
                                specs=self.sub_specs("attn"))
        x = x + a
        y, aux = self.ffn(self.norm("ln2", x))
        return x + y, aux, kv

    def unpartitioned(self) -> List[str]:
        out = [] if self.head_parallel() else ["attn"]
        return out + ([] if col_parallel(self.sub_specs("mlp")) else ["mlp"])

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor], pos: int,
               cache_spec: Optional[Dict[str, tuple]] = None, kv=None):
        a, cache = attention_decode(self.cfg, self.attn, self.norm("ln1", x), cache, pos,
                                    mesh=self.mesh, specs=self.sub_specs("attn"),
                                    cache_spec=cache_spec, kv=kv)
        x = x + a
        y, _ = self.ffn(self.norm("ln2", x), aux=False)
        return x + y, cache


class MoEBlock(DenseBlock):
    """Pre-norm attention + routed experts, both residual.

    ``routing`` holds the top-k expert indices ``[tokens, k]`` of the last
    call, on the block's device, for a caller that checks or counts them.
    """

    kind = "moe"

    def ffn(self, h: torch.Tensor, aux: bool = True):
        mesh = self.mesh
        if mesh is None:
            y, losses, self.routing = moe_apply(self.cfg, self.moe, h, aux=aux)
        elif self._expert_parallel():
            # the experts as they lie, the router and shared experts whole
            specs, want = self.sub_specs("moe"), ep_specs(self.cfg, mesh)
            p = {k: v if want.get(k) else use_full(v, specs[k], mesh)
                 for k, v in self.moe.items()}
            y, losses = moe_apply_ep(self.cfg, p, h, mesh, aux=aux)
            self.routing = None
        else:
            y, losses, self.routing = moe_apply(
                self.cfg, self.part("moe"), h, aux=aux,
                reduce=lambda t: reduce_out(t, mesh, mesh.batch_axes))
        return y, {**_zero_aux(h.device), **losses} if aux else None

    def _expert_parallel(self) -> bool:
        """Whether the experts lie as ``moe_apply_ep`` takes them."""
        if not ep_applicable(self.cfg, self.mesh):
            return False
        specs, want = self.sub_specs("moe"), ep_specs(self.cfg, self.mesh)
        return all(specs[k] == _effective(v, self.mesh) for k, v in want.items() if v)

    def unpartitioned(self) -> List[str]:
        attn = [] if self.head_parallel() else ["attn"]
        return attn + ([] if self._expert_parallel() else ["moe"])


class MambaBlock(_Block):
    """Pre-norm Mamba2 mixer, residual; its cache is the SSM state (under a
    mesh, the rank's heads' where it is head-parallel: ``models/ssm.py``)."""

    kind = "mamba"

    def forward(self, x: torch.Tensor, positions: torch.Tensor, layer_idx: int):
        """Full causal pass: ``(x, aux losses, state after the last token)``."""
        p, mesh = self.own_or_whole("mamba")
        y, state = mamba_apply(self.cfg, p, self.norm("ln1", x), return_state=True, mesh=mesh)
        return x + y, _zero_aux(x.device), state

    def unpartitioned(self) -> List[str]:
        return [] if self.head_parallel() else ["mamba"]

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor], pos: int,
               cache_spec: Optional[Dict[str, tuple]] = None, kv=None):
        p, mesh = self.own_or_whole("mamba")
        y, cache = mamba_decode(self.cfg, p, self.norm("ln1", x), cache, mesh=mesh)
        return x + y, cache


class XLSTMBlock(_Block):
    """Pre-norm mLSTM (``xlstm_m``) or sLSTM (``xlstm_s``) cell, residual; its
    cache is the cell's recurrent state (under a mesh, an mLSTM cell's
    rank's heads' where it is head-parallel: ``models/xlstm.py``)."""

    def forward(self, x: torch.Tensor, positions: torch.Tensor, layer_idx: int):
        """Full causal pass: ``(x, aux losses, state after the last token)``."""
        h, (p, mesh) = self.norm("ln1", x), self.own_or_whole("cell")
        if self.kind == "xlstm_m":
            y, state = mlstm_apply(self.cfg, p, h, return_state=True, mesh=mesh)
        else:
            y, state = slstm_apply(self.cfg, p, h, return_state=True)
        return x + y, _zero_aux(x.device), state

    def unpartitioned(self) -> List[str]:
        """The cell where it runs whole: an sLSTM cell always (its dense
        recurrent ``r_zifo`` would take an exchange over ``model`` at every
        step of the scan if its columns were cut), an mLSTM cell whose heads
        ``model`` does not divide."""
        return [] if self.head_parallel() else ["cell"]

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor], pos: int,
               cache_spec: Optional[Dict[str, tuple]] = None, kv=None):
        h, (p, mesh) = self.norm("ln1", x), self.own_or_whole("cell")
        if self.kind == "xlstm_m":
            y, cache = mlstm_decode(self.cfg, p, h, cache, mesh=mesh)
        else:
            y, cache = slstm_decode(self.cfg, p, h, cache)
        return x + y, cache


_BLOCKS = {"dense": DenseBlock, "moe": MoEBlock, "mamba": MambaBlock,
           "xlstm_m": XLSTMBlock, "xlstm_s": XLSTMBlock}


def _vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor, lo: int, mesh
                        ) -> torch.Tensor:
    """-log softmax at the labels from this rank's logits of ids ``lo`` on:
    the rows' max, sum of exponentials and label logit, each summed (the max
    taken) over ``model``; a label outside the slice adds 0."""
    m = raw_all_reduce(logits.detach().amax(dim=-1), mesh, "model",
                       op=torch.distributed.ReduceOp.MAX)
    sumexp = reduce_out(torch.exp(logits - m[..., None]).sum(dim=-1), mesh, "model")
    local = labels - lo
    inside = (local >= 0) & (local < logits.shape[-1])
    picked = torch.gather(logits, -1, local.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
    label_logit = reduce_out(torch.where(inside, picked, 0.0), mesh, "model")
    return m + torch.log(sumexp) - label_logit


class Model(nn.Module):
    """Decoder of every family; parameters live on ``device`` (the card by
    default).

    The constructor allocates zeroed parameters; :meth:`init` draws them from
    a seeded ``torch.Generator`` and ``load_state_dict`` loads given ones
    (``models.convert.params_from_jax`` carries the reference's across).
    Given a bound ``mesh``, it allocates only this rank's shards, bound as
    ``distributed.sharding.shard_params`` binds them: no rank holds a whole
    parameter it does not compute with.
    ``blocks`` holds the blocks with parameters of their own, ``shared`` the
    shared block where the plan has one; ``entries`` lists the block applied
    at each entry of :func:`layer_blocks`, the shared one as often as it is
    applied.
    """

    def __init__(self, cfg: ModelConfig, device: str | torch.device | None = None, *,
                 mesh=None):
        super().__init__()
        device = resolve_device(device)
        if mesh is None:
            self._build(cfg, device)
            return
        self._build(cfg, torch.device("meta"))  # shapes alone, then this rank's shards
        shard_params(self, mesh)
        self.to_empty(device=device)
        with torch.no_grad():
            for p in self.parameters():
                p.zero_()
        self.device = device

    @classmethod
    def abstract(cls, cfg: ModelConfig) -> "Model":
        """The model on the ``meta`` device: every parameter its spec's shape
        and dtype, no data, no device memory and no generator.  Only shape
        functions run on it (the dry run's trace); it is no way to compute
        without a card."""
        model = cls.__new__(cls)
        nn.Module.__init__(model)
        model._build(cfg, torch.device("meta"))
        return model

    def _build(self, cfg: ModelConfig, device: torch.device) -> None:
        self.cfg = cfg.validate()
        specs = param_specs(cfg)
        self.device = device
        self.mesh = None        # set by bind_mesh
        self.shardings = None   # {name: spec} under a mesh
        self.embed = _param(specs["embed"], self.device)
        self.final_norm = _param(specs["final_norm"], self.device)
        plan = layer_blocks(cfg)
        self.blocks = nn.ModuleList(_BLOCKS[block](cfg, self.device, block)
                                    for block, shared in plan if not shared)
        if any(shared for _, shared in plan):
            self.shared = DenseBlock(cfg, self.device)
        own = iter(self.blocks)
        self.entries = [self.shared if shared else next(own) for _, shared in plan]
        self.entry_shared = [shared for _, shared in plan]
        if not cfg.tie_embeddings:
            self.lm_head = _param(specs["lm_head"], self.device)

    # -- parameters -----------------------------------------------------------

    def param_specs(self) -> Dict[str, ParamSpec]:
        return param_specs(self.cfg)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Draw every parameter from ``generator`` (seeded by the caller), in
        place and one tensor at a time.  Bound to a mesh, every rank draws
        each whole tensor and keeps its slice, so the values do not depend on
        the mesh."""
        own = dict(self.named_parameters())
        for name, spec in self.param_specs().items():
            if self.mesh is None:
                fill_(own[name], spec, generator)
            else:
                full = fill_(torch.empty(spec.shape, dtype=spec.dtype, device=self.device),
                             spec, generator)
                own[name].copy_(shard_tensor(full, self.shardings[name], self.mesh))
        return self

    def bind_mesh(self, mesh, shardings: Dict[str, tuple]) -> None:
        """Mark the parameters as this rank's shards under ``shardings``
        (``distributed.sharding.shard_params`` cuts them and calls this)."""
        self.mesh, self.shardings = mesh, shardings
        for prefix, block in [(f"blocks.{i}", b) for i, b in enumerate(self.blocks)] + (
                [("shared", self.shared)] if hasattr(self, "shared") else []):
            block.mesh = mesh
            block.specs = {k[len(prefix) + 1:]: v for k, v in shardings.items()
                           if k.startswith(prefix + ".")}

    def unpartitioned(self) -> List[str]:
        """The parts of blocks that run whole on every rank of ``model``
        (``blocks.3.cell``, ``shared.attn``, ...): sLSTM cells, and blocks
        whose heads ``model`` does not divide; none without a mesh or where
        ``model`` has one rank."""
        if self.mesh is None or self.mesh.axis_size("model") == 1:
            return []
        named = [(f"blocks.{i}", b) for i, b in enumerate(self.blocks)]
        if hasattr(self, "shared"):
            named.append(("shared", self.shared))
        return [f"{prefix}.{part}" for prefix, b in named for part in b.unpartitioned()]

    def n_params(self) -> int:
        return count_params(self.param_specs())

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only routed experts count)."""
        cfg = self.cfg
        total = self.n_params()
        if cfg.n_experts == 0:
            return total
        moe_layers = cfg.n_layers - cfg.first_dense_layers
        per_expert = 3 * cfg.d_model * cfg.d_ff
        return total - moe_layers * (cfg.n_experts - cfg.experts_per_token) * per_expert

    # -- embedding / head -------------------------------------------------------

    def _embed(self, tokens: Optional[torch.Tensor] = None,
               embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token embeddings, or the frontend's ``embeds [B, S, d_model]``
        (qwen2-vl's and musicgen's stub frontends) in the param dtype."""
        if embeds is not None:
            x = torch.as_tensor(embeds, device=self.device).to(self.cfg.param_dtype)
        elif self.mesh is None:
            x = self.embed[torch.as_tensor(tokens, device=self.device)]
        else:
            x = self._embed_sharded(torch.as_tensor(tokens, device=self.device))
        if self.cfg.scale_embed:
            # sqrt(d_model) rounded to the activation dtype first, as in the
            # reference: 33.94 becomes 34.0 in bf16
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype, device=x.device)
        return x

    def _vocab_slice(self) -> Optional[int]:
        """Under a mesh, where the head's vocabulary is cut over ``model``:
        the first id of this rank's slice; else None."""
        if self.mesh is None or self.mesh.axis_size("model") == 1:
            return None
        tied = self.cfg.tie_embeddings
        spec = _effective(self.shardings["embed" if tied else "lm_head"], self.mesh)
        if spec != (("model",) if tied else (None, "model")):
            return None
        return self.mesh.index("model") * self.cfg.vocab // self.mesh.axis_size("model")

    def _embed_sharded(self, tokens: torch.Tensor) -> torch.Tensor:
        """The vocab-parallel lookup: this rank's rows of the table where the
        tokens fall in its slice, zeros elsewhere, summed over ``model``."""
        spec = _effective(self.shardings["embed"], self.mesh)
        if spec != ("model",) or self.mesh.axis_size("model") == 1:
            return use_full(self.embed, self.shardings["embed"], self.mesh)[tokens]
        rows = self.embed.shape[0]
        local = tokens - self.mesh.index("model") * rows
        inside = ((local >= 0) & (local < rows))[..., None]
        x = torch.where(inside, self.embed[local.clamp(0, rows - 1)], 0)
        return reduce_out(x, self.mesh, "model")

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if self.mesh is not None:
            return self._head_sharded(x)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        w = self.embed.T if cfg.tie_embeddings else self.lm_head
        return self._logits(x, w)

    def _head_sharded(self, x: torch.Tensor) -> torch.Tensor:
        """The logits of this rank's vocabulary slice where the head is cut
        over ``model`` (the input's gradient summed over it), else all."""
        cfg, mesh = self.cfg, self.mesh
        x = rms_norm(x, use_full(self.final_norm, self.shardings["final_norm"], mesh),
                     cfg.norm_eps)
        name = "embed" if cfg.tie_embeddings else "lm_head"
        w = getattr(self, name)
        if self._vocab_slice() is None:
            w = use_full(w, self.shardings[name], mesh)
        else:
            x = copy_in(x, mesh, "model")
        return self._logits(x, w.T if cfg.tie_embeddings else w)

    def _logits(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        logits = (x @ w).float()  # product in the param dtype, then float32
        if cfg.logit_softcap > 0:
            c = cfg.logit_softcap
            logits = torch.tanh(logits / c) * c
        return logits

    # -- full forward -------------------------------------------------------------

    def _layers(self, x: torch.Tensor, *, remat: str = "none"):
        """Every entry's full causal pass: ``(x, summed aux losses, cache
        entries)``; under a remat policy other than "none" each entry goes
        through ``maybe_remat`` (its activations, but what the policy saves,
        recomputed in the backward) and there are no cache entries."""
        B, S = x.shape[:2]
        positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
        aux_total = _zero_aux(x.device)
        kvs = []
        for li, block in enumerate(self.entries):
            if remat != "none":
                x, aux, _ = maybe_remat(block, remat)(x, positions, li)
            else:
                x, aux, kv = block(x, positions, li)
                kvs.append(kv)
            aux_total = {k: aux_total[k] + aux[k] for k in AUX_KEYS}
        return x, aux_total, kvs

    def forward(self, tokens: Optional[torch.Tensor] = None, *,
                embeds: Optional[torch.Tensor] = None, remat: bool = False,
                remat_policy: str = "full"
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Full causal forward: ``(logits [B, S, V] float32, aux losses)``;
        under a mesh with the head cut over ``model``, the logits of this
        rank's vocabulary slice.

        Records for autograd where grad mode is on.  ``remat`` recomputes
        each entry in the backward under ``remat_policy`` ("full", "dots",
        "dots_no_batch": ``distributed/remat.py``).
        """
        if remat and (remat_policy == "none" or remat_policy not in POLICIES):
            raise ValueError(f"unknown remat policy {remat_policy!r}")
        x, aux, _ = self._layers(self._embed(tokens, embeds),
                                 remat=remat_policy if remat else "none")
        return self._head(x), aux

    def loss_fn(self, tokens: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None, *,
                embeds: Optional[torch.Tensor] = None, remat: bool = False,
                remat_policy: str = "full", moe_loss_weight: float = 0.01,
                z_loss_weight: float = 1e-4) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``(loss, metrics)`` as the reference's ``loss_fn``: the mean
        next-token NLL over every position from a float32 ``log_softmax``
        (labels default to the tokens shifted left, padded with 0), plus the
        weighted MoE load-balance and z losses; metrics ``{"ce", **aux}``.

        Under a mesh the tokens are this rank's rows, and the loss is the
        whole batch's (the NLL summed over the batch axes, the MoE losses
        from the whole batch's routing statistics): the same on every rank.
        """
        logits, aux = self.forward(tokens, embeds=embeds, remat=remat,
                                   remat_policy=remat_policy)
        if labels is None:
            labels = F.pad(torch.as_tensor(tokens, device=self.device)[:, 1:], (0, 1))
        labels = torch.as_tensor(labels, device=self.device).long()
        if self.mesh is None:
            logp = torch.log_softmax(logits, dim=-1)
            nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
            ce = nll.sum() / nll.numel()
        else:
            lo = self._vocab_slice()
            nll = (_vocab_parallel_nll(logits, labels, lo, self.mesh) if lo is not None else
                   -torch.gather(torch.log_softmax(logits, dim=-1), -1, labels[..., None])[..., 0])
            batch = self.mesh.batch_axes
            ce = (reduce_out(nll.sum(), self.mesh, batch)
                  / (nll.numel() * self.mesh.axis_size(batch)))
        total = (ce + moe_loss_weight * aux["moe_load_balance"]
                 + z_loss_weight * aux["moe_z"])
        return total, {"ce": ce, **aux}

    # -- serving ----------------------------------------------------------------

    def cache_specs(self, batch: int, max_len: int) -> Optional[List[Dict[str, tuple]]]:
        """Each cache tensor's spec on the model's mesh (:func:`cache_specs`);
        None without a mesh."""
        if self.mesh is None:
            return None
        return cache_specs(self.cfg, self.mesh, batch, max_len, self.shardings)[0]

    def init_caches(self, batch: int, max_len: int, device=None) -> "Caches":
        """Zeroed caches on the model's device (``device``: another, such as
        ``meta``) for a batch of ``batch`` rows and ``max_len`` slots
        (:func:`init_caches`); under a mesh this rank's shards, placed as
        :meth:`cache_specs` says, with the weight columns its decode reads
        (:class:`Caches`), gathered here once for the batch."""
        cfg = self.cfg
        device = self.device if device is None else torch.device(device)
        specs = self.cache_specs(batch, max_len)
        if specs is None:
            return Caches(init_caches(cfg, batch, max_len, device))
        out = []
        whole = init_caches(cfg, batch, max_len, torch.device("meta"))
        for block, entry, spec in zip(self.entries, whole, specs):
            shapes = {name: list(shard_tensor(t, spec[name], self.mesh).shape)
                      for name, t in entry.items()}
            if not isinstance(block, DenseBlock):  # as the block's own init makes it
                parts = self.mesh.axis_size("model") if block.head_parallel() else 1
                out.append(_STATES[block.kind](cfg, next(iter(shapes.values()))[0], device,
                                               parts))
                continue
            # the KV heads a rank holds where it holds those it reads
            if cfg.attn_kind != "mla" and len(spec["k"]) < 3 and block.head_parallel():
                for shape in shapes.values():
                    shape[2] = kv_heads_read(cfg, self.mesh).numel()
            out.append({name: torch.zeros(shape, dtype=entry[name].dtype, device=device)
                        for name, shape in shapes.items()})
        return Caches(out, specs, self._kv_columns(specs))

    @torch.no_grad()
    def _kv_columns(self, specs: List[Dict[str, tuple]]) -> List[Optional[Dict]]:
        """Each entry's :func:`~.attention.kv_columns` on the model's mesh,
        for caches placed as ``specs`` (a shared block's taken once)."""
        taken = {}
        for block, spec in zip(self.entries, specs):
            if isinstance(block, DenseBlock) and id(block) not in taken:
                taken[id(block)] = kv_columns(self.cfg, block.attn, block.sub_specs("attn"),
                                              self.mesh, spec)
        return [taken.get(id(block)) for block in self.entries]

    def abstract_caches(self, batch: int, max_len: int) -> "Caches":
        """:meth:`init_caches` on the ``meta`` device: shapes and dtypes, no
        data (the reference's ``abstract_caches``)."""
        return self.init_caches(batch, max_len, "meta")

    @torch.no_grad()
    def prefill(self, tokens: Optional[torch.Tensor] = None, *,
                embeds: Optional[torch.Tensor] = None, batch: Optional[int] = None,
                max_len: Optional[int] = None):
        """Process a whole prompt: ``(last-token logits [B, V], caches)``.

        The caches are the reference's: ``S`` slots on global layers (and MLA
        latents), a ring of ``min(window, S)`` slots on local ones, and each
        recurrent block's state after the last token.  ``max_len`` (at least
        S) sizes them as :meth:`init_caches` does instead, the prompt in their
        first slots, so that ``decode_step`` goes on to ``max_len`` tokens
        (at S slots, a decode at pos S overwrites slot 0).  Under a mesh the
        tokens are this rank's rows of a batch of ``batch`` rows (default:
        the rows given times the batch axes' ranks; where those axes do not
        divide ``batch``, every row), the logits the whole vocabulary's
        (gathered over ``model`` where the head is cut over it) and the
        caches this rank's shards, placed as :meth:`cache_specs` says.
        """
        x, _, kvs = self._layers(self._embed(tokens, embeds))
        B, S = x.shape[:2]
        L = S if max_len is None else max_len
        if L < S:
            raise ValueError(f"max_len {L} is shorter than the prompt's {S} tokens")
        caches = [self._prefill_cache(kv, li, S, L) if isinstance(block, DenseBlock) else kv
                  for li, (block, kv) in enumerate(zip(self.entries, kvs))]
        logits = self._head(x[:, -1:, :].contiguous())[:, 0, :]  # the kernels take it so
        if self.mesh is None:
            return logits, Caches(caches)
        if self._vocab_slice() is not None:
            logits = raw_all_gather(logits, self.mesh, "model", dim=-1)
        if batch is None:
            batch = B * self.mesh.axis_size(self.mesh.batch_axes)
        specs = self.cache_specs(batch, L)
        for block, entry, spec in zip(self.entries, caches, specs):
            if not isinstance(block, DenseBlock):  # a state: the rank's rows and heads
                continue
            for name, t in entry.items():  # the rows and heads are the rank's already
                cut = spec[name][1] if len(spec[name]) > 1 else None
                if cut is not None:
                    entry[name] = shard_tensor(t, (None, cut), self.mesh).clone()
        return logits, Caches(caches, specs, self._kv_columns(specs))

    def _prefill_cache(self, kv, layer_idx: int, S: int, L: int) -> Dict[str, torch.Tensor]:
        """One attention layer's cache of ``L`` slots (a ring of ``min(window,
        L)`` on a local layer) holding the prompt's ``S`` tokens."""
        cfg = self.cfg

        def padded(t):  # the prompt in the first S of L slots
            return t if L == S else F.pad(t, (0, 0) * (t.dim() - 2) + (0, L - S))

        if cfg.attn_kind == "mla":
            c_kv, k_pe = kv
            return {"c_kv": padded(c_kv), "k_pe": padded(k_pe)}
        k, v = kv
        if cfg.attn_kind == "sliding" and not cfg.is_global_attn(layer_idx):
            # the last w tokens, each at its ring slot pos % ring
            w, ring = min(cfg.sliding_window, S), min(cfg.sliding_window, L)
            idx = torch.arange(S - w, S, device=k.device) % ring
            kc = torch.zeros((k.shape[0], ring, *k.shape[2:]), dtype=k.dtype, device=k.device)
            vc = torch.zeros_like(kc)
            kc[:, idx] = k[:, S - w:]
            vc[:, idx] = v[:, S - w:]
            return {"k": kc, "v": vc}
        return {"k": padded(k), "v": padded(v)}

    @torch.no_grad()
    def decode_step(
        self, caches: List[Dict[str, torch.Tensor]], tokens: Optional[torch.Tensor], pos: int,
        *, embeds: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
        """One token for every sequence in the batch.

        tokens: int[B] (or None with ``embeds [B, 1, d_model]``); pos: tokens
        already in the cache.  The caches are written in place (a KV slot, a
        recurrent state's entries).  Returns
        (logits [B, V] float32, caches).  Under a mesh the tokens are this
        rank's rows and the caches its shards, as :meth:`init_caches` or
        :meth:`prefill` gave them; the logits are its rows' over the whole
        vocabulary.
        """
        specs, kv = getattr(caches, "specs", None), getattr(caches, "kv", None)
        if self.mesh is not None and (specs is None or kv is None):
            raise ValueError("a model bound to a mesh decodes caches placed on it, with the "
                             "K/V columns they carry: take them from its init_caches, "
                             "abstract_caches or prefill")
        tokens = None if tokens is None else torch.as_tensor(tokens, device=self.device)[:, None]
        with tracing.span("model.embed"):
            x = self._embed(tokens, embeds)
        for i, (block, cache, shared) in enumerate(zip(self.entries, caches, self.entry_shared)):
            with tracing.span("model.block", index=i, kind=block.kind, shared=shared):
                x, _ = block.decode(x, cache, pos, None if specs is None else specs[i],
                                    None if kv is None else kv[i])
        with tracing.span("model.head"):
            logits = self._head(x)[:, 0, :]
            if self._vocab_slice() is not None:
                logits = raw_all_gather(logits, self.mesh, "model", dim=-1)
        return logits, caches
