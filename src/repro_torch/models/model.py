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
"full" (the reference's ``jax.checkpoint`` around each scanned block) is
``torch.utils.checkpoint`` around each entry.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..device import resolve_device
from .attention import attention_apply, attention_decode, attention_specs, init_kv_cache
from .common import ModelConfig, ParamSpec, count_params, fill_, rms_norm
from .mlp import mlp_apply, mlp_specs
from .moe import moe_apply, moe_specs
from .ssm import init_ssm_state, mamba_apply, mamba_decode, mamba_specs
from .xlstm import (init_mlstm_state, init_slstm_state, mlstm_apply, mlstm_decode, mlstm_specs,
                    slstm_apply, slstm_decode, slstm_specs)

__all__ = ["Stage", "build_plan", "layer_blocks", "DenseBlock", "MoEBlock", "MambaBlock",
           "XLSTMBlock", "Model", "param_specs", "init_caches", "decode_launches"]

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


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device: torch.device) -> List:
    """One cache an entry of :func:`layer_blocks`: a KV cache (or MLA latents)
    in the param dtype for an attention block, the float32 recurrent state for
    a Mamba or xLSTM block.  ``device="meta"`` gives the shapes alone."""
    states = {"mamba": init_ssm_state, "xlstm_m": init_mlstm_state, "xlstm_s": init_slstm_state}
    return [init_kv_cache(cfg, batch, max_len, li, device) if block in ("dense", "moe")
            else states[block](cfg, batch, device)
            for li, (block, _) in enumerate(layer_blocks(cfg))]


def _param(spec: ParamSpec, device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(spec.shape, dtype=spec.dtype, device=device),
                        requires_grad=False)


def _zero_aux(device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros((), dtype=torch.float32, device=device) for k in AUX_KEYS}


class _Block(nn.Module):
    """A pre-norm residual block; its parameters as ``_block_specs`` names them."""

    kind = ""

    def __init__(self, cfg: ModelConfig, device: torch.device, kind: str | None = None):
        super().__init__()
        self.cfg = cfg
        self.kind = kind or type(self).kind
        for name, s in _block_specs(cfg, self.kind).items():
            setattr(self, name, _param(s, device) if isinstance(s, ParamSpec) else
                    nn.ParameterDict({k: _param(v, device) for k, v in s.items()}))


class DenseBlock(_Block):
    """Pre-norm attention + gated MLP, both residual."""

    kind = "dense"

    def ffn(self, h: torch.Tensor, aux: bool = True):
        """``(y, aux losses)`` of the block's feed-forward half."""
        return mlp_apply(self.cfg, self.mlp, h), _zero_aux(h.device) if aux else None

    def forward(self, x: torch.Tensor, positions: torch.Tensor, layer_idx: int):
        """Full causal pass: ``(x, aux losses, cache entry)``."""
        cfg = self.cfg
        a, kv = attention_apply(cfg, self.attn, rms_norm(x, self.ln1, cfg.norm_eps), positions,
                                is_global=cfg.is_global_attn(layer_idx))
        x = x + a
        y, aux = self.ffn(rms_norm(x, self.ln2, cfg.norm_eps))
        return x + y, aux, kv

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor], pos: int):
        cfg = self.cfg
        a, cache = attention_decode(cfg, self.attn, rms_norm(x, self.ln1, cfg.norm_eps),
                                    cache, pos)
        x = x + a
        y, _ = self.ffn(rms_norm(x, self.ln2, cfg.norm_eps), aux=False)
        return x + y, cache


class MoEBlock(DenseBlock):
    """Pre-norm attention + routed experts, both residual.

    ``routing`` holds the top-k expert indices ``[tokens, k]`` of the last
    call, on the block's device, for a caller that checks or counts them.
    """

    kind = "moe"

    def ffn(self, h: torch.Tensor, aux: bool = True):
        y, losses, self.routing = moe_apply(self.cfg, self.moe, h, aux=aux)
        return y, {**_zero_aux(h.device), **losses} if aux else None


class MambaBlock(_Block):
    """Pre-norm Mamba2 mixer, residual; its cache is the SSM state."""

    kind = "mamba"

    def forward(self, x: torch.Tensor, positions: torch.Tensor, layer_idx: int):
        """Full causal pass: ``(x, aux losses, state after the last token)``."""
        y, state = mamba_apply(self.cfg, self.mamba, rms_norm(x, self.ln1, self.cfg.norm_eps),
                               return_state=True)
        return x + y, _zero_aux(x.device), state

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor], pos: int):
        y, cache = mamba_decode(self.cfg, self.mamba, rms_norm(x, self.ln1, self.cfg.norm_eps),
                                cache)
        return x + y, cache


_XLSTM = {"xlstm_m": (mlstm_apply, mlstm_decode), "xlstm_s": (slstm_apply, slstm_decode)}


class XLSTMBlock(_Block):
    """Pre-norm mLSTM (``xlstm_m``) or sLSTM (``xlstm_s``) cell, residual; its
    cache is the cell's recurrent state."""

    def forward(self, x: torch.Tensor, positions: torch.Tensor, layer_idx: int):
        """Full causal pass: ``(x, aux losses, state after the last token)``."""
        apply = _XLSTM[self.kind][0]
        y, state = apply(self.cfg, self.cell, rms_norm(x, self.ln1, self.cfg.norm_eps),
                         return_state=True)
        return x + y, _zero_aux(x.device), state

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor], pos: int):
        decode = _XLSTM[self.kind][1]
        y, cache = decode(self.cfg, self.cell, rms_norm(x, self.ln1, self.cfg.norm_eps), cache)
        return x + y, cache


_BLOCKS = {"dense": DenseBlock, "moe": MoEBlock, "mamba": MambaBlock,
           "xlstm_m": XLSTMBlock, "xlstm_s": XLSTMBlock}


class Model(nn.Module):
    """Decoder of every family; parameters live on ``device`` (the card by
    default).

    The constructor allocates zeroed parameters; :meth:`init` draws them from
    a seeded ``torch.Generator`` and ``load_state_dict`` loads given ones
    (``models.convert.params_from_jax`` carries the reference's across).
    ``blocks`` holds the blocks with parameters of their own, ``shared`` the
    shared block where the plan has one; ``entries`` lists the block applied
    at each entry of :func:`layer_blocks`, the shared one as often as it is
    applied.
    """

    def __init__(self, cfg: ModelConfig, device: str | torch.device | None = None):
        super().__init__()
        self.cfg = cfg.validate()
        specs = param_specs(cfg)
        self.device = resolve_device(device)
        self.embed = _param(specs["embed"], self.device)
        self.final_norm = _param(specs["final_norm"], self.device)
        plan = layer_blocks(cfg)
        self.blocks = nn.ModuleList(_BLOCKS[block](cfg, self.device, block)
                                    for block, shared in plan if not shared)
        if any(shared for _, shared in plan):
            self.shared = DenseBlock(cfg, self.device)
        own = iter(self.blocks)
        self.entries = [self.shared if shared else next(own) for _, shared in plan]
        if not cfg.tie_embeddings:
            self.lm_head = _param(specs["lm_head"], self.device)

    # -- parameters -----------------------------------------------------------

    def param_specs(self) -> Dict[str, ParamSpec]:
        return param_specs(self.cfg)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Draw every parameter from ``generator`` (seeded by the caller), in
        place and one tensor at a time."""
        own = dict(self.named_parameters())
        for name, spec in self.param_specs().items():
            fill_(own[name], spec, generator)
        return self

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
        else:
            x = self.embed[torch.as_tensor(tokens, device=self.device)]
        if self.cfg.scale_embed:
            # sqrt(d_model) rounded to the activation dtype first, as in the
            # reference: 33.94 becomes 34.0 in bf16
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype, device=x.device)
        return x

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        w = self.embed.T if cfg.tie_embeddings else self.lm_head
        logits = (x @ w).float()  # product in the param dtype, then float32
        if cfg.logit_softcap > 0:
            c = cfg.logit_softcap
            logits = torch.tanh(logits / c) * c
        return logits

    # -- full forward -------------------------------------------------------------

    def _layers(self, x: torch.Tensor, *, remat: bool = False):
        """Every entry's full causal pass: ``(x, summed aux losses, cache
        entries)``; with ``remat`` each entry under ``torch.utils.checkpoint``
        (its activations recomputed in the backward) and no cache entries."""
        B, S = x.shape[:2]
        positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
        aux_total = _zero_aux(x.device)
        kvs = []
        for li, block in enumerate(self.entries):
            if remat:
                x, aux, _ = torch.utils.checkpoint.checkpoint(block, x, positions, li,
                                                              use_reentrant=False)
            else:
                x, aux, kv = block(x, positions, li)
                kvs.append(kv)
            aux_total = {k: aux_total[k] + aux[k] for k in AUX_KEYS}
        return x, aux_total, kvs

    def forward(self, tokens: Optional[torch.Tensor] = None, *,
                embeds: Optional[torch.Tensor] = None, remat: bool = False,
                remat_policy: str = "full"
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Full causal forward: ``(logits [B, S, V] float32, aux losses)``.

        Records for autograd where grad mode is on.  ``remat`` with policy
        "full" recomputes each entry in the backward; "dots" and
        "dots_no_batch" save the products and need the sharded substrate's
        remat policies (slice 4b).
        """
        if remat and remat_policy != "full":
            if remat_policy in ("dots", "dots_no_batch"):
                raise NotImplementedError(
                    f"remat policy {remat_policy!r} needs distributed/remat.py's policies, "
                    "which come with the sharded substrate (slice 4b); use 'full'")
            raise ValueError(f"unknown remat policy {remat_policy!r}")
        x, aux, _ = self._layers(self._embed(tokens, embeds), remat=remat)
        return self._head(x), aux

    def loss_fn(self, tokens: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None, *,
                embeds: Optional[torch.Tensor] = None, remat: bool = False,
                remat_policy: str = "full", moe_loss_weight: float = 0.01,
                z_loss_weight: float = 1e-4) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``(loss, metrics)`` as the reference's ``loss_fn``: the mean
        next-token NLL over every position from a float32 ``log_softmax``
        (labels default to the tokens shifted left, padded with 0), plus the
        weighted MoE load-balance and z losses; metrics ``{"ce", **aux}``."""
        logits, aux = self.forward(tokens, embeds=embeds, remat=remat,
                                   remat_policy=remat_policy)
        if labels is None:
            labels = F.pad(torch.as_tensor(tokens, device=self.device)[:, 1:], (0, 1))
        labels = torch.as_tensor(labels, device=self.device).long()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
        ce = nll.sum() / nll.numel()
        total = (ce + moe_loss_weight * aux["moe_load_balance"]
                 + z_loss_weight * aux["moe_z"])
        return total, {"ce": ce, **aux}

    # -- serving ----------------------------------------------------------------

    def init_caches(self, batch: int, max_len: int):
        """Zeroed caches on the model's device (:func:`init_caches`)."""
        return init_caches(self.cfg, batch, max_len, self.device)

    @torch.no_grad()
    def prefill(self, tokens: Optional[torch.Tensor] = None, *,
                embeds: Optional[torch.Tensor] = None):
        """Process a whole prompt: ``(last-token logits [B, V], caches)``.

        The caches are the reference's: ``S`` slots on global layers (and MLA
        latents), a ring of ``min(window, S)`` slots on local ones, and each
        recurrent block's state after the last token.
        """
        x, _, kvs = self._layers(self._embed(tokens, embeds))
        S = x.shape[1]
        caches = [self._prefill_cache(kv, li, S) if isinstance(block, DenseBlock) else kv
                  for li, (block, kv) in enumerate(zip(self.entries, kvs))]
        return self._head(x[:, -1:, :])[:, 0, :], caches

    def _prefill_cache(self, kv, layer_idx: int, S: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        if cfg.attn_kind == "mla":
            c_kv, k_pe = kv
            return {"c_kv": c_kv, "k_pe": k_pe}
        k, v = kv
        if cfg.attn_kind == "sliding" and not cfg.is_global_attn(layer_idx):
            # the last w tokens, each at its ring slot pos % window
            w = min(cfg.sliding_window, S)
            idx = torch.arange(S - w, S, device=k.device) % cfg.sliding_window
            kc = torch.zeros((k.shape[0], w, *k.shape[2:]), dtype=k.dtype, device=k.device)
            vc = torch.zeros_like(kc)
            kc[:, idx] = k[:, S - w:]
            vc[:, idx] = v[:, S - w:]
            return {"k": kc, "v": vc}
        return {"k": k, "v": v}

    @torch.no_grad()
    def decode_step(
        self, caches: List[Dict[str, torch.Tensor]], tokens: Optional[torch.Tensor], pos: int,
        *, embeds: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
        """One token for every sequence in the batch.

        tokens: int[B] (or None with ``embeds [B, 1, d_model]``); pos: tokens
        already in the cache.  The caches are written in place (a KV slot, a
        recurrent state's entries).  Returns
        (logits [B, V] float32, caches).
        """
        tokens = None if tokens is None else torch.as_tensor(tokens, device=self.device)[:, None]
        x = self._embed(tokens, embeds)
        for block, cache in zip(self.entries, caches):
            x, _ = block.decode(x, cache, pos)
        return self._head(x)[:, 0, :], caches
