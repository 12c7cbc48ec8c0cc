#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

Run from the repository root on a machine with a CUDA device (an H100):
    python3 chip_smoke.py

Phases, each printing one JSON line:
  device   the card's name and power limit (nvidia-smi) and torch's view of it;
  build    nvcc builds the four kernels (ptxas register / shared-memory lines);
  kernels  each kernel against its plain version at its path's shapes (and
           gemv / gemv_tiles at the reference's sweeps, in both layouts of A),
           timed with CUDA events beside the plain version and a library call;
           device time per launch of each kernel and of its library call from
           one torch.profiler run; for gemv / gemv_tiles at both shard shapes
           the plan (slices, items, blocks, stages, bytes in flight), achieved
           TB/s and share of the bound, at the gemma3-27b shard also cold (A
           rotated over copies the L2 cannot hold), gemv row-major, and the
           measured plan variants; for decode_attention at S 544 and 512 the
           plan (chunk, splits, CTAs, CTAs an SM, waves), warm and cold device
           time beside SDPA's, the chunk variants (cold), and the kernel at
           three more head layouts beside SDPA; and faulty controls the bf16
           tolerance must reject;
  gemv_allreduce  the fused GEMV+AllReduce and the unfused psum_matmul on 4
           ranks (4 processes sharing the card, a gloo group exchanging
           through host memory) at the paper's Table-1 shape and at
           gemma3-27b's tensor-parallel down-projection: every rank checks
           its result, its owner_served schedule and its kernel launches;
  scans    the Eidola model's replay_lane and spin_reads on the card against
           their numpy closed forms, exactly;
  serve    gemma3-1b at full width (random bf16 weights from a seeded
           generator) through ServeEngine: 4 requests x (480 + 64) tokens,
           asserting 53 rmsnorm and 26 decode_attention launches per step;
  profile  device time by kernel over the last decode steps (torch.profiler),
           beside the wall of the same steps run without the profiler;
  parity   the reduced config in float32 through ServeEngine on the card and
           on the CPU: first-step logits close, greedy tokens identical.
Then the kernel summary line, the card's name and power limit, and last
{"ok": true, "device": {...}}.  Any failure raises: the script exits non-zero
and prints no result.  Without a CUDA device it exits 2 at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

SRC = Path(__file__).resolve().parent / "src"
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and operations/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
# bf16 kernel output against the float32 plain version on the same inputs: the
# kernel rounds its float32 result to bf16 (relative error <= 2^-9), so this is
# about 5x that rounding; it rejects a dropped slot or a bf16 accumulator
# (see ATTENTION_CONTROLS), which the reference's 3e-2 let through
BF16_TOL = dict(rtol=1e-2, atol=4e-3)
F32_LOGIT_TOL = 1e-4                   # card vs CPU, float32, one decode step
PROMPT_LEN, NEW_TOKENS, REQUESTS = 480, 64, 4
F32_TOL = dict(rtol=3e-5, atol=3e-5)  # float32 kernels: the reference's own _tol
SOURCES = {  # kernel: (CUDA source, the TPU kernel's pallas_call site)
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:44"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:83"),
    "gemv": ("src/repro_torch/kernels/csrc/gemv.cu", "src/repro/kernels/gemv.py:53"),
    "gemv_tiles": ("src/repro_torch/kernels/csrc/gemv_tiles.cu",
                   "src/repro/kernels/gemv_tiles.py:92"),
}
SERVE_KERNELS = ("rmsnorm", "decode_attention")  # the serve path's; gemv's run in
# the kernels and gemv_allreduce phases

# The fused GEMV+AllReduce's shapes: y[B, N] = x[B, K] @ w[K, N], K split over
# RANKS ranks, so each rank's kernels see A = w_shard.T [N, K / RANKS] and x.T
# [K / RANKS, B]:
#  - table1: the paper's Table 1 (src/repro/core/config.py:39-47), M = 256,
#    K = 8192, N = 1 in float32: a rank's slice is [256, 2048], the "2 MB slice";
#  - gemma3_27b_tp4: gemma3-27b's MLP down-projection (d_model 5376, d_ff 21504:
#    src/repro/configs/gemma3_27b.py, and Google's public gemma-3-27b config)
#    under 4-way tensor parallelism, at slice 1's decode batch of 4: a rank's
#    w shard is [5376, 5376] bf16 (57,802,752 bytes), 84 tiles of 64 rows.
RANKS = 4
ALLREDUCE_SHAPES = {  # name: (B, K, N, dtype)
    "table1": (1, 8192, 256, "float32"),
    "gemma3_27b_tp4": (4, 21504, 5376, "bfloat16"),
}
BF16_UNIT_ROUNDOFF = 2.0 ** -8  # bf16 keeps 8 significant bits
GEMV_SWEEP = [(128, 512, 1), (256, 1024, 1), (256, 2048, 4), (64, 256, 8)]  # test_kernels.py:19
GEMV_SCHEDULES = [(4, 0), (4, 1), (4, 3), (8, 5)]                           # test_kernels.py:32
GEMV_CONTROLS = ("acc_bf16_per_slab", "one_slab_dropped")  # must be rejected
COLD_COPIES = 4  # copies of the 57.8 MB shard a cold timing rotates over (L2: 50 MB)
ATTENTION_COLD_BYTES = 100e6  # K and V copies a cold attention timing rotates over: 2x the L2
# head layouts (name: H, KV, D) of configs a later slice ports, timed at B 4, S 1024,
# bf16: gemma3-27b (src/repro/configs/gemma3_27b.py), qwen2-vl-7b, kimi-k2
ATTENTION_HEADS = {"gemma3_27b": (32, 16, 128), "qwen2_vl_7b": (28, 4, 128),
                   "kimi_k2": (64, 8, 112)}
ATTENTION_CHUNKS = (16, 32, 64, 128)  # the measured plan variants at the serve shape


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean time of one call over back-to-back calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(bytes_moved: float, ops: float, dtype: str) -> tuple[float, str]:
    """The least time for the work: bytes over HBM rate or ops over peak rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _attention_controls(q, k, v, length: int) -> dict:
    """Plain attention with one fault each, in bf16 like the kernel's output."""
    B, H, D = q.shape
    KV = k.shape[2]
    qh = q.float().reshape(B, KV, H // KV, D) * D ** -0.5
    kf, vf = k[:, :length].float(), v[:, :length].float()
    w = torch.softmax(torch.einsum("bgrd,bsgd->bgrs", qh, kf), dim=-1)

    def pv(weights):
        return torch.einsum("bgrs,bsgd->bgrd", weights, vf).reshape(B, H, D)

    acc = torch.zeros(B, KV, H // KV, D, dtype=torch.bfloat16, device=q.device)
    for j in range(length):  # accumulator kept in bf16, slot by slot
        acc = (acc.float() + w[..., j:j + 1] * vf[:, j, :, None, :]).to(torch.bfloat16)
    from repro_torch.kernels import ref
    return {
        # the reference attention_decode's rounding: a sound bf16 variant
        "p_bf16": pv(w.to(torch.bfloat16).float()).to(torch.bfloat16),
        "acc_bf16_serial": acc.reshape(B, H, D),
        "one_slot_dropped": ref.decode_attention_ref(q.float(), k.float(), v.float(),
                                                     length - 1).to(torch.bfloat16),
    }


ATTENTION_CONTROLS = ("acc_bf16_serial", "one_slot_dropped")  # must be rejected


def _worst_ratio(out: torch.Tensor, want: torch.Tensor, tol: dict = BF16_TOL) -> float:
    """Largest |out - want| over the tolerance's limit; above 1 fails assert_close."""
    lim = tol["atol"] + tol["rtol"] * want.abs()
    return ((out.float() - want).abs() / lim).max().item()


def _device_ms_per_launch(prof, names) -> tuple[list, dict]:
    """The profile's device rows ``(name, µs, count)``, longest first, and the
    mean device time per launch of each named kernel (None if it is absent)."""

    def device_us(evt) -> float:
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(evt, attr):
                return float(getattr(evt, attr))
        return 0.0

    # device-side events only: a CPU op's entry repeats its kernels' time
    rows = [(evt.key, device_us(evt), evt.count) for evt in prof.key_averages()
            if str(getattr(evt, "device_type", "")).endswith("CUDA")]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    return rows, {name: next(({"device_ms_per_launch": us / 1e3 / n, "launches": n}
                              for key, us, n in rows if f"{name}_kernel" in key), None)
                  for name in names}


def _gemv_controls(a: torch.Tensor, x: torch.Tensor, y_plain: torch.Tensor) -> dict:
    """The plain product with one fault each, in bf16 like the kernel's output."""
    M, K = a.shape
    vec = 16 // a.element_size()
    slabs = torch.einsum("msv,svn->smn", a.float().reshape(M, K // vec, vec),
                         x.float().reshape(K // vec, vec, x.shape[1]))  # one per 16-byte slab
    acc = torch.zeros_like(y_plain, dtype=torch.bfloat16)
    for part in slabs:  # the accumulator kept in bf16, one 16-byte slab at a time
        acc = (acc.float() + part).to(torch.bfloat16)
    return {"acc_bf16_per_slab": acc,
            "one_slab_dropped": (y_plain - slabs[K // vec // 2]).to(torch.bfloat16)}


def _profile_calls(calls: dict, operands: list, reps: int = 20, attempts: int = 3) -> dict:
    """Device ms per call of each labelled call, from one torch.profiler run.

    ``calls`` maps a label to a function of one operand: a kernel of the port
    (its label is the kernel's name) or ``"library"``, the PyTorch call it is
    held against.  The calls take turns, each on the next of ``operands``, so
    with copies enough that the L2 cannot hold them every call finds its
    operand cold.  Device rows of the port's kernels are matched by name,
    memsets (the kernels' counters) apart, and every other device row is the
    library call's.  Also returns ``"memset"``: memset ms per profiled call of
    a port kernel.  A run in which the profiler missed launches (it can drop
    activity records) is made again, up to ``attempts`` runs in all.
    """
    from torch.profiler import ProfilerActivity, profile

    ours = [k for k in calls if k != "library"]
    for fn in calls.values():  # warm-up, outside the profile
        fn(operands[0])
    seen = None
    for _ in range(attempts):
        torch.cuda.synchronize()
        j = 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                for fn in calls.values():
                    fn(operands[j % len(operands)])
                    j += 1
            torch.cuda.synchronize()
        rows, _ = _device_ms_per_launch(prof, ())
        out = {k: 0.0 for k in calls}
        out["memset"] = 0.0
        seen = {}
        for key, us, n in rows:
            mine = next((k for k in ours if f"::{k}_kernel<" in key), None)
            if mine is not None:
                seen[mine] = n
                out[mine] = us / 1e3 / n
            elif "memset" in key.lower():
                out["memset"] += us / 1e3 / (reps * len(ours))
            elif "library" in calls:
                out["library"] += us / 1e3 / reps
            else:
                raise AssertionError(f"unexpected device work {key!r} in a profile of {ours}")
        if all(seen.get(k) == reps for k in ours) and out.get("library", 1.0) > 0.0:
            return out
    raise AssertionError(f"in {attempts} profiles of {reps} calls the profiler saw "
                         f"{seen} launches of {ours}")


def _rates(nbytes: int, b_ms: float, ms: float) -> dict:
    return {"achieved_TBps": nbytes / (ms * 1e-3) / 1e12, "bound_share": b_ms / ms}


def _blocks_per_sm(kernel: str, plan, dtype, N: int) -> int:
    from repro_torch.kernels.gemv import blocks_per_sm
    from repro_torch.kernels.gemv_tiles import blocks_per_sm as tiles_blocks_per_sm

    return (blocks_per_sm if kernel == "gemv" else tiles_blocks_per_sm)(plan, dtype, N, 1)


def _plan_line(kernel: str, plan, per_sm: int, sms: int) -> dict:
    """The plan of a launch as the phase line prints it (A = w.T layout).

    ``blocks``: gemv launches one block an item, gemv_tiles a persistent grid
    of what the card holds at once.
    """
    from repro_torch.kernels.gemv import STAGE_BYTES, STAGES

    return {"rows": plan.rows, "group": plan.group, "splits": plan.splits,
            "slice_k": plan.slice_k, "items": plan.items,
            "blocks": plan.items if kernel == "gemv" else min(plan.items, per_sm * sms),
            "blocks_per_sm": per_sm, "stages": STAGES, "stage_bytes": STAGE_BYTES,
            "in_flight_bytes_per_sm": per_sm * (STAGES - 1) * STAGE_BYTES}


def _gemv_kernel_checks(gen: torch.Generator) -> dict:
    """gemv and gemv_tiles against the plain product, in both layouts of A, at
    the reference's sweeps and at the collective's shard shapes; the exact
    owner_served schedules; times, bounds and device time per launch."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.gemv import TILE_ROWS, gemv_cuda, gemv_plan, sm_count
    from repro_torch.kernels.gemv_tiles import (GROUP, gemv_tiles_cuda, remote_first_order,
                                                tile_plan)

    tol = {torch.float32: F32_TOL, torch.bfloat16: BF16_TOL}

    def operands(M, K, N, dtype, layout):
        a = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
        if layout == "w.T":  # a view of a row-major w [K, M], as the collectives pass it
            a = a.T.contiguous().T
        return a, torch.randn(K, N, generator=gen, device="cuda").to(dtype)

    checks = []

    def check(kernel, a, x, layout, **schedule):
        if kernel == "gemv":
            y = gemv_cuda(a, x)
        else:
            y, owner_served = gemv_tiles_cuda(a, x, **schedule)
        y_plain = ref.gemv_ref(a.float(), x.float())
        torch.testing.assert_close(y.float(), y_plain, **tol[a.dtype])
        entry = {"kernel": kernel, "M_K_N": [*a.shape, x.shape[1]], "layout": layout,
                 "dtype": str(a.dtype).removeprefix("torch."), **schedule,
                 "max_abs_err": (y.float() - y_plain).abs().max().item(),
                 "worst_ratio": _worst_ratio(y, y_plain, tol[a.dtype])}
        if kernel == "gemv_tiles":
            n_dev, my_dev = schedule["n_dev"], schedule["my_dev"]
            _, tiles_per_dev = tile_plan(a.shape[0], n_dev, my_dev, schedule.get("bm", 64))
            expect = [t // tiles_per_dev for t in remote_first_order(n_dev, my_dev, tiles_per_dev)]
            if owner_served.tolist() != expect:
                raise AssertionError(f"owner_served {owner_served.tolist()} != {expect}")
        checks.append(entry)

    for layout in ("row_major", "w.T"):
        for M, K, N in GEMV_SWEEP:
            for dtype in (torch.float32, torch.bfloat16):
                check("gemv", *operands(M, K, N, dtype, layout), layout)
        for n_dev, my_dev in GEMV_SCHEDULES:
            check("gemv_tiles", *operands(256, 1024, 1, torch.float32, layout), layout,
                  n_dev=n_dev, my_dev=my_dev, bm=32)
        for B, K, N, dt in ALLREDUCE_SHAPES.values():  # a rank's A = w_shard.T
            a, x = operands(N, K // RANKS, B, getattr(torch, dt), layout)
            check("gemv", a, x, layout)
            for my_dev in range(RANKS):
                check("gemv_tiles", a, x, layout, n_dev=RANKS, my_dev=my_dev)

    sms = sm_count(torch.device("cuda"))
    timings, extra = {}, {}
    for name, (B, K, N, dt) in ALLREDUCE_SHAPES.items():
        a, x = operands(N, K // RANKS, B, getattr(torch, dt), "w.T")
        M, Kr = a.shape
        nbytes = (M * Kr + Kr * B + M * B) * a.element_size()
        bm, tiles_per_dev = tile_plan(M, RANKS, 0, 64)
        n_tiles = M // bm
        plans = {"gemv": gemv_plan(M, Kr, B, a.element_size(), TILE_ROWS, sms),
                 "gemv_tiles": gemv_plan(M, Kr, B, a.element_size(), bm, sms, group=GROUP,
                                         tiles_per_dev=tiles_per_dev)}
        calls = {"gemv": lambda aa: gemv_cuda(aa, x),
                 "gemv_tiles": lambda aa: gemv_tiles_cuda(aa, x, n_dev=RANKS, my_dev=0),
                 "library": lambda aa: torch.matmul(aa, x)}
        warm = _profile_calls(calls, [a])
        library_ms = time_ms(lambda: torch.matmul(a, x))
        bounds = {"gemv": bound_ms(nbytes, 2 * M * Kr * B, dt),
                  "gemv_tiles": bound_ms(nbytes + 4 * n_tiles, 2 * M * Kr * B, dt)}
        timings[name] = {}
        for kernel, plan in plans.items():
            per_sm = _blocks_per_sm(kernel, plan, a.dtype, B)
            b_ms, b_by = bounds[kernel]
            timings[name][kernel] = {
                "shape": {"A": [M, Kr], "x": [Kr, B]}, "dtype": dt, "tiles": n_tiles,
                "ms": time_ms(lambda k=kernel: calls[k](a)),
                "plain_ms": time_ms(lambda: ref.gemv_ref(a, x)) if kernel == "gemv" else
                time_ms(lambda: ref.gemv_tiles_ref(a, x, RANKS, 0)),
                "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
                "device_ms": warm[kernel], "library_device_ms": warm["library"],
                "memset_device_ms_per_call": warm["memset"],
                **_rates(nbytes, b_ms, warm[kernel]),
                "plan": _plan_line(kernel, plan, per_sm, sms),
            }
        if name != "gemma3_27b_tp4":
            continue
        # cold: every call reads a copy of A that the three calls before it
        # pushed out of the 50 MB L2 (4 copies, 231 MB), as a decode step would
        copies = [a] + [a.T.clone().T for _ in range(COLD_COPIES - 1)]
        cold = _profile_calls(calls, copies)
        for kernel in plans:
            timings[name][kernel].update({
                "cold_device_ms": cold[kernel], "library_cold_device_ms": cold["library"],
                **{f"cold_{k}": v for k, v in _rates(nbytes, bounds[kernel][0],
                                                     cold[kernel]).items()}})
        a_rm = a.contiguous()  # gemv's row-major layout, once
        timings[name]["gemv"]["row_major_device_ms"] = _profile_calls(
            {"gemv": lambda aa: gemv_cuda(aa, x)}, [a_rm])["gemv"]
        del a_rm
        # the measured variants, cold: box rows (gemv) or tiles an item
        # (gemv_tiles) against the items an SM the plan aims at
        variants = []
        sweeps = [({"gemv": {"rows": r}, "gemv_tiles": {"group": g}}, {"items_per_sm": i})
                  for r, g in ((64, 1), (128, 2), (256, 4)) for i in (1, 2, 3, 4, 8)]
        for shape_kw, plan_kw in sweeps:
            for kernel in ("gemv", "gemv_tiles"):
                if kernel == "gemv":
                    plan = gemv_plan(M, Kr, B, a.element_size(), shape_kw[kernel]["rows"],
                                     sms, **plan_kw)
                    fn = (lambda aa, p=plan: gemv_cuda(aa, x, plan=p))
                else:
                    plan = gemv_plan(M, Kr, B, a.element_size(), bm, sms,
                                     tiles_per_dev=tiles_per_dev, **shape_kw[kernel],
                                     **plan_kw)
                    fn = (lambda aa, p=plan: gemv_tiles_cuda(aa, x, n_dev=RANKS, my_dev=0,
                                                             plan=p))
                variants.append({
                    "kernel": kernel, **shape_kw[kernel], **plan_kw,
                    "cold_device_ms": _profile_calls({kernel: fn}, copies)[kernel],
                    "plan": _plan_line(kernel, plan, _blocks_per_sm(kernel, plan, a.dtype, B),
                                       sms)})
        # a quarter of the shard's K, 14.5 MB, held in the L2 between calls:
        # what the kernels and cuBLAS reach when DRAM is out of the way
        a_l2 = a[:, :Kr // 4]
        x_l2 = x[:Kr // 4].contiguous()
        l2 = _profile_calls({"gemv": lambda aa: gemv_cuda(aa, x_l2),
                             "gemv_tiles": lambda aa: gemv_tiles_cuda(aa, x_l2, n_dev=RANKS,
                                                                      my_dev=0),
                             "library": lambda aa: torch.matmul(aa, x_l2)}, [a_l2])
        extra["gemv_l2_resident"] = {"A": list(a_l2.shape), "bytes": a_l2.numel() * 2, **{
            k: {"device_ms": ms, "TBps": a_l2.numel() * 2 / (ms * 1e-3) / 1e12}
            for k, ms in l2.items() if k != "memset"}}
        extra["gemv_variants"] = variants
        del copies
        y_plain = ref.gemv_ref(a.float(), x.float())
        controls = {c: {"max_abs_err": (out.float() - y_plain).abs().max().item(),
                        "worst_ratio": _worst_ratio(out, y_plain)}
                    for c, out in _gemv_controls(a, x, y_plain).items()}
        passed = [c for c in GEMV_CONTROLS if controls[c]["worst_ratio"] <= 1.0]
        if passed:
            raise AssertionError(f"tolerance {BF16_TOL} lets faulty gemv controls {passed} pass")
    out = {"gemv_checks": checks, "gemv_controls": controls, **extra}
    for kernel in ("gemv", "gemv_tiles"):
        out[kernel] = {**timings["gemma3_27b_tp4"][kernel],
                       "max_abs_err": max(c["max_abs_err"] for c in checks
                                          if c["kernel"] == kernel),
                       "at_table1": timings["table1"][kernel]}
    return out


def _attention_copies(gen: torch.Generator, B: int, H: int, KV: int, D: int, S: int,
                      copies: int) -> tuple:
    """bf16 q [B, H, D] and ``copies`` of (k, v) [B, S, KV, D], each beside
    SDPA's layout of it, [B, KV, S, D]."""

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    q = randn(B, H, D)
    out = []
    for _ in range(copies):
        k, v = randn(B, S, KV, D), randn(B, S, KV, D)
        out.append((k, v, k.permute(0, 2, 1, 3).contiguous(), v.permute(0, 2, 1, 3).contiguous()))
    return q, out


def _attention_device_ms(q, copies, length: int, plan=None) -> dict:
    """Device ms per call of the kernel and of SDPA (``enable_gqa``) in one
    profile, each call on the next of ``copies``."""
    from repro_torch.kernels.decode_attention import decode_attention_cuda

    q4 = q[:, :, None, :].contiguous()  # [B, H, 1, D]
    return _profile_calls(
        {"decode_attention": lambda c: decode_attention_cuda(q, c[0], c[1], length, plan=plan),
         "library": lambda c: F.scaled_dot_product_attention(q4, c[2], c[3], enable_gqa=True)},
        copies)


def _attention_plan_line(plan, H: int, KV: int, D: int, B: int, sms: int) -> dict:
    from repro_torch.kernels.decode_attention import blocks_per_sm

    per_sm = blocks_per_sm(plan, H, KV, D, torch.bfloat16)
    return {"chunk": plan.chunk, "splits": plan.splits, "block": plan.block,
            "ctas": plan.ctas(B, KV), "blocks_per_sm": per_sm,
            "waves": plan.ctas(B, KV) / (per_sm * sms)}


def _attention_sweep(gen: torch.Generator, sms: int) -> dict:
    """The kernel at the head layouts of ATTENTION_HEADS (B 4, S = length =
    1024, bf16): checked against the plain version, then warm and cold device
    time beside SDPA's under the default plan, and cold under chunk variants."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda, decode_attention_plan

    B, S = REQUESTS, 1024
    out = {}
    for name, (H, KV, D) in ATTENTION_HEADS.items():
        nbytes = 2 * B * S * KV * D * 2
        q, copies = _attention_copies(gen, B, H, KV, D, S, -(-int(ATTENTION_COLD_BYTES) // nbytes))
        k, v = copies[0][:2]
        o = decode_attention_cuda(q, k, v, S)
        o_plain = ref.decode_attention_ref(q.float(), k.float(), v.float(), S)
        torch.testing.assert_close(o.float(), o_plain, **BF16_TOL)
        plan = decode_attention_plan(B, KV, H // KV, D, 2, S, sms)
        warm, cold = _attention_device_ms(q, copies[:1], S), _attention_device_ms(q, copies, S)
        b_ms, b_by = bound_ms(nbytes + 2 * q.numel() * 2, 4 * B * H * S * D, "bfloat16")
        variants = []
        for chunk in (16, 64, 256):
            p = decode_attention_plan(B, KV, H // KV, D, 2, S, sms, chunk=chunk)
            variants.append({**_attention_plan_line(p, H, KV, D, B, sms), "cold_device_ms":
                             _attention_device_ms(q, copies, S, p)["decode_attention"]})
        out[name] = {"H_KV_D": [H, KV, D], "rep": H // KV, "B": B, "S": S, "copies": len(copies),
                     "worst_ratio": _worst_ratio(o, o_plain), "bound_ms": b_ms, "bound_by": b_by,
                     "device_ms": warm["decode_attention"], "library_device_ms": warm["library"],
                     "cold_device_ms": cold["decode_attention"],
                     "library_cold_device_ms": cold["library"],
                     "memset_device_ms_per_call": warm["memset"],
                     "plan": _attention_plan_line(plan, H, KV, D, B, sms), "variants": variants}
        del q, copies
    return out


def phase_build() -> dict:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
             for name, log in logs.items()}
    return {"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas}


def phase_kernels() -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda, decode_attention_plan
    from repro_torch.kernels.gemv import sm_count
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    # rmsnorm at the serve path's shape: x [B, 1, d_model] bf16
    x, g = randn(REQUESTS, 1, 1152), randn(1152) * 0.2
    y = rmsnorm_cuda(x, g)
    y_plain = ref.rmsnorm_ref(x.float(), g.float())
    torch.testing.assert_close(y.float(), y_plain, **BF16_TOL)
    w = (1.0 + g.float()).to(torch.bfloat16)  # F.rms_norm scales by weight, not 1 + weight
    b_ms, b_by = bound_ms(2 * x.numel() * 2 + g.numel() * 2, 5 * x.numel(), "float32")
    rms = {
        "shape": list(x.shape), "dtype": "bfloat16",
        "max_abs_err": (y.float() - y_plain).abs().max().item(),
        "ms": time_ms(lambda: rmsnorm_cuda(x, g)),
        "plain_ms": time_ms(lambda: ref.rmsnorm_ref(x, g)),
        "library_ms": time_ms(lambda: F.rms_norm(x, (1152,), weight=w, eps=1e-6)),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    same_run = _profile_calls({"rmsnorm": lambda xx: rmsnorm_cuda(xx, g),
                               "library": lambda xx: F.rms_norm(xx, (1152,), weight=w, eps=1e-6)},
                              [x])
    rms.update(device_ms=same_run["rmsnorm"], library_device_ms=same_run["library"])

    # decode_attention: q [B, 4, 256], k/v [B, S, 1, 256] bf16; the 22 local
    # layers see S = 512, the 4 global layers S = plen + new = 544
    checks = []
    for S in (512, 544):
        q, k, v = randn(REQUESTS, 4, 256), randn(REQUESTS, S, 1, 256), randn(REQUESTS, S, 1, 256)
        for length in (1, 300, 512, 544):
            if length > S:
                continue
            o = decode_attention_cuda(q, k, v, length)
            o_plain = ref.decode_attention_ref(q.float(), k.float(), v.float(), length)
            torch.testing.assert_close(o.float(), o_plain, **BF16_TOL)
            checks.append({"S": S, "length": length,
                           "max_abs_err": (o.float() - o_plain).abs().max().item(),
                           "worst_ratio": _worst_ratio(o, o_plain)})
    # timed at the global layers' last step, S = length = 544, and at a
    # local layer's full ring, S = length = 512; cold: K and V rotated over
    # copies that exceed twice the L2, as the serve path's 26 layers do
    timings = {}
    sms = sm_count(dev)
    for S in (PROMPT_LEN + NEW_TOKENS, 512):
        length = S
        nbytes_kv = 2 * REQUESTS * S * 256 * 2
        q, copies = _attention_copies(gen, REQUESTS, 4, 1, 256, S,
                                      -(-int(ATTENTION_COLD_BYTES) // nbytes_kv))
        k, v, k4, v4 = copies[0]
        q4 = q[:, :, None, :].contiguous()       # [B, H, 1, D]
        o_lib = F.scaled_dot_product_attention(q4, k4, v4, enable_gqa=True)[:, :, 0]
        o_plain = ref.decode_attention_ref(q.float(), k.float(), v.float(), length)
        torch.testing.assert_close(o_lib.float(), o_plain, **BF16_TOL)
        if S == PROMPT_LEN + NEW_TOKENS:
            controls = {name: {"max_abs_err": (out.float() - o_plain).abs().max().item(),
                               "worst_ratio": _worst_ratio(out, o_plain)}
                        for name, out in _attention_controls(q, k, v, length).items()}
            passed = [name for name in ATTENTION_CONTROLS
                      if controls[name]["worst_ratio"] <= 1.0]
            if passed:
                raise AssertionError(f"tolerance {BF16_TOL} lets faulty controls {passed} pass")
        nbytes = (q.numel() + 2 * REQUESTS * length * 256 + q.numel()) * 2
        b_ms, b_by = bound_ms(nbytes, 4 * REQUESTS * 4 * length * 256, "bfloat16")
        timings[S] = {
            "shape": {"q": list(q.shape), "k": list(k.shape), "length": length},
            "ms": time_ms(lambda: decode_attention_cuda(q, k, v, length)),
            "plain_ms": time_ms(lambda: ref.decode_attention_ref(q, k, v, length)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        warm = _attention_device_ms(q, copies[:1], length)
        cold = _attention_device_ms(q, copies, length)
        timings[S].update(device_ms=warm["decode_attention"], library_device_ms=warm["library"],
                          cold_device_ms=cold["decode_attention"],
                          library_cold_device_ms=cold["library"], copies=len(copies),
                          memset_device_ms_per_call=warm["memset"],
                          **_rates(nbytes, b_ms, warm["decode_attention"]),
                          plan=_attention_plan_line(
                              decode_attention_plan(REQUESTS, 1, 4, 256, 2, length, sms),
                              4, 1, 256, REQUESTS, sms))
        if S == PROMPT_LEN + NEW_TOKENS:  # the measured plan variants, cold
            variants = [{**_attention_plan_line(plan, 4, 1, 256, REQUESTS, sms),
                         "cold_device_ms": _attention_device_ms(q, copies, length,
                                                                plan)["decode_attention"]}
                        for plan in (decode_attention_plan(REQUESTS, 1, 4, 256, 2, length, sms,
                                                           chunk=c) for c in ATTENTION_CHUNKS)]
        del q, k, v, k4, v4, copies
    att = {"dtype": "bfloat16", "max_abs_err": max(c["max_abs_err"] for c in checks),
           **timings[PROMPT_LEN + NEW_TOKENS], "at_S512": timings[512]}
    return {"phase": "kernels", "tolerance": BF16_TOL, "f32_tolerance": F32_TOL,
            "decode_attention_checks": checks, "decode_attention_controls": controls,
            "rmsnorm": rms, "decode_attention": att, "decode_attention_variants": variants,
            "decode_attention_heads": _attention_sweep(gen, sms), **_gemv_kernel_checks(gen)}


def _allreduce_rank(rank: int, world: int, shapes: dict, reps: int) -> dict:
    """One rank of the gemv_allreduce phase, in its own spawned process.

    Every rank makes the whole x and w from one seed on the card, keeps its
    K slice, runs fused_gemv_allreduce and psum_matmul once (counting their
    kernel launches), and holds both against the plain float32 product x @ w
    on the card.  Tolerance: float32 keeps the JAX test's 1e-4.  In bf16 each
    rank's partial p_r is rounded once (world roundings) and the ring adds
    world - 1 times in bf16, as the reference's does (collectives.py:92); the
    all-reduce adds world - 1 times too.  Each of those 2 world - 1 roundings
    errs by at most 2^-8 of a value no larger than sum_r |p_r|, so the limit
    is (2 world - 1) 2^-8 sum_r |p_r|, plus the float32 1e-4 for the sums.
    A control with the successor's partial dropped must break it.
    """
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import torch.distributed as dist

    from repro_torch.distributed import fused_gemv_allreduce, psum_matmul
    from repro_torch.distributed.collectives import exchange_device
    from repro_torch.kernels.gemv import gemv_cuda
    from repro_torch.kernels.gemv_tiles import gemv_tiles_cuda, remote_first_order, tile_plan

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    out = {"backend": str(dist.get_backend()), "shapes": {}}
    for name, (B, K, N, dt) in shapes.items():
        dtype = getattr(torch, dt)
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(B, K, generator=gen, device=dev).to(dtype)
        w = (torch.randn(K, N, generator=gen, device=dev) * 0.05).to(dtype)
        ks = K // world
        xs, ws = x[:, rank * ks:(rank + 1) * ks], w[rank * ks:(rank + 1) * ks]
        gemv_cuda.launches = gemv_tiles_cuda.launches = 0
        y_fused, owner_served = fused_gemv_allreduce(xs, ws)
        y_psum = psum_matmul(xs, ws)
        torch.cuda.synchronize()
        launches = {"gemv_tiles": gemv_tiles_cuda.launches, "gemv": gemv_cuda.launches}
        if launches != {"gemv_tiles": 1, "gemv": 1}:
            raise AssertionError(f"rank {rank}, {name}: kernel launches {launches}")
        out["exchange_device"] = str(exchange_device(y_fused))

        partials = [x[:, r * ks:(r + 1) * ks].float() @ w[r * ks:(r + 1) * ks].float()
                    for r in range(world)]
        plain = x.float() @ w.float()
        limit = 1e-4 + 1e-4 * plain.abs()
        if dtype == torch.bfloat16:
            limit += (2 * world - 1) * BF16_UNIT_ROUNDOFF * sum(p.abs() for p in partials)

        def ratio(y, lim=limit):
            return ((y.float() - plain).abs() / lim).max().item()

        res = {"fused_worst_ratio": ratio(y_fused), "psum_worst_ratio": ratio(y_psum),
               "fused_vs_psum_worst_ratio": ((y_fused.float() - y_psum.float()).abs()
                                             / (2 * limit)).max().item(),
               "fused_max_abs_err": (y_fused.float() - plain).abs().max().item(),
               "psum_max_abs_err": (y_psum.float() - plain).abs().max().item(),
               "dropped_partial_worst_ratio":
                   ratio((plain - partials[(rank + 1) % world]).to(dtype)),
               "launches": launches}
        if max(res["fused_worst_ratio"], res["psum_worst_ratio"],
               res["fused_vs_psum_worst_ratio"]) > 1.0:
            raise AssertionError(f"rank {rank}, {name}: out of tolerance {res}")
        if res["dropped_partial_worst_ratio"] <= 1.0:
            raise AssertionError(f"rank {rank}, {name}: the tolerance lets a dropped "
                                 f"partial pass {res}")
        _, tiles_per_dev = tile_plan(N, world, rank, 64)
        expect = [t // tiles_per_dev for t in remote_first_order(world, rank, tiles_per_dev)]
        if owner_served.tolist() != expect:
            raise AssertionError(f"rank {rank}, {name}: owner_served "
                                 f"{owner_served.tolist()} != {expect}")
        res["owner_served"] = owner_served.tolist()
        # the ranks share one card and the host: walls, not kernel speeds
        for label, fn in (("fused", lambda: fused_gemv_allreduce(xs, ws)),
                          ("psum", lambda: psum_matmul(xs, ws))):
            dist.barrier()
            walls = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            res[f"{label}_wall_ms_median"] = float(np.median(walls))
            res[f"{label}_wall_ms_min"] = min(walls)
        out["shapes"][name] = res
        del x, w, partials, plain, limit
        torch.cuda.empty_cache()
    return out


def phase_gemv_allreduce() -> dict:
    from repro_torch.distributed import run_world

    t0 = time.perf_counter()
    ranks = run_world(_allreduce_rank, RANKS, ALLREDUCE_SHAPES, 10, timeout=300)
    backends = {r["backend"] for r in ranks}
    places = {r["exchange_device"] for r in ranks}
    if len(backends) != 1 or len(places) != 1:
        raise AssertionError(f"ranks disagree on the exchange: {backends}, {places}")
    place = places.pop()
    exchange = f"{backends.pop()} " + ("via host" if place == "cpu" else f"on {place}")
    shapes = {}
    for name, (B, K, N, dt) in ALLREDUCE_SHAPES.items():
        per_rank = [r["shapes"][name] for r in ranks]
        shapes[name] = {
            "x": [B, K], "w": [K, N], "dtype": dt, "shard": [K // RANKS, N],
            **{key: max(p[key] for p in per_rank)
               for key in ("fused_worst_ratio", "psum_worst_ratio",
                           "fused_vs_psum_worst_ratio", "fused_max_abs_err",
                           "psum_max_abs_err")},
            "dropped_partial_worst_ratio_min": min(p["dropped_partial_worst_ratio"]
                                                   for p in per_rank),
            "per_rank": per_rank,
        }
    return {"phase": "gemv_allreduce", "ranks": RANKS, "exchange": exchange,
            "note": "the ranks are processes sharing one card: walls, not kernel speeds",
            "seconds": time.perf_counter() - t0, "shapes": shapes,
            "launches": {k: sum(r["shapes"][name]["launches"][k] for r in ranks
                                for name in ALLREDUCE_SHAPES)
                         for k in ("gemv", "gemv_tiles")}}


def _replay_lane_numpy(dispatch, is_wait, val, poll, check):
    """The script's own copy of repro/core/cohort_timeline.py::replay_lane_numpy."""
    t = np.array(dispatch, np.int64, copy=True)
    reads = np.zeros_like(t)
    for w, v in zip(is_wait, val):
        if w:
            nticks = np.maximum((v - t + poll - 1) // poll, 0)
            reads += nticks + 1
            t += nticks * poll + check
        else:
            t += v
    return reads, t


def _spin_reads_numpy(wait_start, flag_T, poll, check):
    """The script's own copy of the SPIN branch of repro/core/vector_engine.py:129-135."""
    c = np.array(wait_start, np.int64, copy=True)
    reads = np.zeros_like(c)
    for T in flag_T:
        already = T <= c
        nticks = np.where(already, 0, np.ceil(np.maximum(T - c, 0) / poll).astype(np.int64))
        reads += np.where(already, 1, nticks + 1)
        c = np.where(already, c + check, c + nticks * poll + check)
    return reads, c


def phase_scans() -> dict:
    """The model's two scans on the card at pod scale, against numpy, exactly."""
    from repro_torch.core import replay_lane, spin_reads

    rng = np.random.default_rng(0)
    cohorts, steps, poll, check = 4096, 64, 64, 4  # poll / check: SimConfig's defaults
    dispatch = rng.integers(0, 5000, cohorts)
    is_wait = rng.random(steps) < 0.5
    val = np.where(is_wait, rng.integers(0, 2_000_000, steps), rng.integers(1, 4000, steps))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reads, end = replay_lane(dispatch, is_wait, val, poll=poll, check=check)
    torch.cuda.synchronize()
    lane_wall = time.perf_counter() - t0
    if not (reads.is_cuda and end.is_cuda and reads.dtype == torch.int64):
        raise AssertionError("replay_lane did not run in int64 on the card")
    r_np, t_np = _replay_lane_numpy(dispatch, is_wait, val, poll, check)
    if not (np.array_equal(reads.cpu().numpy(), r_np) and np.array_equal(end.cpu().numpy(), t_np)):
        raise AssertionError("replay_lane on the card differs from the numpy closed form")

    wait_start = rng.integers(0, 200_000, cohorts)
    flag_T = rng.integers(0, 400_000, steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_reads, cursor = spin_reads(wait_start, flag_T, 52, check)
    torch.cuda.synchronize()
    spin_wall = time.perf_counter() - t0
    s_np, c_np = _spin_reads_numpy(wait_start, flag_T, 52, check)
    if not (s_reads.is_cuda and np.array_equal(s_reads.cpu().numpy(), s_np)
            and np.array_equal(cursor.cpu().numpy(), c_np)):
        raise AssertionError("spin_reads on the card differs from the numpy closed form")
    return {"phase": "scans", "cohorts": cohorts, "steps": steps, "exact": True,
            "replay_lane_wall_s": lane_wall, "spin_reads_wall_s": spin_wall,
            "flag_reads": int(r_np.sum()), "end_cycle_max": int(t_np.max()),
            "spin_flag_reads": int(s_np.sum())}


def phase_serve(card: str):
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.models import Model
    from repro_torch.serving import ServeConfig, ServeEngine

    cfg = get_config("gemma3-1b")  # full width, bf16
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = Model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = np.random.default_rng(0).integers(1, cfg.vocab, (REQUESTS, PROMPT_LEN)).tolist()

    # one decode step on its own: finite logits of the expected shape
    caches = model.init_caches(REQUESTS, 8)
    logits, _ = model.decode_step(caches, torch.tensor([p[0] for p in prompts], device=dev), 0)
    if logits.shape != (REQUESTS, cfg.vocab) or not torch.isfinite(logits).all():
        raise AssertionError(f"bad first-step logits {tuple(logits.shape)}")
    ServeEngine(model, ServeConfig(max_batch=REQUESTS)).generate(
        [p[:8] for p in prompts], 2)  # warm-up: cuBLAS handles, allocator

    eng = ServeEngine(model, ServeConfig(max_batch=REQUESTS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rmsnorm_cuda.launches = decode_attention_cuda.launches = 0
    t0 = time.perf_counter()
    outs = eng.generate(prompts, NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"rmsnorm": rmsnorm_cuda.launches,
                "decode_attention": decode_attention_cuda.launches}

    steps = eng.stats["prefill_tokens"] // REQUESTS + eng.stats["decode_steps"]
    if steps != PROMPT_LEN + NEW_TOKENS:
        raise AssertionError(f"{steps} decode steps, expected {PROMPT_LEN + NEW_TOKENS}")
    expect = {"rmsnorm": (2 * cfg.n_layers + 1) * steps,
              "decode_attention": cfg.n_layers * steps}
    if launches != expect:
        raise AssertionError(f"kernel launches {launches} != {expect}")
    if not all(len(o) == PROMPT_LEN + NEW_TOKENS and all(0 <= t < cfg.vocab for t in o)
               for o in outs):
        raise AssertionError("served outputs have the wrong length or token range")
    return model, {
        "phase": "serve", "arch": cfg.name, "params": model.n_params(),
        "dtype": "bfloat16", "requests": REQUESTS, "prompt_len": PROMPT_LEN,
        "new_tokens": NEW_TOKENS, "decode_steps": steps, "stats": eng.stats,
        "launches": launches, "expected_launches": expect,
        "wall_s": wall, "new_tokens_per_s": REQUESTS * NEW_TOKENS / wall,
        "ms_per_step": wall * 1e3 / steps, "init_s": init_s,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(), "card": card,
    }


def phase_profile(model, steps: int = 32) -> dict:
    """Device time by kernel over the last decode steps of a 544-token batch.

    The same steps also run without the profiler just before and just after
    it.  The idle share reads the profiled device busy time against the run
    before; the run after shows how far the host-bound wall of the same
    device work moves inside one call.  The caches hold zeros, which changes
    no kernel's work: attention reads min(pos + 1, S) slots whatever they
    hold.
    """
    from torch.profiler import ProfilerActivity, profile

    end = PROMPT_LEN + NEW_TOKENS
    caches = model.init_caches(REQUESTS, end)
    toks = torch.ones(REQUESTS, dtype=torch.long, device="cuda")
    model.decode_step(caches, toks, end - steps - 1)

    def run_steps() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pos in range(end - steps, end):
            model.decode_step(caches, toks, pos)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    plain_before = run_steps()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_ms = run_steps()
    plain_after = run_steps()

    rows, per_kernel = _device_ms_per_launch(prof, SERVE_KERNELS)
    busy_ms = sum(r[1] for r in rows) / 1e3
    return {"phase": "profile", "steps": steps, "positions": [end - steps, end - 1],
            "wall_ms_per_step_profiled": wall_ms / steps,
            "wall_ms_per_step_unprofiled": plain_before / steps,
            "wall_ms_per_step_after_profiler": plain_after / steps,
            "device_busy_ms_per_step": busy_ms / steps,
            "device_idle_share_profiled": 1 - busy_ms / wall_ms,
            "device_idle_share": 1 - busy_ms / plain_before,
            "kernels": per_kernel,
            "top": [{"name": key[:80], "device_ms_per_step": us / 1e3 / steps, "count": n}
                    for key, us, n in rows[:12]]}


def phase_parity() -> dict:
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import Model
    from repro_torch.serving import ServeConfig, ServeEngine

    cfg = reduced(get_config("gemma3-1b")).with_(param_dtype=torch.float32)
    gpu = Model(cfg).init(torch.Generator().manual_seed(1))
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    toks = torch.tensor([5, 9])
    lg, _ = gpu.decode_step(gpu.init_caches(2, 4), toks.cuda(), 0)
    lc, _ = cpu.decode_step(cpu.init_caches(2, 4), toks, 0)
    err = (lg.cpu() - lc).abs().max().item()
    if not err <= F32_LOGIT_TOL:
        raise AssertionError(f"first-step logits differ by {err} > {F32_LOGIT_TOL}")
    prompts = [[5, 6, 7], [9, 10], [1, 2, 3, 4],
               np.random.default_rng(1).integers(1, cfg.vocab, 21).tolist()]
    res = {}
    for name, model in (("cuda", gpu), ("cpu", cpu)):
        eng = ServeEngine(model, ServeConfig(max_batch=2))
        res[name] = (eng.generate(prompts, 12), dict(eng.stats))
    if res["cuda"] != res["cpu"]:
        raise AssertionError("greedy tokens or stats differ between the card and the CPU")
    return {"phase": "parity", "config": "gemma3-1b reduced, float32",
            "first_step_logit_max_abs_err": err, "tolerance": F32_LOGIT_TOL,
            "greedy_tokens_identical": True, "stats": res["cuda"][1]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import repro_torch  # noqa: F401  (fails before any output outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    emit(phase_build())
    kernels = phase_kernels()
    emit(kernels)
    torch.cuda.empty_cache()
    allreduce = phase_gemv_allreduce()
    emit(allreduce)
    emit(phase_scans())
    model, serve = phase_serve(card)
    emit(serve)
    profile = phase_profile(model)
    emit(profile)
    del model
    torch.cuda.empty_cache()
    emit(phase_parity())

    def launches_and_device_ms(name):
        # the serve path's kernels: launches in the serve phase, mean device
        # time per launch on that path (profile phase); gemv's: launches over
        # every rank of the gemv_allreduce phase, device time per launch at
        # the gemma3-27b shard (kernels phase).  `ms` is back-to-back calls by
        # CUDA events, host dispatch included.
        if name in SERVE_KERNELS:
            return serve["launches"][name], profile["kernels"][name]["device_ms_per_launch"]
        return allreduce["launches"][name], kernels[name]["device_ms"]

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         **dict(zip(("launches", "device_ms"), launches_and_device_ms(name))),
         **{key: kernels[name][key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms", "library_device_ms")},
         **{key: kernels[name][key] for key in ("cold_device_ms", "library_cold_device_ms",
                                                "plan") if key in kernels[name]}}
        for name, (src, tpu) in SOURCES.items()]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
