#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

Run from the repository root on a machine with a CUDA device (an H100):
    python3 chip_smoke.py

Phases, each printing one JSON line:
  device   the card's name and power limit (nvidia-smi) and torch's view of it;
  build    nvcc builds both kernels (ptxas register / shared-memory lines);
  kernels  each kernel against its plain version at the serve path's shapes,
           timed with CUDA events beside the plain version and a library call,
           and faulty attention controls the tolerance must reject;
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
SOURCES = {  # kernel: (CUDA source, the TPU kernel's pallas_call site)
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:44"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:83"),
}


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


def _worst_ratio(out: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |out - want| over the BF16_TOL limit; above 1 fails assert_close."""
    lim = BF16_TOL["atol"] + BF16_TOL["rtol"] * want.abs()
    return ((out.float() - want).abs() / lim).max().item()


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
    from repro_torch.kernels.decode_attention import decode_attention_cuda
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
    # local layer's full ring, S = length = 512
    timings = {}
    for S in (PROMPT_LEN + NEW_TOKENS, 512):
        length = S
        q, k, v = randn(REQUESTS, 4, 256), randn(REQUESTS, S, 1, 256), randn(REQUESTS, S, 1, 256)
        q4 = q[:, :, None, :].contiguous()       # [B, H, 1, D]
        k4 = k.permute(0, 2, 1, 3).contiguous()  # [B, KV, S, D]
        v4 = v.permute(0, 2, 1, 3).contiguous()
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
    att = {"dtype": "bfloat16", "max_abs_err": max(c["max_abs_err"] for c in checks),
           **timings[PROMPT_LEN + NEW_TOKENS], "at_S512": timings[512]}
    return {"phase": "kernels", "tolerance": BF16_TOL, "decode_attention_checks": checks,
            "decode_attention_controls": controls, "rmsnorm": rms, "decode_attention": att}


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

    def device_us(evt) -> float:
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(evt, attr):
                return float(getattr(evt, attr))
        return 0.0

    # device-side events only: a CPU op's entry repeats its kernels' time
    rows = [(evt.key, device_us(evt), evt.count) for evt in prof.key_averages()
            if str(getattr(evt, "device_type", "")).endswith("CUDA")]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / 1e3
    per_kernel = {name: next(({"device_ms_per_launch": us / 1e3 / n, "launches": n}
                              for key, us, n in rows if f"{name}_kernel" in key), None)
                  for name in SOURCES}
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
    model, serve = phase_serve(card)
    emit(serve)
    profile = phase_profile(model)
    emit(profile)
    del model
    torch.cuda.empty_cache()
    emit(phase_parity())

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": serve["launches"][name],
         **{key: kernels[name][key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")},
         # mean device time per launch on the serve path (profile phase); `ms`
         # is back-to-back calls by CUDA events, host dispatch included
         "device_ms": profile["kernels"][name]["device_ms_per_launch"]}
        for name, (src, tpu) in SOURCES.items()]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
