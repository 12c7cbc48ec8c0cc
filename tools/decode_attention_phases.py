#!/usr/bin/env python3
"""Where a decode_attention launch spends its time, phase by phase, on the card.

Builds a copy of ``src/repro_torch/kernels/csrc/decode_attention.cu`` with a
timestamp (``%globaltimer``, and ``clock64`` for the SM clock) taken by thread
0 of every CTA at the kernel's phase boundaries, launches it through the
port's wrapper on seeded bf16 operands, and prints one JSON line per shape,
plan and cache state: the median and the maximum over CTAs of each phase, in
microseconds.  Run from the repository root on a machine with a CUDA device:
    python3 tools/decode_attention_phases.py
    python3 tools/decode_attention_phases.py '[[[4, 28, 4, 128, 1024], [64, null]]]'
The argument lists ``[[B, H, KV, D, S], [chunk, ...]]`` pairs (``null``: the
default plan); S is also the length.  Without it: the gemma3-1b serve path's
global (S 544) and local (S 512) layers under the default plan.  "cold"
rotates K and V over copies that exceed twice the 50 MB L2.  The copy and its
library go to ``build/phases/`` (gitignored); the kernel itself is untouched.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SLOTS = 10  # timestamps a CTA
# (marker in the source, timestamp index, insert before the marker?)
MARKS = [
    ("  const Smem lay(sizeof(T), D, rep, a.block, a.splits, pv.GS);\n", 0, False),
    ("    cp_async_wait<1>();  // this block's K (its V may still be in flight)\n"
     "    __syncthreads();\n", 1, False),
    ("    if (next < s_end) {\n      stage<T>(k_s, ks, kg,", 2, True),
    ("    cp_async_wait<1>();  // this block's V (the next block's K may be in flight)\n"
     "    __syncthreads();\n", 3, False),
    ("    __syncthreads();  // the V buffer and the scores are free\n", 4, False),
    ("  __syncthreads();\n  const int bg = b * a.KV + g;\n", 5, True),
    ("  if (a.splits == 1) return;\n", 6, True),
    ("  if (!last) return;\n", 7, True),
    ("  __syncthreads();\n  for (int o = tid; o < split_stride;", 8, True),
]
END = ("    if (lse != nullptr && o * 4 % D == 0) lse[r] = m_s[r] + logf(den);\n  }\n}")  # the kernel's last lines
PHASES = {  # name: (from, to); times of the last block where a chunk has several
    "k_and_q_landed": (0, 1), "scores": (1, 2), "softmax_and_v_landed": (2, 3),
    "p_times_v": (3, 4), "slot_group_sums": (4, 5), "partials_out": (5, 6),
    "arrival": (6, 7), "combine_weights": (7, 8), "combine_out": (8, 9),
}


def _stamp(k: int) -> str:
    cta = "((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) % 8192"
    return (f"  if (threadIdx.x == 0) {{ unsigned long long t_; "
            f"asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
            f"stamp_ns[{cta}][{k}] = t_; stamp_clk[{cta}][{k}] = clock64(); }}\n")


def build_instrumented() -> ctypes.CDLL:
    from repro_torch.kernels import build

    src = (build.CSRC / "decode_attention.cu").read_text()
    head = "using namespace repro_torch;\n"
    src = src.replace(head, head + (
        f"__device__ unsigned long long stamp_ns[8192][{SLOTS}];\n"
        f"__device__ long long stamp_clk[8192][{SLOTS}];\n"
        "extern \"C\" int stamps_read(void* ns, void* clk) {\n"
        "  cudaError_t e = cudaMemcpyFromSymbol(ns, stamp_ns, sizeof(stamp_ns));\n"
        "  return e != cudaSuccess ? e : cudaMemcpyFromSymbol(clk, stamp_clk, sizeof(stamp_clk));\n"
        "}\n"
        "extern \"C\" int stamps_clear(void* zeros) {\n"
        "  return cudaMemcpyToSymbol(stamp_ns, zeros, sizeof(stamp_ns));\n"
        "}\n"), 1)
    for marker, k, before in MARKS + [(END, 9, None)]:
        if src.count(marker) != 1:
            raise RuntimeError(f"marker for timestamp {k} not found once in the source: {marker!r}")
        if before is None:  # the end of the combine: after the CTA's last store
            src = src.replace(marker, marker[:-1] + "  __syncthreads();\n" + _stamp(k) + "}")
        else:
            src = src.replace(marker, _stamp(k) + marker if before else marker + _stamp(k))
    out = build.BUILD_DIR.parent / "phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "decode_attention.cu").write_text(src)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
                    str(out / "decode_attention.so"), str(out / "decode_attention.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out / "decode_attention.so"))
    lib.decode_attention_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.decode_attention_launch.restype = ctypes.c_int
    lib.decode_attention_blocks_per_sm.argtypes = [ctypes.c_int] * 7
    lib.decode_attention_blocks_per_sm.restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_attention_phases: no CUDA device", file=sys.stderr)
        return 2
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    lib = build_instrumented()
    da._lib = lambda: lib  # the wrapper launches the instrumented copy
    cases = json.loads(sys.argv[1]) if len(sys.argv) > 1 else [
        [[4, 4, 1, 256, 544], [None]], [[4, 4, 1, 256, 512], [None]]]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else torch.cuda.get_device_name(0))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    ns = np.zeros((8192, SLOTS), np.uint64)
    clk = np.zeros((8192, SLOTS), np.int64)
    zeros = np.zeros_like(ns)
    for (B, H, KV, D, S), chunks in cases:
        copies = max(2, -(-int(100e6) // (2 * B * S * KV * D * 2)))
        q = torch.randn(B, H, D, generator=gen, device="cuda").bfloat16()
        kv = [(torch.randn(B, S, KV, D, generator=gen, device="cuda").bfloat16(),
               torch.randn(B, S, KV, D, generator=gen, device="cuda").bfloat16())
              for _ in range(copies)]
        for chunk in chunks:
            plan = da.decode_attention_plan(B, KV, H // KV, D, 2, S, sms, chunk=chunk)
            for mode in ("warm", "cold"):
                for it in range(6):  # the last of six launches is read
                    k, v = kv[0] if mode == "warm" else kv[it % copies]
                    torch.cuda.synchronize()
                    lib.stamps_clear(zeros.ctypes.data)
                    da.decode_attention_cuda(q, k, v, S, plan=plan)
                    torch.cuda.synchronize()
                    lib.stamps_read(ns.ctypes.data, clk.ctypes.data)
                n = plan.ctas(B, KV)
                t = ns[:n].astype(np.int64)
                rel = np.where(t > 0, t - t[:, 0].min(), -1) / 1e3
                last = rel[rel[:, 9] > 0]
                row = {"shape": {"B": B, "H": H, "KV": KV, "D": D, "S": S, "length": S},
                       "plan": {"chunk": plan.chunk, "splits": plan.splits,
                                "block": plan.block, "ctas": n},
                       "mode": mode, "start": [float(np.median(rel[:, 0])), float(rel[:, 0].max())]}
                for name, (a, b) in PHASES.items():
                    rows = last if a >= 7 else rel
                    ok = (rows[:, a] >= 0) & (rows[:, b] >= 0)
                    if ok.any():
                        d = rows[ok, b] - rows[ok, a]
                        row[name] = [float(np.median(d)), float(d.max())]
                end = last[:, 9] if len(last) else rel[:, 6]
                row["end"] = float(end.max())
                c = clk[:n]
                row["sm_GHz"] = float(np.median((c[:, 6] - c[:, 0]) / np.maximum(
                    1, t[:, 6] - t[:, 0])))
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
