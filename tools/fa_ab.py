"""Time the fp32 flash-attention kernels against an older build of their
sources, in turns, on one card: the forward (``--mode fwd``) and the
backward's dK/dV and dQ kernels (``--mode bwd``; both by default); or the
backward's preprocess, either dtype (``--mode pre``).

``python tools/fa_ab.py --old DIR [--mode fwd|bwd|both|pre] [--ceilings]``

``DIR`` holds another version's ``flash_attention.cu``,
``flash_attention_bwd.cu`` and the headers they include (``fa_hopper.cuh``,
and ``fa_tf32.cuh`` where that version has it): for example
``src/repro_torch/kernels/flash_attention/csrc/`` of a ``git archive`` of
the parent commit.  Both versions are built with ``kernels/build.py`` and
called on the same fp32 inputs, each through its library's C entry
points into outputs made beforehand, so that no Python wrapper's checks or
allocations land inside the timed window.  Each kernel is timed old, new,
new, old: the median over 15 windows of ``BURST`` launches back to back,
per launch (CUDA events).  Prints the card's name and power limit first,
each library's registers and spills per fp32 kernel from ``-Xptxas -v``,
and the largest difference between the two versions' outputs.  Needs a
CUDA card.

* Forward: ``fa_launch`` (dtype 0, the fp32 kernel; timed without the
  log-sum-exp, as serving launches it) at ``FWD_SHAPES``; each version's
  worst |Δ| over 2e-5 against ``attention_ref`` and its lse's over
  1e-4·max(max|ref|, 1) against ``attention_lse_ref``.
* Backward: ``fa_bwd_dkdv_launch`` and ``fa_bwd_dq_launch`` at
  ``BWD_SHAPES`` (q, k, v, dO normal; o and lse from the new forward, D
  from the preprocess kernel); each version's worst |Δ| over the fp32
  bar 1e-4·max(max|ref|, 1) against ``attention_bwd_ref``.

* Preprocess: ``fa_bwd_preprocess_launch`` at ``PRE_SHAPES`` (o and dO
  normal, bf16 and fp32), with each version's worst |Δ| over
  1e-4·max(max|ref|, 1) against ``bwd_preprocess_ref``, whether the two
  agree bit for bit, and each one's share of the byte bound (o and dO
  read, D written once, at 3.35 TB/s).

``--ceilings`` (backward) also times, at the first shape and in turns
with the new build, variants made from the new ``fa_tf32.cuh``'s text,
and says whether each gives the new build's outputs bit for bit: "no
split" (every operand passed as both of its TF32 terms: the same three
MMAs a product without the splitting's arithmetic; wrong results), "no
MMA" (each ``mma.sync`` an empty statement that keeps its operands: the
loads, splits and the rest without the tensor cores; wrong results) and
"lo cleared" (the lo term's 13 low bits cleared by hand: equal bits show
that the tensor cores read a .tf32 operand cut to its top 19); and the
rate of ``mma.sync.m16n8k8`` TF32 issued back to back, eight independent
sums a warp, at 8 and 16 warps an SM (``MMA_RATE_SRC``).
"""
from __future__ import annotations

import argparse
import ctypes
import math
import re
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from ab_common import card, ms  # noqa: E402
from repro_torch.kernels.build import CudaLibrary  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_lse_ref, attention_ref, bwd_preprocess_ref)

# [B, L, H, D], causal: hubert-xlarge's fp32 attention (non-causal), then
# phase 11 (b)'s fp32 llama3-8b attention and phase 11 (a)'s shape.
FWD_SHAPES = (((4, 2048, 16, 80), False), ((1, 2048, 32, 128), True),
              ((2, 4096, 32, 128), True))
FWD_BAR = 2e-5
BWD_SHAPES = (((1, 2048, 32, 128), True), ((2, 4096, 32, 128), True))
BAR = 1e-4
# [B, L, H, D], dtype: phase 11 (a)'s step, (b)'s fp32 llama3-8b step and
# phase 14's two head dims, each launching the preprocess once a layer.
PRE_SHAPES = (((2, 4096, 32, 128), torch.bfloat16),
              ((1, 2048, 32, 128), torch.float32),
              ((2, 4096, 32, 96), torch.bfloat16),
              ((2, 4096, 16, 256), torch.bfloat16))
HBM_BYTES_PER_S = 3.35e12
HEADERS = ("fa_hopper.cuh", "fa_tf32.cuh")

# The --ceilings variants: (name, text in the source, its replacement).
MMA_ASM = ('  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "\n'
           '      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, '
           '{%0, %1, %2, %3};\\n"')
VARIANTS = (
    ("no split",
     "  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
     "  lo = __float_as_uint(x - __uint_as_float(hi));",
     "  hi = __float_as_uint(x);\n  lo = hi;"),
    ("no MMA", MMA_ASM,
     '  asm volatile("// %0 %1 %2 %3 %4 %5 %6 %7 %8 %9\\n"'),
    ("lo cleared", "  lo = __float_as_uint(x - __uint_as_float(hi));",
     "  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;"))

# One kernel: 8 independent m16n8k8 TF32 sums a warp, `iters` rounds.
MMA_RATE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void __launch_bounds__(256) mma_rate(float* out, int iters) {
  const uint32_t a0 = __float_as_uint(1.f + threadIdx.x), a1 = a0 ^ 0x2000u;
  const uint32_t b0 = __float_as_uint(0.5f), b1 = __float_as_uint(-0.25f);
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};\n"
          : "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
          : "r"(a0), "r"(a1), "r"(a1), "r"(a0), "r"(b0), "r"(b1));
  }
  float s = 0.f;
  for (int i = 0; i < 8; ++i) s += d[i][0] + d[i][1] + d[i][2] + d[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_rate_launch(void* out, int blocks, int iters,
                               void* stream) {
  mma_rate<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  return (int)cudaGetLastError();
}
"""


def old_library(name, source, bind) -> CudaLibrary:
    """The old version's library: ``source`` with the headers it has."""
    return CudaLibrary(name, source, ("-lcuda",), bind,
                       tuple(source.parent / h for h in HEADERS
                             if (source.parent / h).exists()))


def report_build(tag, lib, pattern) -> None:
    """Registers and spills of the library's kernels matching
    ``pattern``."""
    lib.load()
    for name, (regs, st, ld) in sorted(lib.ptxas().items()):
        if re.search(pattern, name):
            print(f"[{tag}] {name}: {regs} registers, spills {st} / {ld}",
                  flush=True)


def variant_libs() -> dict:
    """The --ceilings variants of the new fa_tf32.cuh, written with the
    backward's source under the kernels' git-ignored build directory."""
    hdr = (fa.CSRC / "fa_tf32.cuh").read_text()
    out = {}
    for name, old, new in VARIANTS:
        if hdr.count(old) != 1:
            raise SystemExit(f"--ceilings: fa_tf32.cuh no longer holds the "
                             f"text the {name!r} variant replaces")
        d = fa.LIB_BWD.build_root / "variants" / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        for f in ("flash_attention_bwd.cu", "fa_hopper.cuh"):
            (d / f).write_text((fa.CSRC / f).read_text())
        (d / "fa_tf32.cuh").write_text(hdr.replace(old, new))
        out[name] = CudaLibrary("fa_bwd_" + name.replace(" ", "_"),
                                d / "flash_attention_bwd.cu", ("-lcuda",),
                                fa._bind_bwd,
                                tuple(d / h for h in HEADERS)).load()
    return out


def mma_rate() -> None:
    """TFLOP/s of mma.sync m16n8k8 TF32 issued back to back."""
    d = fa.LIB_BWD.build_root / "variants" / "mma_rate"
    d.mkdir(parents=True, exist_ok=True)
    (d / "mma_rate.cu").write_text(MMA_RATE_SRC)

    def bind(lib):
        lib.mma_rate_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_void_p]
    lib = CudaLibrary("mma_rate", d / "mma_rate.cu", (), bind).load()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    iters = 4096
    for per_sm in (1, 2):
        blocks = sms * per_sm
        out = torch.empty(blocks * 256, device="cuda")
        t = ms(lambda: lib.mma_rate_launch(out.data_ptr(), blocks, iters,
                                           stream), reps=5)
        flops = blocks * 8 * iters * 8 * 2 * 16 * 8 * 8
        print(f"mma.sync m16n8k8 TF32, {8 * per_sm} warps an SM: "
              f"{flops / (t * 1e-3) / 1e12:.1f} TFLOP/s ({t:.5f} ms)",
              flush=True)


def fwd_mode(old_dir: Path) -> None:
    """The fp32 forward kernel, old against new, at FWD_SHAPES."""
    new_lib = fa.LIB
    old_lib = old_library("flash_attention_old",
                          old_dir / "flash_attention.cu", fa._bind)
    pattern = r"fa_kernel_(?!tc)"
    report_build("new", new_lib, pattern)
    report_build("old", old_lib, pattern)
    libs = {"old": old_lib.load(), "new": new_lib.load()}
    stream = torch.cuda.current_stream().cuda_stream
    for (B, L, H, D), causal in FWD_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(B * L + D)
        q, k, v = (torch.randn((B, L, H, D), generator=gen, device="cuda")
                   for _ in range(3))
        want = attention_ref(q, k, v, causal)
        want_lse = attention_lse_ref(q, k, causal)
        scale = 1.0 / math.sqrt(D)
        outs = {tag: (torch.empty_like(q),
                      torch.empty((B, H, L), device="cuda"))
                for tag in libs}

        def call(tag, lse):
            lib, (o, stats) = libs[tag], outs[tag]
            return lambda: lib.fa_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                stats.data_ptr() if lse else None, 0, B, H, L, L, D, scale,
                int(causal), stream)

        for tag in libs:
            if call(tag, True)() != 0:
                raise RuntimeError(f"{tag}: launch failed")
        torch.cuda.synchronize()
        for tag, (o, stats) in outs.items():
            r_o = float((o - want).abs().max()) / FWD_BAR
            r_l = float((stats - want_lse).abs().max()) / (
                BAR * max(float(want_lse.abs().max()), 1.0))
            print(f"[B,H,L,D]={[B, H, L, D]} causal={causal} fp32 forward "
                  f"{tag}: worst |Δ|/2e-5 {r_o:.4g}, lse |Δ|/bar "
                  f"{r_l:.4g}", flush=True)
            if not max(r_o, r_l) <= 1.0:
                raise AssertionError(f"{tag} misses the fp32 bar")
        diff = float((outs["old"][0] - outs["new"][0]).abs().max())
        t = (ms(call("old", False)), ms(call("new", False)),
             ms(call("new", False)), ms(call("old", False)))
        print(f"[B,H,L,D]={[B, H, L, D]} causal={causal} fp32 forward: "
              f"old, new, new, old ms a launch "
              f"{', '.join(f'{x:.5f}' for x in t)}; new / old "
              f"{(t[1] + t[2]) / (t[0] + t[3]):.4f}; max|new - old| "
              f"{diff:.3g}", flush=True)
        del q, k, v, want, want_lse, outs
        torch.cuda.empty_cache()


def bwd_mode(old_dir: Path, ceilings: bool) -> None:
    """The fp32 dK/dV and dQ kernels, old against new, at BWD_SHAPES."""
    new_lib = fa.LIB_BWD
    old_lib = old_library("flash_attention_bwd_old",
                          old_dir / "flash_attention_bwd.cu", fa._bind_bwd)
    pattern = r"fa_bwd_(dkdv|dq)(?!_tc)"
    report_build("new", new_lib, pattern)
    report_build("old", old_lib, pattern)
    libs = {"old": old_lib.load(), "new": new_lib.load()}
    for (B, L, H, D), causal in BWD_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(B * L + D)
        q, k, v, do = (torch.randn((B, L, H, D), generator=gen,
                                   device="cuda") for _ in range(4))
        o, lse = fa.flash_attention_cuda(q, k, v, causal, lse=True)
        delta = fa.bwd_preprocess_cuda(o, do)
        want = attention_bwd_ref(q, k, v, o, do, lse, causal)
        stream = torch.cuda.current_stream().cuda_stream
        scale = 1.0 / math.sqrt(D)
        outs = {tag: [torch.empty_like(q) for _ in range(3)]
                for tag in libs}

        def dkdv(tag):
            lib, (_, dk, dv) = libs[tag], outs[tag]
            return lambda: lib.fa_bwd_dkdv_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), 0, B, H, L, L, D, scale, int(causal), stream)

        def dq(tag):
            lib, (dqo, _, _) = libs[tag], outs[tag]
            return lambda: lib.fa_bwd_dq_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dqo.data_ptr(), 0, B, H,
                L, L, D, scale, int(causal), stream)

        calls = {"dkdv": {t: dkdv(t) for t in libs},
                 "dq": {t: dq(t) for t in libs}}
        for step in calls.values():
            for fn in step.values():
                if fn() != 0:
                    raise RuntimeError("launch failed")
        torch.cuda.synchronize()
        for tag in libs:
            ratios = [float((g - w).abs().max())
                      / (BAR * max(float(w.abs().max()), 1.0))
                      for g, w in zip(outs[tag], want)]
            print(f"[B,H,L,D]={[B, H, L, D]} causal={causal} fp32 {tag}: "
                  f"worst |Δ|/bar dq, dk, dv "
                  f"{', '.join(f'{r:.4g}' for r in ratios)}", flush=True)
            if not max(ratios) <= 1.0:
                raise AssertionError(f"{tag} misses the fp32 bar")
        diff = [float((a - b).abs().max())
                for a, b in zip(outs["old"], outs["new"])]
        for name, step in calls.items():
            t = (ms(step["old"]), ms(step["new"]), ms(step["new"]),
                 ms(step["old"]))
            print(f"[B,H,L,D]={[B, H, L, D]} causal={causal} fp32 {name}: "
                  f"old, new, new, old ms a launch "
                  f"{', '.join(f'{x:.5f}' for x in t)}; new / old "
                  f"{(t[1] + t[2]) / (t[0] + t[3]):.4f}", flush=True)
        print(f"[B,H,L,D]={[B, H, L, D]}: max|new - old| dq, dk, dv "
              f"{', '.join(f'{x:.3g}' for x in diff)}", flush=True)
        if ceilings and (B, L, H, D) == BWD_SHAPES[0][0]:
            for name, lib in variant_libs().items():
                libs[name] = lib
                outs[name] = [torch.empty_like(q) for _ in range(3)]
                for step, fn in (("dkdv", dkdv), ("dq", dq)):
                    t = (ms(fn("new")), ms(fn(name)), ms(fn(name)),
                         ms(fn("new")))
                    print(f"[B,H,L,D]={[B, H, L, D]} causal={causal} fp32 "
                          f"{step}: new, {name}, {name}, new ms a launch "
                          f"{', '.join(f'{x:.5f}' for x in t)}", flush=True)
                torch.cuda.synchronize()
                same = [torch.equal(a, b)
                        for a, b in zip(outs[name], outs["new"])]
                print(f"{name}: dq, dk, dv bit for bit the new build's "
                      f"{same}", flush=True)
                del libs[name], outs[name]
            mma_rate()
        del q, k, v, do, o, lse, delta, want, outs
        torch.cuda.empty_cache()


def pre_mode(old_dir: Path) -> None:
    """The preprocess, old against new, at PRE_SHAPES."""
    new_lib = fa.LIB_BWD
    old_lib = old_library("flash_attention_bwd_old",
                          old_dir / "flash_attention_bwd.cu", fa._bind_bwd)
    report_build("new", new_lib, r"fa_bwd_preprocess")
    report_build("old", old_lib, r"fa_bwd_preprocess")
    libs = {"old": old_lib.load(), "new": new_lib.load()}
    stream = torch.cuda.current_stream().cuda_stream
    for (B, L, H, D), dtype in PRE_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(B * L + D)
        o, do = (torch.randn((B, L, H, D), generator=gen, device="cuda")
                 .to(dtype) for _ in range(2))
        want = bwd_preprocess_ref(o, do)
        outs = {tag: torch.empty((B, H, L), device="cuda") for tag in libs}

        def call(tag):
            return lambda: libs[tag].fa_bwd_preprocess_launch(
                o.data_ptr(), do.data_ptr(), outs[tag].data_ptr(),
                fa.DTYPES[dtype], B, H, L, D, stream)

        for tag in libs:
            if call(tag)() != 0:
                raise RuntimeError(f"{tag}: launch failed")
        torch.cuda.synchronize()
        name = f"[B,H,L,D]={[B, H, L, D]} {str(dtype)[6:]} preprocess"
        for tag, got in outs.items():
            r = float((got - want).abs().max()) / (
                BAR * max(float(want.abs().max()), 1.0))
            print(f"{name} {tag}: worst |Δ|/bar {r:.4g}", flush=True)
            if not r <= 1.0:
                raise AssertionError(f"{tag} misses the bar")
        t = (ms(call("old")), ms(call("new")), ms(call("new")),
             ms(call("old")))
        nbytes = 2 * B * L * H * D * o.element_size() + B * H * L * 4
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"{name}: old, new, new, old ms a launch "
              f"{', '.join(f'{x:.5f}' for x in t)}; new / old "
              f"{(t[1] + t[2]) / (t[0] + t[3]):.4f}; byte bound "
              f"{bound:.6f}, share old {2 * bound / (t[0] + t[3]):.3f} new "
              f"{2 * bound / (t[1] + t[2]):.3f}; bitwise "
              f"{torch.equal(outs['old'], outs['new'])}", flush=True)
        del o, do, want, outs
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, type=Path)
    ap.add_argument("--mode", choices=("fwd", "bwd", "both", "pre"),
                    default="both")
    ap.add_argument("--ceilings", action="store_true")
    args = ap.parse_args()
    old_dir = args.old.resolve()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card(), flush=True)
    if args.mode in ("fwd", "both"):
        fwd_mode(old_dir)
    if args.mode in ("bwd", "both"):
        bwd_mode(old_dir, args.ceilings)
    if args.mode == "pre":
        pre_mode(old_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
