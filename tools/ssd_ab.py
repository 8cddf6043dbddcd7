"""Time the SSD's kernels against an older build of their sources, in
turns, on one card: the chunk kernel and backward, and the carry and its
backward.

``python tools/ssd_ab.py --old DIR [--plans] [--heads]``

``DIR`` holds another version's ``ssd.cu``, ``ssd_bwd.cu`` and
``ssd_mma.cuh`` (for example ``src/repro_torch/kernels/ssd/csrc/`` of a
``git archive`` of the parent commit).  Both are built with
``kernels/build.py`` and called at chunk 64 (the chunk both take) on the
same inputs, each through its library's C entry point into outputs made
beforehand (no Python wrapper's checks or allocations inside the timed
window): the chunk kernel (bf16: the CUDA-core kernel, ``terms`` 0, and
the row "chunk tc", ``ssd_chunk_tc`` with ``kernel.TERMS``; fp32:
``ssd_chunk_tf32``, ``terms`` 3, where the old build takes it, else the
old build's CUDA-core kernel), the carry (``ssd_carry_launch``: bf16
``ssd_carry_tc``, fp32 ``ssd_carry_tf32`` where the build has it, else
``ssd_carry_kernel``; the new build prints its plan), the carry backward
(``ssd_carry_bwd_launch`` with ``tc`` 1: bf16 ``ssd_carry_bwd_tc``, fp32
``ssd_carry_bwd_tf32`` where the build takes it, else ``ssd_carry_bwd``)
and the chunk backward (``tc`` 1: bf16 ``ssd_chunk_bwd_tc``, fp32
``ssd_chunk_bwd_tf32`` where the old build takes it, else
``ssd_chunk_bwd``).  For fp32 the new
build's tensor-core kernels are also timed against its own CUDA-core
kernels on the same inputs (the rows "chunk, CUDA cores", "carry, CUDA
cores" (``ssd_carry_core_launch``), "carry bwd, CUDA cores" and "chunk
bwd, CUDA cores": "old" is the CUDA-core kernel).  Each is timed old,
new, new, old:
the median over 15 windows of ``BURST`` launches back to back, per
launch (CUDA events), so that the card never waits on the host between
launches.  Also prints whether the two agree bit for bit (the backward:
max |Δ| per output, and whether every output is equal bit for bit),
each library's registers and spills per kernel
from ``-Xptxas -v``, and, where ``cuobjdump`` is on the path, each
kernel's SASS instruction count.  For the carry it also prints the host
time of one call to each build's C entry point (old, new, new, old:
the median over 9 windows of ``HOST_CALLS`` calls, perf_counter, the
card's queue never full), which holds the new build's plan lookup.
Then the chunk kernel, the carry backward and the chunk backward at the
chunks of 128 to 256 rows (``TILED_SHAPES``), through each build's
tensor-core kernels where it takes the chunk (bf16 ``ssd_chunk_tc_tiled``,
``ssd_carry_bwd_tc`` and ``ssd_chunk_bwd_tc_tiled``, fp32
``ssd_chunk_tf32_tiled``, ``ssd_carry_bwd_tf32`` and
``ssd_chunk_bwd_tf32_tiled``), else its CUDA-core kernels; and the new
build's carry backward there against its own ``ssd_carry_bwd`` (the row
"carry bwd, CUDA cores").  Prints the card's name and power limit
first.  Needs a CUDA card.

``--plans`` also times the new tensor-core carry at each shape
(``ssd_carry_tc`` for bf16, ``ssd_carry_tf32`` for fp32) under every plan
it can take (slices of 8, 16, 32 and 64 columns, rings of 1 to 3 stages),
with the chosen plan timed before and after, and says whether each gives
the new build's outputs bit for bit.  The plans are
forced through a variant of the new ``ssd.cu``, written under the
kernels' git-ignored build directory, to which ``FORCE_PLAN`` adds an
entry point ``ssd_carry_force_plan(ps, stages)`` (ps 0: the chosen plan
again); the library the program loads has no such entry point.

``--heads`` also times the new fp32 tensor-core kernels at each fp32
shape at every group of heads a block they can take (each divisor of H
up to 16), ``ssd_chunk_bwd_tf32`` through its entry point's ``G``
argument and ``ssd_chunk_tf32`` through a variant of the new ``ssd.cu``
to which ``FORCE_HEADS`` adds ``ssd_chunk_tf32_force_heads(g)`` (0: the
kernel's own choice), and prints the group each takes by itself.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from ab_common import card, ms  # noqa: E402
from repro_torch.kernels.build import CudaLibrary  # noqa: E402
from repro_torch.kernels.ssd import kernel as sk  # noqa: E402
from repro_torch.kernels.ssd.ref import (chunk_cumsum,  # noqa: E402
                                         ssd_carry_bwd_ref)

# (B, L, H, P, N, Q), dtype: mamba2-780m's heads in fp32 at 1 x 2048
# (phase 11 (b)'s fp32 step in chip_smoke.py) and 2 x 4096, and
# zamba2-1.2b's at 2 x 4096 (the fp32 tensor-core kernels' dtype), then in
# bf16 zamba2-1.2b's 4 x 2048 prefill, mamba2-780m's 2 x 4096 training step
# and zamba2-1.2b's 32,768-token prompt: the chunk pass on the CUDA-core
# kernel and on ssd_chunk_tc, the carry on ssd_carry_tc (bf16 C), the
# backward on ssd_carry_bwd_tc and ssd_chunk_bwd_tc.
SHAPES = (((1, 2048, 48, 64, 128, 64), torch.float32),
          ((2, 4096, 48, 64, 128, 64), torch.float32),
          ((2, 4096, 64, 64, 64, 64), torch.float32),
          ((4, 2048, 64, 64, 64, 64), torch.bfloat16),
          ((2, 4096, 48, 64, 128, 64), torch.bfloat16),
          ((1, 32768, 64, 64, 64, 64), torch.bfloat16))


# The chunks of 128 to 256 rows the tiled tensor-core kernels take
# (chip_smoke.py's SSD_TILED): mamba2-780m's heads at 2 x 4096 in chunks of
# 128 and 256 and zamba2-1.2b's in chunks of 256, fp32 and bf16.
TILED_SHAPES = tuple((s, dt) for dt in (torch.float32, torch.bfloat16)
                     for s in ((2, 4096, 48, 64, 128, 128),
                               (2, 4096, 48, 64, 128, 256),
                               (2, 4096, 64, 64, 64, 256)))

HOST_CALLS = 100

# The --plans variant: a forced plan, read by carry_tc_plan before its
# cache, and the entry point that sets it.
PLAN_HEAD = """template <typename TC, typename TY>
cudaError_t carry_tc_plan(int B, int H, int P, int N, int Q,
                          CarryTcPlan* plan) {
"""
FORCE_PLAN = (PLAN_HEAD, "int g_force_ps = 0, g_force_stages = 0;\n\n"
              + PLAN_HEAD + """  if (g_force_ps) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return carry_tc_candidate<TC, TY>(g_force_ps, B, H, P, N, Q,
                                      g_force_stages, sms, plan);
  }
""")
FORCE_ENTRY = """
extern "C" int ssd_carry_force_plan(int ps, int stages) {
  if (ps != 0 && ((ps != 8 && ps != 16 && ps != 32 && ps != 64) ||
                  stages < 1 || stages > kCarryPlanStages))
    return (int)cudaErrorInvalidValue;
  g_force_ps = ps;
  g_force_stages = stages;
  return 0;
}
"""


def bind(lib):
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ssd_chunk_launch.argtypes = [P] * 7 + [I] * 8 + [P]
    lib.ssd_carry_launch.argtypes = [P] * 7 + [I] * 8 + [P]


def bind_plans(lib):
    bind(lib)
    lib.ssd_carry_force_plan.argtypes = [ctypes.c_int] * 2


def plans_lib():
    """The new ssd.cu with FORCE_PLAN and FORCE_ENTRY, built."""
    src = (sk.CSRC / "ssd.cu").read_text()
    if src.count(FORCE_PLAN[0]) != 1:
        raise SystemExit("--plans: ssd.cu no longer holds carry_tc_plan's "
                         "head as FORCE_PLAN expects it")
    d = sk.LIB.build_root / "variants" / "carry_plans"
    d.mkdir(parents=True, exist_ok=True)
    (d / "ssd.cu").write_text(src.replace(*FORCE_PLAN) + FORCE_ENTRY)
    (d / "ssd_mma.cuh").write_text((sk.CSRC / "ssd_mma.cuh").read_text())
    return CudaLibrary("ssd_plans", d / "ssd.cu", (), bind_plans,
                       headers=(d / "ssd_mma.cuh",)).load()


# The --heads variant: the forward's heads a block forced by an entry
# point.
HEADS_HEAD = "int tf32_heads_per_block(int pairs, int H, int sms) {\n"
FORCE_HEADS = (HEADS_HEAD, "int g_force_heads = 0;\n\n" + HEADS_HEAD
               + "  if (g_force_heads) return g_force_heads;\n")
FORCE_HEADS_ENTRY = """
extern "C" int ssd_chunk_tf32_force_heads(int g) {
  if (g < 0 || g > 16) return (int)cudaErrorInvalidValue;
  g_force_heads = g;
  return 0;
}
"""


def heads_lib():
    """The new ssd.cu with FORCE_HEADS and FORCE_HEADS_ENTRY, built."""
    src = (sk.CSRC / "ssd.cu").read_text()
    if src.count(FORCE_HEADS[0]) != 1:
        raise SystemExit("--heads: ssd.cu no longer holds "
                         "tf32_heads_per_block as FORCE_HEADS expects it")
    d = sk.LIB.build_root / "variants" / "tf32_heads"
    d.mkdir(parents=True, exist_ok=True)
    (d / "ssd.cu").write_text(src.replace(*FORCE_HEADS) + FORCE_HEADS_ENTRY)
    (d / "ssd_mma.cuh").write_text((sk.CSRC / "ssd_mma.cuh").read_text())

    def bind_heads(lib):
        bind(lib)
        lib.ssd_chunk_tf32_force_heads.argtypes = [ctypes.c_int]
    return CudaLibrary("ssd_tf32_heads", d / "ssd.cu", (), bind_heads,
                       headers=(d / "ssd_mma.cuh",)).load()


def time_heads(lib, fwd, bwd, shape, sms) -> None:
    """The fp32 tensor-core kernels at every group of heads a block:
    ``fwd()`` through the --heads variant ``lib``, ``bwd(G)`` a call of
    the new backward library with G heads a block."""
    B, L, H, P, N, Q = shape
    pairs = B * L // Q
    for g in range(1, 17):
        if H % g:
            continue
        assert lib.ssd_chunk_tf32_force_heads(g) == 0 and fwd() == 0
        t_fwd = ms(fwd)
        call = bwd(g)
        assert call() == 0
        print(f"{list(shape)} float32 at {g} heads a block "
              f"({pairs * H // g} blocks): ssd_chunk_tf32 {t_fwd:.5f}, "
              f"ssd_chunk_bwd_tf32 {ms(call):.5f} ms a launch", flush=True)
    lib.ssd_chunk_tf32_force_heads(0)
    print(f"{list(shape)} float32: the kernels take "
          f"{sk.chunk_tf32_heads(pairs, H, sms)} (forward) and "
          f"{sk.tf32_heads(pairs, H, sms)} "
          f"(backward) heads a block", flush=True)


def host_us(fn, reps=9):
    """Median host µs a call over ``reps`` windows of HOST_CALLS calls."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        times.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def bind_bwd(lib):
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ssd_chunk_bwd_launch.argtypes = [P] * 13 + [I] * 9 + [P]
    lib.ssd_carry_bwd_launch.argtypes = [P] * 9 + [I] * 8 + [P]
    lib.ssd_chunk_bwd_tiled_launch.argtypes = [P] * 14 + [I] * 8 + [P]


def sass_counts(so) -> dict:
    """{function: SASS instructions} from ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            out[cur] = 0
        elif cur and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            out[cur] += 1
    return out


def report_builds(tag, libs) -> None:
    for lib in libs:
        regs, sass = lib.ptxas(), sass_counts(lib.build())
        for name in sorted(set(regs) | set(sass)):
            if "ssd" not in name:
                continue
            r = regs.get(name, (None, None, None))
            print(f"[{tag}] {name}: registers {r[0]}, spills {r[1]} / "
                  f"{r[2]}, SASS instructions {sass.get(name)}", flush=True)


def time_plans(lib, call, out, want, shape) -> None:
    """The plans variant ``lib`` (``call`` writing ``out``) under every plan
    it takes at this shape, between two timings of its chosen plan;
    bitwise against the new build's y and final state ``want``."""
    chosen = ms(call)
    for ps in (8, 16, 32, 64):
        for stages in (1, 2, 3):
            if lib.ssd_carry_force_plan(ps, stages) != 0 or call() != 0:
                continue
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(out, want))
            print(f"{list(shape)} carry plan ps {ps} stages {stages}: "
                  f"{ms(call):.5f} ms a launch; bitwise the new build's "
                  f"{same}", flush=True)
    lib.ssd_carry_force_plan(0, 0)
    print(f"{list(shape)} carry, chosen plan: {chosen:.5f} then "
          f"{ms(call):.5f} ms a launch", flush=True)


def time_tiled(old, old_bwd, new, new_bwd, sms) -> None:
    """The chunk kernel, carry backward and chunk backward at
    ``TILED_SHAPES`` through both builds' C entry points, old, new, new,
    old: the tensor-core kernels (``ssd_chunk_launch`` with the dtype's
    terms, ``ssd_carry_bwd_launch`` with ``tc`` 1,
    ``ssd_chunk_bwd_tiled_launch``), which the new build must take at
    every shape; the old build's CUDA-core kernels (``terms`` 0, ``tc`` 0,
    ``ssd_chunk_bwd_launch`` with ``tc`` 0) where it refuses them, named
    in the line as "old core"; the new build's tensor-core carry backward
    also against its own ``ssd_carry_bwd`` ("carry bwd, CUDA cores": "old"
    is the CUDA-core kernel); each
    backward's outputs finished as the wrapper finishes them (its tails
    added to the chunks' last rows, the partial dB and dC summed over
    their groups where the two builds group the heads apart)."""
    for shape, dtype in TILED_SHAPES:
        B, L, H, P, N, Q = shape
        gen = torch.Generator(device="cuda").manual_seed(1)
        x, Bm, Cm, dy = (torch.randn(sz, generator=gen, device="cuda")
                         .to(dtype) for sz in ((B, L, H, P), (B, L, N),
                                               (B, L, N), (B, L, H, P)))
        dt = 0.01 + 0.19 * torch.rand((B, L, H), generator=gen,
                                      device="cuda")
        A = -(0.5 + 1.5 * torch.rand((H,), generator=gen, device="cuda"))
        h0, df = (torch.randn((B, H, N, P), generator=gen, device="cuda")
                  for _ in range(2))
        cum = chunk_cumsum(dt, A, Q)
        code = sk.DTYPES[dtype]
        stream = torch.cuda.current_stream().cuda_stream
        terms = sk.TERMS if dtype == torch.bfloat16 else sk.TF32_TERMS
        name = sk.bwd_kernels(dtype, Q, P, N)[1]
        G = sk.chunk_bwd_heads(name, B * L // Q, H, sms, Q)
        Gc = sk.bwd_heads_per_block(B * L // Q, H, sms)
        fwd_out = {v: [torch.empty(sz, device="cuda") for sz in (
            (B, L, H, P), (B, L // Q, H, N, P))] for v in ("old", "new")}

        def chunk(lib, out, t):
            return lambda: lib.ssd_chunk_launch(
                x.data_ptr(), dt.data_ptr(), cum.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), code,
                B, L, H, P, N, Q, t, stream)
        calls = {"chunk": {}, "chunk bwd": {}}
        old_core = {}   # what the old build falls back to its CUDA cores for
        for v, lib in (("old", old), ("new", new)):
            fn = chunk(lib, fwd_out[v], terms)
            if fn() != 0:
                assert v == "old", f"{shape} {dtype}: the new build " \
                    f"refuses its tiled chunk kernel"
                fn, old_core["chunk"] = chunk(lib, fwd_out[v], 0), True
            calls["chunk"][v] = fn
        assert calls["chunk"]["old"]() == 0 and calls["chunk"]["new"]() == 0
        st = fwd_out["new"][1]

        def carry_bwd(lib, out, tc):
            return lambda: lib.ssd_carry_bwd_launch(
                st.data_ptr(), cum.data_ptr(), Cm.data_ptr(), dy.data_ptr(),
                h0.data_ptr(), df.data_ptr(), *(o.data_ptr() for o in out),
                code, B, L, H, P, N, Q, tc, stream)
        cbwd_out = {v: [torch.empty_like(st), torch.empty_like(st),
                        torch.empty((B, H, N, P), device="cuda")]
                    for v in ("old", "new", "core")}
        calls["carry bwd"] = {"new": carry_bwd(new_bwd, cbwd_out["new"], 1)}
        assert calls["carry bwd"]["new"]() == 0, f"{shape} {dtype}: the " \
            f"new build refuses its tensor-core carry backward"
        fn = carry_bwd(old_bwd, cbwd_out["old"], 1)
        if fn() != 0:
            fn, old_core["carry bwd"] = (
                carry_bwd(old_bwd, cbwd_out["old"], 0), True)
            assert fn() == 0
        calls["carry bwd"]["old"] = fn
        calls["carry bwd, CUDA cores"] = {
            "old": carry_bwd(new_bwd, cbwd_out["core"], 0),
            "new": calls["carry bwd"]["new"]}
        for fn in calls["carry bwd, CUDA cores"].values():
            assert fn() == 0
        h_prev, g, _ = ssd_carry_bwd_ref(st, cum, Cm, dy, Q, h0, df)
        ins = [t.data_ptr() for t in (x, dt, cum, Bm, Cm, dy, g, h_prev)]
        bwd_out = {}

        def outs(groups, tiled):
            return [torch.empty(sz, device="cuda") for sz in (
                (B, L, H, P), (B, L, H), (B, L, H), (H // groups, B, L, N),
                (H // groups, B, L, N))] + (
                [torch.empty((B, L // Q, Q // 64, H), device="cuda")]
                if tiled else [])
        for v, lib in (("old", old_bwd), ("new", new_bwd)):
            o = outs(G, True)
            fn = (lambda lib=lib, o=o: lib.ssd_chunk_bwd_tiled_launch(
                *ins, *(t.data_ptr() for t in o), code, B, L, H, P, N, Q, G,
                stream))
            if fn() != 0:
                assert v == "old", f"{shape} {dtype}: the new build " \
                    f"refuses its tiled chunk backward"
                old_core["chunk bwd"] = True
                o = outs(Gc, False)
                fn = (lambda lib=lib, o=o: lib.ssd_chunk_bwd_launch(
                    *ins, *(t.data_ptr() for t in o), code, B, L, H, P, N,
                    Q, Gc, 0, stream))
            assert fn() == 0
            calls["chunk bwd"][v], bwd_out[v] = fn, o
        torch.cuda.synchronize()

        def finished(o):
            o = [t.clone() for t in o]
            if len(o) == 6:
                o[1].view(B, L // Q, Q, H)[:, :, -1] += o[5].sum(2)
            return [o[0], o[1], o[2], o[3].sum(0), o[4].sum(0)]
        fo, fn_ = finished(bwd_out["old"]), finished(bwd_out["new"])
        pairs = {"chunk": (fwd_out["old"], fwd_out["new"]),
                 "carry bwd": (cbwd_out["old"], cbwd_out["new"]),
                 "carry bwd, CUDA cores": (cbwd_out["core"],
                                           cbwd_out["new"])}
        same = {what: [float((a - b).abs().max()) for a, b in zip(*o)]
                for what, o in pairs.items()}
        same["chunk bwd"] = [float((a - b).abs().max())
                             for a, b in zip(fo, fn_)]
        bitwise = {what: all(torch.equal(a, b) for a, b in zip(*o))
                   for what, o in pairs.items()}
        bitwise["chunk bwd"] = (
            len(bwd_out["old"]) == len(bwd_out["new"])
            and all(a.shape == b.shape and torch.equal(a, b)
                    for a, b in zip(bwd_out["old"], bwd_out["new"])))
        for what, c in calls.items():
            t = (ms(c["old"]), ms(c["new"]), ms(c["new"]), ms(c["old"]))
            side = "old core" if old_core.get(what) else "old"
            print(f"{list(shape)} {str(dtype)[6:]} tiled {what}: {side}, new, "
                  f"new, old ms a launch {', '.join(f'{v:.5f}' for v in t)}; "
                  f"new / old {(t[1] + t[2]) / (t[0] + t[3]):.4f}; max|Δ| "
                  f"per output {same[what]}; bitwise {bitwise[what]}",
                  flush=True)
        del x, Bm, Cm, dy, dt, cum, h0, df, fwd_out, bwd_out, g, h_prev
        del st, cbwd_out
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, type=Path)
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--heads", action="store_true")
    args = ap.parse_args()
    old_dir = args.old.resolve()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(card(), flush=True)
    hdr = (old_dir / "ssd_mma.cuh",)
    old_libs = (CudaLibrary("ssd_old", old_dir / "ssd.cu", (), bind,
                            headers=hdr),
                CudaLibrary("ssd_bwd_old", old_dir / "ssd_bwd.cu", (),
                            bind_bwd, headers=hdr))
    old, old_bwd_lib = (lib.load() for lib in old_libs)
    new, new_bwd_lib = sk.LIB.load(), sk.LIB_BWD.load()
    report_builds("old", old_libs)
    report_builds("new", (sk.LIB, sk.LIB_BWD))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = plans_lib() if args.plans else None
    heads = heads_lib() if args.heads else None
    for shape, dtype in SHAPES:
        B, L, H, P, N, Q = shape
        gen = torch.Generator(device="cuda").manual_seed(0)
        x, Bm, Cm, dy = (torch.randn(s, generator=gen, device="cuda")
                         .to(dtype) for s in ((B, L, H, P), (B, L, N),
                                              (B, L, N), (B, L, H, P)))
        dt = 0.01 + 0.19 * torch.rand((B, L, H), generator=gen,
                                      device="cuda")
        A = -(0.5 + 1.5 * torch.rand((H,), generator=gen, device="cuda"))
        cum = chunk_cumsum(dt, A, Q)
        code = sk.DTYPES[dtype]
        stream = torch.cuda.current_stream().cuda_stream

        def empty(*shapes, dtype=torch.float32):
            return [torch.empty(s, device="cuda", dtype=dtype)
                    for s in shapes]

        f32 = dtype == torch.float32

        def chunk(lib, out, terms=0):
            return lambda: lib.ssd_chunk_launch(
                x.data_ptr(), dt.data_ptr(), cum.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), code,
                B, L, H, P, N, Q, terms, stream)

        def taken(make):
            """The TF32 call where the library takes it, else the
            CUDA-core one."""
            fn = make(1)
            return fn if fn() == 0 else make(0)
        chunk_out = {v: empty((B, L, H, P), (B, L // Q, H, N, P))
                     for v in ("old", "new", "core")}
        yi, st = chunk_out["new"]
        tf32 = sk.TF32_TERMS if f32 else 0

        def carry(lib, out, core=False):
            entry = lib.ssd_carry_core_launch if core else lib.ssd_carry_launch
            return lambda: entry(
                yi.data_ptr(), st.data_ptr(), cum.data_ptr(), Cm.data_ptr(),
                None, out[0].data_ptr(), out[1].data_ptr(), code, code, B, L,
                H, P, N, Q, stream)
        carry_out = {v: empty((B, L, H, P), dtype=dtype) + empty((B, H, N, P))
                     for v in ("old", "new", "core")}
        h0, df = (torch.randn((B, H, N, P), generator=gen, device="cuda")
                  for _ in range(2))

        def carry_bwd(lib, out, tc=1):
            return lambda: lib.ssd_carry_bwd_launch(
                st.data_ptr(), cum.data_ptr(), Cm.data_ptr(), dy.data_ptr(),
                h0.data_ptr(), df.data_ptr(), *[o.data_ptr() for o in out],
                code, B, L, H, P, N, Q, tc, stream)
        cbwd_out = {v: empty(st.shape, st.shape, (B, H, N, P))
                    for v in ("old", "new", "core")}
        calls = {"chunk": {
            "old": taken(lambda t: chunk(old, chunk_out["old"], t * tf32)),
            "new": chunk(new, chunk_out["new"], tf32)}}
        outs = {"chunk": {k: chunk_out[k] for k in ("old", "new")}}
        if not f32:
            tc_out = {v: empty((B, L, H, P), (B, L // Q, H, N, P))
                      for v in ("old", "new")}
            calls["chunk tc"] = {v: chunk(lib, tc_out[v], sk.TERMS)
                                 for v, lib in (("old", old), ("new", new))}
            outs["chunk tc"] = tc_out
        if f32:
            calls["chunk, CUDA cores"] = {
                "old": chunk(new, chunk_out["core"]),
                "new": calls["chunk"]["new"]}
            outs["chunk, CUDA cores"] = {"old": chunk_out["core"],
                                         "new": chunk_out["new"]}
        for fn in calls["chunk"].values():
            assert fn() == 0
        calls["carry"] = {"old": carry(old, carry_out["old"]),
                          "new": carry(new, carry_out["new"])}
        outs["carry"] = {k: carry_out[k] for k in ("old", "new")}
        calls["carry bwd"] = {
            "old": taken(lambda t: carry_bwd(old_bwd_lib, cbwd_out["old"],
                                             t)),
            "new": carry_bwd(new_bwd_lib, cbwd_out["new"])}
        outs["carry bwd"] = {k: cbwd_out[k] for k in ("old", "new")}
        if f32:
            calls["carry, CUDA cores"] = {
                "old": carry(new, carry_out["core"], core=True),
                "new": calls["carry"]["new"]}
            outs["carry, CUDA cores"] = {"old": carry_out["core"],
                                         "new": carry_out["new"]}
            calls["carry bwd, CUDA cores"] = {
                "old": carry_bwd(new_bwd_lib, cbwd_out["core"], 0),
                "new": calls["carry bwd"]["new"]}
            outs["carry bwd, CUDA cores"] = {"old": cbwd_out["core"],
                                             "new": cbwd_out["new"]}
        h_prev, g, _ = ssd_carry_bwd_ref(st, cum, Cm, dy, Q)
        # Heads a block: the tensor-core kernel's rule for a tc call
        # (TF32 for fp32), ssd_chunk_bwd's for a CUDA-core one (the
        # partial dB, dC sums follow it).
        groups = {1: sk.chunk_bwd_heads(sk.bwd_kernels(dtype, Q, P, N)[1],
                                        B * L // Q, H, sms, Q),
                  0: sk.bwd_heads_per_block(B * L // Q, H, sms)}

        def bwd(lib, out, tc=0):
            G = groups[tc]
            if out[3].shape[0] != H // G:
                out[3:] = empty((H // G, B, L, N), (H // G, B, L, N))
            return lambda: lib.ssd_chunk_bwd_launch(
                x.data_ptr(), dt.data_ptr(), cum.data_ptr(),
                Bm.data_ptr(), Cm.data_ptr(), dy.data_ptr(),
                g.data_ptr(), h_prev.data_ptr(),
                *[o.data_ptr() for o in out], code, B, L, H, P, N, Q,
                G, tc, stream)
        bwd_out = {v: empty((B, L, H, P), (B, L, H), (B, L, H),
                            (1, B, L, N), (1, B, L, N))
                   for v in ("old", "new", "core")}
        calls["chunk bwd"] = {
            "old": taken(lambda t: bwd(old_bwd_lib, bwd_out["old"], t)),
            "new": bwd(new_bwd_lib, bwd_out["new"], 1)}
        outs["chunk bwd"] = {k: bwd_out[k] for k in ("old", "new")}
        if f32:
            calls["chunk bwd, CUDA cores"] = {
                "old": bwd(new_bwd_lib, bwd_out["core"]),
                "new": calls["chunk bwd"]["new"]}
            outs["chunk bwd, CUDA cores"] = {"old": bwd_out["core"],
                                             "new": bwd_out["new"]}
        for name in calls:
            for fn in calls[name].values():
                assert fn() == 0
        torch.cuda.synchronize()
        # Partial dB, dC sums over other groups of heads: their sums.
        same = {name: [float((a.float().sum(0) - b.float().sum(0)).abs()
                             .max() if a.shape != b.shape else
                             (a.float() - b.float()).abs().max())
                       for a, b in zip(o["old"], o["new"])]
                for name, o in outs.items()}
        bitwise = {name: all(torch.equal(a, b)
                             for a, b in zip(o["old"], o["new"]))
                   for name, o in outs.items()}
        pairs = {name: (c["old"], c["new"]) for name, c in calls.items()}
        for name, (fo, fn) in pairs.items():
            t = (ms(fo), ms(fn), ms(fn), ms(fo))
            print(f"{list(shape)} {str(dtype)[6:]} {name}: old, new, new, "
                  f"old ms a launch {', '.join(f'{v:.5f}' for v in t)}; "
                  f"new / old {(t[1] + t[2]) / (t[0] + t[3]):.4f}; max|Δ| "
                  f"per output {same[name]}; bitwise {bitwise[name]}",
                  flush=True)
        if f32 and args.heads:
            out = empty((B, L, H, P), (B, L // Q, H, N, P))

            def bwd_at(G):
                outs = empty((B, L, H, P), (B, L, H), (B, L, H),
                             (H // G, B, L, N), (H // G, B, L, N))
                return lambda: new_bwd_lib.ssd_chunk_bwd_launch(
                    x.data_ptr(), dt.data_ptr(), cum.data_ptr(),
                    Bm.data_ptr(), Cm.data_ptr(), dy.data_ptr(),
                    g.data_ptr(), h_prev.data_ptr(),
                    *[o.data_ptr() for o in outs], code, B, L, H, P, N, Q,
                    G, 1, stream)
            time_heads(heads, chunk(heads, out, tf32), bwd_at, shape, sms)
        fo, fn = calls["carry"]["old"], calls["carry"]["new"]
        t = (host_us(fo), host_us(fn), host_us(fn), host_us(fo))
        print(f"{list(shape)} {str(dtype)[6:]} carry: host µs a call to "
              f"ssd_carry_launch, old, new, new, old "
              f"{', '.join(f'{v:.3f}' for v in t)}", flush=True)
        print(f"{list(shape)} new carry's plan: "
              f"{sk.carry_plan(dtype, B, H, P, N, Q, c_dtype=dtype)}",
              flush=True)
        if args.plans:
            out = empty((B, L, H, P), dtype=dtype) + empty((B, H, N, P))
            time_plans(plans, carry(plans, out), out, carry_out["new"],
                       shape)
    time_tiled(old, old_bwd_lib, new, new_bwd_lib, sms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
