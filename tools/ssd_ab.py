"""Time the SSD's CUDA-core kernels against an older build of their
sources, in turns, on one card.

``python tools/ssd_ab.py --old DIR``

``DIR`` holds another version's ``ssd.cu``, ``ssd_bwd.cu`` and
``ssd_mma.cuh`` (for example ``src/repro_torch/kernels/ssd/csrc/`` of a
``git archive`` of the parent commit).  Both are built with
``kernels/build.py`` and called at chunk 64 (the chunk both take) on the
same inputs, each through its library's C entry point into outputs made
beforehand (no Python wrapper's checks or allocations inside the timed
window): the CUDA-core chunk kernel (``terms`` 0), the carry, and for
fp32 the CUDA-core chunk backward.  Each is timed old, new, new, old:
the median over 15 windows of ``BURST`` launches back to back, per
launch (CUDA events), so that the card never waits on the host between
launches.  Also prints whether the two agree bit for bit (the backward:
max |Δ| per output), each library's registers and spills per kernel
from ``-Xptxas -v``, and, where ``cuobjdump`` is on the path, each
kernel's SASS instruction count.  Prints the card's name and power limit
first.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from ab_common import card, ms  # noqa: E402
from repro_torch.kernels.build import CudaLibrary  # noqa: E402
from repro_torch.kernels.ssd import kernel as sk  # noqa: E402
from repro_torch.kernels.ssd.ref import (chunk_cumsum,  # noqa: E402
                                         ssd_carry_bwd_ref)

# (B, L, H, P, N, Q), dtype: mamba2-780m's heads at 2 x 4096 in fp32 (the
# CUDA-core kernels' dtype), then zamba2-1.2b's and mamba2-780m's serving
# shapes in bf16 forced onto the CUDA-core chunk kernel.
SHAPES = (((2, 4096, 48, 64, 128, 64), torch.float32),
          ((4, 2048, 64, 64, 64, 64), torch.bfloat16),
          ((2, 4096, 48, 64, 128, 64), torch.bfloat16))


def bind(lib):
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ssd_chunk_launch.argtypes = [P] * 7 + [I] * 8 + [P]
    lib.ssd_carry_launch.argtypes = [P] * 7 + [I] * 8 + [P]


def bind_bwd(lib):
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ssd_chunk_bwd_launch.argtypes = [P] * 13 + [I] * 9 + [P]


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, type=Path)
    old_dir = ap.parse_args().old.resolve()
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

        def chunk(lib, out):
            return lambda: lib.ssd_chunk_launch(
                x.data_ptr(), dt.data_ptr(), cum.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), code,
                B, L, H, P, N, Q, 0, stream)
        chunk_out = {v: empty((B, L, H, P), (B, L // Q, H, N, P))
                     for v in ("old", "new")}
        yi, st = chunk_out["new"]

        def carry(lib, out):
            return lambda: lib.ssd_carry_launch(
                yi.data_ptr(), st.data_ptr(), cum.data_ptr(), Cm.data_ptr(),
                None, out[0].data_ptr(), out[1].data_ptr(), code, code, B, L,
                H, P, N, Q, stream)
        carry_out = {v: empty((B, L, H, P), dtype=dtype) + empty((B, H, N, P))
                     for v in ("old", "new")}
        calls = {"chunk": {"old": chunk(old, chunk_out["old"]),
                           "new": chunk(new, chunk_out["new"])}}
        outs = {"chunk": chunk_out}
        for fn in calls["chunk"].values():
            assert fn() == 0
        calls["carry"] = {"old": carry(old, carry_out["old"]),
                          "new": carry(new, carry_out["new"])}
        outs["carry"] = carry_out
        if dtype == torch.float32:
            h_prev, g, _ = ssd_carry_bwd_ref(st, cum, Cm, dy, Q)
            G = sk.bwd_heads_per_block(B * L // Q, H, sms)

            def bwd(lib, out):
                return lambda: lib.ssd_chunk_bwd_launch(
                    x.data_ptr(), dt.data_ptr(), cum.data_ptr(),
                    Bm.data_ptr(), Cm.data_ptr(), dy.data_ptr(),
                    g.data_ptr(), h_prev.data_ptr(),
                    *[o.data_ptr() for o in out], code, B, L, H, P, N, Q,
                    G, 0, stream)
            bwd_out = {v: empty((B, L, H, P), (B, L, H), (B, L, H),
                                (H // G, B, L, N), (H // G, B, L, N))
                       for v in ("old", "new")}
            calls["chunk bwd"] = {"old": bwd(old_bwd_lib, bwd_out["old"]),
                                  "new": bwd(new_bwd_lib, bwd_out["new"])}
            outs["chunk bwd"] = bwd_out
        for name in calls:
            for fn in calls[name].values():
                assert fn() == 0
        torch.cuda.synchronize()
        same = {name: [float((a.float() - b.float()).abs().max())
                       for a, b in zip(o["old"], o["new"])]
                for name, o in outs.items()}
        pairs = {name: (c["old"], c["new"]) for name, c in calls.items()}
        for name, (fo, fn) in pairs.items():
            t = (ms(fo), ms(fn), ms(fn), ms(fo))
            print(f"{list(shape)} {str(dtype)[6:]} {name}: old, new, new, "
                  f"old ms a launch {', '.join(f'{v:.5f}' for v in t)}; "
                  f"new / old {(t[1] + t[2]) / (t[0] + t[3]):.4f}; max|Δ| "
                  f"per output {same[name]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
