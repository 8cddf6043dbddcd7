"""The kernel build's report, read on the CPU: ``CudaLibrary.ptxas``
parses nvcc's ``-Xptxas -v`` log into registers and spills per entry
function (the card's runs check every kernel's against it)."""
from pathlib import Path

from repro_torch.kernels.build import CudaLibrary

LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z14fa_bwd_dq_tf32ILi128EEvPKf' for 'sm_90a'
ptxas info    : Function properties for _Z14fa_bwd_dq_tf32ILi128EEvPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 232 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z14fa_bwd_dq_tf32ILi64EEvPKf' for 'sm_90a'
ptxas info    : Function properties for _Z14fa_bwd_dq_tf32ILi64EEvPKf
    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function 'fa_bwd_preprocess' for 'sm_90a'
ptxas info    : Used 30 registers, 392 bytes cmem[0]
"""


def library() -> CudaLibrary:
    return CudaLibrary("probe", Path("csrc") / "probe.cu", (),
                       lambda lib: None)


def test_ptxas_reads_registers_and_spills_per_entry_function():
    lib = library()
    lib.build_info["log"] = LOG
    assert lib.ptxas() == {
        "_Z14fa_bwd_dq_tf32ILi128EEvPKf": (232, 0, 0),
        "_Z14fa_bwd_dq_tf32ILi64EEvPKf": (255, 8, 4),
        "fa_bwd_preprocess": (30, None, None)}


def test_ptxas_is_empty_before_a_build_in_this_process():
    assert library().ptxas() == {}
