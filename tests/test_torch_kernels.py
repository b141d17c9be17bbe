"""The kernel build's report (`learn_fhe_tpu_torch/utils/kernels.py`): the
registers and spills of each kernel instance, read from nvcc's `-Xptxas -v`
output. Runs on the CPU, on lines as an sm_90a build prints them."""

from __future__ import annotations

import pytest

from learn_fhe_tpu_torch.utils import kernels

# nvcc names an anonymous namespace after a hash of the source's path; its
# hex digits may read as a length in the mangled name.
_MUL = "_ZN40_GLOBAL__N__4f310aae_8_ntt32_cu_bc68ad5223negacyclic_mul32_kernelILi11EEEvPKjS2_PjS2_S2_S2_S2_xjjjjj"
_FWD = "_ZN40_GLOBAL__N__7d0c2e15_8_ntt32_cu_52a1f9c316ntt32_fwd_kernelILi3EEEvPKjPjS2_S2_xj"
_INV = "_ZN40_GLOBAL__N__4f310aae_8_ntt32_cu_bc68ad5216ntt32_inv_kernelILi11EEEvPKjPjS2_S2_xjjj"
_GARNER = "_ZN45_GLOBAL__N__cf0e079d_12_torus_crt_cu_de5b7d2913garner_kernelEPKjPmxN3lft9CrtConstsE"
_STEP = (
    "_ZN45_GLOBAL__N__cdbaa05f_12_tfhe_step_cu_d9a3cecf16tfhe_step_kernelILi11EEEvPlS1_PKlPKjS5_S5_S5_S5_S5_"
    "S5_S5_S5_S5_iiN3lft9CrtConstsE"
)
_FHEW = (
    "_ZN53_GLOBAL__N__f1c25e59_20_fhew_blind_rotate_cu_23175c5024fhew_blind_rotate_kernelILi9EEEvPKjS2_PjS3_PKiS5_"
    "iS2_S2_S2_S2_S2_S2_S2_S2_S5_PKhS2_S2_S2_S2_jjjNS_6GadgetES8_i"
)


def _entry(mangled: str, regs: int, spill: int) -> str:
    return (
        f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {mangled}\n"
        f"    {8 * spill} bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
        f"ptxas info    : Used {regs} registers, used 1 barriers, 16384 bytes smem\n"
        "ptxas info    : Compile time = 189.346 ms\n"
    )


@pytest.mark.parametrize(
    "mangled,name",
    [
        (_MUL, "negacyclic_mul32_kernel<11>"),
        (_FWD, "ntt32_fwd_kernel<3>"),
        (_INV, "ntt32_inv_kernel<11>"),
        (_GARNER, "garner_kernel"),
        (_STEP, "tfhe_step_kernel<11>"),
        (_FHEW, "fhew_blind_rotate_kernel<9>"),
    ],
)
def test_ptxas_report_names_each_kernel(mangled, name):
    assert kernels.ptxas_report(_entry(mangled, 61, 8)) == {name: (61, 8, 8)}


def test_ptxas_report_reads_a_whole_build_log():
    log = (
        "ptxas info    : 0 bytes gmem\n"
        + _entry(_MUL, 64, 0)
        + _entry(_INV, 61, 0)
        + "ptxas info    : Function properties for _Z9some_helperv\n"
        + "    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
        + _entry(_GARNER, 29, 0)
        + _entry(_STEP, 64, 8)
    )
    assert kernels.ptxas_report(log) == {
        "negacyclic_mul32_kernel<11>": (64, 0, 0),
        "ntt32_inv_kernel<11>": (61, 0, 0),
        "garner_kernel": (29, 0, 0),
        "tfhe_step_kernel<11>": (64, 8, 8),
    }
    assert kernels.ptxas_report("") == {}
