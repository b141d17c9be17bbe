"""The kernel build's report (`learn_fhe_tpu_torch/utils/kernels.py`): the
registers, spills and stack frame of each kernel instance, read from
nvcc's `-Xptxas -v` output. Runs on the CPU, on lines as an sm_90a build
prints them."""

from __future__ import annotations

import pytest

from learn_fhe_tpu_torch.utils import kernels

# nvcc names an anonymous namespace after a hash of the source's path; its
# hex digits may read as a length in the mangled name.
_MUL = "_ZN40_GLOBAL__N__4f310aae_8_ntt32_cu_bc68ad5223negacyclic_mul32_kernelILi11EEEvPKjS2_PjS2_S2_S2_S2_xjjjjj"
_FWD = "_ZN40_GLOBAL__N__7d0c2e15_8_ntt32_cu_52a1f9c316ntt32_fwd_kernelILi3EEEvPKjPjS2_S2_xj"
_INV = "_ZN40_GLOBAL__N__4f310aae_8_ntt32_cu_bc68ad5216ntt32_inv_kernelILi11EEEvPKjPjS2_S2_xjjj"
_GARNER = "_ZN45_GLOBAL__N__cf0e079d_12_torus_crt_cu_de5b7d2913garner_kernelEPKjPmxN3lft9CrtConstsE"
# K-GARNER's instance per prime count since its 5-prime widening, and K-STEP's
# 4-prime constants as a template instance
_GARNER_K = "_ZN45_GLOBAL__N__cf0e079d_12_torus_crt_cu_de5b7d2913garner_kernelILi5EEEvPKjPmxN3lft11CrtConstsOfILi5EEE"
_STEP = (
    "_ZN45_GLOBAL__N__cdbaa05f_12_tfhe_step_cu_d9a3cecf16tfhe_step_kernelILi11EEEvPlS1_PKlPKjS5_S5_S5_S5_S5_"
    "S5_S5_S5_S5_iiN3lft9CrtConstsE"
)
_FHEW = (
    "_ZN53_GLOBAL__N__f1c25e59_20_fhew_blind_rotate_cu_23175c5024fhew_blind_rotate_kernelILi9EEEvPKjS2_PjS3_PKiS5_"
    "iS2_S2_iS2_S2_S5_PKhiS2_S2_S2_S2_NS_6ConstsENS_6GadgetES9_iiPi"
)
_FHEW_11 = _FHEW.replace("ILi9EE", "ILi11EE")
_NTT64 = "_ZN40_GLOBAL__N__ef756456_8_ntt64_cu_8d3d39ff16ntt64_fwd_kernelILb1ELi11ELb1EEEvPKmPmN5lft646TablesEiimm"
_INTT64 = "_ZN40_GLOBAL__N__ef756456_8_ntt64_cu_8d3d39ff16ntt64_inv_kernelILb1ELi11EEEvPKmPmN5lft646TablesEii"
_MUL64_BULK = "_ZN40_GLOBAL__N__ef756456_8_ntt64_cu_8d3d39ff28negacyclic_mul64_bulk_kernelILb1EEEvPKmS2_PmN5lft646TablesEm"
_EXT64 = "_ZN44_GLOBAL__N__15b4274e_11_fhew_u64_cu_b001eb1725external_product64_kernelILb1ELi11EEEvPKmS2_PmS3_PKiS2_S2_iiiN5lft646TablesENS6_6GadgetEiiPi"
_CROSS64 = "_ZN39_GLOBAL__N__5b1e0c7a_7_coef_cu_c3d2e1f019coef_cross64_kernelILb1EEEvPK10ulonglong2S3_PS1_PKmS6_S6_iiii"
_CROSS32 = "_ZN39_GLOBAL__N__5b1e0c7a_7_coef_cu_c3d2e1f019coef_cross32_kernelILb0EEEvPK5uint4S3_PS1_jjjiii"
# K6 and K-FHEW-PRE: no template arguments, each in a source whose name
# holds most of the kernel's
_K6 = "_ZN50_GLOBAL__N__6d1e2f3a_17_tfhe_keyswitch_cu_a1b2c3d422tfhe_key_switch_kernelEPKmS1_iS1_S1_PyS2_NS_5ShapeE"
_PRE = "_ZN49_GLOBAL__N__7e2f3a4b_16_fhew_preamble_cu_b2c3d4e520fhew_preamble_kernelEPKmS1_S1_S1_S1_PxPvNS_3PreE"
# K-TFHE-PRE's instance by its bool, K-EXTRACT's by its element type
_FRONT = "_ZN46_GLOBAL__N__8a1b2c3d_13_tfhe_front_cu_c4d5e6f717tfhe_front_kernelILb1EEEvPKmS2_S2_PxS3_S3_NS_5FrontE"
_EXTRACT = "_ZN48_GLOBAL__N__9b2c3d4e_15_rlwe_extract_cu_d5e6f7a819rlwe_extract_kernelIiEEvPKT_S3_PxS4_iiiyy"
_RNS_ADD = "_ZN40_GLOBAL__N__1c2d3e4f_8_rns64_cu_e6f7a8b914rns_add_kernelILi1EEEvNS_8AddPartsEPKmiiiii"
_WALK64 = (
    "_ZN44_GLOBAL__N__0f9cfd78_11_fhew_u64_cu_b001eb1726fhew_blind_rotate64_kernelILb1ELb0EEEvPKmS2_PmS3_PKiS5_iS2_"
    "S2_iS2_S2_S5_PKhiN5lft646TablesENS6_6GadgetES8_iiPi"
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
        (_GARNER_K, "garner_kernel<5>"),
        (_STEP, "tfhe_step_kernel<11>"),
        (_STEP.replace("N3lft9CrtConstsE", "N3lft11CrtConstsOfILi4EEE"), "tfhe_step_kernel<11>"),
        (_FHEW, "fhew_blind_rotate_kernel<9>"),
        (_FHEW_11, "fhew_blind_rotate_kernel<11>"),
        (_NTT64, "ntt64_fwd_kernel<true,11,true>"),
        (_NTT64.replace("ILb1ELi11ELb1EE", "ILb0ELi0ELb0EE"), "ntt64_fwd_kernel<false,0,false>"),
        (_INTT64, "ntt64_inv_kernel<true,11>"),
        (_MUL64_BULK, "negacyclic_mul64_bulk_kernel<true>"),
        (_EXT64, "external_product64_kernel<true,11>"),
        (_EXT64.replace("ILb1ELi11EE", "ILb0ELi0EE"), "external_product64_kernel<false,0>"),
        (_WALK64, "fhew_blind_rotate64_kernel<true,false>"),
        (_WALK64.replace("ILb1ELb0EE", "ILb1ELb1EE"), "fhew_blind_rotate64_kernel<true,true>"),
        (_MUL.replace("ILi11EE", "ILi14EE"), "negacyclic_mul32_kernel<14>"),
        (_CROSS64, "coef_cross64_kernel<true>"),
        (_CROSS32, "coef_cross32_kernel<false>"),
        (_K6, "tfhe_key_switch_kernel"),
        (_PRE, "fhew_preamble_kernel"),
        (_FRONT, "tfhe_front_kernel<true>"),
        (_FRONT.replace("ILb1EE", "ILb0EE"), "tfhe_front_kernel<false>"),
        (_EXTRACT, "rlwe_extract_kernel<int>"),
        (_EXTRACT.replace("IiEE", "IxEE"), "rlwe_extract_kernel<long long>"),
        (_RNS_ADD, "rns_add_kernel<1>"),
    ],
)
def test_ptxas_report_names_each_kernel(mangled, name):
    assert kernels.ptxas_report(_entry(mangled, 61, 8)) == {name: (61, 8, 8, 64)}


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
        "negacyclic_mul32_kernel<11>": (64, 0, 0, 0),
        "ntt32_inv_kernel<11>": (61, 0, 0, 0),
        "garner_kernel": (29, 0, 0, 0),
        "tfhe_step_kernel<11>": (64, 8, 8, 64),
    }
    assert kernels.ptxas_report("") == {}
