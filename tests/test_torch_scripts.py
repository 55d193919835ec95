"""The CPU-side logic of the port's card scripts: chip_smoke.py's names for
the kernels in nvcc's build report, the delta emulation of
gta_tpu_torch/scripts/probe_delta_from_o.py against flash_core's plain
backward, and time_kernels.py's digest and config choice."""

import numpy as np
import pytest
import torch

import chip_smoke
from gta_tpu_torch.ops import flash_core as fc
from gta_tpu_torch.scripts import probe_delta_from_o


@pytest.mark.parametrize("mangled,label", [
    ("_ZN4sm9013attn_sm90_fwdINS_3CfgILi64ELi128EEEEEv14CUtensorMap_stS2_S2_iPKfP13__nv_bfloat16",
     "sm90::attn_sm90_fwd<Cfg<64, 128>>"),
    ("_ZN4sm9015attn_sm90_bwd_qINS_3CfgILi64ELi64EEE13__nv_bfloat16EEvK14CUtensorMap_st",
     "sm90::attn_sm90_bwd_q<Cfg<64, 64>, __nv_bfloat16>"),
    ("_ZN4sm9016attn_sm90_bwd_kvINS_3CfgILi96ELi64EEEfEEvK14CUtensorMap_st",
     "sm90::attn_sm90_bwd_kv<Cfg<96, 64>, float>"),
    ("_ZN4attn18attn_bwd_kv_kernelILi96ELi2EEEvPKfS2_", "attn::attn_bwd_kv_kernel<96, 2>"),
    ("_ZN8gta_rows19gta_rows_mma_kernelILi64ELi1E13__nv_bfloat16fEEvNS_6RowJobIT1_T2_EEii",
     "gta_rows::gta_rows_mma_kernel<64, 1, __nv_bfloat16, float>"),
    ("_ZN4attn15attn_fwd_kernelILi64EEEvPKf", "attn::attn_fwd_kernel<64>"),
    ("plain_c_symbol", "plain_c_symbol"),
])
def test_kernel_label_names_template_kernels(mangled, label):
    """Namespaces, name and template arguments, a nested class template
    argument (the sm90 core's `Cfg`) with its own arguments."""
    assert chip_smoke.kernel_label(mangled) == label


def test_ptxas_report_gives_one_line_per_kernel():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN4sm9013attn_sm90_fwdINS_3CfgILi64ELi64EEEEEv' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN4sm9013attn_sm90_fwdINS_3CfgILi64ELi64EEEEEv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers, 528 bytes cmem[0]",
        "ptxas error   : Entry function uses too much shared data",
    ])
    assert list(chip_smoke.ptxas_report(log)) == [
        "sm90::attn_sm90_fwd<Cfg<64, 64>>: Used 168 registers, used 1 barriers, 528 bytes cmem[0]; "
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas error   : Entry function uses too much shared data",
    ]


@pytest.mark.parametrize("tq,tk", [(5, 7), (33, 17)])
def test_delta_from_o_emulation_is_the_plain_backward_in_exact_arithmetic(tq, tk):
    """Without the TPU rounding (no mxu_dtype) and with the forward's fp32
    output, delta = rowsum(g * o) equals the plain backward's
    rowsum(p * dp): the probe's emulation differs from the plain
    version only in where delta comes from."""
    rng = np.random.default_rng(3)
    heads, c = 2, probe_delta_from_o.C
    q, k, v, g = (torch.from_numpy(rng.normal(size=(2, t, heads * c)).astype(np.float32)) for t in (tq, tk, tk, tq))
    o = fc.flash_core_fwd_plain(q, k, v, heads, c**-0.5)
    got = probe_delta_from_o.bwd_delta_from_o(q, k, v, g, o, heads, None)
    want = fc.flash_core_bwd_plain(q, k, v, heads, c**-0.5, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-4)


def test_time_kernels_digest_tells_bits_apart():
    """The digest covers every tensor of nested outputs and residual
    objects, skips None, and changes with one bit of one element."""
    from gta_tpu_torch.scripts.time_kernels import digest

    class Res:
        def __init__(self, z, lse):
            self.z, self.lse = z, lse

    z = torch.arange(12, dtype=torch.float32).reshape(3, 4).to(torch.bfloat16)
    lse = torch.linspace(0, 1, 5)
    base = digest((z, Res(z.t(), lse), None))
    assert base == digest((z.clone(), Res(z.t().contiguous(), lse.clone()), None))
    flipped = lse.clone()
    flipped.view(torch.int32)[2] ^= 1
    assert digest((z, Res(z.t(), flipped), None)) != base


@pytest.mark.parametrize("names,want", [
    (None, ["clevr_gta", "msn_so3", "clevr_srt", "msn_srt"]),
    (["msn_srt", "clevr_gta"], ["clevr_gta", "msn_srt"]),
])
def test_time_kernels_picks_configs_in_table_order(names, want):
    from gta_tpu_torch.scripts.time_kernels import pick_configs

    assert list(pick_configs(names)) == want


def test_time_kernels_rejects_an_unknown_config():
    from gta_tpu_torch.scripts.time_kernels import pick_configs

    with pytest.raises(SystemExit, match="msn_gta"):
        pick_configs(["msn_srt", "msn_gta"])
