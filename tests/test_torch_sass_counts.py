"""The SASS counting tool (``artist_tpu_torch.tools.sass_counts``) on hand-written listings.

The tool runs ``nvcc`` and ``cuobjdump`` only on the machine with the card;
its parsing and counting are plain Python, checked here on listings in the
two forms ``cuobjdump -sass`` prints branch targets in (labels and absolute
addresses), and on ``ptxas -v`` output.
"""

import pytest

from artist_tpu_torch.tools import sass_counts

_BODY = """\
        /*{a0}*/                   LDS.128 R4, [R2] ;                 /* 0x0000000002047984 */
        /*{a1}*/                   FFMA R5, R4, R6, R7 ;
        /*{a2}*/                   FMUL R8, R5, R5 ;
        /*{a3}*/                   MUFU.EX2 R9, R8 ;
        /*{a4}*/                   MUFU.EX2 R10, R8 ;
        /*{a5}*/                   MUFU.EX2 R11, R8 ;
        /*{a6}*/                   MUFU.EX2 R12, R8 ;
        /*{a7}*/                   MUFU.EX2 R13, R8 ;
        /*{a8}*/                   MUFU.EX2 R14, R8 ;
        /*{a9}*/                   MUFU.EX2 R15, R8 ;
        /*{a10}*/                   MUFU.EX2 R16, R8 ;
        /*{a11}*/                   MUFU.EX2 R17, R8 ;
        /*{a12}*/                   MUFU.EX2 R18, R8 ;
        /*{a13}*/                   MUFU.RCP R19, R8 ;
        /*{a14}*/                   SHFL.BFLY PT, R20, R19, 0x1, 0x1f ;
        /*{a15}*/                   FSEL R21, R20, R19, P0 ;
        /*{a16}*/                   STS [R3], R21 ;
        /*{a17}*/                   IADD3 R2, R2, 0x40, RZ ;
        /*{a18}*/                   ISETP.NE.AND P1, PT, R2, R22, PT ;
"""


def _listing(labels: bool) -> str:
    addresses = {f"a{i}": f"{0x20 + 0x10 * i:04x}" for i in range(19)}
    back = "`(.L_x_0)" if labels else "0x20"
    forward = "`(.L_x_1)" if labels else "0x170"
    return (
        "\tcode for sm_90a\n"
        "\t\tFunction : _ZN12_GLOBAL__N_126sigma_flat_backward_kernelILi2EEEvPKfS2_\n"
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;\n"
        f"        /*0010*/              @P0 BRA {forward} ;\n"
        + (".L_x_0:\n" if labels else "")
        + _BODY.format(**addresses)
        + f"        /*0150*/              @P1 BRA {back} ;\n"
        + "        /*0160*/                   BRA 0x160;\n"
        + (".L_x_1:\n" if labels else "")
        + "        /*0170*/                   EXIT ;\n"
        "\t\tFunction : _ZN12_GLOBAL__N_125sigma_flat_forward_kernelEPKf\n"
        "        /*0000*/                   EXIT ;\n"
    )


@pytest.mark.parametrize("labels", [True, False], ids=["labels", "addresses"])
def test_pair_loop_counts_each_pair_once(labels):
    kernels = sass_counts.parse_sass(_listing(labels))
    assert sorted(kernels) == ["sigma_flat_backward_kernel<2>", "sigma_flat_forward_kernel"]
    assert sass_counts.pair_loop(kernels["sigma_flat_forward_kernel"]) is None
    loop = sass_counts.pair_loop(kernels["sigma_flat_backward_kernel<2>"])
    # 20 instructions from the loop's first to its branch, 10 exponentials: 2 pairs an iteration.
    assert (loop["start"], loop["end"], loop["pairs_per_iteration"]) == (0x20, 0x150, 2.0)
    assert loop["per_pair"] == {
        "fp32": 1.0, "mufu": 5.5, "shared_loads": 0.5, "shared_stores": 0.5, "shuffles": 0.5, "selects": 0.5,
        "rest": 1.5, "total": 10.0, "mufu_ex2": 5.0, "mufu_rcp": 0.5, "skip_total": None,
    }
    other = sass_counts.parse_sass(_listing(labels).replace("FMUL R8, R5, R5", "FMUL R8, R5, R6"))
    assert sass_counts.same_code(kernels, other) == {
        "sigma_flat_backward_kernel<2>": False, "sigma_flat_forward_kernel": True,
    }
    floors = sass_counts.floors_ms(loop, 1e9)
    assert floors["issue_ms"] == pytest.approx(10.0e9 / sass_counts.INSTRUCTIONS_PER_S * 1e3)
    assert floors["mufu_ms"] == pytest.approx(5.5e9 / sass_counts.MUFU_PER_S * 1e3)


def test_ptxas_report_reads_registers_and_spills():
    output = (
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125sigma_flat_forward_kernelEPKf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_125sigma_flat_forward_kernelEPKf\n"
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 40 registers, 17440 bytes smem, 400 bytes cmem[0]\n"
    )
    assert sass_counts.ptxas_report(output) == {
        "sigma_flat_forward_kernel": {"registers": 40, "spill_stores": 8, "spill_loads": 12}
    }


_SKIPPING_LOOP = """\
\t\tFunction : _ZN12_GLOBAL__N_125sigma_flat_forward_kernelEPKf
        /*0000*/                   LDC R1, c[0x0][0x28] ;
.L_x_0:
        /*0010*/                   LDS.128 R4, [R2] ;
        /*0020*/                   FFMA R5, R4, R6, R7 ;
        /*0030*/              @P2 BRA `(.L_x_1) ;
        /*0040*/                   MUFU.EX2 R9, R5 ;
        /*0050*/                   MUFU.EX2 R10, R5 ;
        /*0060*/                   MUFU.EX2 R11, R5 ;
        /*0070*/                   MUFU.EX2 R12, R5 ;
        /*0080*/                   MUFU.EX2 R13, R5 ;
        /*0090*/                   FMUL R8, R9, R10 ;
.L_x_1:
        /*00a0*/                   FADD R3, R3, R8 ;
        /*00b0*/                   ISETP.NE.AND P1, PT, R2, R22, PT ;
        /*00c0*/              @P1 BRA `(.L_x_0) ;
        /*00d0*/                   EXIT ;
"""


def test_pair_loop_counts_what_a_skipped_pair_leaves_out():
    """A forward branch over a pair's exponentials (a pair whose gates overflow) is the
    loop's skip path: ``skip_total`` counts the body without the instructions it jumps
    over, and :func:`floors_ms` charges skipped pairs that many."""
    loop = sass_counts.pair_loop(sass_counts.parse_sass(_SKIPPING_LOOP)["sigma_flat_forward_kernel"])
    assert (loop["start"], loop["end"], loop["pairs_per_iteration"]) == (0x10, 0xC0, 1.0)
    # 12 instructions from 0x10 to 0xc0; the branch at 0x30 jumps over the 6 at 0x40-0x90.
    assert (loop["per_pair"]["total"], loop["per_pair"]["skip_total"]) == (12.0, 6.0)
    floors = sass_counts.floors_ms(loop, 1e9, 0.75e9)
    assert floors["issue_ms"] == pytest.approx((12.0 * 0.25e9 + 6.0 * 0.75e9) / sass_counts.INSTRUCTIONS_PER_S * 1e3)
    assert floors["mufu_ms"] == pytest.approx(5.0 * 0.25e9 / sass_counts.MUFU_PER_S * 1e3)
