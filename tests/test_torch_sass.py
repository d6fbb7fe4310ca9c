"""The SASS instruction counter of the kernel bounds (stark_tpu_torch/ops/sass.py)
on a small hand-written listing in ``cuobjdump -sass`` form: no card, no
toolkit, no JAX.  Counts are exact integers."""

import pytest

from stark_tpu_torch.ops import sass

LISTING = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_14flat_kernelEPKjPjl
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                    /* 0x00000a00ff017b82 */
                                                                             /* 0x000e300000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                        /* 0x0000000000007919 */
        /*0020*/                   ISETP.GE.AND P0, PT, R0, UR4, PT ;       /* 0x0000000400007c0c */
        /*0030*/               @P0 EXIT ;                                    /* 0x000000000000094d */
        /*0040*/                   IMAD.WIDE.U32 R2, R0, 0x4, R2 ;          /* 0x0000000400027825 */
        /*0050*/                   LOP3.LUT R4, R2, R3, RZ, 0x3c, !PT ;     /* 0x0000000302047212 */
        /*0060*/                   SHF.R.U32.HI R5, RZ, 0x10, R4 ;          /* 0x00000010ff057819 */
        /*0070*/                   STG.E [R2.64], R5 ;                      /* 0x0000000502007986 */
        /*0080*/                   EXIT ;                                    /* 0x000000000000794d */
        /*0090*/                   BRA 0x90;                                 /* 0xfffffffc00fc7947 */
        /*00a0*/                   NOP;                                      /* 0x0000000000007918 */
		..........
		Function : _ZN12_GLOBAL__N_14loop_kernelILb1EEEvPKjPj
        /*0000*/                   S2R R0, SR_TID.X ;                        /* 0x0000000000007919 */
        /*0010*/                   IADD3 R1, R0, 0x1, RZ ;                   /* 0x0000000100017810 */
        /*0020*/                   IMAD R2, R1, R1, RZ ;                     /* 0x0000000101027224 */
        /*0030*/                   LDS.128 R4, [R2] ;                        /* 0x0000000002047984 */
        /*0040*/                   IADD3 R0, R0, 0x20, RZ ;                  /* 0x0000002000007810 */
        /*0050*/                   ISETP.GE.AND P0, PT, R0, UR4, PT ;       /* 0x0000000400007c0c */
        /*0060*/              @!P0 BRA 0x20 ;                                /* 0xfffffffc00708947 */
        /*0070*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;            /* 0x0000000000007b1d */
        /*0080*/                   LOP3.LUT R4, R4, R5, RZ, 0x3c, !PT ;     /* 0x0000000504047212 */
        /*0090*/               @P1 BRA 0xb0 ;                                /* 0x0000000000001947 */
        /*00a0*/                   IMAD.MOV.U32 R4, RZ, RZ, R5 ;            /* 0x000000ffff047224 */
        /*00b0*/                   ISETP.GE.AND P0, PT, R0, UR4, PT ;       /* 0x0000000400007c0c */
        /*00c0*/              @!P0 BRA 0x80 ;                                /* 0xfffffffc00708947 */
        /*00d0*/                   EXIT ;                                    /* 0x000000000000794d */
        /*00e0*/                   BRA 0xe0;                                 /* 0xfffffffc00fc7947 */
"""


def test_functions_split_the_listing_by_kernel():
    funcs = sass.functions(LISTING)
    assert list(funcs) == ["_ZN12_GLOBAL__N_14flat_kernelEPKjPjl", "_ZN12_GLOBAL__N_14loop_kernelILb1EEEvPKjPj"]
    assert len(sass.find(funcs, "flat_kernel")) == 11
    with pytest.raises(LookupError):
        sass.find(funcs, "_kernel")  # two kernels match


@pytest.mark.parametrize("instruction, op", [
    ("@!P0 IMAD.WIDE.U32 R2, R0, 0x4, R2", "IMAD"), ("LOP3.LUT R4, R2, R3, RZ, 0x3c, !PT", "LOP3"),
    ("@P0 EXIT", "EXIT"), ("NOP", "NOP"), ("BAR.SYNC.DEFER_BLOCKING 0x0", "BAR"),
])
def test_opcode_drops_predicate_and_modifiers(instruction, op):
    assert sass.opcode(instruction) == op


def test_straight_line_counts_every_instruction_but_padding():
    counts = sass.straight_line(sass.find(sass.functions(LISTING), "flat_kernel"))
    # 9 instructions: ISETP, LOP3, SHF on the ALU pipe; IMAD on the FMA pipe
    assert counts == sass.Counts(issue=9, alu=3, fma=1)
    with pytest.raises(ValueError):
        sass.straight_line(sass.find(sass.functions(LISTING), "loop_kernel"))


def test_loops_are_the_innermost_bodies_in_address_order():
    body = sass.loops(sass.find(sass.functions(LISTING), "loop_kernel"))
    # IMAD, LDS, IADD3, ISETP, BRA; then LOP3, BRA, IMAD.MOV, ISETP, BRA
    assert [b.counts for b in body] == [sass.Counts(5, 2, 1), sass.Counts(5, 2, 1)]
    assert [b.branch_free for b in body] == [True, False]
    assert body[0].opcodes["LDS"] == 1


def test_local_accesses_count_local_loads_and_stores():
    listing = """
		Function : _ZN12_GLOBAL__N_15local_kernelEv
        /*0000*/                   STL.64 [R1+0x8], R4 ;                     /* 0x0000080401007387 */
        /*0010*/                   LDL.64 R6, [R1+0x8] ;                     /* 0x0000080001067983 */
        /*0020*/               @P0 LDL R8, [R1] ;                            /* 0x0000000001080983 */
        /*0030*/                   LDS R9, [R2] ;                            /* 0x0000000002097984 */
        /*0040*/                   EXIT ;                                    /* 0x000000000000794d */
"""
    assert sass.local_accesses(sass.find(sass.functions(listing), "local_kernel")) == {"LDL": 2, "STL": 1}
    assert sass.local_accesses(sass.find(sass.functions(LISTING), "flat_kernel")) == {"LDL": 0, "STL": 0}


def test_seconds_take_the_slowest_of_issue_and_pipes():
    # 132 SMs at 1 GHz: 4 warp instructions a clock each issue, 2 on each pipe
    assert sass.Counts(issue=528, alu=0, fma=0).seconds(132, 1e9) == pytest.approx(1e-9)
    assert sass.Counts(issue=528, alu=528, fma=0).seconds(132, 1e9) == pytest.approx(2e-9)
    assert (sass.Counts(1, 2, 3) * 2 + sass.Counts(1, 1, 1)) == sass.Counts(3, 5, 7)


def test_enclosing_counts_the_loop_around_an_innermost_one():
    listing = """
		Function : _ZN12_GLOBAL__N_16nested_kernelEv
        /*0000*/                   IMAD.MOV.U32 R0, RZ, RZ, RZ ;            /* 0x000000ffff007224 */
        /*0010*/                   IADD3 R1, R0, 0x1, RZ ;                   /* 0x0000000100017810 */
        /*0020*/                   IMAD R2, R1, R1, RZ ;                     /* 0x0000000101027224 */
        /*0030*/                   ISETP.GE.AND P0, PT, R2, 0x10, PT ;       /* 0x000000100200780c */
        /*0040*/              @!P0 BRA 0x20 ;                                /* 0xfffffffc00708947 */
        /*0050*/                   LOP3.LUT R0, R0, R2, RZ, 0x3c, !PT ;     /* 0x0000000200007212 */
        /*0060*/                   ISETP.GE.AND P1, PT, R0, 0x4, PT ;        /* 0x000000040000780c */
        /*0070*/              @!P1 BRA 0x10 ;                                /* 0xfffffffc00708947 */
        /*0080*/                   EXIT ;                                    /* 0x000000000000794d */
"""
    ins = sass.find(sass.functions(listing), "nested_kernel")
    assert [b.counts for b in sass.loops(ins)] == [sass.Counts(3, 1, 1)]  # IMAD, ISETP, BRA
    outer = sass.enclosing(ins)
    # IADD3, the inner body, LOP3, ISETP, BRA
    assert outer.counts == sass.Counts(7, 4, 1) and not outer.branch_free
    with pytest.raises(LookupError):
        sass.enclosing(sass.find(sass.functions(LISTING), "loop_kernel"))
