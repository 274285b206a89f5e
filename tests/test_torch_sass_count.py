"""The SASS reader behind the infection kernel's operations bound
(sbr_tpu_torch.benchmarks.sass_count), on listings written out here: the
CPU has no cuobjdump, and the card's own listing is read by chip_smoke.py."""

import pytest

from sbr_tpu_torch.benchmarks import sass_count as sc

# the shape of a `cuobjdump -sass` listing: an outer loop (0x0030-0x00b0)
# around an inner one (0x0040-0x0090) that holds the MUFU instructions, and
# the self-branch that ends every function
LISTING = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_123infection_update_kernelIfEEvPKh
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                  /* 0x00000a00ff017b82 */
                                                                           /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                      /* 0x0000000000007919 */
        /*0020*/              @!P0 BRA 0xc0 ;                              /* 0x0000000000000947 */
        /*0030*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;
        /*0040*/                   IADD3 R6, R6, R7, RZ ;
        /*0050*/                   SHF.L.W.U32.HI R7, R7, 0xd, R7 ;
        /*0060*/                   IMAD.IADD R8, R6, 0x1, R9 ;
        /*0070*/                   MUFU.RCP R10, R11 ;
        /*0080*/                   FFMA R12, R10, R11, R12 ;
        /*0090*/               @P1 BRA 0x40 ;
        /*00a0*/                   STG.E.128 desc[UR4][R2.64], R4 ;
        /*00b0*/               @P2 BRA 0x30 ;
        /*00c0*/                   EXIT ;
        /*00d0*/                   BRA 0xd0;
		Function : _ZN12_GLOBAL__N_113other_kernelEv
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   EXIT ;
"""


def test_parse_splits_functions_and_reads_each_instruction():
    funcs = sc.parse(LISTING)
    assert list(funcs) == ["_ZN12_GLOBAL__N_123infection_update_kernelIfEEvPKh",
                           "_ZN12_GLOBAL__N_113other_kernelEv"]
    instrs = funcs["_ZN12_GLOBAL__N_123infection_update_kernelIfEEvPKh"]
    assert len(instrs) == 14
    assert instrs[2] == (0x20, "BRA", "0xc0")
    assert instrs[5] == (0x50, "SHF.L.W.U32.HI", "R7, R7, 0xd, R7")


def test_agent_loop_is_the_innermost_loop_holding_a_mufu():
    funcs = sc.parse(LISTING)
    kernel = funcs["_ZN12_GLOBAL__N_123infection_update_kernelIfEEvPKh"]
    assert sc.agent_loop(kernel) == (0x40, 0x90)
    assert sc.agent_loop(funcs["_ZN12_GLOBAL__N_113other_kernelEv"]) is None


def test_count_sorts_the_loop_into_pipes():
    instrs = sc.parse(LISTING)["_ZN12_GLOBAL__N_123infection_update_kernelIfEEvPKh"]
    c = sc.count(instrs, (0x40, 0x90))
    assert c["opcodes"] == {"BRA": 1, "FFMA": 1, "IADD3": 1, "IMAD.IADD": 1, "MUFU.RCP": 1,
                            "SHF.L.W.U32.HI": 1}
    assert c["pipes"] == {"alu": 2, "fma": 1, "imad": 1, "issue": 6, "other": 1, "xu": 1}
    # one MUFU at 16 lanes a clock outweighs two ALU instructions at 64
    assert sc.busiest(c["pipes"]) == ("xu", 1 / 16)


@pytest.mark.parametrize("opcode, pipe", [
    ("IADD3.X", "alu"), ("LOP3.LUT", "alu"), ("ISETP.GE.AND", "alu"), ("FSETP.GEU.AND", "alu"),
    ("F2FP.F16.F32.PACK_AB", "alu"), ("I2FP.F32.S32", "alu"), ("IMAD.MOV.U32", "imad"),
    ("IMAD.WIDE.U32", "imad"), ("FFMA.SAT", "fma"), ("HADD2.F32", "fma"), ("DFMA", "fp64"),
    ("MUFU.EX2", "xu"), ("F2F.BF16.F32", "xu"), ("I2F.F64", "xu"), ("POPC", "xu"),
    ("LDG.E.CONSTANT", "lsu"), ("STS.U8", "lsu"), ("SHFL.UP", "lsu"), ("BRA", "other"),
    ("BSSY", "other"),
])
def test_pipe_of(opcode, pipe):
    assert sc.pipe_of(opcode) == pipe
