"""The probes' tools on the CPU: the SASS floor's reading of `cuobjdump
-sass` text (as it and nvdisasm print it) and the probe scripts' saved
records held to each other (`kernel_microbench.hold`).  No card, no
cuobjdump."""

import pytest
import torch

from lidar_rt_tpu_torch.scripts import bf16_microbench
from lidar_rt_tpu_torch.scripts import kernel_microbench
from lidar_rt_tpu_torch.scripts import sass_floor as sf

torch.set_num_threads(1)

# A kernel with an outer loop (0x0010-0x00a0) around an inner one
# (0x0020-0x0080, counting by 2 on a uniform register), a second
# innermost loop of two instructions (0x00b0-0x00c0) and the self-branch
# every kernel ends with.
ADDRESSED = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_121probe_ablation_kernelILi4EEEvPKfS2_Pfii
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;     /* 0x00000a00ff017b82 */
                                                               /* 0x000fe40000000800 */
        /*0010*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0020*/                   LDS.128 R4, [R2+0x10] ;
        /*0030*/                   FFMA R8, R4, R5, R8 ;
        /*0040*/                   MUFU.EX2 R9, R8 ;
        /*0050*/                   UIADD3 UR5, UR5, 0x2, URZ ;
        /*0060*/                   NOP ;
        /*0070*/                   ISETP.LE.AND P0, PT, R3, UR5, PT ;
        /*0080*/              @!P0 BRA 0x20 ;
        /*0090*/                   IADD3 R3, R3, 0x80, RZ ;
        /*00a0*/              @!P1 BRA 0x10 ;
        /*00b0*/                   FADD R10, R10, R8 ;
        /*00c0*/               @P2 BRA 0xb0 ;
        /*00d0*/                   EXIT ;
        /*00e0*/                   BRA 0xe0;
"""

# Labels as nvdisasm prints them; a down-counter by 4 whose ISETP reads
# it, beside a pointer bump the loop does not compare; a kernel with no
# loop.
LABELLED = """
		Function : _ZN12_GLOBAL__N_117probe_gate_kernelILb1ELb0EEEvPK14__nv_bfloat162S3_PS1_ii
.L_x_0:
        /*0000*/                   HMUL2.BF16_V2 R4, R2, R3 ;
        /*0010*/                   IADD3 R9, R9, 0x40, RZ ;
        /*0020*/                   HADD2.BF16_V2 R4, R4, 0.5, 0.5 ;
        /*0030*/                   HMNMX2.BF16_V2 R4, R4, R5, PT ;
        /*0040*/                   F2FP.BF16.F32.PACK_AB R6, R7, R8 ;
        /*0050*/                   IADD3 R0, R0, -0x4, RZ ;
        /*0060*/                   ISETP.NE.AND P0, PT, R0, RZ, PT ;
        /*0070*/              @P0 BRA `(.L_x_0) ;
        /*0080*/                   EXIT ;
.L_x_1:
        /*0090*/                   BRA `(.L_x_1);
		Function : _ZN12_GLOBAL__N_117probe_gate_kernelILb0ELb0EEEvPK6float2S3_PS1_ii
        /*0000*/                   FMUL R2, R3, R4 ;
        /*0010*/                   EXIT ;
"""


def test_kernel_names_follow_the_ptxas_report():
    assert sf.kernel_name(
        "_ZN12_GLOBAL__N_117probe_gate_kernelILb1ELb0EEEvPK") == \
        "probe_gate_kernel<true,false>"
    assert sf.kernel_name(
        "_ZN12_GLOBAL__N_121probe_ablation_kernelILi9EEEvPKf") == \
        "probe_ablation_kernel<9>"
    assert sf.kernel_name("_Z6helperv") == "_Z6helperv"


def test_loops_take_the_largest_innermost_loop_by_address():
    """The inner loop (0x20-0x80, its NOP left out) and not the outer one
    around it, nor the two-instruction loop or the closing self-branch;
    its counter steps by 2 on a uniform register."""
    loop = sf.innermost_loops(ADDRESSED)["probe_ablation_kernel<4>"]
    assert loop == {"insns": 6, "step": 2, "pipes": {
        "fma": 1, "alu": 1, "xu": 1, "shared": 1}}


def test_loops_read_nvdisasm_labels_and_the_counter_they_compare():
    loops = sf.innermost_loops(LABELLED)
    loop = loops["probe_gate_kernel<true,false>"]
    assert loop["insns"] == 8 and loop["step"] == 4     # not the 0x40 bump
    assert loop["pipes"] == {"fma": 2, "alu": 5, "xu": 0, "shared": 0}
    assert "probe_gate_kernel<false,false>" not in loops   # no loop


def test_a_loop_without_a_compared_counter_has_no_step():
    sass = LABELLED.replace("ISETP.NE.AND P0, PT, R0, RZ, PT",
                            "ISETP.NE.AND P0, PT, R7, RZ, PT")
    assert sf.innermost_loops(sass)["probe_gate_kernel<true,false>"][
        "step"] is None


@pytest.mark.parametrize("pipes,insns,want", [
    ({"fma": 8, "alu": 2, "xu": 0, "shared": 2}, 16, (4.0, "issue")),
    ({"fma": 2, "alu": 10, "xu": 0, "shared": 0}, 14, (5.0, "alu")),
    ({"fma": 4, "alu": 2, "xu": 4, "shared": 0}, 12, (8.0, "xu")),
    ({"fma": 4, "alu": 0, "xu": 0, "shared": 8}, 12, (8.0, "shared")),
])
def test_clocks_a_trip_are_the_slowest_pipe(pipes, insns, want):
    assert sf.clocks_per_trip({"insns": insns, "pipes": pipes}) == want


def test_floor_at_the_gate_reference_shape():
    """A float32 gate of 16 instructions an element a repetition (32 a
    pair, four repetitions a trip) on 132 SMs at 1.98 GHz: 0.0160 ms."""
    loop = {"insns": 128, "step": 4, "pipes": {"fma": 104, "alu": 24,
                                               "xu": 0, "shared": 0}}
    units = 512 * 1024 // 2 // 32 * 64
    ms, pipe = sf.floor_ms(loop, units, 132, 1.98e9)
    assert pipe == "issue"
    assert ms == pytest.approx(512 * 1024 * 64 * 16 / (132 * 128 * 1.98e9)
                               * 1e3)


def test_floor_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA card"):
        sf.main([])


def _record(outs):
    return {name: {"ms": 0.01 * (i + 1)} for i, name in enumerate(outs)}


def test_held_records_of_the_same_bits(tmp_path, capsys):
    """Two runs' saved outputs held to each other: the same bits, both
    ms; a level only one side ran is left out."""
    a = torch.tensor([1.0, -0.0, 2.0])
    h = torch.tensor([1.0, 2.0], dtype=torch.bfloat16)
    mine = {"full": a, "bf16": h}
    kernel_microbench.hold(_record(mine), mine, save=tmp_path / "other.pt")
    theirs = {"full": a.clone(), "bf16": h.clone(), "scan": a.clone()}
    record = _record(theirs)
    kernel_microbench.hold(record, theirs, against=tmp_path / "other.pt")
    assert record["full"] == {"ms": 0.01, "against_ms": 0.01, "differ": 0,
                              "max_abs_diff": 0.0}
    assert record["bf16"]["differ"] == 0
    assert "against_ms" not in record["scan"]
    assert capsys.readouterr().out.count("same bits") == 2


def test_held_records_count_differing_bits(tmp_path):
    """-0.0 against 0.0 is a different bit pattern though equal values."""
    kernel_microbench.hold({"full": {"ms": 1.0}},
                           {"full": torch.tensor([1.0, -0.0, 2.0])},
                           save=tmp_path / "a.pt")
    record = {"full": {"ms": 2.0}}
    kernel_microbench.hold(record, {"full": torch.tensor([1.0, 0.0, 2.5])},
                           save=tmp_path / "b.pt", against=tmp_path / "a.pt")
    assert record["full"] == {"ms": 2.0, "against_ms": 1.0, "differ": 2,
                              "max_abs_diff": 0.5}
    assert torch.load(tmp_path / "b.pt")["full"]["ms"] == 2.0


@pytest.mark.parametrize("run", (
    lambda: kernel_microbench.run(device="cpu"),
    lambda: bf16_microbench.run(device="cpu")))
def test_probe_runs_need_a_card(run):
    with pytest.raises(SystemExit, match="CUDA card"):
        run()
