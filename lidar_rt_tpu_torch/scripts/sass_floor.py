"""Instruction floors of the two probe kernels, read from their SASS.

    python -m lidar_rt_tpu_torch.scripts.sass_floor

Builds the probe libraries (`ops/kernels.py`), disassembles each with
`cuobjdump -sass` and takes each kernel's innermost loop with the most
instructions: the ablation kernel's walk over a tile's candidates, the
gate kernel's repetitions.  It counts the loop's instructions by the pipe
that issues them and reads its step (the immediate by which the loop's
counter moves: candidates or repetitions a trip).  A trip takes a warp
the clocks of the slowest of: all its instructions at 4
warp-instructions a clock per SM (one per scheduler), the float32 and
packed-half pipe at 4, the ALU (min, max, compares, selects, logic,
integer adds) at 2, the XU (MUFU, conversions) at 0.5 and shared-memory
loads at 1 (CUDA's arithmetic-throughput table for compute capability
9.0, results a clock per SM over 32).  The floor is that times the trips
every warp makes at the reference's shapes (T=42, R=4096, K=128;
512 x 1024 and 64 repetitions), over the SMs and the card's highest SM
clock.  It leaves out staging, the prologue and the epilogue.

Prints, per level and mode, the instructions a trip, by pipe, a pair
(ablation) or a repetition of one pair (gate), and the floor.  Measures
on a CUDA card only; the SASS reading (`innermost_loops`) runs anywhere.
"""

from __future__ import annotations

import os
import re
import subprocess
from pathlib import Path

import torch

from lidar_rt_tpu_torch.ops import kernels
from lidar_rt_tpu_torch.scripts import bf16_microbench as gate
from lidar_rt_tpu_torch.scripts import kernel_microbench as abl

# Warp-instructions a clock per SM of each pipe (compute capability 9.0).
PIPE_RATE = {"issue": 4.0, "fma": 4.0, "alu": 2.0, "xu": 0.5,
             "shared": 1.0}
PIPES = {
    "fma": ("FFMA", "FMUL", "FADD", "FFMA32I", "FMUL32I", "FADD32I",
            "HFMA2", "HMUL2", "HADD2", "HFMA2_32I", "HMUL2_32I",
            "HADD2_32I", "IMAD", "IMAD32I"),
    "alu": ("FMNMX", "HMNMX2", "IMNMX", "FSETP", "HSETP2", "ISETP",
            "FSEL", "SEL", "LOP3", "PLOP3", "IADD3", "VIADD", "SHF",
            "LEA", "PRMT", "MOV", "F2FP", "FCHK", "P2R", "R2P"),
    "xu": ("MUFU", "F2F", "I2F", "F2I", "FRND"),
    "shared": ("LDS", "STS", "LDSM", "ATOMS"),
}
_PIPE_OF = {op: pipe for pipe, ops in PIPES.items() for op in ops}
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"`?\(?(\.L_x_\d+)\)?`?|(0x[0-9a-f]+)")
_STEP = re.compile(r"^(?:U?IADD3|VIADD)(?:\.\S+)?\s+(U?R\d+),\s*(U?R\d+),"
                   r"\s*(-?0x[0-9a-f]+)")


def kernel_name(mangled: str) -> str:
    """A probe kernel's name with its template arguments as the ptxas
    report in `chip_smoke.py` gives them (`probe_gate_kernel<true,false>`,
    `probe_ablation_kernel<4>`); any other name as it is."""
    m = re.search(r"(probe_[a-z_]+_kernel)I((?:L[bi]\d+E)*)", mangled)
    if not m:
        return mangled
    args = [("true" if v == "1" else "false") if t == "b" else v
            for t, v in re.findall(r"L([bi])(\d+)E", m.group(2))]
    return f"{m.group(1)}<{','.join(args)}>"


def _opcode(text: str) -> str:
    """The base opcode of one SASS instruction (no modifiers)."""
    return text.split(".", 1)[0].split(None, 1)[0] if text.strip() else ""


def innermost_loops(sass: str) -> dict[str, dict]:
    """{kernel: its innermost loop with the most instructions, as {"insns":
    n, "pipes": {pipe: n}, "step": s or None}} from `cuobjdump -sass` text
    (branch targets as addresses or as nvdisasm's `.L_x_` labels).  A loop
    is a branch to an address at or before its own; an innermost one holds
    no other; NOPs are left out.  The step is the immediate of an integer
    add of a register to itself that the loop also compares.  Kernels
    without a loop are left out."""
    funcs: dict[str, list[tuple[int, str]]] = {}
    labels: dict[str, dict[str, int]] = {}
    name, pending = None, []
    for line in sass.splitlines():
        if "Function :" in line:
            name = kernel_name(line.split("Function :")[1].strip())
            funcs[name], labels[name], pending = [], {}, []
        elif name is not None and (m := _LABEL.match(line)):
            pending.append(m.group(1))
        elif name is not None and (m := _INSN.search(line)):
            addr = int(m.group(1), 16)
            labels[name].update(dict.fromkeys(pending, addr))
            pending = []
            text = m.group(2)
            if text.startswith("@"):                 # the predicate
                text = text.split(None, 1)[1]
            funcs[name].append((addr, text))
    out = {}
    for name, insns in funcs.items():
        loops = []
        for addr, text in insns:
            op = _opcode(text)
            t = _TARGET.search(text.split(op, 1)[1]) if op == "BRA" else None
            target = t and (labels[name].get(t.group(1)) if t.group(1)
                            else int(t.group(2), 16))
            if target is not None and target <= addr:
                loops.append((target, addr))
        inner = [(a, b) for a, b in loops
                 if not any((a2, b2) != (a, b) and a <= a2 and b2 <= b
                            for a2, b2 in loops)]
        bodies = [[text for addr, text in insns
                   if a <= addr <= b and _opcode(text) != "NOP"]
                  for a, b in inner]
        if not bodies:
            continue
        body = max(bodies, key=len)
        pipes = dict.fromkeys(PIPES, 0)
        for text in body:
            if _PIPE_OF.get(_opcode(text)):
                pipes[_PIPE_OF[_opcode(text)]] += 1
        out[name] = {"insns": len(body), "pipes": pipes,
                     "step": _step(body)}
    return out


def _step(body: list[str]) -> int | None:
    """The loop counter's step: an `IADD3 Rx, Rx, imm` (or `UIADD3` on a
    uniform register, or `VIADD`) whose register an ISETP of the loop
    reads."""
    compared = " ".join(text for text in body if _opcode(text) == "ISETP")
    for text in body:
        m = _STEP.match(text)
        if m and m.group(1) == m.group(2) and re.search(
                rf"\b{m.group(1)}\b", compared):
            return abs(int(m.group(3), 16))
    return None


def clocks_per_trip(loop: dict) -> tuple[float, str]:
    """(SM clocks a trip of `loop` takes one warp at the pipes' rates,
    the pipe that sets them): the slowest of issue and each pipe."""
    need = {"issue": loop["insns"] / PIPE_RATE["issue"]}
    need.update({pipe: loop["pipes"][pipe] / PIPE_RATE[pipe]
                 for pipe in PIPES})
    pipe = max(need, key=need.get)
    return need[pipe], pipe


def floor_ms(loop: dict, warp_units: int, sms: int, clock_hz: float
             ) -> tuple[float, str]:
    """(the least ms the loop takes when every warp together advances its
    counter `warp_units` in all, at `loop["step"]` a trip, on `sms` SMs at
    `clock_hz`; the pipe that sets it)."""
    clocks, pipe = clocks_per_trip(loop)
    return 1e3 * warp_units / loop["step"] * clocks / sms / clock_hz, pipe


def _warps(threads: int) -> int:
    return -(-threads // 32)


def main(argv=None) -> dict[str, dict]:
    """Print and return {level or mode: {"insns", "pipes", "step",
    "per_unit", "floor_ms", "floor_pipe"}}."""
    if not torch.cuda.is_available():
        raise SystemExit("the floors need a CUDA card's SM count and clock: "
                         "torch.cuda.is_available() is False")
    libs = kernels.build(("kernel_microbench", "bf16_microbench"))
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / \
        "cuobjdump"
    loops = {}
    for path in libs.values():
        loops.update(innermost_loops(subprocess.run(
            [str(tool), "-sass", str(path)], check=True, capture_output=True,
            text=True, timeout=300).stdout))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    card, clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True, timeout=60).stdout.splitlines()[0].rsplit(",", 1)
    clock_hz = float(clock) * 1e6
    print(f"[sass_floor] {card.strip()} W; {sms} SMs at up to "
          f"{clock_hz / 1e6:.0f} MHz", flush=True)
    # Each warp of the ablation walks its tile's K candidates; each warp
    # of the gate, one pair a thread, runs the repetitions.
    units = {**{(f"probe_ablation_kernel<{i}>", level):
                abl.T * _warps(abl.R) * abl.K
                for i, level in enumerate(abl.LEVELS)},
             **{(f"probe_gate_kernel<{str(dtype == 'bf16').lower()},"
                 f"{str(with_exp).lower()}>", gate.mode_name(dtype, with_exp)):
                _warps(gate.ROWS * gate.LANES // 2) * gate.REPS
                for dtype, with_exp in gate.MODES}}
    out = {}
    for (kernel, what), n in units.items():
        loop = loops.get(kernel)
        if loop is None or not loop["step"]:
            print(f"[sass_floor] {what:10s}: {kernel}'s loop or its step "
                  "not read", flush=True)
            continue
        ms, pipe = floor_ms(loop, n, sms, clock_hz)
        out[what] = {**loop, "per_unit": loop["insns"] / loop["step"],
                     "floor_ms": ms, "floor_pipe": pipe}
        print(f"[sass_floor] {what:10s}: {loop['insns']} instructions a "
              f"trip of {loop['step']} ({out[what]['per_unit']:.2f} each; "
              + ", ".join(f"{p} {c}" for p, c in loop["pipes"].items())
              + f"); floor {ms:.4f} ms ({pipe})", flush=True)
    return out


if __name__ == "__main__":
    main()
