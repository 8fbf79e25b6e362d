"""The benchmark's frozen roofline: the least time the card could take for
the work a call needs, whatever kernel does it and whatever instructions
it uses.

Instructions per cell are the fewest any exact kernel can issue for the
fill's step. A cell's H combines four values that differ from cell to
cell (DIAG, its score s, UP and LEFT); Hopper's widest integer
instructions, the DPX forms (``__viaddmax_s32_relu``: max(a + b, c, 0),
``__vimax3_s32_relu``: max(a, b, c, 0)), take three, so H takes two
instructions at the least (linear gaps: 2). With affine gaps E and F are
values of their own, each at least one more instruction (4). The score's
lookup and the running max are not counted, so the count is a floor.

Peak: no SM issues more than 128 lane-instructions a clock (four warp
schedulers, each one 32-lane warp instruction a clock; Hopper's SM, the
H100 whitepaper), whatever the instruction; times the SM count and the
maximum SM clock the card reports. A 32-bit lane holds one cell, or two
in 16-bit halves (the ``s16x2`` DPX forms), where the configuration's
``precision`` says every answer of the deployment fits 16 bits; the
configuration's precision, not each pair's, sets the lane width, because
an exact kernel for the deployment may use it throughout. Memory: 3.35
TB/s (H100 SXM HBM3, NVIDIA's data sheet), bytes counted as each input
read once and each output written once. The least time is the larger of
the two; which one, and the card's power limit, go beside it. A cell on N
cards has N times both peaks: its least time is the work spread evenly
over them.

A kernel that scores cells a bit at a time (bit-parallel forms) is a
different algorithm from these lanes and could pass this peak; none of
the program's does.
"""

from __future__ import annotations

import dataclasses
import subprocess

MEM_BYTES_PER_S = 3.35e12
ISSUE_PER_CLOCK_PER_SM = 128
# a configuration's precision -> the bits of a lane
BITS = {"int32": 32, "int16": 16}


def instructions_per_cell(affine: bool) -> int:
    """The fewest instructions a lane issues for one cell of the fill."""
    return 4 if affine else 2


@dataclasses.dataclass(frozen=True)
class Peak:
    """The card's peaks, read on the card, and the cards a cell uses."""
    name: str
    sms: int
    max_sm_mhz: float
    power_limit_w: float
    cards: int = 1

    def issue_per_s(self) -> float:
        """Lane-instructions a second the card can issue."""
        return self.sms * ISSUE_PER_CLOCK_PER_SM * self.max_sm_mhz * 1e6

    def cells_per_s(self, bits: int, instructions: int) -> float:
        return self.issue_per_s() * (32 // bits) / instructions

    def least_s(self, work: "Work") -> tuple:
        """(seconds, 'operations' or 'bytes') the cards need at least."""
        op_s = sum(cells / self.cells_per_s(bits, work.instructions)
                   for bits, cells in work.cells_by_bits.items()) / self.cards
        byte_s = work.nbytes / MEM_BYTES_PER_S / self.cards
        return (op_s, "operations") if op_s >= byte_s else (byte_s, "bytes")


@dataclasses.dataclass
class Work:
    """What one call asks of the card: its real cells by the lane width
    they need, the instructions a cell costs, and the bytes in and out."""
    cells_by_bits: dict
    instructions: int
    nbytes: int

    @property
    def cells(self) -> int:
        return sum(self.cells_by_bits.values())


def _smi(field: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader,nounits",
         "--id=0"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()


def card_peak(cards: int = 1) -> Peak:
    """Card 0's peaks, for a cell on ``cards`` such cards. Raises where
    there is no card: a roofline is never taken from the CPU."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: a roofline share needs one")
    props = torch.cuda.get_device_properties(0)
    return Peak(name=torch.cuda.get_device_name(0),
                sms=props.multi_processor_count,
                max_sm_mhz=float(_smi("clocks.max.sm")),
                power_limit_w=float(_smi("power.limit")), cards=cards)
