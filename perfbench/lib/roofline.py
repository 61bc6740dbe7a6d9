"""The yardstick of the roofline shares: the published peaks of one NVIDIA
H100 SXM (dense, at its 700 W limit) and the least time of an operation.

Copied from the port's chip_smoke.py (`bound`, `block_bound`) so that a
later change there does not move the benchmark."""

from __future__ import annotations

from dataclasses import dataclass

HBM_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12


def least_s(n_bytes: float, n_flops: float, peak: float = PEAK_F32_FLOPS) -> float:
    """The least seconds the card could take: the larger of the bytes over
    the memory rate and the operations over the peak of their type."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / peak)


@dataclass
class Op:
    """`count` applications of one operation, each moving `bytes` (inputs
    read once, outputs written once) and doing `flops` at `peak`."""
    name: str
    count: float
    flops: float
    bytes: float
    peak: float = PEAK_F32_FLOPS

    @property
    def least_s(self) -> float:
        return self.count * least_s(self.bytes, self.flops, self.peak)


def block_apply(n_blocks: int, bw: int, n_vec: int, entry_bytes: int = 4,
                factored: bool = False) -> Op:
    """One block apply over n_blocks (bw x bw) blocks and n_vec f32 entries
    of r read and of the result written: K2 reads every entry of B^-1 once,
    2 operations each; K3 needs W's upper triangle only, bw (bw + 1) / 2
    entries a block, used twice, 4 operations each."""
    entries = n_blocks * (bw * (bw + 1) // 2 if factored else bw * bw)
    return Op("k3" if factored else "k2", 1, (4 if factored else 2) * entries,
              entries * entry_bytes + 4 * 2 * n_vec)
