"""The yardstick of the roofline shares: the H100's peaks and frozen
copies of the work counts of the port's kernels (``kernels/*.py::cost``
as of the benchmark's first version), so a later change to the program
cannot move the yardstick.

Each count gives ``(bytes, flops)``: every input byte read once and
every output byte written once, at the sizes these inputs need.
"""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense, at its full 700 W: HBM3 bandwidth
#: and float32 outside the tensor cores.  A card below 700 W runs slower;
#: the run prints its power limit beside every share.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def absorb(N, R, B, F, C, touched):
    """Absorbing R folded rows (X of B rows) into (N, F, C) tables: X, y,
    the ids and weights read once; the tables of the ``touched`` leaves
    read and written once; ~16 flops a row and feature, 14 a touched bin."""
    return (B * F * 4 + B * 4 + R * 8 + touched * F * (C * 32 + 8),
            R * F * 16 + touched * F * C * 14)


def route(T, B, F, nodes, walked):
    """Routing B rows through T trees: the ``nodes`` the rows visit (17
    bytes each), X and the (T, B) ids once; a compare and a select per
    ply ``walked``."""
    return nodes * 17 + B * F * 4 + T * B * 4, walked * 2


def query(K, F, C):
    """The split query of K table rows: four (K, F, C) planes read, the
    row ids read, (K, F) merits and thresholds written; ~30 flops a bin."""
    return K * F * C * 16 + K * 4 + K * F * 8, K * F * C * 30


def compact(R, J, K):
    """Compacting R rows of J centroids into K: four (R, J) planes read,
    four (R, K) planes written; ~20 flops a centroid."""
    return R * J * 16 + R * K * 16, R * J * 20
