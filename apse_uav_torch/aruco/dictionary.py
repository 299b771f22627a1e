"""ArUco DICT_4X4_50 dictionary and batched decoding, in PyTorch.

Counterpart of the JAX reference's ``aruco/dictionary.py`` (its own copy of the
table).  The 50 codes are OpenCV's predefined DICT_4X4_50, each packing the
16 inner bits row-major, MSB first.  ``maxCorrectionBits`` is 1 for this
dictionary; the reference's ``errorCorrectionRate = 2.0`` gives a budget of
int(1 * 2.0) = 2 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from apse_uav_torch.utils import profiling

# fmt: off
DICT_4X4_50 = np.array([
    46386, 3994, 13101, 39238, 21662, 31181, 40494, 50418, 65242, 53078,
    63889, 4519, 3767, 10767, 9393, 9790, 18021, 26112, 27742, 30383,
    34443, 45099, 52437, 56706, 65095, 38001, 44260, 42324, 8483, 13423,
    17429, 22450, 40655, 61643, 2222, 2345, 6261, 1279, 3574, 7258,
    5912, 10792, 12940, 14514, 9448, 12011, 11583, 19300, 20526, 20499,
], dtype=np.int64)
# fmt: on

MARKER_SIZE = 4
MAX_CORRECTION_BITS = 1


def _bits_to_grid(code: int) -> np.ndarray:
    return np.array([[(code >> (15 - (r * 4 + c))) & 1 for c in range(4)] for r in range(4)], dtype=np.uint8)


def _grid_to_bits(grid: np.ndarray) -> int:
    out = 0
    for b in grid.reshape(-1):
        out = (out << 1) | int(b)
    return out


def _rotations(code: int) -> list[int]:
    """The 4 rotations of a code (90 deg steps, as OpenCV stores them)."""
    g = _bits_to_grid(code)
    return [_grid_to_bits(np.rot90(g, -k)) for k in range(4)]


_ALL_ROTATIONS = np.array([_rotations(int(c)) for c in DICT_4X4_50], dtype=np.int64)  # (50, 4)


def _popcount16(x: torch.Tensor) -> torch.Tensor:
    x = x - ((x >> 1) & 0x5555)
    x = (x & 0x3333) + ((x >> 2) & 0x3333)
    x = (x + (x >> 4)) & 0x0F0F
    return (x + (x >> 8)) & 0x1F


def rotation_table(device=None) -> torch.Tensor:
    """The (200,) int64 codes of every (id, rotation) in table order on ``device``: a copy from the host."""
    return torch.as_tensor(_ALL_ROTATIONS, device=device).reshape(200)


def match_dictionary(bits: torch.Tensor, error_correction_rate: float = 2.0, table: torch.Tensor | None = None):
    """Match packed 16-bit codes (...,) against DICT_4X4_50.

    Returns (ids, rotations, distances), each (...,) int32; id -1 when no
    code is within the correction budget; rotation k = roll the candidate's
    corners by k to the canonical orientation.  Ties take the first
    (id, rotation) in table order, like ``jnp.argmin``.  With ``table``
    (:func:`rotation_table` on the codes' device, made once by the caller)
    the call copies nothing from the host.
    """
    budget = int(MAX_CORRECTION_BITS * error_correction_rate)
    if table is None:
        with profiling.sync("dictionary_table"):  # a copy from the host
            table = rotation_table(bits.device)
    dist = _popcount16(torch.bitwise_xor(bits.to(torch.int64)[..., None], table))  # (..., 200)
    best_dist, best = torch.min(dist, dim=-1)
    # torch.min's index on ties is not promised to be the first: take it explicitly.
    first = torch.argmax((dist == best_dist[..., None]).to(torch.int32), dim=-1)
    ids = torch.where(best_dist <= budget, torch.div(first, 4, rounding_mode="floor"), torch.full_like(first, -1))
    return ids.to(torch.int32), (first % 4).to(torch.int32), best_dist.to(torch.int32)


def marker_image(marker_id: int, cell_px: int = 1) -> np.ndarray:
    """Canonical marker (6x6 cells incl. the 1-cell black border) as u8, 0/255."""
    grid = np.zeros((6, 6), dtype=np.uint8)
    grid[1:5, 1:5] = _bits_to_grid(int(DICT_4X4_50[marker_id]))
    return np.kron((grid * 255).astype(np.uint8), np.ones((cell_px, cell_px), dtype=np.uint8))
