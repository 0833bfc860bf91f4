"""Operations and bytes of the port's hand-written kernels, from shapes.

The TTA warp (``csrc/warp_rotate_flip.cu``) reads each (N, S, S, C) f32
input element once and writes each output element once at best, plus its
(N, 4) coefficient and (N, C) fill tables; its floor is device-memory
bytes over the card's bandwidth.
"""

from __future__ import annotations

from typing import List, Tuple

Shape = Tuple[int, int, int, int]


def warp_bytes(shape: Shape, itemsize: int = 4) -> int:
    """Least device-memory traffic of one warp launch on (N, S, S, C)."""
    n, s, _, c = shape
    return 2 * n * s * s * c * itemsize + n * 4 * 4 + n * c * 4


def coteach_warp_launches(batch: int, views: int, size: int, two_modal: bool,
                          classes: int = 2, nets: int = 2) -> List[Shape]:
    """The warp launches of one co-teaching step: a forward warp of the V
    views of each modality's B images (3 channels), then one inverse warp
    of both nets' view logits."""
    forward = [(views * batch, size, size, 3)] * (2 if two_modal else 1)
    return forward + [(nets * views * batch, size, size, classes)]


def warp_bound_s(shapes: List[Shape], bytes_per_s: float) -> float:
    """Seconds the launches of ``shapes`` take at least."""
    return sum(warp_bytes(s) for s in shapes) / bytes_per_s
