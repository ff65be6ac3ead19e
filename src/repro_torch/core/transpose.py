"""Pencil transposes — the paper's "fold communications" (§3.2.4).

Port of the single-rank part of ``repro.core.transpose``.  On a grid
dimension of one rank the block exchange is the identity and a fold is a
local permute of the last three axes; exchanges over more than one rank
come with the ``torch.distributed`` engines (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import torch

MODES = ("switched", "torus")


def all_to_all_blocks(x: torch.Tensor, ranks: int, *, split_axis: int,
                      concat_axis: int, mode: str = "switched") -> torch.Tensor:
    """Exchange ``ranks`` equal blocks of ``x`` (split along ``split_axis``)
    so block j goes to rank j, concatenated along ``concat_axis`` by source
    rank.  Over one rank that is ``x`` itself."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    del split_axis, concat_axis
    if ranks <= 1:
        return x
    raise NotImplementedError(
        f"a block exchange over {ranks} ranks needs the torch.distributed "
        "comm engines, ROADMAP Queue 1 item 5")


def permute_last3(a: torch.Tensor, perm: tuple[int, int, int]) -> torch.Tensor:
    """Apply a permutation of the LAST THREE axes; leading axes untouched.

    The ``CommStep.permute`` executor: ``(2, 1, 0)`` is the X↔Y fold's
    transpose, ``(0, 2, 1)`` the Y↔Z fold's.  Returns a view.
    """
    d = a.dim()
    return a.permute(*range(d - 3), *(d - 3 + i for i in perm))
