"""2D pencil domain decomposition (paper §3.2.3, Fig. 3.2).

Port of ``repro.core.decomposition``.  The N³ grid is distributed over a
Pu×Pv process grid; local layouts (as in the reference):

* **X-pencil** (physical space input): local ``(Ny/Pu, Nz/Pv, Nx)``;
* **Y-pencil** (after the X↔Y fold): local ``(Nx/Pu, Nz/Pv, Ny)``;
* **Z-pencil** (after the Y↔Z fold, spectral output): local
  ``(Nx/Pu, Ny/Pv, Nz)``, natural (kx, ky, kz) order.

There is no JAX mesh here: a :class:`PencilGrid` is built from ``(pu, pv)``,
or from a mesh's shape (axis name → size) and the axes each grid dimension
spans, and this rank's ``(u, v)`` coordinates, ``(0, 0)`` on one rank.  The
communication DAG (:class:`CommStep`, :class:`CommDAG`, :func:`fft3d_dag`)
is the reference's, field for field.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping


@dataclasses.dataclass(frozen=True)
class PencilGrid:
    """The Pu×Pv processor grid of the paper and this rank's place in it.

    ``u_axes``/``v_axes`` name the grid dimensions' axes and
    ``u_sizes``/``v_sizes`` their per-axis factorization, as in the
    reference; ``coords`` is this rank's ``(u, v)`` grid coordinate.
    """

    pu: int
    pv: int
    u_axes: tuple[str, ...] = ("data",)
    v_axes: tuple[str, ...] = ("model",)
    u_sizes: tuple[int, ...] = ()
    v_sizes: tuple[int, ...] = ()
    coords: tuple[int, int] = (0, 0)

    def __post_init__(self):
        if not self.u_sizes:
            object.__setattr__(self, "u_sizes", (self.pu,))
        if not self.v_sizes:
            object.__setattr__(self, "v_sizes", (self.pv,))
        if math.prod(self.u_sizes) != self.pu:
            raise ValueError(f"u_sizes {self.u_sizes} do not factor pu={self.pu}")
        if math.prod(self.v_sizes) != self.pv:
            raise ValueError(f"v_sizes {self.v_sizes} do not factor pv={self.pv}")
        u, v = self.coords
        if not (0 <= u < self.pu and 0 <= v < self.pv):
            raise ValueError(f"coords {self.coords} outside the "
                             f"{self.pu}x{self.pv} grid")

    @classmethod
    def from_mesh(cls, pu=1, pv: int = 1, *, coords=(0, 0),
                  u_axes=("data",), v_axes=("model",)) -> "PencilGrid":
        """The grid of a ``pu × pv`` mesh, seen from rank ``coords``.

        ``pu`` may instead be a mesh's shape, a mapping of axis name to
        size (the reference's ``mesh.shape``), as in
        ``from_mesh({"pod": 2, "data": 2, "model": 2}, u_axes=("pod",
        "data"))``: each grid dimension then spans its axes, with their
        sizes as its per-axis factorization (``pv`` is not given)."""
        u_axes, v_axes = tuple(u_axes), tuple(v_axes)
        coords = tuple(int(c) for c in coords)
        if not isinstance(pu, Mapping):
            return cls(pu=int(pu), pv=int(pv), u_axes=u_axes, v_axes=v_axes,
                       coords=coords)
        u_sizes = tuple(int(pu[a]) for a in u_axes)
        v_sizes = tuple(int(pu[a]) for a in v_axes)
        return cls(pu=math.prod(u_sizes), pv=math.prod(v_sizes),
                   u_axes=u_axes, v_axes=v_axes, u_sizes=u_sizes or (1,),
                   v_sizes=v_sizes or (1,), coords=coords)

    @property
    def p(self) -> int:
        return self.pu * self.pv

    # ---- per-dimension views (CommStep.grid_dim -> axes/ranks) -----------
    def dim_axes(self, dim: str) -> tuple[str, ...]:
        """Axis names spanned by grid dimension ``"u"`` or ``"v"``."""
        if dim not in ("u", "v"):
            raise ValueError(f"grid dimension must be 'u' or 'v', got {dim!r}")
        return self.u_axes if dim == "u" else self.v_axes

    def dim_ranks(self, dim: str) -> int:
        """Total rank count of grid dimension ``"u"`` or ``"v"``."""
        return self.pu if dim == "u" else self.pv

    def dim_sizes(self, dim: str) -> tuple[int, ...]:
        """Per-axis rank factorization of grid dimension ``dim``."""
        return self.u_sizes if dim == "u" else self.v_sizes

    def comm_axes(self, dim: str) -> tuple[tuple[str, int], ...]:
        """``(axis, size)`` of the mesh axes of grid dimension ``dim`` that
        communicate (size > 1): a ring engine runs one ring per entry (the
        staged exchange), and prices Σᵢ ``wire_rounds(qᵢ)`` rounds."""
        return tuple((a, q) for a, q in zip(self.dim_axes(dim), self.dim_sizes(dim))
                     if q > 1)

    @property
    def mesh_label(self) -> str:
        """The mesh's per-axis sizes, ``"2x2x2"`` or ``"4x2"``, as the
        reference labels a mesh (``u_sizes + v_sizes``)."""
        return "x".join(str(q) for q in self.u_sizes + self.v_sizes)

    # ---- local shapes ----------------------------------------------------
    def validate(self, n: tuple[int, int, int]) -> None:
        nx, ny, nz = n
        if ny % self.pu:
            raise ValueError(f"Ny={ny} not divisible by Pu={self.pu}")
        if nz % self.pv:
            raise ValueError(f"Nz={nz} not divisible by Pv={self.pv}")
        if nx % self.pu:
            raise ValueError(f"Nx={nx} not divisible by Pu={self.pu} (X<->Y fold)")
        if ny % self.pv:
            raise ValueError(f"Ny={ny} not divisible by Pv={self.pv} (Y<->Z fold)")

    def x_pencil_local(self, n):  # (Ny/Pu, Nz/Pv, Nx)
        nx, ny, nz = n
        return (ny // self.pu, nz // self.pv, nx)

    def y_pencil_local(self, n, kx: int | None = None):
        nx, ny, nz = n
        return ((kx or nx) // self.pu, nz // self.pv, ny)

    def z_pencil_local(self, n, kx: int | None = None):
        nx, ny, nz = n
        return ((kx or nx) // self.pu, ny // self.pv, nz)

    def padded_r2c_len(self, nx: int) -> int:
        """Shard-divisible length holding the N/2+1 significant bins."""
        keep = nx // 2 + 1
        return ((keep + self.pu - 1) // self.pu) * self.pu

    # ---- data-volume model (paper §3.2.5) --------------------------------
    def local_volume_bytes(self, n, s: int = 8) -> int:
        """V = s·N³/P (Eq. 3.3)."""
        nx, ny, nz = n
        return s * nx * ny * nz // self.p

    def local_volume_after_x_bytes(self, n, s: int = 8) -> int:
        """V' = s(N³ + 2N²)/P (Eq. 3.4), N=Nx."""
        nx, ny, nz = n
        return s * (nx * ny * nz + 2 * ny * nz) // self.p


# ---------------------------------------------------------------------------
# Communication DAG: axis-labelled transpose steps
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CommStep:
    """One distributed transpose of the pencil pipeline, axis-labelled.

    ``name``          step label (``"xy"``, ``"yz"``)
    ``grid_dim``      ``"u"`` or ``"v"``
    ``split_offset``  local axis split across the ranks on the way out
    ``concat_offset`` local axis the received blocks are merged into
    ``permute``       permutation of the last three local axes applied after
                      the fold exchange (an involution for both steps)
    ``slab_offset``   local axis untouched by the exchange (the slab axis)
    ``c2c``           the compute paired with this step is plain c2c
    """

    name: str
    grid_dim: str
    split_offset: int
    concat_offset: int
    permute: tuple[int, int, int]
    slab_offset: int
    c2c: bool = True

    @property
    def unfold_split(self) -> int:
        return self.concat_offset

    @property
    def unfold_concat(self) -> int:
        return self.split_offset

    def replace(self, **changes) -> "CommStep":
        return dataclasses.replace(self, **changes)


XY_STEP = CommStep(name="xy", grid_dim="u", split_offset=-1, concat_offset=-3,
                   permute=(2, 1, 0), slab_offset=-2, c2c=True)
YZ_STEP = CommStep(name="yz", grid_dim="v", split_offset=-1, concat_offset=-2,
                   permute=(0, 2, 1), slab_offset=-3, c2c=True)


@dataclasses.dataclass(frozen=True)
class CommDAG:
    """The ordered transpose steps of one distributed transform."""

    steps: tuple[CommStep, ...]

    def __iter__(self):
        return iter(self.steps)

    def __len__(self) -> int:
        return len(self.steps)

    def step(self, name: str) -> CommStep:
        for s in self.steps:
            if s.name == name:
                return s
        raise KeyError(f"no CommStep named {name!r} in "
                       f"{tuple(s.name for s in self.steps)}")

    def inverse_steps(self) -> tuple[CommStep, ...]:
        """Steps in unfold order (right to left)."""
        return tuple(reversed(self.steps))

    def validate(self, grid: PencilGrid) -> None:
        for s in self.steps:
            grid.dim_axes(s.grid_dim)  # raises on unknown grid_dim
            if sorted(s.permute) != [0, 1, 2]:
                raise ValueError(f"step {s.name!r}: permute {s.permute} is "
                                 "not a permutation of the last three axes")


def fft3d_dag(real: bool = False) -> CommDAG:
    """The two-step pencil-transpose DAG of the 3D FFT (``real=True`` clears
    the X↔Y step's ``c2c`` flag)."""
    return CommDAG(steps=(XY_STEP.replace(c2c=not real), YZ_STEP))
