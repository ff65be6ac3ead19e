"""The paper's own problem configurations: 3D FFT sizes N = 512..8192 on
P <= 1024 nodes (Table 5.7 grid), with engine parameters (R, Q, l_op, f)."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class FFTProblem:
    n: int
    p: int                      # total processing elements (Pu*Pv)
    mu: int = 1                 # vector components
    r: int = 4                  # engine rows
    q: int = 4                  # engines per node (pipelined: 2X+Y+Z)
    l_op: int = 9
    f_mhz: float = 180.0
    schedule: str = "pipelined"
    net: str = "switched"
    real: bool = True           # physical fields are real-valued


PAPER_PROBLEMS = {
    f"fft{n}_p{p}": FFTProblem(n=n, p=p)
    for n in (512, 1024, 2048, 4096, 8192)
    for p in (1, 4, 16, 64, 256, 1024)
}
