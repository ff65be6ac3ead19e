"""Build the port's CUDA sources into shared libraries, at first use.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
``nvcc`` compiles it in seconds into ``build/kernels/<name>-<hash>.so`` at the
root of the checkout, keyed by a hash of the source, the ``csrc/*.cuh``
headers it includes and the flags; ``ctypes`` loads it.  A source that
calls the CUDA driver API links ``libcuda`` (``LINK``).  A source listed in
``PARTS`` is compiled once a part (``-D<NAME>_PART=k``), the parts at once,
and its objects linked into the one library.  ``nvcc``'s ``-Xptxas -v``
report (registers, shared memory, spills) is kept beside the library as
``<name>-<hash>.log``.

A missing ``nvcc`` or a failed build raises: nothing here falls back to a
plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: extra link flags of the sources that need them
LINK = {"ring_rdma": ("-lcuda",), "flash_attention": ("-lcuda",)}
#: sources compiled in parts at once: ring_rdma's payload kernels in four
#: sets beside the rest (``csrc/ring_rdma.cu`` says how)
PARTS = {"ring_rdma": 5}
_INCLUDE = re.compile(rb'^\s*#include\s+"([\w.]+\.cuh)"', re.MULTILINE)


def nvcc() -> str:
    """Path of the CUDA compiler; raises when the toolkit is absent."""
    found = shutil.which("nvcc")
    if found:
        return found
    if NVCC_DEFAULT.exists():
        return str(NVCC_DEFAULT)
    raise RuntimeError("nvcc not found (neither on PATH nor under "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + LINK.get(name, ())


def _compile(compiler: str, name: str, out: Path) -> list:
    """The ``nvcc`` processes that build ``name`` into ``out``: one, or one
    a part (objects beside ``out``), started at once."""
    src = str(CSRC / f"{name}.cu")
    if name not in PARTS:
        return [(out, subprocess.Popen(
            [compiler, *NVCC_FLAGS, "-o", str(out), src, *LINK.get(name, ())],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))]
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    return [(out.with_name(f"{out.stem}.part{k}.o"), subprocess.Popen(
        [compiler, *flags, f"-D{name.upper()}_PART={k}", "-c", "-o",
         str(out.with_name(f"{out.stem}.part{k}.o")), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for k in range(PARTS[name])]


def _link(compiler: str, name: str, objects: list, out: Path) -> tuple[int, str]:
    """Link a source's part objects into ``out``: (exit code, output)."""
    r = subprocess.run([compiler, "-shared", "-o", str(out), *map(str, objects),
                        *LINK.get(name, ())], capture_output=True, text=True)
    for o in objects:
        o.unlink(missing_ok=True)
    return r.returncode, r.stdout + r.stderr


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join((CSRC / h.decode()).read_bytes()
                       for h in _INCLUDE.findall(src))
    parts = f" parts={PARTS[name]}" if name in PARTS else ""
    digest = hashlib.sha256(src + headers + (" ".join(_flags(name)) + parts).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names) -> dict[str, Path]:
    """Compile every named source that is not built yet, all ``nvcc``
    processes started together; returns ``{name: library path}``."""
    targets = {name: _target(name) for name in names}
    todo = {name: t for name, t in targets.items() if not t.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        compiler = nvcc()
        procs = {}
        for name, t in todo.items():
            tmp = t.with_name(f"{t.stem}.{os.getpid()}.tmp.so")
            procs[name] = (tmp, _compile(compiler, name, tmp))
        failed = []
        for name, (tmp, parts) in procs.items():
            outs = [proc.communicate()[0] for _, proc in parts]
            out = "".join(outs)
            code = next((proc.returncode for _, proc in parts if proc.returncode), 0)
            if code == 0 and name in PARTS:
                code, linked = _link(compiler, name, [o for o, _ in parts], tmp)
                out += linked
            if code != 0:
                failed.append(f"{name}.cu (exit {code}):\n{out}")
                continue
            todo[name].with_suffix(".log").write_text(out)
            os.replace(tmp, todo[name])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def build_log(name: str) -> str:
    """The ``-Xptxas -v`` report of the built library ``name``."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it."""
    return ctypes.CDLL(str(build_all([name])[name]))
