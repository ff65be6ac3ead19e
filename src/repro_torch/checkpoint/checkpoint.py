"""Fault-tolerant checkpointing — port of ``repro.checkpoint.checkpoint``:
atomic (tmp + rename) saves, an async writer thread, keep-last-k GC, and
the **resharding restore** — a checkpoint written on one grid restores onto
another, because leaves are stored as full logical arrays and cut to the
target's blocks at load.

The on-disk layout is the reference's, so a checkpoint either package
writes restores in the other::

    <dir>/step_<n>/   manifest.json  +  arrays.npz (flat path-keyed)
    <dir>/LATEST      (atomic pointer file)

Keys are the flat tree paths the reference takes from
``jax.tree_util.tree_flatten_with_path`` (``fields/0``, ``t``,
``n_steps``): :func:`_flatten` yields the same keys for dicts, tuples and
lists.

:meth:`CheckpointManager.save` takes the host snapshot synchronously, as a
copy (``.to("cpu", copy=True)`` of a tensor, on the card or not), before
the writer thread starts: the snapshot aliases nothing a later step
changes in place, and the writer touches numpy only, never CUDA.

Failure semantics, as in the reference:

* a save is visible only after the atomic rename — a writer killed or
  raising mid-write leaves a ``step_*.tmp`` directory that
  :meth:`latest_step` and GC ignore, never a half-checkpoint;
* an exception in the **async** writer thread is captured, not swallowed:
  the next :meth:`wait` (or the implicit one at the head of the next
  :meth:`save`) re-raises it as :class:`CheckpointError`;
* a torn ``LATEST`` pointer (or a pointer at an incomplete directory)
  falls back to scanning for the newest *complete* step directory.

Counters: ``checkpoint.saves``, ``checkpoint.bytes``,
``checkpoint.write_errors``, ``checkpoint.restores``; gauges
``checkpoint.restore_us``, and the latest save's ``checkpoint.snapshot_us``
and ``checkpoint.write_us``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch import obs


class CheckpointError(RuntimeError):
    """A (possibly async) checkpoint write failed; the save did not land."""


def _flatten(tree, prefix: str = "") -> dict:
    """``{path: leaf}`` of a tree of dicts, tuples and lists, the paths
    those of ``jax.tree_util.tree_flatten_with_path``: the keys (dicts in
    sorted key order) and indices joined by ``/``.  ``None`` is an empty
    subtree, as in jax."""
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(tree))
    elif tree is None:
        return {}
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def _unflatten(tree, leaves: dict, prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``leaves[path]``."""
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(v, leaves, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return leaves[prefix]


def _host_copy(leaf) -> np.ndarray:
    """A numpy copy of ``leaf`` that shares no memory with it."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _numpy_dtype(leaf):
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.last_save_bytes = 0       # host bytes of the latest save
        self.last_snapshot_s = 0.0     # seconds of its host snapshot
        self.last_write_s = 0.0        # seconds of its write to disk
        os.makedirs(directory, exist_ok=True)

    # ---- save -------------------------------------------------------------
    def save(self, step: int, tree, meta: dict | None = None, block: bool = False):
        """Snapshot to host memory synchronously (a copy), write to disk
        async.

        Raises :class:`CheckpointError` if a *previous* async write failed
        (before starting this one), or — with ``block=True`` or
        ``async_write=False`` — if this write fails."""
        t0 = time.perf_counter()
        host = {k: _host_copy(v) for k, v in _flatten(tree).items()}
        self.last_snapshot_s = time.perf_counter() - t0
        self.last_save_bytes = sum(a.nbytes for a in host.values())
        obs.metrics.set_gauge("checkpoint.snapshot_us", self.last_snapshot_s * 1e6)
        obs.metrics.inc("checkpoint.saves")
        obs.metrics.inc("checkpoint.bytes", self.last_save_bytes)
        self.wait()                    # re-raises a prior async failure
        if not self.async_write:
            try:
                self._write(step, host, meta or {})
            except BaseException as e:
                obs.metrics.inc("checkpoint.write_errors")
                raise CheckpointError(
                    f"checkpoint write failed: "
                    f"{type(e).__name__}: {e}") from e
            return
        self._thread = threading.Thread(
            target=self._write_guarded, args=(step, host, meta or {}),
            daemon=True)
        self._thread.start()
        if block:
            self.wait()

    def wait(self):
        """Join the in-flight async write; re-raise its failure, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            obs.metrics.inc("checkpoint.write_errors")
            raise CheckpointError(
                f"async checkpoint write failed: "
                f"{type(err).__name__}: {err}") from err

    def _write_guarded(self, step: int, host: dict, meta: dict):
        try:
            self._write(step, host, meta)
        except BaseException as e:     # surfaces on the next wait()/save()
            self._error = e

    def _write(self, step: int, host: dict, meta: dict):
        t0 = time.perf_counter()
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        meta = dict(meta, step=step, time=time.time())
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(meta, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        ptr = os.path.join(self.dir, "LATEST.tmp")
        with open(ptr, "w") as f:
            f.write(os.path.basename(final))
        os.replace(ptr, os.path.join(self.dir, "LATEST"))
        self._gc()
        self.last_write_s = time.perf_counter() - t0
        obs.metrics.set_gauge("checkpoint.write_us", self.last_write_s * 1e6)

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.dir) if d.startswith("step_")
                       and not d.endswith(".tmp"))
        for d in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # ---- restore ------------------------------------------------------------
    def _complete_steps(self) -> list[int]:
        """Step numbers with a complete (manifest-bearing) directory."""
        out = []
        for d in os.listdir(self.dir):
            if not d.startswith("step_") or d.endswith(".tmp"):
                continue
            if os.path.exists(os.path.join(self.dir, d, "manifest.json")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        ptr = os.path.join(self.dir, "LATEST")
        if os.path.exists(ptr):
            with open(ptr) as f:
                name = f.read().strip()
            if os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                return int(name.split("_")[1])
        # torn pointer or incomplete dir — scan for the newest complete step
        steps = self._complete_steps()
        return steps[-1] if steps else None

    def restore(self, target_tree, step: int | None = None, place=None) -> tuple:
        """Restore into the structure of ``target_tree``: each leaf's array
        is checked against the target leaf's shape and cast to its dtype (a
        tensor on the ``meta`` device is a template of both).  ``place``
        (a tree of the target's structure, or a prefix of it) holds, for
        some leaves, a callable that takes the numpy array and returns the
        leaf: the elastic path, which cuts this rank's block.  Other leaves
        come back as tensors on the target's device where the target is a
        tensor (the CPU for ``meta``), else as numpy arrays."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        t0 = time.monotonic()
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            meta = json.load(f)
        placers = _flatten(place) if place is not None else {}
        leaves = {}
        with np.load(os.path.join(d, "arrays.npz")) as z:
            for k, tgt in _flatten(target_tree).items():
                a = z[k]
                if tuple(a.shape) != tuple(np.shape(tgt)):
                    raise ValueError(f"checkpoint leaf {k!r} has shape "
                                     f"{a.shape}, the target {tuple(np.shape(tgt))}")
                a = a.astype(_numpy_dtype(tgt))
                if placers.get(k) is not None:
                    a = placers[k](a)
                elif isinstance(tgt, torch.Tensor):
                    dev = "cpu" if tgt.device.type == "meta" else tgt.device
                    a = torch.from_numpy(a).to(dev)
                leaves[k] = a
        tree = _unflatten(target_tree, leaves)
        obs.metrics.inc("checkpoint.restores")
        obs.metrics.set_gauge("checkpoint.restore_us",
                              (time.monotonic() - t0) * 1e6)
        return tree, meta
