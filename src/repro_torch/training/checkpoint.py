"""Crash-safe checkpoints of trees of tensors (port of
``repro.training.checkpoint``), in the reference's on-disk layout:

    <dir>/step_<k>/
        shard_0.npz      every leaf as ``a<i>``, leaves in ``jax.tree``
                         order (``training.tree``)
        manifest.json    step, then each leaf's name, shape, dtype, crc32
    <dir>/LATEST         the newest step, replaced atomically, last

* **atomicity**: a save writes ``step_<k>.tmp`` and ``os.replace``s it to
  ``step_<k>``; ``LATEST`` moves only after that, so a crash mid-save
  never corrupts the restore path;
* **integrity**: each array's crc32 is checked on restore;
* **async save**: ``save_async`` copies device to host on the caller's
  thread, then serializes on a background thread;
* **retention**: the newest ``keep`` checkpoints stay.

The leaf order and the files are the reference's, so a checkpoint saved
by either package restores in the other.  Every leaf needs a numpy
dtype (training keeps fp32 parameters and state).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Optional

import numpy as np
import torch

from .tree import leaves, unflatten


def _host(x):
    """A host copy of a leaf, taken now (tensors leave the device here)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _crc32(a: np.ndarray) -> int:
    """crc32 of the array's bytes in C order (``zlib.crc32(a.tobytes())``
    without the copy)."""
    return zlib.crc32(memoryview(np.ascontiguousarray(a)).cast("B"))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree) -> str:
        host = [_to_numpy(x) for x in leaves(tree)]
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "arrays": []}
        arrays = {}
        for i, a in enumerate(host):
            manifest["arrays"].append({
                "name": f"a{i}", "shape": list(a.shape),
                "dtype": str(a.dtype), "crc32": _crc32(a)})
            arrays[f"a{i}"] = a
        np.savez(os.path.join(tmp, "shard_0.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        latest_tmp = os.path.join(self.dir, "LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(str(step))
        os.replace(latest_tmp, os.path.join(self.dir, "LATEST"))
        self._gc()
        return final

    def save_async(self, step: int, tree) -> None:
        """Copy to host on this thread (the only part that waits for the
        device), then write on a background thread."""
        host = unflatten(tree, [_host(x) for x in leaves(tree)])
        self.wait()
        self._thread = threading.Thread(
            target=self.save, args=(step, host), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.dir, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(f.read().strip())

    def restore(self, template, step: Optional[int] = None, device=None,
                shardings=None):
        """Restore into the structure of ``template``: every leaf a tensor,
        on ``device``, or (None) where the template's leaf lives (the CPU
        for a leaf that is not a tensor).  ``shardings``, a tree like
        ``template`` of ``distributed.sharding.NamedSharding``s, places
        each leaf with its placements instead (``distribute_tensor``: a
        resharding restore, each rank keeping its shard alone).  Returns
        (tree, step)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        data = np.load(os.path.join(d, "shard_0.npz"))
        slots = leaves(template)
        if len(slots) != len(manifest["arrays"]):
            raise ValueError(f"{d} holds {len(manifest['arrays'])} arrays, "
                             f"the template {len(slots)} leaves")
        places = [None] * len(slots) if shardings is None \
            else leaves(shardings)
        if len(places) != len(slots):
            raise ValueError(f"{len(places)} shardings for "
                             f"{len(slots)} leaves")
        out = []
        for meta, slot, place in zip(manifest["arrays"], slots, places):
            a = data[meta["name"]]
            if _crc32(a) != meta["crc32"]:
                raise IOError(f"checksum mismatch in {meta['name']} "
                              f"(corrupt checkpoint {d})")
            if place is not None:
                out.append(place.place(torch.from_numpy(a)))
                continue
            where = device if device is not None else (
                slot.device if isinstance(slot, torch.Tensor) else "cpu")
            out.append(torch.from_numpy(a).to(where))
        return unflatten(template, out), step

    def _gc(self) -> None:
        steps = sorted(int(n.split("_")[1]) for n in os.listdir(self.dir)
                       if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
