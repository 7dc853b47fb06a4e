"""Checkpointing: atomic, async, restore onto a device.  PyTorch port of
``repro.train.checkpoint``, with the reference's on-disk layout, so a
checkpoint that either package writes restores in the other.

Layout:  <dir>/step_<N>/{leaves.npz, meta.json}
  - leaves.npz holds every tree leaf under its '/'-joined key path (keys
    sorted at every level, ``jax.tree_util``'s order); bfloat16 leaves are
    stored as float32 (exact) and re-cast on restore;
  - meta.json records step, leaf count and ``extra``.

Trees are nested dicts of tensors (or numpy arrays).  Restore takes
``device``, the one-device meaning of the reference's ``shardings``: a
checkpoint written from the CPU restores onto the card and the reverse.
AsyncCheckpointer copies the tree to host memory (one blocking
device-to-host copy: training then updates its tensors in place) and
writes from a background thread; ``keep`` bounds disk usage.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading

import numpy as np
import torch

from .tree import tree_items, tree_map, tree_unflatten

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "AsyncCheckpointer"]


def _items(tree) -> list[tuple[str, object]]:
    """(the '/'-joined key path, leaf) pairs, the reference's keys."""
    return [("/".join(map(str, path)), leaf) for path, leaf in tree_items(tree)]


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            # numpy has no bfloat16: float32 holds every bf16 value exactly,
            # as the reference stores it
            leaf = leaf.float()
        return leaf.numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "fiub":
        arr = arr.astype(np.float32)
    return arr


def _flatten(tree) -> dict[str, np.ndarray]:
    return {key: _numpy(leaf) for key, leaf in _items(tree)}


def save_checkpoint(ckpt_dir: str, step: int, tree, *, extra: dict | None = None):
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        leaves = _flatten(tree)
        np.savez(os.path.join(tmp, "leaves.npz"), **leaves)
        meta = {"step": step, "n_leaves": len(leaves),
                "extra": extra or {}}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic publish
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, like, *, device=None):
    """Restore into the structure of ``like``: a tree of tensors whose
    shapes and dtypes the leaves take (on the ``meta`` device, it holds no
    storage).  Each leaf lands on ``device``, or on its ``like`` leaf's
    device where ``device`` is None."""
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    data = np.load(os.path.join(path, "leaves.npz"))
    keys = [k for k, _ in _items(like)]
    if set(keys) != set(data.files):
        missing = set(keys) ^ set(data.files)
        raise ValueError(f"checkpoint/model tree mismatch: {sorted(missing)[:5]}")
    restored = []
    for key, (path, ref) in zip(keys, tree_items(like)):
        arr = data[key]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {tuple(ref.shape)}")
        target = torch.device(device) if device is not None else ref.device
        if target.type == "meta":
            raise ValueError(f"{key}: the like leaf is on the meta device; pass device=")
        leaf = torch.from_numpy(np.array(arr)).to(target)     # keeps a 0-d leaf 0-d
        restored.append((path, leaf.to(ref.dtype)))
    return tree_unflatten(restored), meta


def _host_copy(leaf):
    """A host copy of a leaf (a copy even of a CPU tensor: the train step
    updates its tensors in place while the writer runs)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


class AsyncCheckpointer:
    """Snapshot-to-host then write in the background; keeps last `keep`."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree, *, extra: dict | None = None) -> None:
        self.wait()
        host_tree = tree_map(_host_copy, tree)     # blocking D2H snapshot

        def _write():
            save_checkpoint(self.ckpt_dir, step, host_tree, extra=extra)
            self._gc()

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def _gc(self) -> None:
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.ckpt_dir)
                       if d.startswith("step_"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:09d}"),
                          ignore_errors=True)
