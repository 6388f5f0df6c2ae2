"""Atomic checkpoints in the reference's on-disk format: the counterpart of
`repro/checkpoint/ckpt.py`.

* atomic   -- write to ``<dir>/tmp.<step>``, fsync the manifest,
              `os.replace` to ``<dir>/step_<n>``: a crash never leaves a
              half checkpoint visible (the trainer only ever restores
              complete steps).
* format   -- the reference's, file for file: ``manifest.json`` maps each
              leaf's path (dict keys joined by ``/``, in the reference's
              sorted order) to its file, shape and dtype name, and each
              leaf is one ``.npy``.  numpy has no bfloat16: a bfloat16 leaf
              is written through its 16-bit pattern with the header numpy
              gives an ``ml_dtypes`` bfloat16 array (``'<V2'``), and
              ``"dtype": "bfloat16"`` in the manifest.  A checkpoint
              written by either package restores in the other.
* elastic  -- leaves are whole logical arrays; `restore` places each on
              the device of the target's leaf.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import tree_items, tree_map, tree_unflatten

#: dtypes numpy lacks, saved through their 16-bit patterns (the
#: reference's ``ml_dtypes`` types): their npy header descr, torch dtype
_EXTENDED = {"bfloat16": ("<V2", torch.bfloat16)}


def _host(leaf):
    """(a leaf as a numpy array on the host, its dtype's name); a bfloat16
    tensor as its bits (uint16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        leaf = t.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _save_leaf(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype not in _EXTENDED:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _EXTENDED[dtype][0], "fortran_order": False,
                "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _load_leaf(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype in _EXTENDED:
        return torch.from_numpy(arr.view(np.int16)).view(_EXTENDED[dtype][1])
    return torch.from_numpy(arr)


def save(ckpt_dir: str, step: int, tree: Any, keep_last: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {}
    for path, leaf in tree_items(tree):
        key = "/".join(path)
        arr, dtype = _host(leaf)
        fname = key.replace("/", "__") + ".npy"
        _save_leaf(os.path.join(tmp, fname), arr, dtype)
        manifest[key] = {"file": fname, "shape": list(arr.shape),
                         "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": manifest}, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(ckpt_dir, keep_last)
    return final


def _gc(ckpt_dir: str, keep_last: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return int(steps[-1].split("_")[1]) if steps else None


def manifest(ckpt_dir: str, step: int) -> dict:
    """Step `step`'s leaves: ``{path: {"file", "shape", "dtype"}}``, each
    path its dict keys joined by ``/``."""
    with open(os.path.join(ckpt_dir, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)["leaves"]


def restore(ckpt_dir: str, step: int, target: Any) -> Any:
    """Restore into `target`'s structure: each leaf a new tensor of the
    saved dtype, on the device of the target's leaf (the CPU where the
    target's leaf is not a tensor)."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    saved = manifest(ckpt_dir, step)
    leaves = []
    for path, leaf in tree_items(target):
        info = saved["/".join(path)]
        t = _load_leaf(os.path.join(d, info["file"]), info["dtype"])
        assert list(t.shape) == list(leaf.shape), (path, t.shape, leaf.shape)
        leaves.append(t.to(leaf.device) if isinstance(leaf, torch.Tensor)
                      else t)
    return tree_unflatten(target, leaves)


class CheckpointManager:
    """Every-K-steps saver with optional async (background thread) writes.
    `maybe_save` copies the tree to the host before it returns, so the
    caller may update its tensors in place at once."""

    def __init__(self, ckpt_dir: str, every: int = 100, keep_last: int = 3,
                 async_save: bool = True):
        self.dir, self.every, self.keep = ckpt_dir, every, keep_last
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    def maybe_save(self, step: int, tree: Any, force: bool = False):
        if not force and (self.every <= 0 or step % self.every != 0):
            return False
        host_tree = tree_map(
            lambda t: t.detach().to("cpu", copy=True)
            if isinstance(t, torch.Tensor) else np.array(t), tree)
        self.wait()
        if self.async_save:
            self._thread = threading.Thread(
                target=save, args=(self.dir, step, host_tree, self.keep))
            self._thread.start()
        else:
            save(self.dir, step, host_tree, self.keep)
        return True

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
