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
              the device of the target's leaf.  Across ranks (`save` and
              `restore` given a `RankMesh` and the tree's specs) no rank
              gathers a leaf: rank 0 creates each ``.npy`` at its whole
              shape, then (after a barrier) each block's owner -- the rank
              at index 0 on the axes the block is replicated over -- writes
              its block into it through a memmap, and (after a second
              barrier) rank 0 writes the manifest, fsyncs and renames.  A
              restore reads each rank's block of the whole arrays through a
              memmap, on any mesh: a checkpoint of 4 ranks restores on 2
              or in one process.
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


def _meta(leaf):
    """(a leaf's shape, the dtype name `_host` gives it), without copying
    it to the host."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return tuple(leaf.shape), "bfloat16"
        return tuple(leaf.shape), str(
            torch.empty(0, dtype=leaf.dtype).numpy().dtype)
    arr = np.asarray(leaf)
    return arr.shape, str(arr.dtype)


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


def _barrier(mesh) -> None:
    import torch.distributed as dist
    dist.barrier(device_ids=[mesh.device.index]
                 if mesh.backend == "nccl" else None)


def _create(path: str, shape, dtype: str) -> None:
    """An ``.npy`` of `shape` and `dtype` (zeros), its data to be written
    in place."""
    arr_dtype = _EXTENDED[dtype][0] if dtype in _EXTENDED else \
        np.lib.format.dtype_to_descr(np.dtype(dtype))
    nbytes = int(np.prod(shape, dtype=np.int64)) * (
        2 if dtype in _EXTENDED else np.dtype(dtype).itemsize)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": arr_dtype, "fortran_order": False,
                "shape": tuple(shape)})
        f.truncate(f.tell() + nbytes)


def _memmap(path: str, dtype: str, mode: str) -> np.ndarray:
    """The array of an ``.npy`` as a memmap; an extended dtype's as its
    16-bit patterns (uint16)."""
    with open(path, "rb") as f:
        read = (np.lib.format.read_array_header_1_0
                if np.lib.format.read_magic(f) == (1, 0)
                else np.lib.format.read_array_header_2_0)
        shape, _, _ = read(f)
        offset = f.tell()
    store = np.uint16 if dtype in _EXTENDED else np.dtype(dtype)
    return np.memmap(path, dtype=store, mode=mode, offset=offset,
                     shape=tuple(shape) or (1,)).reshape(tuple(shape))


def _save_ranks(ckpt_dir: str, step: int, tree: Any, specs: Any, mesh,
                keep_last: int) -> str:
    from repro_torch.sharding.partition import cut_leaf, owns, whole_shape
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    items = tree_items(tree)
    spec_of = dict(tree_items(specs))
    manifest = {}
    for path, leaf in items:
        shape, dtype = _meta(leaf)
        key = "/".join(path)
        manifest[key] = {"file": key.replace("/", "__") + ".npy",
                         "shape": list(whole_shape(shape, spec_of[path],
                                                   mesh)),
                         "dtype": dtype}
    if mesh.rank == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for info in manifest.values():
            _create(os.path.join(tmp, info["file"]), info["shape"],
                    info["dtype"])
    _barrier(mesh)
    for path, leaf in items:
        if not owns(spec_of[path], mesh):
            continue
        info = manifest["/".join(path)]
        arr, dtype = _host(leaf)
        out = _memmap(os.path.join(tmp, info["file"]), dtype, "r+")
        block = cut_leaf(out, spec_of[path], mesh) if out.ndim else out
        block[...] = arr.view(np.uint16) if dtype in _EXTENDED else arr
        out.flush()
        del out
    _barrier(mesh)
    if mesh.rank == 0:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": manifest}, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        _gc(ckpt_dir, keep_last)
    _barrier(mesh)
    return final


def save(ckpt_dir: str, step: int, tree: Any, keep_last: int = 3,
         specs: Any = None, mesh=None) -> str:
    """Write `tree` as step `step`'s checkpoint.  Across ranks (`mesh` a
    `RankMesh`, `tree` the rank's blocks under `specs`, a matching spec
    tree) every rank calls it: the elastic write of the module
    docstring."""
    if mesh is not None:
        return _save_ranks(ckpt_dir, step, tree, specs, mesh, keep_last)
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


def restore(ckpt_dir: str, step: int, target: Any, specs: Any = None,
            mesh=None) -> Any:
    """Restore into `target`'s structure: each leaf a new tensor of the
    saved dtype, on the device of the target's leaf (the CPU where the
    target's leaf is not a tensor).  Across ranks (`mesh`, `specs` as for
    `save`) each leaf is this rank's block of the whole array, read
    through a memmap: the checkpoint may come from any mesh."""
    from repro_torch.sharding.partition import cut_leaf
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    saved = manifest(ckpt_dir, step)
    spec_of = dict(tree_items(specs)) if mesh is not None else {}
    leaves = []
    for path, leaf in tree_items(target):
        info = saved["/".join(path)]
        if mesh is not None:
            whole = _memmap(os.path.join(d, info["file"]), info["dtype"], "r")
            arr = np.array(cut_leaf(whole, spec_of[path], mesh))
            del whole
            t = torch.from_numpy(arr)
            if info["dtype"] in _EXTENDED:
                t = t.view(torch.int16).view(_EXTENDED[info["dtype"]][1])
        else:
            t = _load_leaf(os.path.join(d, info["file"]), info["dtype"])
        assert list(t.shape) == list(leaf.shape), (path, t.shape, leaf.shape)
        leaves.append(t.to(leaf.device) if isinstance(leaf, torch.Tensor)
                      else t)
    return tree_unflatten(target, leaves)


class CheckpointManager:
    """Every-K-steps saver with optional async (background thread) writes.
    `maybe_save` copies the tree to the host before it returns, so the
    caller may update its tensors in place at once.  Across ranks (`mesh`,
    and `specs` given to `maybe_save`) every rank saves together, in the
    caller's thread: the write's barriers are collectives, which a
    background thread would interleave with the step's."""

    def __init__(self, ckpt_dir: str, every: int = 100, keep_last: int = 3,
                 async_save: bool = True, mesh=None):
        self.dir, self.every, self.keep = ckpt_dir, every, keep_last
        self.async_save = async_save and mesh is None
        self.mesh = mesh
        self.saved_step: Optional[int] = None   # the last step saved
        self._thread: Optional[threading.Thread] = None

    def maybe_save(self, step: int, tree: Any, force: bool = False,
                   specs: Any = None):
        if not force and (self.every <= 0 or step % self.every != 0):
            return False
        host_tree = tree_map(
            lambda t: t.detach().to("cpu", copy=True)
            if isinstance(t, torch.Tensor) else np.array(t), tree)
        self.wait()
        self.saved_step = step
        if self.mesh is not None:
            save(self.dir, step, host_tree, self.keep, specs, self.mesh)
        elif self.async_save:
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
