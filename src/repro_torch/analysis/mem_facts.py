"""Memory facts of a call that runs: its live range and its aliasing.

The counterpart of `repro/analysis/hlo_facts.py`.  The reference reads
these facts off a compiled program: a linear scan of the entry
computation's buffers (`liveness`) and the header's donation aliases.
The port has no program text, so `call_facts` runs the call once under a
`TorchDispatchMode` that sees every ATen op and the storages its outputs
live in:

* **liveness.**  A storage that no argument and no earlier output holds
  is a new buffer, opened by the op that made it and named by it; it
  stays live until its last reference goes (a weak reference to the
  storage says when).  The live bytes are summed after every op, so the
  peak is exact at op granularity.  As in `hlo_facts.liveness`, the
  arguments stay live for the whole call (``param_bytes``), and scratch
  that a kernel takes inside one op is not seen: on the card the CUDA
  allocator's peak over the call (`memory_stats`) covers it, as XLA's
  `memory_analysis()` covers the reference's.  The scan counts storage
  bytes, so the same ops give the same figure on the CPU and the card.
* **aliasing.**  Every tensor argument, with whether an output of the
  same shape and dtype comes back, and whether one of those lives in the
  argument's own storage (written in place, the counterpart of a
  donation alias) or in a fresh one (a copy the call makes every time).
  Storages are told apart by identity, never by address: every ``meta``
  storage has address 0, and a dry run (`launch.dryrun`) takes these
  facts on ``meta`` tensors.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

#: how many of the largest buffers live at the peak a fact keeps
TOP_AT_PEAK = 8


def _leaves(tree, path: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``(path, tensor)`` of every tensor in a dict/list/tuple tree."""
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return []
    return [leaf for k, v in items
            for leaf in _leaves(v, f"{path}.{k}" if path else str(k))]


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class _Tracker(TorchDispatchMode):
    """Opens a record for each new storage an op returns; samples the
    live bytes after every op that opened one.

    The peak is exact at op granularity, but a sample scans every live
    record only when it could rise: `bound` holds the live bytes at most
    (exact after a full scan, then every record opened since added and
    only the young records' deaths taken off).  The young records, opened
    since the last full scan, where a step's temporaries die, are
    pruned at every sample; while `bound` stays at or under the peak, the
    peak cannot move and the older records are left unscanned.
    """

    #: young records kept apart at most; more join the older ones
    YOUNG = 256

    def __init__(self, held: Dict[int, StorageWeakRef], base: int):
        super().__init__()
        self.held = held              # cdata -> weak ref: known storages
        self.base = base              # the arguments' bytes
        self.live: List[list] = []    # [bytes, name, op, weak ref]
        self.young: List[list] = []   # records opened since the last scan
        self.bound = base             # the live bytes at most
        self.peak = base
        self.at_peak: List[Tuple[int, str, str]] = []
        self.n_buffers = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        inputs = {t.untyped_storage()._cdata
                  for t in _tensors((args, kwargs))}
        fresh = False
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in inputs or st.nbytes() == 0:
                continue
            ref = self.held.get(key)
            if ref is not None and not ref.expired():
                continue
            ref = StorageWeakRef(st)
            self.held[key] = ref
            self.n_buffers += 1
            self.young.append([st.nbytes(), f"%{self.n_buffers}",
                               func.overloadpacket.__name__, ref])
            self.bound += st.nbytes()
            fresh = True
        if fresh:
            self._sample()
        return out

    def _sample(self) -> None:
        alive = [r for r in self.young if not r[3].expired()]
        self.bound -= sum(r[0] for r in self.young) - sum(r[0] for r in alive)
        self.young = alive
        if len(self.young) > self.YOUNG:
            self.live += self.young
            self.young = []
        if self.bound <= self.peak:
            return
        self.live = [r for r in self.live + self.young if not r[3].expired()]
        self.young = []
        self.bound = self.base + sum(r[0] for r in self.live)
        if self.bound > self.peak:
            self.peak = self.bound
            self.at_peak = [(r[0], r[1], r[2]) for r in self.live]


def _device_of(tensors) -> Optional[torch.device]:
    for t in tensors:
        if t.device.type == "cuda":
            return t.device
    return None


def call_facts(fn, *args) -> Tuple[Any, Dict]:
    """Run ``fn(*args)`` once and return ``(its result, facts)``.

    ``facts["liveness"]`` is `hlo_facts.liveness`'s dict: ``peak_bytes``
    (the arguments plus the most the call's own buffers held at once),
    ``param_bytes``, ``n_buffers`` (arguments' storages and new ones) and
    ``live_at_peak`` (``(bytes, name, op)``, largest first: arguments by
    their path, ``"parameter"``; new buffers as ``%k``, the op that made
    them).  ``facts["aliasing"]`` lists every tensor argument: its
    ``path`` (``"1.m0.k"`` is ``args[1]["m0"]["k"]``), shape, dtype,
    bytes, whether an output of its shape and dtype ``returned`` and
    whether one came back ``in_place`` (in its storage).
    ``facts["memory_stats"]`` is, where an argument lies on the card,
    ``{"allocated_bytes.all.peak": B}``: the CUDA allocator's peak over
    the call less what was allocated before it beyond the arguments
    (None on the CPU).
    """
    leaves = _leaves(list(args))
    held: Dict[int, StorageWeakRef] = {}
    named: Dict[int, Tuple[int, str]] = {}
    for path, t in leaves:
        st = t.untyped_storage()
        if st._cdata not in held:
            held[st._cdata] = StorageWeakRef(st)
            named[st._cdata] = (st.nbytes(), f"arg{path}")
    param_bytes = sum(b for b, _ in named.values())
    dev = _device_of(t for _, t in leaves)
    if dev is not None:
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    tracker = _Tracker(held, param_bytes)
    with tracker:
        out = fn(*args)
    stats = None
    if dev is not None:
        torch.cuda.synchronize(dev)
        stats = {"allocated_bytes.all.peak": torch.cuda.max_memory_allocated(
            dev) - before + param_bytes}
    params = [(b, name, "parameter") for b, name in named.values()]
    at_peak = sorted(params + tracker.at_peak, reverse=True)
    outs = _leaves(out)
    aliasing = []
    for path, t in leaves:
        nbytes = t.numel() * t.element_size()
        same = [o for _, o in outs
                if o.shape == t.shape and o.dtype == t.dtype]
        key = t.untyped_storage()._cdata
        aliasing.append(dict(
            index=int(path.split(".")[0]), path=path, shape=tuple(t.shape),
            dtype=str(t.dtype).replace("torch.", ""), bytes=nbytes,
            returned=bool(same),
            in_place=any(o.untyped_storage()._cdata == key for o in same)))
    liveness = {"peak_bytes": float(tracker.peak),
                "param_bytes": float(param_bytes),
                "n_buffers": len(named) + tracker.n_buffers,
                "live_at_peak": at_peak[:TOP_AT_PEAK]}
    return out, {"liveness": liveness, "aliasing": aliasing,
                 "memory_stats": stats}
