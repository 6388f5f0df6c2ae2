"""The cost of one rank's step, counted while it runs.

The counterpart of `repro/launch/hlo_cost.py`, which parses the
partitioned HLO of one device's step.  The port has no program text:
`analyze(fn, *args)` runs ``fn(*args)`` once -- on ``meta`` tensors of an
`core.mesh.AbstractRankMesh` for a dry run (`launch.dryrun`), or on the
card -- and counts what it dispatches:

  * FLOPs             `torch.utils.flop_counter.FlopCounterMode` over the
                      ATen ops (backward ops too, so a train step's
                      count holds the recompute under remat), plus each
                      kernel launch's ``work(...)`` (the kernel module's
                      count, `kernels.flash_attention.work`), which the
                      counter cannot see inside;
  * HBM bytes         each ATen op's input and output tensor bytes (a
                      tensor's elements, at most its storage's bytes),
                      what eager mode reads and writes: ops that move no
                      data (views, reshapes, transposes, ``detach``,
                      ``empty``) count 0, the reference's
                      ``_ZERO_BYTE_OPS``; an in-place indexed write
                      (``scatter_``, ``index_put_``, ...) counts its index
                      and update read and the update written, and a copy
                      into a slice the slice read and written, not the
                      whole buffer (the reference's dynamic-update-slice
                      rule); kernel launches add their ``work(...)`` bytes,
                      and a collective's transport ops (``c10d``) none;
  * collectives       the rank's `core.collectives` records of the call:
                      wire bytes and counts by kind, and the inter- and
                      intra-pod and inter- and intra-node splits.

Eager PyTorch unrolls every loop (superblocks, microbatches, KV chunks),
so every iteration is dispatched and counted: there are no trip counts to
recover, and the reference's ``while_trips`` has no counterpart here.
Nothing in the count depends on the device: a run on ``meta`` and one on
the card that dispatch the same ops count the same.
"""
from __future__ import annotations

import contextlib
import importlib
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis.launches import LaunchFacts, record
from repro_torch.core import collectives

#: ops that allocate without writing, or only name data (`_is_view`)
ZERO_BYTE_OPS = frozenset({"empty", "empty_like", "empty_strided",
                           "new_empty", "new_empty_strided", "detach",
                           "lift_fresh", "_local_scalar_dense",
                           "_unsafe_view"})
#: in-place ops that write `self` without reading it
WRITE_ONLY_OPS = frozenset({"copy_", "fill_", "zero_", "normal_",
                            "uniform_", "random_", "bernoulli_",
                            "exponential_"})
#: in-place indexed writes: their index and update are read, the update
#: written; the rest of the buffer is not touched
INDEXED_WRITE_OPS = frozenset({"scatter_", "scatter_add_", "scatter_reduce_",
                               "index_put_", "_index_put_impl_",
                               "index_copy_", "index_add_", "masked_scatter_",
                               "put_"})
#: the ops of a collective's transport: counted on the wire, not in HBM
COLLECTIVE_NAMESPACES = frozenset({"c10d", "_c10d_functional"})
#: how many of the largest entries `top_flops` / `top_bytes` keep
TOP = 40
#: the record keys a collective's bytes are split by
SPLITS = ("inter_pod_bytes", "intra_pod_bytes", "inter_node_bytes",
          "intra_node_bytes")


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes an op reads or writes of `t`: its elements', at most its
    storage's (a broadcast view reads its storage once)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _is_view(func) -> bool:
    """Whether every output of `func` aliases an input without writing it."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _writes_self(func) -> bool:
    args = func._schema.arguments
    return bool(args) and args[0].alias_info is not None \
        and args[0].alias_info.is_write


def op_bytes(func, args, kwargs, out) -> int:
    """`func`'s HBM bytes under the rules of the module docstring."""
    name = func.overloadpacket.__name__
    if name in ZERO_BYTE_OPS or _is_view(func) \
            or func.namespace in COLLECTIVE_NAMESPACES:
        return 0
    ins = list({id(t): t for t in _tensors((args, kwargs))}.values())
    if not _writes_self(func) or not isinstance(args[0], torch.Tensor):
        outs = {id(t): t for t in _tensors(out)}
        return sum(map(tensor_bytes, ins)) + sum(map(tensor_bytes,
                                                     outs.values()))
    self_ = args[0]
    rest = [t for t in ins if t is not self_]
    read = sum(map(tensor_bytes, rest))
    if name in INDEXED_WRITE_OPS:
        upd = [tensor_bytes(t) for t in rest if t.dtype == self_.dtype]
        return read + max(upd, default=0)
    if name in WRITE_ONLY_OPS:
        return read + tensor_bytes(self_)
    return read + 2 * tensor_bytes(self_)


def _label(func, args, kwargs) -> str:
    shapes = [f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}"
              for t in _tensors((args, kwargs))]
    return f"{func.overloadpacket.__name__}({', '.join(shapes)})"


class _Counter(TorchDispatchMode):
    """Sums each op's bytes and, from the flop counter below it, its
    FLOPs, by op and operand shapes."""

    def __init__(self, flops: FlopCounterMode):
        super().__init__()
        self.flops = flops
        self.bytes = 0
        self.by_label: Dict[str, List[int]] = defaultdict(lambda: [0, 0, 0])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        before = self.flops.get_total_flops()
        out = func(*args, **kwargs)
        f = self.flops.get_total_flops() - before
        b = op_bytes(func, args, kwargs, out)
        self.bytes += b
        if f or b:
            e = self.by_label[_label(func, args, kwargs)]
            e[0] += f
            e[1] += b
            e[2] += 1
        return out


def kernel_work(facts: List[LaunchFacts]) -> Tuple[int, int]:
    """``(flops, bytes)`` of the recorded launches: each call's
    ``work(*args)`` from its kernel module (once a call: its first launch,
    ``step`` 0)."""
    flops = nbytes = 0
    for f in facts:
        if f.step:
            continue
        module, args = f.call
        mod = importlib.import_module(module)
        if not hasattr(mod, "work"):
            raise NotImplementedError(
                f"{module} states no work(...) for its launches, so a step "
                f"that launches {f.name} cannot be costed")
        w = mod.work(*args)
        flops += w["flops"]
        nbytes += w["bytes"]
    return flops, nbytes


def fold_launches(facts: List[LaunchFacts]) -> List[Dict]:
    """The recorded launches by name, grid, threads and shared memory,
    each with its count, in first-seen order."""
    seen: Dict[Tuple, int] = {}
    for f in facts:
        key = f.launch_tuple()
        seen[key] = seen.get(key, 0) + 1
    return [{"name": k[0], "grid": list(k[1]), "threads": k[2],
             "smem_bytes": k[3] + k[4], "count": n} for k, n in seen.items()]


def fold_collectives(log: List[Dict]) -> Dict:
    """`analyze`'s collective keys from a rank's records."""
    by_kind: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    split = {k: 0 for k in SPLITS}
    for r in log:
        by_kind[r["kind"]] += r["wire_bytes"] * r["mult"]
        counts[r["kind"]] += r["mult"]
        for k in SPLITS:
            split[k] += r[k] * r["mult"]
    return {"collective": dict(by_kind),
            "collective_total": sum(by_kind.values()),
            "collective_counts": dict(counts), "collective_split": split,
            "collective_ops": log}


@contextlib.contextmanager
def counting() -> Iterator[Dict]:
    """Count everything run inside the block; the dict it yields is
    filled with `analyze`'s keys when the block ends.  Another dispatch
    mode entered inside it (`analysis.mem_facts.call_facts`) sees the
    same ops."""
    result: Dict = {}
    start = len(collectives.LOG)
    flops = FlopCounterMode(display=False)
    counter = _Counter(flops)
    with record() as facts, flops, counter:
        yield result
    kflops, kbytes = kernel_work(facts)
    rows = sorted(((f, b, n, label) for label, (f, b, n)
                   in counter.by_label.items()), reverse=True)
    result.update(
        flops=flops.get_total_flops() + kflops,
        bytes=counter.bytes + kbytes,
        aten_flops=flops.get_total_flops(), aten_bytes=counter.bytes,
        kernel_flops=kflops, kernel_bytes=kbytes,
        top_flops=[(f, label, n) for f, _, n, label in rows if f][:TOP],
        top_bytes=sorted(((b, label, n) for _, b, n, label in rows if b),
                         reverse=True)[:TOP],
        launches=facts, kernel_launches=fold_launches(facts),
        **fold_collectives(collectives.collective_log()[start:]))


def analyze(fn, *args) -> Dict:
    """Run ``fn(*args)`` once and return its counts: ``flops``, ``bytes``
    (each with its ``aten_`` and ``kernel_`` parts), ``top_flops`` /
    ``top_bytes`` (``(count, "op(operand shapes)", calls)``, largest
    first), ``launches`` (the `LaunchFacts` noted) and
    ``kernel_launches`` (folded), ``collective`` (wire bytes by kind),
    ``collective_total``, ``collective_counts``, ``collective_split`` and
    ``collective_ops`` (the records).  The result of the call is
    ``"out"``."""
    with counting() as cost:
        out = fn(*args)
    cost["out"] = out
    return cost


__all__ = ["analyze", "counting", "op_bytes", "tensor_bytes", "kernel_work",
           "fold_launches", "fold_collectives"]
