"""The port's step cost (`launch.step_cost`) against the reference's
`launch/hlo_cost.py` on the same analytic programs.

The counterparts of `tests/test_hlo_cost.py`'s analytic tests: a matmul
looped 10 times counts 10 * 2 * 64^3 FLOPs and its gradient 7 * 3 * 2 *
32^3, each the reference's count of the same program's HLO; views count
no bytes, an indexed write into a large buffer counts its update only; a
``meta`` `flash_attention` counts exactly `flash_attention.work` and notes
the launch the CPU plan states; a `psum` in a loop on an abstract rank
mesh is one record an iteration, with (g - 1) x its payload on the wire
split by pod and by node.  Beside them, the shape-only routes: the
abstract mesh's records, the wrappers that refuse ``meta``, the storage
identity `mem_facts` now compares, its pruned live scan against the
plain scan, and `flash_attention.work` against the
two formulas `chip_smoke.py` used before it (``attention_work``,
``cross_work``) at its four attention cells.
"""
import numpy as np
import pytest
import torch

from repro_torch.analysis.launches import record
from repro_torch.analysis import mem_facts
from repro_torch.analysis.mem_facts import call_facts
from repro_torch.core import collectives
from repro_torch.core.mesh import AbstractRankMesh, RankMesh
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.step_cost import analyze


def _jax_flops(fn, *args):
    """The reference's trip-count-aware FLOPs of ``jax.jit(fn)``."""
    import jax
    from repro.launch.hlo_cost import analyze as hlo_analyze
    return hlo_analyze(jax.jit(fn).lower(*args).compile().as_text())["flops"]


def test_looped_matmul_counts_every_iteration():
    import jax
    import jax.numpy as jnp

    def scanned(w, x):
        y, _ = jax.lax.scan(lambda c, _: (w @ c, None), x, None, length=10)
        return y

    def looped(w, x):
        for _ in range(10):
            x = w @ x
        return x

    w, x = (torch.empty(64, 64, device="meta") for _ in range(2))
    cost = analyze(looped, w, x)
    want = 10 * 2 * 64 ** 3
    assert cost["flops"] == want
    assert cost["flops"] == _jax_flops(scanned, jnp.zeros((64, 64)),
                                       jnp.zeros((64, 64)))
    # each product reads two 64 x 64 float32 operands and writes one
    assert cost["bytes"] == 10 * 3 * 64 * 64 * 4
    assert cost["top_flops"] == [(want, "mm(float32[64, 64], float32[64, 64])",
                                  10)]


def test_gradient_counts_forward_and_backward():
    import jax
    import jax.numpy as jnp

    def loss(w, x):
        y, _ = jax.lax.scan(lambda c, _: (w @ c, None), x, None, length=7)
        return jnp.sum(y)

    def step(w, x):
        y = x
        for _ in range(7):
            y = w @ y
        # the carry's cotangent too, as the scan's transpose computes it
        return torch.autograd.grad(y.sum(), (w, x))

    w, x = (torch.zeros(32, 32, requires_grad=True) for _ in range(2))
    cost = analyze(step, w, x)
    assert cost["flops"] == 7 * 3 * 2 * 32 ** 3
    assert cost["flops"] == _jax_flops(jax.grad(loss), jnp.zeros((32, 32)),
                                       jnp.zeros((32, 32)))
    # on meta, the same count
    wm, xm = (torch.empty(32, 32, device="meta", requires_grad=True)
              for _ in range(2))
    assert analyze(step, wm, xm)["flops"] == 7 * 3 * 2 * 32 ** 3


def test_views_count_no_bytes_and_an_indexed_write_its_update():
    x = torch.randn(64, 32)
    views = analyze(lambda: x.view(32, 64).t().unsqueeze(0).expand(
        4, 64, 32).detach()[0, 1:3].reshape(2, 32))
    assert views["bytes"] == 0 and views["flops"] == 0

    buf = torch.zeros(4096, 128)
    idx = torch.zeros(2, 128, dtype=torch.int64)
    src = torch.ones(2, 128)
    cost = analyze(lambda: buf.scatter_(0, idx, src))
    # the index and the update read, the update written: not the buffer
    assert cost["bytes"] == idx.numel() * 8 + 2 * src.numel() * 4
    assert cost["bytes"] < buf.numel() * 4

    # a copy into a slice: the slice read and written
    upd = torch.ones(3, 128)
    assert analyze(lambda: buf[5:8].copy_(upd))["bytes"] == 2 * upd.numel() * 4
    # an index_put_ of rows
    rows = torch.tensor([1, 7])
    vals = torch.ones(2, 128)
    assert analyze(lambda: buf.index_put_((rows,), vals))["bytes"] \
        == rows.numel() * 8 + 2 * vals.numel() * 4


@pytest.mark.parametrize("causal,window,Skv", [(True, 0, 200), (True, 64, 200),
                                               (False, 0, 96)])
def test_meta_flash_attention_counts_its_work(causal, window, Skv):
    B, H, KV, Sq, hd = 2, 4, 2, 200 if causal else 72, 64
    args = (B, H, KV, Sq, Skv, hd, 128, 128, causal, window, "bfloat16")
    q = torch.empty(B, H, Sq, hd, dtype=torch.bfloat16, device="meta")
    k, v = (torch.empty(B, KV, Skv, hd, dtype=torch.bfloat16, device="meta")
            for _ in range(2))
    fa.flash_attention.launches = 0
    cost = analyze(lambda: fa.flash_attention(q, k, v, causal=causal,
                                              window=window))
    w = fa.work(*args)
    assert cost["kernel_flops"] == w["flops"] and cost["kernel_bytes"] \
        == w["bytes"]
    assert cost["flops"] == w["flops"] and cost["bytes"] == w["bytes"]
    assert cost["out"].shape == q.shape and cost["out"].is_meta
    assert fa.flash_attention.launches == 0          # nothing launched
    # the launch it notes is the one the CPU plan (and the card) states
    cpu = [torch.zeros(t.shape, dtype=torch.bfloat16) for t in (q, k, v)]
    with record() as on_cpu:
        fa.flash_attention(*cpu, causal=causal, window=window)
    assert [f.launch_tuple() for f in cost["launches"]] \
        == [f.launch_tuple() for f in on_cpu] \
        == [f.launch_tuple() for f in fa.plan(*args)]
    assert [f.call for f in cost["launches"]] == [f.call for f in on_cpu]
    assert cost["kernel_launches"] == [
        {"name": "fa_wgmma", "grid": list(on_cpu[0].grid),
         "threads": on_cpu[0].threads, "smem_bytes": on_cpu[0].smem_bytes,
         "count": 1}]


def test_other_wrappers_refuse_meta():
    from repro_torch.kernels import ops
    x = torch.empty(4, 128, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="tensors on 'meta' are not supported"):
        ops.local_sort(x)
    with pytest.raises(ValueError, match="tensors on 'meta' are not supported"):
        ops.localised_copy(torch.empty(1, 256, device="meta"), 2)


def test_psum_in_a_loop_is_one_record_an_iteration():
    mesh = AbstractRankMesh({"data": 4})
    assert isinstance(mesh, AbstractRankMesh) and isinstance(mesh, RankMesh)
    assert mesh.device.type == "meta" and mesh.coords == {"data": 0}

    def looped(x):
        for _ in range(5):
            x = collectives.psum(x, mesh, "data") + 1
        return x

    x = torch.empty(8, 64, device="meta")
    cost = analyze(looped, x)
    payload = 8 * 64 * 4
    assert cost["collective_counts"] == {"all-reduce": 5}
    assert cost["collective"] == {"all-reduce": 5 * 3 * payload}
    assert cost["collective_total"] == 5 * 3 * payload
    assert cost["out"].shape == x.shape and cost["out"].is_meta
    for rec in cost["collective_ops"]:
        assert rec["wire_bytes"] == 3 * payload
        assert rec["payload_bytes"] == payload and rec["staged_bytes"] == 0
        assert rec["groups"] == [[0, 1, 2, 3]]
        # four ranks: one pod, one node
        assert rec["intra_node_bytes"] == rec["intra_pod_bytes"] \
            == 3 * payload
        assert rec["inter_node_bytes"] == rec["inter_pod_bytes"] == 0


def test_records_split_by_pod_and_node():
    """Rank 5 of {"pod": 2, "data": 16}: a psum over ("pod", "data") sends
    its payload to 31 ranks, 16 in the other pod and 24 on other nodes of
    8 ranks; an all-gather over "data" to 15, 8 of them on another node."""
    mesh = AbstractRankMesh({"pod": 2, "data": 16}, rank=5)
    x = torch.empty(16, dtype=torch.bfloat16, device="meta")
    collectives.reset_collectives()
    assert collectives.psum(x, mesh, ("pod", "data")).shape == x.shape
    g = collectives.all_gather(x, mesh, "data")
    assert g.shape == (16, 16) and g.is_meta
    s = collectives.reduce_scatter(torch.empty(32, 4, device="meta"), mesh,
                                   "data")
    assert s.shape == (2, 4)
    psum, gather, scatter = collectives.collective_log()
    assert (psum["wire_bytes"], psum["inter_pod_bytes"],
            psum["inter_node_bytes"]) == (31 * 32, 16 * 32, 24 * 32)
    assert (gather["wire_bytes"], gather["inter_pod_bytes"],
            gather["inter_node_bytes"]) == (15 * 32, 0, 8 * 32)
    assert scatter["wire_bytes"] == 15 * 2 * 4 * 4
    assert scatter["inter_node_bytes"] == 8 * 2 * 4 * 4
    for rec in (psum, gather, scatter):
        assert rec["intra_node_bytes"] + rec["inter_node_bytes"] \
            == rec["wire_bytes"]
    collectives.reset_collectives()


def test_autograd_collectives_take_the_route_backward():
    mesh = AbstractRankMesh({"data": 2, "model": 4}, rank=6)
    x = torch.empty(4, 8, 16, device="meta", requires_grad=True)
    collectives.reset_collectives()
    y = collectives.Gather.apply(x, mesh, ("model",), 1)
    z = collectives.Exit.apply(collectives.Enter.apply(y, mesh, ("model",))
                               * 2, mesh, ("model",))
    z.sum().backward()
    assert x.grad.shape == x.shape and x.grad.is_meta
    kinds = [r["kind"] for r in collectives.collective_log()]
    assert kinds == ["all-gather", "all-reduce", "all-reduce",
                     "reduce-scatter"]
    collectives.reset_collectives()


def test_abstract_mesh_takes_meta_only():
    mesh = AbstractRankMesh({"data": 2})
    with pytest.raises(ValueError, match="meta tensors only"):
        collectives.psum(torch.zeros(4), mesh, "data")
    with pytest.raises(ValueError, match="not a rank"):
        AbstractRankMesh({"data": 2}, rank=2)


def test_in_place_is_storage_identity_on_meta():
    def step(a, b):
        a.add_(1)
        return a, b * 2

    a, b = (torch.empty(1024, device="meta") for _ in range(2))
    _, facts = call_facts(step, a, b)
    got = {r["path"]: r["in_place"] for r in facts["aliasing"]}
    assert got == {"0": True, "1": False}
    assert facts["liveness"]["peak_bytes"] == 3 * 1024 * 4


class _PlainScan(mem_facts._Tracker):
    """The plain live scan: every record checked at every sample."""

    def _sample(self):
        self.live = [r for r in self.live + self.young if not r[3].expired()]
        self.young = []
        current = self.base + sum(r[0] for r in self.live)
        if current > self.peak:
            self.peak = current
            self.at_peak = [(r[0], r[1], r[2]) for r in self.live]


def _late_peaks(x):
    """Records that grow old and then die; a buffer that would be a new
    peak if the dead old records still counted (the bound says it could
    be, the scan says it is not); then a true new peak."""
    n = 2 * mem_facts._Tracker.YOUNG
    kept = [x * i for i in range(n)]
    total = torch.stack(kept).sum(0)
    del kept
    mid = x.repeat(n + n // 2)
    del mid
    big = x.repeat(3 * n)
    return total + big[:x.numel()]


def _small_train_step():
    """A reduced qwen3-0.6b train step on the CPU and its arguments."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import build_cell
    from repro_torch.models import LM
    from repro_torch.sharding.partition import NULL_PLAN
    cfg = reduce_config(get_config("qwen3-0.6b"))
    return build_cell(cfg, ShapeSpec("t", 16, 4, "train"), NULL_PLAN,
                      LM(cfg).init(torch.Generator().manual_seed(0)),
                      gen=torch.Generator().manual_seed(1))


@pytest.mark.parametrize("case", ["late_peaks", "train_step"])
def test_live_scan_equals_the_plain_scan(monkeypatch, case):
    """The pruned live scan gives the plain scan's peak and the buffers
    live at it, where the peak falls after old records died."""
    seen = {}
    for name, cls in (("pruned", mem_facts._Tracker), ("plain", _PlainScan)):
        class Kept(cls):
            def __init__(self, *a):
                super().__init__(*a)
                seen[name] = self
        monkeypatch.setattr(mem_facts, "_Tracker", Kept)
        if case == "late_peaks":
            fn, args = _late_peaks, (torch.ones(64),)
        else:
            fn, args = _small_train_step()
        with torch.set_grad_enabled(case == "train_step"):
            _, facts = call_facts(fn, *args)
        seen[name + "_facts"] = facts["liveness"]
    assert seen["pruned"].n_buffers > 2 * mem_facts._Tracker.YOUNG
    assert seen["pruned"].peak == seen["plain"].peak
    assert seen["pruned"].at_peak == seen["plain"].at_peak
    assert seen["pruned_facts"] == seen["plain_facts"]
    if case == "late_peaks":       # x, total, big and the sum: the last
        assert seen["pruned"].peak == 64 * 4 * (3 + 3 * 2 * 256)


#: `chip_smoke.py`'s attention cells (B, H, KV, S, hd, window, dtype)
ATTN_CELLS = {"qwen3-0.6b_bf16": (1, 16, 8, 4096, 128, 0, "bfloat16"),
              "qwen3-0.6b_f32": (1, 16, 8, 4096, 128, 0, "float32"),
              "qwen3-0.6b_f16": (1, 16, 8, 4096, 128, 0, "float16"),
              "mixtral-8x7b_bf16": (1, 32, 8, 8192, 128, 4096, "bfloat16")}


def old_attention_work(B, H, KV, S, hd, window, itemsize):
    """`chip_smoke.py`'s former causal count."""
    q = torch.arange(S, dtype=torch.float64)
    pairs = float((q + 1).clamp(max=window).sum()) if window else \
        S * (S + 1) / 2
    return 4 * hd * pairs * B * H, (2 * B * H + 2 * B * KV) * S * hd * itemsize


def old_cross_work(B, H, KV, Sq, Skv, hd, itemsize):
    """`chip_smoke.py`'s former non-causal count."""
    return (4 * hd * Sq * Skv * B * H,
            (2 * B * H * Sq + 2 * B * KV * Skv) * hd * itemsize)


@pytest.mark.parametrize("cell", sorted(ATTN_CELLS))
def test_work_equals_the_former_formulas(cell):
    B, H, KV, S, hd, window, dtype = ATTN_CELLS[cell]
    item = getattr(torch, dtype).itemsize
    w = fa.work(B, H, KV, S, S, hd, 128, 128, True, window, dtype)
    assert (w["flops"], w["bytes"]) == old_attention_work(
        B, H, KV, S, hd, window, item)
    # the cell's shape without the mask: every pair, as cross attention
    c = fa.work(B, H, KV, S, 2 * S, hd, 128, 128, False, 0, dtype)
    assert (c["flops"], c["bytes"]) == old_cross_work(B, H, KV, S, 2 * S, hd,
                                                      item)


def test_work_counts_the_dense_mask():
    """The pairs `work` counts are those the dense oracle's mask keeps."""
    for Sq, Skv, causal, window in [(37, 37, True, 0), (37, 37, True, 5),
                                    (20, 33, True, 0), (20, 33, False, 0),
                                    (33, 20, True, 7)]:
        i, j = np.arange(Sq)[:, None], np.arange(Skv)[None, :]
        keep = np.ones((Sq, Skv), bool)
        if causal:
            keep &= j <= i
        if window:
            keep &= j > i - window
        w = fa.work(1, 1, 1, Sq, Skv, 16, 128, 128, causal, window,
                    "float32")
        assert w["flops"] == 4 * 16 * int(keep.sum())
