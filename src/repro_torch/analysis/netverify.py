"""Rule R6: certify the engine's exchange network as a sorting network.

(A copy of `repro/analysis/netverify.py`, run over the port's own
descriptors, `repro_torch.core.engine.exchange_network`.)

The merge-split network is the one piece of the engine whose correctness is
*combinatorial*: a wrong permutation, a dropped substage, or a flipped keep
flag produces silently mis-sorted output on exactly the mesh shapes nobody
benchmarked — the same class of silent corruption coherence-protocol
verification targets in distributed directories.  `core.engine` now exposes
the network as data (`exchange_network`), so this module proves it instead
of sampling it:

Structural checks (any mesh size)
  * every substage's device-space `partner` map is a fixed-point-free
    involution at XOR stride 2^substage — neighbour-only traffic, nobody
    paired twice or with themselves;
  * keep flags are complementary across each pair (one side keeps the low
    half, the other the high half — anything else loses or duplicates a
    chunk);
  * every on-axis ppermute `perm` is a bijection of the declared axis and
    routes exactly the partner map's stride;
  * hierarchical plans never cross pods with a pairwise exchange: every
    `NetExchange` stride stays below the inner-axis size, cross-pod strides
    appear only as `NetGatherReplay` replays over the pod axes;
  * the (stage, substage) sequence is exactly the bitonic schedule
    ``stage i: substages i..0`` — no level missing, none duplicated.

0-1 certification (meshes up to `MAX_CERT_DEVICES`)
  By the 0-1 principle a comparison network on m keys sorts every input iff
  it sorts all 2^m 0/1 patterns; and a comparison network that sorts m keys
  sorts m *sorted blocks* when each compare-exchange is replaced by a
  merge-split (Knuth 5.3.4 ex. 38 — the block lemma the engine's docstring
  has always leaned on).  `zero_one_certify` therefore simulates the
  descriptor's device-space substages over all 2^m patterns (vectorised:
  one numpy array of every pattern at once) and checks every result is
  sorted.  For m = 16 that is 65536 patterns x 10 substages — milliseconds,
  and a *proof* for every input on that mesh, not a fuzz run.

`certify_supported_meshes` sweeps every localised policy family over every
power-of-two mesh decomposition up to 16 devices — the repo-wide
certificate the CLI prints and the tests pin.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.analysis.findings import Finding, Report, Severity

#: 0-1 certification is exhaustive (2^m patterns); cap the exhaustive sweep.
MAX_CERT_DEVICES = 16


def _substage_findings(net) -> List[Finding]:
    """Structural violations of one network descriptor (empty = sound)."""
    from repro_torch.core.engine import NetExchange, NetGatherReplay
    out: List[Finding] = []
    m = net.m
    m_inner = net.sizes[-1]
    seen: List[Tuple[int, int]] = []

    def bad(op, msg):
        out.append(Finding("R6", Severity.ERROR, op, message=msg))

    for sub in net.substages():
        tag = f"stage {sub.stage} substage {sub.substage}"
        seen.append((sub.stage, sub.substage))
        p = np.asarray(sub.partner)
        k = np.asarray(sub.keep_low)
        if p.shape != (m,) or k.shape != (m,):
            bad("network", f"{tag}: partner/keep arrays sized {p.shape}/"
                           f"{k.shape}, want ({m},)")
            continue
        if np.any((p < 0) | (p >= m)) or np.any(np.sort(p) != np.arange(m)):
            bad("ppermute", f"{tag}: partner map is not a permutation of "
                            f"the {m} devices: {p.tolist()}")
            continue
        if np.any(p == np.arange(m)):
            bad("ppermute", f"{tag}: device(s) "
                            f"{np.nonzero(p == np.arange(m))[0].tolist()} "
                            f"paired with themselves")
        elif np.any(p[p] != np.arange(m)):
            bad("ppermute", f"{tag}: partner map is not an involution — "
                            f"exchanges are not pairwise")
        if np.any(p != (np.arange(m) ^ sub.stride)):
            bad("ppermute", f"{tag}: partner is not the XOR-2^{{j}} "
                            f"neighbour map at stride {sub.stride}")
        if np.any(k == k[p]):
            d = int(np.nonzero(k == k[p])[0][0])
            bad("merge_split",
                f"{tag}: keep flags not complementary — devices {d} and "
                f"{int(p[d])} both keep the "
                f"{'low' if k[d] else 'high'} half (a chunk is "
                f"{'duplicated' if k[d] else 'dropped'})")

    for lv in net.levels:
        if isinstance(lv, NetExchange):
            na = net.sizes[net.axes.index(lv.axis)]
            src = [s for s, _ in lv.perm]
            dst = [t for _, t in lv.perm]
            if sorted(src) != list(range(na)) or sorted(dst) != list(range(na)):
                bad("ppermute",
                    f"stage {lv.stage} substage {lv.substage}: perm over "
                    f"axis {lv.axis!r} is not a bijection of its {na} "
                    f"indices: {list(lv.perm)}")
            elif any(t != s ^ lv.axis_stride for s, t in lv.perm):
                bad("ppermute",
                    f"stage {lv.stage} substage {lv.substage}: perm does "
                    f"not route the declared stride {lv.axis_stride} on "
                    f"axis {lv.axis!r}")
            if net.hier and lv.stride >= m_inner:
                bad("ppermute",
                    f"stage {lv.stage} substage {lv.substage}: hierarchical "
                    f"plan crosses pods with a pairwise exchange (stride "
                    f"{lv.stride} >= inner size {m_inner}) — cross-pod "
                    f"traffic must go through the per-stage all_gather")
        elif isinstance(lv, NetGatherReplay):
            for rp in lv.replays:
                if rp.stride < m_inner:
                    bad("all_gather",
                        f"stage {rp.stage} substage {rp.substage}: replay "
                        f"at intra-pod stride {rp.stride} — intra-pod "
                        f"exchanges must be pairwise ppermutes")

    want = [(i, j) for i in range(m.bit_length() - 1)
            for j in range(i, -1, -1)]
    if seen != want:
        bad("network", f"(stage, substage) sequence {seen} is not the "
                       f"bitonic schedule {want} — the network cannot sort")
    return out


def zero_one_certify(net) -> Optional[Tuple[int, ...]]:
    """Exhaustively run all 2^m 0/1 patterns; None = sorts, else a witness.

    Simulates the device-space compare-exchange sequence (merge-split at
    chunk granularity == min/max at key granularity, by the block lemma)
    over every pattern at once.  Returns the first unsorted input pattern
    as a witness when certification fails.
    """
    m = net.m
    if m > MAX_CERT_DEVICES:
        raise ValueError(f"0-1 certification is exhaustive; {m} devices "
                         f"exceeds MAX_CERT_DEVICES={MAX_CERT_DEVICES}")
    pats = ((np.arange(1 << m)[:, None] >> np.arange(m)[None, :]) & 1
            ).astype(np.uint8)
    x = pats.copy()
    for sub in net.substages():
        p = np.asarray(sub.partner)
        keep = np.asarray(sub.keep_low)[None, :]
        other = x[:, p]
        x = np.where(keep, np.minimum(x, other), np.maximum(x, other))
    bad = np.nonzero(np.any(np.diff(x.astype(np.int8), axis=1) < 0, axis=1))[0]
    if bad.size == 0:
        return None
    return tuple(int(b) for b in pats[bad[0]])


def r6_network_certification(report: Report, policy, sizes: Sequence[int],
                             axes: Optional[Sequence[str]] = None) -> None:
    """Run R6 over one (policy, mesh-slice): structural + 0-1 certification.

    Non-localised policies have no merge-split network — recorded as a
    note, not a finding (their exchanges are whole-array gathers screened
    by R1/R2).  Meshes beyond `MAX_CERT_DEVICES` get the structural checks
    plus a note that 0-1 ran on the inductive family members instead.
    """
    from repro_torch.core.engine import exchange_network
    try:
        net = exchange_network(policy, sizes, axes)
    except ValueError as e:
        report.notes.append(f"R6 skipped: {e}")
        return
    findings = _substage_findings(net)
    for f in findings:
        report.add(f)
    if net.m > MAX_CERT_DEVICES:
        report.notes.append(
            f"R6: structural checks only on {net.m} devices (0-1 "
            f"certification is exhaustive up to {MAX_CERT_DEVICES})")
        return
    if findings:
        return                      # structure already broken; witness noise
    witness = zero_one_certify(net)
    if witness is None:
        report.notes.append(
            f"R6: 0-1 certified — network sorts all {1 << net.m} patterns "
            f"on mesh {net.sizes} ({policy.name})")
    else:
        report.add(Finding(
            "R6", Severity.ERROR, "network",
            message=f"merge-split network fails the 0-1 principle on mesh "
                    f"{net.sizes}: input pattern {witness} ends unsorted "
                    f"— the engine would silently mis-sort"))


def _mesh_shapes(max_devices: int) -> List[Tuple[Tuple[int, ...], bool]]:
    """Every supported sort-axis shape up to `max_devices`: flat sizes
    (m,) plus every 2-level (pods, inner) power-of-two decomposition."""
    shapes: List[Tuple[Tuple[int, ...], bool]] = []
    m = 2
    while m <= max_devices:
        shapes.append(((m,), False))
        pods = 2
        while pods < m:
            shapes.append(((pods, m // pods), True))
            pods *= 2
        m *= 2
    return shapes


def certify_supported_meshes(max_devices: int = MAX_CERT_DEVICES) -> Dict:
    """The repo-wide certificate: every localised policy x mesh <= cap.

    Returns ``{policy_name: {"certified": [sizes...], "failed":
    [(sizes, witness)...]}}``; an empty ``failed`` everywhere is the
    acceptance contract.  Flat policies certify on every shape (a flat
    plan routes cross-pod strides as pairwise hops); hierarchical policies
    only on multi-axis shapes (their contract requires one).
    """
    from repro_torch.core.engine import exchange_network
    from repro_torch.core.homing import Homing
    from repro_torch.core.localisation import LocalisationPolicy
    policies = {
        "flat": LocalisationPolicy(),
        "hash": LocalisationPolicy(homing=Homing.HASH_INTERLEAVED),
        "hier": LocalisationPolicy.hierarchical(),
        "hier-hash": LocalisationPolicy.hierarchical(inner="hash"),
    }
    out: Dict = {}
    for pname, policy in policies.items():
        cert: List[Tuple[int, ...]] = []
        failed: List = []
        for sizes, multi in _mesh_shapes(max_devices):
            if policy.outer is not None and not multi:
                continue
            net = exchange_network(policy, sizes)
            if _substage_findings(net):
                failed.append((sizes, "structural"))
                continue
            witness = zero_one_certify(net)
            if witness is None:
                cert.append(sizes)
            else:
                failed.append((sizes, witness))
        out[policy.name] = {"policy": pname, "certified": cert,
                            "failed": failed}
    return out
