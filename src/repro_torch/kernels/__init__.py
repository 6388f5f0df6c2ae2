"""Hand-written CUDA kernels of the port, each beside its plain version.

Every wrapper dispatches on where its tensor lies: a CPU tensor goes to
the plain PyTorch version, a CUDA tensor to the kernel (built from
``repro_torch/csrc`` at first use, see `_build`), and anything else raises.
Each wrapper counts its kernel launches in a plain integer attribute
(``launches``); `ops.reset_launches` / `ops.launch_counts` read them all.
Each kernel module also states the launches it makes for a shape as data
(``plan``, `repro_torch.analysis.launches`), hands them to an open
`launches.record()` on either device, and on the card reads the same list
from its C entry's dry run (``c_plan``) and runs a poisoned-output call for
the coverage probe (``probe``).
"""

# Dynamic shared memory one block may use on an H100 (227 KB of the SM's
# 256 KB).  Takes the place of the reference's VMEM_BYTES_PER_CORE: every
# kernel bounds its tiles against it (`local_sort`'s tile pass uses 64 KB,
# its merge blocks 33 KB).
SMEM_BYTES_PER_BLOCK = 232_448

# Device memory of one H100 SXM.
HBM_BYTES_PER_DEVICE = 80 * 10**9


def _device(x, what: str) -> str:
    """'cpu' or 'cuda' for a wrapper's dispatch; any other device raises."""
    kind = x.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{what}: tensors on {kind!r} are not supported; "
                         f"use a CPU tensor (plain version) or a CUDA tensor "
                         f"(kernel)")
    return kind
