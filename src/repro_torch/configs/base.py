"""Config dataclasses + arch registry.

Every assigned architecture is a frozen `ArchConfig` built from the exact
figures in the assignment brief. `reduce_config` derives the tiny smoke-test
variant of the same family; the full configs are exercised only through the
dry-run (ShapeDtypeStruct, no allocation).

A copy of `repro/configs/base.py`: the port imports nothing of the JAX
package, and `tests/test_torch_models.py` holds the two equal.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input shape (seq_len x global_batch)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ParallelConfig:
    """Distribution knobs — the 'static mapping' side of the paper's technique.

    Everything is explicit: parameter layouts, activation layouts and the
    data-chunk ownership are all chosen statically (never left to the
    runtime), mirroring the paper's static thread->core mapping.
    """

    fsdp: bool = False              # shard params over the dp axes too (ZeRO-3 style)
    sequence_shard: bool = True     # SP: residual stream seq-sharded over model axis
    zero1: bool = False             # optimizer state sharded over dp axes
    remat: bool = True              # per-(super)block activation rematerialisation
    microbatches: int = 1           # gradient-accumulation steps inside train_step
    grad_compression: bool = False  # int8 + error-feedback DP all-reduce
    accum_via_scan_grad: bool = False  # differentiate through the microbatch
                                       # scan: one grad reduction per step
    accum_dtype: str = "float32"


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- attention details ---
    qk_norm: bool = False
    sliding_window: int = 0         # 0 = full attention
    rope_theta: float = 10000.0
    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_every: int = 1              # a MoE FFN every `moe_every` layers (others dense)
    capacity_factor: float = 1.25
    # --- SSM (mamba2 / hybrid) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_ngroups: int = 1
    attn_every: int = 0             # hybrid: 1 attention layer per attn_every layers
    # --- modality frontends (stubbed per brief) ---
    embed_input: bool = True        # False -> inputs are precomputed embeddings
    cross_attn_every: int = 0       # vlm: 1 cross-attn layer per N layers
    num_image_tokens: int = 0
    # --- numerics ---
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    # --- distribution ---
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    # --- long-context applicability (sub-quadratic attention available?) ---
    subquadratic: bool = False

    # ---------- derived ----------
    @property
    def vocab_padded(self) -> int:
        return pad_to(self.vocab_size, 256)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def attn_layers(self) -> Tuple[int, ...]:
        """Indices (within the full stack) that are attention layers."""
        if self.family == "ssm":
            return ()
        if self.attn_every:
            return tuple(i for i in range(self.num_layers) if i % self.attn_every == 0)
        return tuple(range(self.num_layers))

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ---------- parameter count (for MODEL_FLOPS = 6*N*D) ----------
    def param_counts(self) -> dict[str, float]:
        """Analytic parameter counts: total and active-per-token."""
        D, H, KV, hd, F, V = (self.d_model, self.num_heads, self.num_kv_heads,
                              self.head_dim, self.d_ff, self.vocab_padded)
        attn = D * H * hd + 2 * D * KV * hd + H * hd * D
        dense_ffn = 3 * D * F
        moe_ffn = self.num_experts * 3 * D * F
        shared_ffn = self.num_shared_experts * 3 * D * F
        active_moe = (self.top_k + self.num_shared_experts) * 3 * D * F
        if self.family == "ssm" or self.attn_every:
            di, G, N, Hs = self.d_inner, self.ssm_ngroups, self.ssm_state, self.ssm_nheads
            mamba = (2 * D * di + 2 * D * G * N + D * Hs  # in projections
                     + self.ssm_conv * (di + 2 * G * N)   # conv
                     + 2 * Hs + di                        # A, dt_bias, norm-ish
                     + di * D)                            # out proj
        else:
            mamba = 0
        total = active = 0
        for i in range(self.num_layers):
            is_attn = (i in self.attn_layers) if (self.attn_every or self.family == "ssm") else True
            if self.family == "ssm":
                total += mamba; active += mamba
                continue
            lyr = attn if is_attn else mamba
            if self.is_moe and (i % self.moe_every == self.moe_every - 1 or self.moe_every == 1):
                ffn_t, ffn_a = moe_ffn + shared_ffn, active_moe
            else:
                ffn_t = ffn_a = dense_ffn
            if self.cross_attn_every and i % self.cross_attn_every == self.cross_attn_every - 1:
                lyr += attn  # extra cross-attention block
            total += lyr + ffn_t + 2 * D
            active += lyr + ffn_a + 2 * D
        emb = V * D * (1 if not self.embed_input else 2)  # in-embed + head (untied)
        total += emb + D
        active += emb + D
        return {"total": float(total), "active": float(active)}


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        from repro_torch import configs as _c  # noqa: F401  (populates registry)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    from repro_torch import configs as _c  # noqa: F401
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# reduced (smoke-test) variants — same family/pattern, tiny sizes
# ---------------------------------------------------------------------------
def reduce_config(cfg: ArchConfig, *, layers: Optional[int] = None) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    block = max(cfg.attn_every, cfg.cross_attn_every, cfg.moe_every, 1)
    n_layers = layers if layers is not None else 2 * block
    kv = 2 if cfg.num_kv_heads > 1 else 1
    return cfg.replace(
        num_layers=n_layers,
        d_model=64,
        num_heads=4,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=0 if cfg.family == "ssm" else 128,
        vocab_size=503,  # deliberately not a multiple of 256 -> exercises padding
        num_experts=4 if cfg.num_experts else 0,
        num_shared_experts=min(cfg.num_shared_experts, 1),
        top_k=min(cfg.top_k, 2),
        # no-drop capacity: GShard capacity dropping is not causal, so parity
        # tests (decode == forward) need C == group size. Dropping semantics
        # are covered separately in test_moe.py.
        capacity_factor=2.0 if cfg.num_experts else 1.25,
        sliding_window=16 if cfg.sliding_window else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_headdim=16 if cfg.ssm_state else 64,
        num_image_tokens=24 if cfg.num_image_tokens else 0,
        dtype="float32",
        param_dtype="float32",
        parallel=ParallelConfig(fsdp=False, sequence_shard=False, remat=False),
    )
