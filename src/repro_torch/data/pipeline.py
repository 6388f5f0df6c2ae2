"""Synthetic LM data pipeline with *localised placement*: the counterpart
of `repro/data/pipeline.py`.

Batches are *born* locally homed through `Locale.make`: each home's rows
of a batch are generated for that home alone (Algorithm 1 steps 1-4
fused), on the mesh's device, and never relaid out afterwards.  Every
leaf of the batch (tokens, targets, frame embeddings, image embeddings)
is produced by a per-row content function -- copied from the reference,
numpy `RandomState` and all, so both packages make the same bits -- and
under ``striped=True`` (the default) each home's callback materialises
only the rows it owns.  ``striped=False`` builds every full array on the
host and then places it: the bit-exact oracle.

On a `RankMesh` (training across ranks) each rank builds only its home's
rows -- `Locale.make` over the data-parallel axes, as the reference's
`locale` homes them -- so the ranks of one home (every "model" rank of
it) build equal rows.

Determinism: batch content is a pure function of (seed, step, row), so a
restart replays exactly the same batches, which checkpoint resume relies
on.  Batches land on the card unless ``device="cpu"`` (or a mesh on the
CPU) is given.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.api import Locale
from repro_torch.core.mesh import entry_device


def _row_tokens(seed: int, step: int, row: int, seq_len: int,
                vocab: int) -> np.ndarray:
    """One deterministic 'document': a noisy arithmetic sequence (learnable)."""
    rng = np.random.RandomState((seed * 1_000_003 + step * 7919 + row)
                                % (2 ** 31 - 1))
    start = rng.randint(0, vocab)
    stride = rng.randint(1, 17)
    toks = (start + stride * np.arange(seq_len + 1)) % vocab
    noise = rng.rand(seq_len + 1) < 0.02
    toks = np.where(noise, rng.randint(0, vocab, seq_len + 1), toks)
    return toks.astype(np.int32)


def _embed_rows(toks: np.ndarray, d_model: int) -> np.ndarray:
    """Stub frontend: frame embeddings derived deterministically per row."""
    return (np.sin(toks[..., None] * (1.0 + np.arange(d_model)))
            / 8.0).astype(np.float32)


def _row_image_embeds(seed: int, step: int, row: int, n_tokens: int,
                      d_model: int) -> np.ndarray:
    """Per-row image stub -- a function of (seed, step, row) like every other
    leaf, so image batches stripe over homes exactly like token batches."""
    rng = np.random.RandomState((seed * 31 + step * 7919 + row * 104_729)
                                % (2 ** 31 - 1))
    return (rng.randn(n_tokens, d_model) / 8.0).astype(np.float32)


@dataclass
class SyntheticLM:
    cfg: ArchConfig
    global_batch: int
    seq_len: int
    seed: int = 0
    mesh: Optional[object] = None   # a HomeMesh or a RankMesh
    striped: bool = True    # per-home generation; False = host-build oracle
    device: Optional[str] = None   # without a mesh: default "cuda"

    @property
    def locale(self) -> Locale:
        """Batch rows chunk-contiguous over the data-parallel axes (every
        mesh axis but ``"model"``, outer first: a pod's rows are
        contiguous)."""
        if self.mesh is None:
            return Locale(mesh=None)
        dp = tuple(a for a in self.mesh.shape if a != "model")
        return Locale(mesh=self.mesh, axis=dp)

    def batch(self, step: int) -> dict:
        B, S, V = self.global_batch, self.seq_len, self.cfg.vocab_size
        locale = self.locale
        if not self.striped:
            return self._host_batch(step, locale)

        built = {}

        def build(rows):
            # every leaf's callback sees the same row range -- build once
            key = (rows.start, rows.stop)
            if key not in built:
                built[key] = np.stack([_row_tokens(self.seed, step, r, S, V)
                                       for r in rows])
            return built[key]

        def rows_of(index):
            return range(*index[0].indices(B))

        def make(shape, cb):
            return locale.make(shape, cb, device=self.device)

        # localised generation: each home materialises only the rows it
        # owns -- for every leaf, including the (B, S, D) embedding stripes
        batch = {"targets": make((B, S),
                                 lambda index: build(rows_of(index))[:, 1:])}
        if self.cfg.embed_input:
            batch["tokens"] = make((B, S),
                                   lambda index: build(rows_of(index))[:, :-1])
        else:
            batch["embeds"] = make(
                (B, S, self.cfg.d_model),
                lambda index: _embed_rows(build(rows_of(index))[:, :-1],
                                          self.cfg.d_model))
        if self.cfg.family == "vlm":
            T, D = self.cfg.num_image_tokens, self.cfg.d_model
            batch["image_embeds"] = make(
                (B, T, D), lambda index: np.stack(
                    [_row_image_embeds(self.seed, step, r, T, D)
                     for r in rows_of(index)]))
        return batch

    def _host_batch(self, step: int, locale: Locale) -> dict:
        """The pre-striping oracle: build every full array on the host, then
        place it.  Same per-row content functions, so `striped=True` must
        reproduce it bit-exactly."""
        B, S, V = self.global_batch, self.seq_len, self.cfg.vocab_size
        dev = entry_device(locale.mesh, self.device)

        def place(a: np.ndarray):
            return torch.from_numpy(a).to(dev)

        full = np.stack([_row_tokens(self.seed, step, r, S, V)
                         for r in range(B)])
        batch = {"targets": place(full[:, 1:])}
        if self.cfg.embed_input:
            batch["tokens"] = place(full[:, :-1])
        else:
            batch["embeds"] = place(_embed_rows(full[:, :-1],
                                                self.cfg.d_model))
        if self.cfg.family == "vlm":
            T, D = self.cfg.num_image_tokens, self.cfg.d_model
            batch["image_embeds"] = place(
                np.stack([_row_image_embeds(self.seed, step, r, T, D)
                          for r in range(B)]))
        return batch


def make_batch_iterator(cfg, global_batch, seq_len, seed=0, mesh=None,
                        start_step: int = 0, striped: bool = True,
                        device=None) -> Iterator[dict]:
    ds = SyntheticLM(cfg, global_batch, seq_len, seed, mesh, striped, device)
    step = start_step
    while True:
        yield ds.batch(step)
        step += 1
