"""Deterministic synthetic LM batches (a numpy copy of the JAX package's
``SyntheticCorpus``: the same seeds, draws and casts, so the same batches
bit for bit).

The stream is a fixed-seed Zipf-ish token process: cheap, with no I/O,
and treated exactly like a real corpus reader.  ``frames`` / ``vision``
are stub embeddings for the encdec and vlm families.  The reference's
``input_specs`` (shapes for the dry run) waits for the port's launch and
dry-run (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticCorpus:
    cfg: object                  # ArchConfig
    batch: int
    seq: int
    seed: int = 0
    dtype: object = np.float32   # embeddings dtype for stub modalities

    def __iter__(self):
        step = 0
        while True:
            yield self.make_batch(step)
            step += 1

    def make_batch(self, step: int) -> dict:
        """{"tokens", "labels"} (batch, seq) int32 numpy arrays, labels the
        tokens shifted by one (plus ``frames`` or ``vision``)."""
        cfg = self.cfg
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        V = cfg.vocab_size
        # Zipf-ish marginal so the loss has realistic structure
        ranks = rng.zipf(1.3, size=(self.batch, self.seq + 1))
        tokens_all = np.minimum(ranks, V - 1).astype(np.int32)
        out = {"tokens": tokens_all[:, :-1], "labels": tokens_all[:, 1:]}
        if cfg.family == "encdec":
            out["frames"] = rng.standard_normal(
                (self.batch, cfg.encoder_seq, cfg.d_model)).astype(self.dtype) * 0.02
        elif cfg.family == "vlm":
            out["vision"] = rng.standard_normal(
                (self.batch, cfg.vision_tokens, cfg.d_model)).astype(self.dtype) * 0.02
        return out
