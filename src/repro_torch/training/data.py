"""Deterministic synthetic LM batches (a numpy copy of the JAX package's
``SyntheticCorpus``: the same seeds, draws and casts, so the same batches
bit for bit).

The stream is a fixed-seed Zipf-ish token process: cheap, with no I/O,
and treated exactly like a real corpus reader.  ``frames`` / ``vision``
are stub embeddings for the encdec and vlm families.  ``input_specs``
gives the dry run the same inputs as meta tensors (shapes and dtypes, no
storage).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


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


def input_specs(cfg, batch: int, seq: int, dtype="bfloat16", kind: str = "train") -> dict:
    """Meta tensors for every model input (the dry run's stand-ins).

    kind: train -> tokens + labels (+ modality); prefill -> tokens (+
    modality); decode -> one token (the cache comes from
    ``Model.init_cache``).  ``dtype`` (a name or a torch dtype) is the stub
    embeddings'."""
    emb = getattr(torch, dtype) if isinstance(dtype, str) else dtype

    def meta(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")

    if kind == "train":
        out = {"tokens": meta((batch, seq), torch.int32),
               "labels": meta((batch, seq), torch.int32)}
    elif kind == "prefill":
        out = {"tokens": meta((batch, seq), torch.int32)}
    elif kind == "decode":
        out = {"tokens": meta((batch, 1), torch.int32)}
    else:
        raise ValueError(kind)
    if kind != "decode":
        if cfg.family == "encdec":
            out["frames"] = meta((batch, cfg.encoder_seq, cfg.d_model), emb)
        elif cfg.family == "vlm":
            out["vision"] = meta((batch, cfg.vision_tokens, cfg.d_model), emb)
    return out
