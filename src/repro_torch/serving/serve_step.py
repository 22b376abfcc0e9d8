"""Serving steps: batched prefill and single-token decode with sampling.

Eager PyTorch on the model's device: greedy decoding takes the argmax (the
first of equal logits), temperature sampling draws from a
``torch.Generator`` on that device.
"""

from __future__ import annotations

import weakref

import torch


def make_prefill_step(model, max_seq: int, cache_dtype=torch.bfloat16):
    """prefill_step(params, batch): ``batch`` holds ``tokens`` and, for the
    encdec and vlm families, ``frames`` or ``vision``."""
    def prefill_step(params, batch):
        extras = {k: v for k, v in batch.items() if k in ("frames", "vision")}
        return model.prefill(params, batch["tokens"], extras=extras, max_seq=max_seq,
                             cache_dtype=cache_dtype)
    return prefill_step


def make_decode_step(model, temperature: float = 0.0):
    def decode_step(params, cache, tokens, rng: torch.Generator | None = None):
        logits, cache = model.decode_step(params, cache, tokens)
        last = logits[:, -1]
        if temperature > 0:
            probs = torch.softmax(last / temperature, dim=-1)
            next_tok = torch.multinomial(probs, 1, generator=rng)[:, 0]
        else:
            next_tok = torch.argmax(last, dim=-1)
        return next_tok.to(torch.int32)[:, None], cache
    return decode_step


# model -> {temperature: decode step}.  Weak keys, and steps that reach the
# model through a weak proxy: a model going out of scope releases its steps.
_DECODE_STEPS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def cached_decode_step(model, temperature: float = 0.0):
    """``make_decode_step``, one per (model, temperature): the port's
    counterpart of the JAX package's ``jitted_decode_step`` (nothing is
    compiled here, so the plain name)."""
    per_model = _DECODE_STEPS.setdefault(model, {})
    key = float(temperature)
    if key not in per_model:
        per_model[key] = make_decode_step(weakref.proxy(model), temperature)
    return per_model[key]


def generate(model, params, prompt, *, steps: int, max_seq: int,
             temperature: float = 0.0, extras=None, rng: torch.Generator | None = None,
             cache_dtype=torch.bfloat16) -> torch.Tensor:
    """Greedy/temperature generation on the model's device (the device
    ``build`` was given: None there means the CUDA card).  prompt: (B, S)
    token ids -> (B, steps) int32; the first token is the prefill's argmax.
    ``extras`` (``frames`` or ``vision``) go to the prefill.  ``rng``
    defaults to a generator on that device seeded with 0."""
    if rng is None:
        rng = torch.Generator(device=model.device).manual_seed(0)
    logits, cache = model.prefill(params, prompt, extras=extras, max_seq=max_seq,
                                  cache_dtype=cache_dtype)
    decode = cached_decode_step(model, temperature)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    out = [tok]
    for _ in range(steps - 1):
        tok, cache = decode(params, cache, tok, rng)
        out.append(tok)
    return torch.cat(out, dim=1)
