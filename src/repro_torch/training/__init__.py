"""repro_torch.training: the loss's optimizer, the train step, data,
gradient compression and checkpoints (plain and erasure-coded), on the
port's nested dicts of tensors.

``make_train_step(model, AdamW(...))`` takes ``model.loss`` through
``torch.autograd.grad``, clips by the global norm and applies AdamW in
place.  Coded checkpoints and ``coded_aggregate`` encode with the paper's
(P, S)-sparse code and decode with the hybrid peeling/rooting decoder on
the job's device: the CUDA card unless the caller asks for the CPU.
"""

from repro_torch.training.compress import coded_aggregate
from repro_torch.training.optimizer import AdamW, cosine_warmup_schedule
from repro_torch.training.train_step import make_eval_step, make_train_step

__all__ = ["AdamW", "coded_aggregate", "cosine_warmup_schedule", "make_eval_step",
           "make_train_step"]
