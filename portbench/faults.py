"""Faults planted under the timed path, for the tests that show a broken
program, or the control in its place, reads as not correct.
``planted(name)`` patches this process for the length of a ``with`` block;
no benchmark run names a fault.

* ``drop_half``: each launch leaves out half of its output rows, the
  rows it owns but never writes;
* ``alter_answer``: one element of each launch's output is moved by 1% of
  that output's largest magnitude, where it is produced;
* ``control``: ``CodedOp.apply`` returns the control's product
  (``reference.control_product``: A^T B at TF32 precision) in place of
  the program's.
"""

from __future__ import annotations

import contextlib

FAULTS = ("drop_half", "alter_answer", "control")


@contextlib.contextmanager
def planted(name: str | None):
    if name is None:
        yield
        return
    if name not in FAULTS:
        raise ValueError(f"fault {name!r} not in {FAULTS}")
    if name == "control":
        from portbench import reference
        from repro_torch.coded.op import CodedOp

        owner, attr = CodedOp, "apply"

        def broken(self, A, B, **kwargs):
            return reference.control_product(A, B)
    else:
        from repro_torch.kernels import ops

        owner, attr = ops, "spmm_block_fused_decode"
        launch = ops.spmm_block_fused_decode

        def broken(*args, **kwargs):
            out = launch(*args, **kwargs)
            if name == "drop_half":
                out[:, out.shape[1] // 2:] = 0.0
            else:
                out[0, 0, 0] += 0.01 * float(out.abs().max())
            return out
    sound = getattr(owner, attr)
    setattr(owner, attr, broken)
    try:
        yield
    finally:
        setattr(owner, attr, sound)
