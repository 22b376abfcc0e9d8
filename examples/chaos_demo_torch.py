"""Chaos smoke on PyTorch: kill a real worker process mid-chunk, decode anyway.

Workers are OS subprocesses (``repro_torch.runtime.procpool``), each
computing on ``--device``; the fault plan SIGKILLs worker 1 the moment its
first chunk reaches the master, so the rest of its ordered sub-task stream
genuinely never arrives (pipe EOF, exit code -9).  The master detects the
crash, keeps consuming the survivors' chunks, decodes from the prefixes
that made it, and accounts the fault in the report's ledger -- which this
demo asserts, making it the port's chaos gate.

  PYTHONPATH=src python examples/chaos_demo_torch.py [--device cpu]

The counterpart of ``examples/chaos_demo.py``; ``--device`` is the CUDA
card by default (raising where there is none), or ``cpu``.
"""

import argparse

import numpy as np
import scipy.sparse as sp
import torch

from repro_torch.core import schemes
from repro_torch.core.blocks import resolve_device
from repro_torch.core.encoder import split_blocks
from repro_torch.runtime import run_proc_job
from repro_torch.runtime.chaos import kill


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)
    m = n = 2
    A = sp.random(40, 16, density=0.3, format="csc",
                  random_state=np.random.RandomState(0))
    B = sp.random(40, 20, density=0.3, format="csc",
                  random_state=np.random.RandomState(1))
    code = schemes.sparse_code(m, n, N=8, seed=4)

    rep = run_proc_job(
        code, split_blocks(A, m), split_blocks(B, n), n,
        num_chunks=4,
        straggler_sleep={w: 0.4 for w in range(code.num_workers)},
        plan=[kill(1, after_chunk=0)],  # SIGKILL mid-stream, for real
        timeout=30.0, device=device)

    print(rep.summary())
    for entry in rep.fault_ledger:
        print("  ", entry)

    # the decoded product must be exact despite the crash
    C = (A.T @ B).toarray()
    br, bt = C.shape[0] // m, C.shape[1] // n
    for i in range(m):
        for j in range(n):
            got = rep.blocks[i * n + j]
            got = (got.to_dense() if got.layout == torch.sparse_csr else got).cpu().numpy()
            np.testing.assert_allclose(
                got, C[i * br:(i + 1) * br, j * bt:(j + 1) * bt], atol=1e-8)

    # and the ledger must actually name the fault it recovered from
    kinds = {e["kind"] for e in rep.fault_ledger}
    assert "kill" in kinds and "crash_detected" in kinds, kinds
    assert 1 in {e["worker"] for e in rep.fault_ledger}
    crash = next(e for e in rep.fault_ledger if e["kind"] == "crash_detected")
    assert crash["exitcode"] == -9, crash
    print("killed worker 1 mid-chunk; decoded from survivors: OK")


if __name__ == "__main__":  # worker processes re-import this file
    main()
