"""Live master/worker run on PyTorch with real threads, real sparse matmuls
and an injected straggler -- the paper's experimental protocol in
miniature (Section V: workers Isend results, master Waitany's until
decodable), plus the chunked sub-task protocol: with ``num_chunks`` > 1 a
straggler's *finished* chunks are harvested as decode equations instead of
being discarded with the unfinished task.

  PYTHONPATH=src python examples/straggler_sim_torch.py [--device cpu]

The counterpart of ``examples/straggler_sim.py``: the workers' products run
on ``--device``, the CUDA card by default (raising where there is none),
or ``cpu``.
"""

import argparse

import numpy as np
import scipy.sparse as sp

from repro_torch.coded import get_scheme
from repro_torch.core.blocks import resolve_device
from repro_torch.core.encoder import split_blocks
from repro_torch.runtime import run_live_job


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)
    m = n = 3
    s, r, t = 6000, 3000, 3000
    A = sp.random(s, r, density=0.005, format="csc",
                  random_state=np.random.RandomState(2))
    B = sp.random(s, t, density=0.005, format="csc",
                  random_state=np.random.RandomState(3))
    A_blocks, B_blocks = split_blocks(A, m), split_blocks(B, n)

    for name, code, num_chunks in [
        ("sparse_code", get_scheme("sparse_code").instance(m, n, 18, seed=0), 1),
        ("sparse q=3", get_scheme("sparse_code").instance(m, n, 18, seed=0), 3),
        ("uncoded", get_scheme("uncoded").instance(m, n), 1),
    ]:
        # worker 0 sleeps 30s -- with the sparse code the master never waits
        # (chunked: the sleep spreads over the chunks, and any chunk worker 0
        # does finish becomes a usable equation); the uncoded run must wait
        # (we cap the demo by making it 1.5s there)
        sleep = {0: 30.0 if name != "uncoded" else 1.5}
        rep = run_live_job(code, A_blocks, B_blocks, n, straggler_sleep=sleep,
                           num_chunks=num_chunks, device=device)
        chunks = (f" ({rep.chunks_used} chunks)" if num_chunks > 1 else "")
        print(f"{name:12s} waited {rep.workers_used}/{rep.num_workers} workers"
              f"{chunks}, "
              f"compute {rep.sim_compute_time:.3f}s decode {rep.decode_wall_time:.3f}s "
              f"total {rep.total_time:.3f}s")

    C = (A.T @ B).toarray()
    print(f"(direct product nnz: {np.count_nonzero(C)})")
    print("straggler never blocked the coded run: OK")


if __name__ == "__main__":
    main()
