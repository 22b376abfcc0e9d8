"""Quickstart on PyTorch: the port's coded-matmul API end to end.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The counterpart of ``examples/quickstart.py``.  One scheme registry entry
drives BOTH execution paths from the same code design
(``repro_torch.coded``):

1. pick the paper's (P, S)-sparse code by name -- ``get_scheme("sparse_code")``;
2. host path: ``scheme.instance(...)`` -> master/worker protocol with two
   declared stragglers, hybrid peeling + rooting decode (Algorithm 1), on
   torch blocks on the device;
3. device path: ``plan(config, ...)`` -> a ``CodedOp`` bound to the device,
   applied, then rebound to survivors with ``with_survivors``;
4. checks both against the direct product.

``--device`` is the CUDA card by default (raising where there is none), or
``cpu``.
"""

import argparse

import numpy as np
import scipy.sparse as sp
import torch

from repro_torch.coded import CodedMatmulConfig, get_scheme, plan, scheme_names
from repro_torch.core.blocks import blocks_to_device, hold_a_blocks, resolve_device
from repro_torch.core.encoder import encode_blocks, make_tasks, split_blocks


def _dense(block) -> np.ndarray:
    block = block.to_dense() if block.layout == torch.sparse_csr else block
    return block.cpu().numpy()


def host_path(device):
    """The paper's protocol: code across 12 workers, never wait for two.
    Returns the code and the decoded blocks (torch, on ``device``)."""
    m, n, N = 2, 3, 12
    s, r, t = 4000, 1800, 2400
    A = sp.random(s, r, density=0.01, format="csc",
                  random_state=np.random.RandomState(0))
    B = sp.random(s, t, density=0.01, format="csc",
                  random_state=np.random.RandomState(1))
    print(f"A: {A.shape} nnz={A.nnz}   B: {B.shape} nnz={B.nnz}")

    scheme = get_scheme("sparse_code")     # any name in scheme_names()
    code = scheme.instance(m, n, N, seed=0, distribution="wave_soliton")
    print(f"scheme {code.name}: avg degree {code.M.nnz / N:.2f} "
          f"(Theta(ln mn) -- the paper's overhead)")

    A_blocks = hold_a_blocks(split_blocks(A, m), device)
    B_blocks = blocks_to_device(split_blocks(B, n), device)
    results = [encode_blocks(t_, A_blocks, B_blocks, n)
               for t_ in make_tasks(code.M)]

    stragglers = {3, 7}
    finished = [k for k in range(N) if k not in stragglers]
    print(f"workers {sorted(stragglers)} are stragglers -> decoding from "
          f"{len(finished)} results")
    blocks = code.decode(finished, dict(enumerate(results)))

    C = (A.T @ B).toarray()
    br, bt = r // m, t // n
    err = max(
        abs(_dense(blocks[i * n + j]) - C[i*br:(i+1)*br, j*bt:(j+1)*bt]).max()
        for i in range(m) for j in range(n)
    )
    print(f"host path max abs error vs direct product: {err:.2e}")
    assert err < 1e-8
    return code, blocks


def device_path(device):
    """The same design as a device op: plan -> bind -> apply (-> rebind)."""
    from repro_torch.core.coded_matmul import uncoded_matmul_reference

    cfg = CodedMatmulConfig(scheme="sparse_code", backend="dense_scan")
    op = plan(cfg, m=2, n=2, num_workers=8, seed=5).bind(device)
    print(f"device path: {op}")

    rng = np.random.default_rng(0)
    s, r, t = 64, 16, 24
    A = torch.as_tensor(rng.standard_normal((s, r)), dtype=torch.float32, device=op.device)
    B = torch.as_tensor(rng.standard_normal((s, t)), dtype=torch.float32, device=op.device)
    C_ref = uncoded_matmul_reference(A, B).cpu().numpy()

    C = op(A, B).cpu().numpy()
    err = np.abs(C - C_ref).max()
    print(f"all-alive max abs error: {err:.2e}")
    assert err < 1e-2

    # kill a worker whose loss keeps the code decodable, rebind, re-apply
    M = op.plan_.coefficient_matrix()
    for kill in range(op.num_workers):
        surv = np.ones(op.num_workers, dtype=bool)
        surv[kill] = False
        if np.linalg.matrix_rank(M * surv[:, None]) >= 4:
            break
    C2 = op.with_survivors(surv)(A, B).cpu().numpy()
    err2 = np.abs(C2 - C_ref).max()
    print(f"killed worker {kill}: max abs error {err2:.2e} "
          "(decoded from survivors, no recompute)")
    assert err2 < 1e-2


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)
    print(f"registered schemes: {', '.join(scheme_names())}")
    host_path(device)
    device_path(device)
    print("OK")


if __name__ == "__main__":
    main()
