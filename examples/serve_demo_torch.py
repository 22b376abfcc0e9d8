"""Serving smoke on PyTorch: two tenants, real subprocess workers, one SIGKILLed.

The port's serving gate.  A small MoE model serves a two-tenant Poisson
trace through ``repro_torch.serving.ServingEngine`` with the shared pool
backed by ``repro_torch.runtime.procpool.MuxProcPool`` -- real OS
subprocesses -- and a chaos plan that SIGKILLs worker 1 after its first
delivered chunk.  The coded expert jobs keep decoding from the surviving
workers, so the demo asserts: every request completes, every per-token
expert product is exact (the engine verifies each decoded job against the
host product and fails the request otherwise), the kill is in the fault
ledger, and at least one straggler recovery was recorded.

  PYTHONPATH=src python examples/serve_demo_torch.py [--device cpu]

The counterpart of ``examples/serve_demo.py``: the model, the pool's
workers and the decode run on ``--device``, the CUDA card by default
(raising where there is none), or ``cpu``.
"""

import argparse

from repro_torch.configs import ARCH_REGISTRY
from repro_torch.core.blocks import resolve_device
from repro_torch.runtime.chaos import kill
from repro_torch.runtime.procpool import MuxProcPool
from repro_torch.serving import SLO, TenantSpec, poisson_trace
from repro_torch.serving.engine import ServingEngine

NUM_WORKERS = 6


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)
    cfg = ARCH_REGISTRY["qwen3-moe-30b-a3b"].reduced()
    tenants = [
        TenantSpec("interactive", rate=25.0, prompt_len=6, max_new_tokens=2,
                   slo=SLO(ttft=120.0, per_token=60.0)),
        TenantSpec("batch", rate=12.0, prompt_len=10, max_new_tokens=3,
                   slo=SLO(ttft=240.0, per_token=120.0)),
    ]
    reqs = poisson_trace(tenants, horizon=0.2, seed=5, max_requests=6)
    assert len({r.tenant for r in reqs}) == 2, "want both tenants in the trace"

    pool = MuxProcPool(NUM_WORKERS, plan=[kill(1, after_chunk=0)],
                       timeout=60.0, device=device)
    eng = ServingEngine(cfg, coded=True, num_workers=NUM_WORKERS,
                        source=pool, n_blocks=4, num_chunks=2, max_batch=3,
                        device=device)
    assert eng.device == pool.device == device, (eng.device, pool.device, device)
    with eng:
        eng.warmup(sorted({r.prompt_len for r in reqs}))
        metrics = eng.run(reqs)

    s = metrics.summary()
    print(f"served {s['requests']} requests from {sorted(s['by_tenant'])} on "
          f"{device}: {s['completed']} completed, {s['tokens']} tokens, "
          f"{s['straggler_recoveries']} straggler recoveries")
    kinds = sorted({e["kind"] for e in pool.ledger.entries})
    print("fault ledger kinds:", kinds)

    # every request completed with exact decode despite the killed worker
    assert s["completed"] == s["requests"] == len(reqs), [
        (r.rid, r.error) for r in metrics.requests]
    assert all(r.error is None for r in metrics.requests)
    assert "kill" in kinds, kinds
    assert s["straggler_recoveries"] >= 1, s
    assert s["slo_attainment"] == 1.0, s
    print("OK: all requests completed exactly over a pool with a real "
          "SIGKILLed worker")


if __name__ == "__main__":  # worker processes re-import this file
    main()
