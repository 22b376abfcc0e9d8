"""The device mesh as it is meant to run: nccl, one card a rank, four cards.

    python3 chip_mesh.py  # on a host with four cards

With fewer than 4 CUDA cards it exits 2 before it starts a rank.  It prints
each card's ``nvidia-smi --query-gpu=name,power.limit`` line, then one JSON
line a part, each checked:

1. ``bandwidth``: ``all_reduce`` and ``all_gather_into_tensor`` over the 4
   cards at 256 MiB and 1 GiB (f32): the median of 5 timed calls after one
   warm-up, as algorithm and bus bandwidth (nccl-tests' definitions:
   all_reduce moves 2 (n-1)/n of its bytes over each link, all_gather
   (n-1)/n of its output).
2. ``lm``: internlm2-1.8b at full width and depth on {data 2, model 2},
   batch 4 x 512 (the train phase's cell), 5 steps: each rank's step
   times, tokens/s and peak memory; step 0's loss against the one-process
   step on card 0 (within 1e-5 relative).
3. ``restart``: the CLI at full width, depth cut to 1 layer (the
   checkpoints' size): 4 cards fail at step 8, ``--elastic`` resumes on 2
   cards ({data 1, model 2}) from step 5; the losses against an
   uninterrupted one-process run (within 2e-4; 4 decimals printed).
4. ``moe``: qwen3-moe-30b-a3b at full width, 4 of 48 layers (the serving
   phase's depth), batch 2 x 256, in the MoE forms of chip_smoke.py's
   ``mesh`` phase, each timed and held as there.

The last line is ``{"ok": true, ...}``.  The rank-side measurements are
``chip_smoke``'s (``mesh_lm``, ``mesh_forms``).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
CARDS = 4
MESH = {"data": 2, "model": 2}
TIMEOUT_S = 600.0
BW_SIZES = (256 << 20, 1 << 30)
BW_REPEATS = 5
LM_ARCH, LM_BATCH, LM_SEQ, LM_STEPS = "internlm2-1.8b", 4, 512, 5
MOE_ARCH, MOE_LAYERS, MOE_BATCH, MOE_SEQ = "qwen3-moe-30b-a3b", 4, 2, 256
RESTART_CLI = ["--arch", "internlm2-1.8b", "--layers", "1", "--steps", "12", "--batch", "2",
               "--seq", "256", "--ckpt-every", "5", "--opt-dtype", "bfloat16"]
RESTART_FAIL, RESTART_ATOL = 8, 2e-4


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_mesh: FAILED: {what}")


def _smi() -> list[str]:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()


def _bandwidth_rank(dev: torch.device, dmesh) -> dict:
    """Each collective's median seconds at each size on the world group."""
    import torch.distributed as dist

    n = dist.get_world_size()
    out = {}
    for size in BW_SIZES:
        for op in ("all_reduce", "all_gather_into_tensor"):
            if op == "all_reduce":
                buf = torch.ones(size // 4, device=dev)

                def call():
                    dist.all_reduce(buf)
            else:
                src = torch.ones(size // 4 // n, device=dev)
                buf = torch.empty(size // 4, device=dev)

                def call():
                    dist.all_gather_into_tensor(buf, src)
            times = []
            for i in range(1 + BW_REPEATS):
                dist.barrier()
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize(dev)
                if i:
                    times.append(time.perf_counter() - t0)
            t = statistics.median(times)
            factor = 2 * (n - 1) / n if op == "all_reduce" else (n - 1) / n
            out[f"{op}/{size >> 20}MiB"] = {"bytes": size, "median_s": t,
                                            "algbw_GBps": size / t / 1e9,
                                            "busbw_GBps": size / t / 1e9 * factor}
            del buf
    return out


def _lm_rank(dev: torch.device, dmesh) -> dict:
    import repro_torch.configs as configs
    from chip_smoke import mesh_lm

    return mesh_lm(dev, dmesh, configs.get(LM_ARCH), LM_BATCH, LM_SEQ, LM_STEPS, grads=False)


def _moe_rank(dev: torch.device, dmesh) -> dict:
    import repro_torch.configs as configs
    from chip_smoke import SEED, mesh_forms
    from repro_torch.models import build
    from repro_torch.training.data import SyntheticCorpus

    cfg = dataclasses.replace(configs.get(MOE_ARCH), num_layers=MOE_LAYERS)
    model = build(cfg, dev)
    batch = SyntheticCorpus(cfg, MOE_BATCH, MOE_SEQ, seed=SEED).make_batch(0)
    return mesh_forms(dev, dmesh, lambda opts: build(cfg.with_opts(opts), dev),
                      model.init(SEED), model.specs(), batch)


def _cli(ckpt: str, *extra: str) -> tuple[int, str, float]:
    from chip_smoke import _train_cli

    return _train_cli(torch.device("cuda"), ckpt, *extra, base=RESTART_CLI, timeout=TIMEOUT_S)


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < CARDS:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"chip_mesh: needs {CARDS} CUDA cards, found {n}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from chip_smoke import _cli_losses, emit
    from repro_torch.runtime.procpool import stop_fork_server
    from repro_torch.runtime.workergroup import spawn_group

    smi = _smi()
    for line in smi:
        print(line, flush=True)
    seconds = {}

    def group(fn, mesh=MESH):
        t0 = time.perf_counter()
        out = spawn_group(fn, CARDS, backend="nccl", timeout=TIMEOUT_S, mesh=mesh)
        seconds[fn.__name__] = time.perf_counter() - t0
        return out

    bw = group(_bandwidth_rank)
    emit(part="bandwidth", cards=CARDS, backend="nccl", repeats=BW_REPEATS, nvidia_smi=smi,
         rank0=bw[0], slowest_rank_s={k: max(r[k]["median_s"] for r in bw) for k in bw[0]})

    lm = group(_lm_rank)
    check(lm[0]["loss_rel_err"] <= 1e-5, f"lm: step-0 loss {lm[0]['loss']} vs one process "
                                         f"{lm[0]['one_process_loss']}")
    emit(part="lm", arch=LM_ARCH, mesh=MESH, batch=LM_BATCH, seq=LM_SEQ, steps=LM_STEPS,
         nvidia_smi=smi, loss=lm[0]["loss"], one_process_loss=lm[0]["one_process_loss"],
         loss_rel_err=lm[0]["loss_rel_err"], losses=lm[0]["losses"],
         by_rank=[{k: r[k] for k in ("step_s", "tokens_per_s", "max_memory_allocated",
                                     "first_value_and_grad_s")} for r in lm])

    with tempfile.TemporaryDirectory(prefix="mesh_restart_") as tmp:
        rc1, out1, s1 = _cli(tmp, "--nproc", "4", "--simulate-failure", str(RESTART_FAIL))
        check(rc1 == 17 and "[train] mesh {'data': 2, 'model': 2}" in out1,
              f"restart: the failing run exited {rc1}: {out1[-3000:]}")
        rc2, out2, s2 = _cli(tmp, "--nproc", "2", "--elastic", "--model-parallel", "2")
        check(rc2 == 0 and "[train] mesh {'data': 1, 'model': 2}" in out2
              and "resumed from step 5" in out2, f"restart: resume exited {rc2}: {out2[-3000:]}")
    with tempfile.TemporaryDirectory(prefix="mesh_one_") as tmp:
        rc3, out3, s3 = _cli(tmp, "--ckpt-every", "0")
    got, want = {**_cli_losses(out1), **_cli_losses(out2)}, _cli_losses(out3)
    check(rc3 == 0 and sorted(got) == sorted(want) == [0, 10, 11]
          and all(abs(got[s] - want[s]) <= RESTART_ATOL for s in got),
          f"restart: losses {got} vs one process {want}")
    emit(part="restart", args=RESTART_CLI, fail_at=RESTART_FAIL, losses=got,
         one_process_losses=want, atol=RESTART_ATOL, seconds=[s1, s2, s3])

    moe = group(_moe_rank)
    for form, row in moe[0].items():
        check(row["loss_rel_err"] <= row["rtol"] and row["grad_rel_err"] <= row["grad_rtol"],
              f"moe {form}: {row}")
    emit(part="moe", arch=MOE_ARCH, layers=MOE_LAYERS, batch=MOE_BATCH, seq=MOE_SEQ,
         mesh=MESH, forms=moe[0], fwd_bwd_ms_by_rank={
             form: [r[form]["fwd_bwd_ms"] for r in moe] for form in moe[0]})
    stop_fork_server()
    emit(part="seconds", **seconds)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
