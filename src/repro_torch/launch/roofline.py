"""Roofline analysis from the dry run's meta records (single-pod mesh).

    python -m repro_torch.launch.roofline [--arch A] [--shape S] [--opt a,b]

The step runs on meta tensors at 1 and 2 layer groups (encoder depths
likewise for enc-dec; the cross entropy in 2 chunks: the dry run's probe
mode, ``run_cell(..., probes=True)``) and the totals are extrapolated:

    total(G) = probe(1) + (G - 1) * [probe(2) - probe(1)]

which is exact for the FLOPs because every group is structurally
identical.  The counter sees the products of the sequence scans' steps
(the port runs them as Python loops), but not their elementwise state
updates, which are added analytically as the JAX package adds them; the
Mamba read-out's einsum (2 of the 6 * d_inner * d_state FLOPs a token the
analytic term counts) is therefore counted twice.

Terms (per training or serving step, priced on the NVIDIA H100 SXM data
sheet, ``launch.mesh``):
    compute_s    = counted FLOPs per device / 989e12 (dense bf16)
    memory_s     = analytic HBM bytes per device / 3.35e12
    collective_s = collective bytes per device / 450e9 (NVLink 4, one
                   direction), the bytes the JAX package's formula takes
                   of the dry run's record (``collective_bytes``): each
                   kind's output bytes, an all-reduce's twice (a ring
                   moves about twice its payload)
and ``dominant`` is the largest of the three.

The kernel-level functions (``machine_peaks``, ``fused_kernel_cost``,
``roofline_fraction``) price one coded local product as the JAX package
prices it.  ``fused_kernel_cost`` counts the gathered B once per live
slot, which is what a kernel without reuse reads; the port's SpMM kernel
reads each B tile once per 16 column blocks, so the fraction it gives can
read above 1 there (PERF.md section 6).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import torch

from repro_torch.configs import ARCHS, get
from repro_torch.core.blocks import resolve_device
from repro_torch.launch.dryrun import SHAPES, _leaves, cell_supported, run_cell
from repro_torch.launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16
from repro_torch.models.registry import build

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / "torch" / "roofline"


# ------------------------- kernel-level roofline -----------------------------

def machine_peaks(calibrate: bool | None = None, *, reps: int = 5, device=None) -> dict:
    """{"peak_flops", "peak_bw", "source"} of ``device``.

    ``calibrate=None`` takes the data sheet on an H100 (the target, as the
    TPU was the JAX package's) and measures anywhere else; ``False`` always
    takes the data sheet (without touching a device), ``True`` always
    measures: a 1024^2 f32 product (TF32 off) for FLOP/s and a 32 MB
    ``a + 1`` stream (read and write) for bytes/s, best of ``reps``, timed
    with CUDA events on a card and the host clock on the CPU.  On an H100
    that stream fits its 50 MB L2, so the measured bytes/s need not be an
    HBM rate.  ``device`` None is the CUDA card, raising where there is
    none; ``"cpu"`` measures the host.
    """
    sheet = {"peak_flops": PEAK_FLOPS_BF16, "peak_bw": HBM_BW,
             "source": "datasheet-h100-sxm"}
    if calibrate is False:
        return sheet
    dev = resolve_device(device)
    if calibrate is None:
        calibrate = not (dev.type == "cuda" and "H100" in torch.cuda.get_device_name(dev))
    if not calibrate:
        return sheet

    def best_time(fn, x) -> float:
        fn(x)
        ts = []
        for _ in range(reps):
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize(dev)
                start.record()
                fn(x)
                stop.record()
                stop.synchronize()
                ts.append(start.elapsed_time(stop) / 1e3)
            else:
                t0 = time.perf_counter()
                fn(x)
                ts.append(time.perf_counter() - t0)
        return min(ts)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        n = 1024
        x = torch.ones((n, n), dtype=torch.float32, device=dev)
        peak_flops = 2.0 * n ** 3 / best_time(lambda a: a @ a, x)
        big = torch.ones((32 * 1024 * 1024 // 4,), dtype=torch.float32, device=dev)
        peak_bw = 2.0 * big.numel() * 4 / best_time(lambda a: a + 1.0, big)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    clock = "CUDA events" if dev.type == "cuda" else "host clock"
    return {"peak_flops": float(peak_flops), "peak_bw": float(peak_bw),
            "source": f"calibrated on {dev.type} ({clock})"}


def fused_kernel_cost(*, live_tiles: int, bs: int, bt: int, mn: int, br: int,
                      fused: bool, tile_itemsize: int = 4) -> dict:
    """{"flops", "bytes"} of one worker's coded local product + decode.

    The useful work is identical for both paths (same tiles, same decode
    combine); the unfused path additionally round-trips the (br, bt)
    accumulation C~ through HBM between its two launches.
    ``tile_itemsize`` prices quantized packs (4 f32, 2 bf16, 1 int8); B and
    the outputs are always f32.
    """
    flops = 2.0 * live_tiles * bs * bs * bt     # tile^T @ B-tile MACs
    flops += live_tiles * bs * bt               # per-slot weight scale
    flops += mn * br * bt                       # decode combine multiplies
    bytes_ = live_tiles * bs * bs * tile_itemsize   # packed tiles of A
    bytes_ += live_tiles * bs * bt * 4              # gathered B tiles
    bytes_ += mn * br * bt * 4                      # decode-stack write
    if not fused:
        bytes_ += 2.0 * br * bt * 4             # C~ HBM round-trip
    return {"flops": float(flops), "bytes": float(bytes_)}


def roofline_fraction(cost: dict, measured_s: float, peaks: dict) -> float:
    """Achieved fraction of the roofline for the given cost: ideal =
    max(compute-bound, memory-bound) time; fraction = ideal / measured."""
    ideal = max(cost["flops"] / peaks["peak_flops"],
                cost["bytes"] / peaks["peak_bw"])
    return float(ideal / max(measured_s, 1e-12))


# ------------------------- model-level roofline ------------------------------

def _n_params(cfg) -> int:
    return sum(t.numel() for t in _leaves(build(cfg, "meta").shapes()))


def analytic_memory_bytes(cfg, shape: str, chips: int = 256,
                          dp: int = 16, tp: int = 16) -> float:
    """Per-device HBM traffic model, the JAX package's.

    train  : AdamW state machine (24 B/param local) + C1 passes over local
             activations (fwd+bwd+remat) + attention score traffic.
    prefill: param reads + C2 activation passes + KV-cache writes.
    decode : params read once per token step + full KV-cache read.
    """
    info = SHAPES[shape]
    n_params = _n_params(cfg)
    d = cfg.d_model
    L = cfg.num_layers

    if info["kind"] == "train":
        toks_local = info["batch"] * info["seq"] // dp
        param_traffic = 24.0 * n_params / chips
        # ~40 passes of (tokens_local x d) per layer cover fwd+bwd+remat
        act = 40.0 * toks_local * d * 2.0 * L
        # attention scores fwd+bwd+remat (causal ~ S^2/2), sharded dp x tp
        if not cfg.rwkv and cfg.attn_every >= 1:
            attn_layers = sum(1 for mx, _ in cfg.layer_plan()
                              if mx in ("attn", "cross", "self_cross")) * cfg.num_groups
            act += 3.0 * info["batch"] * cfg.num_heads * info["seq"] ** 2 * 2.0 \
                * attn_layers / (2.0 * chips)
        return param_traffic + act
    if info["kind"] == "prefill":
        toks_local = info["batch"] * info["seq"] // dp
        act = 14.0 * toks_local * d * 2.0 * L
        attn_layers = sum(1 for mx, _ in cfg.layer_plan()
                          if mx in ("attn", "cross", "self_cross")) * cfg.num_groups
        if not cfg.rwkv:
            act += info["batch"] * cfg.num_heads * info["seq"] ** 2 * 2.0 \
                * attn_layers / (2.0 * chips)
        return 2.0 * n_params / chips + act
    # decode: one token against the cache
    cache_bytes = 0.0
    attn_layers = sum(1 for mx, _ in cfg.layer_plan()
                      if mx in ("attn", "self_cross")) * cfg.num_groups
    cache_bytes += (2.0 * info["batch"] * info["seq"] * cfg.num_kv_heads
                    * cfg.hd * 2.0 * attn_layers) / chips
    frac_active = cfg.active_params_count() / max(cfg.params_count(), 1)
    return 2.0 * n_params * min(frac_active, 1.0) / chips + cache_bytes


def _recurrence_flops(cfg, tokens: int) -> float:
    """Analytic per-step state-update flops inside the sequence scans."""
    per_tok_layer = 0.0
    if cfg.rwkv:
        hs = cfg.rwkv_head_size
        H = cfg.d_model // hs
        per_tok_layer += 6.0 * H * hs * hs
    if cfg.ssm is not None:
        di = cfg.ssm.expand * cfg.d_model
        frac = sum(1 for mx, _ in cfg.layer_plan() if mx == "mamba") / cfg.group_size
        per_tok_layer += 6.0 * di * cfg.ssm.d_state * frac
    return per_tok_layer * cfg.num_layers * tokens


def collective_bytes(collectives: dict) -> float:
    """A device's collective bytes of a dry-run record's ``collectives``,
    the JAX package's way: all-gather + reduce-scatter + all-to-all +
    collective-permute + 2 x all-reduce."""
    b = collectives["bytes"]
    return float(b["all-gather"] + b["reduce-scatter"] + b["all-to-all"]
                 + b["collective-permute"] + 2 * b["all-reduce"])


def analyze_cell(arch: str, shape: str, *, chips: int = 256,
                 cfg_override=None, force: bool = False,
                 opts: tuple = ()) -> dict:
    cfg = cfg_override or get(arch)
    if opts:
        cfg = cfg.with_opts(opts)
    ok, why = cell_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "status": "skipped", "reason": why}

    info = SHAPES[shape]
    tokens = info["batch"] * (info["seq"] if info["kind"] == "train" else
                              (info["seq"] if info["kind"] == "prefill" else 1))

    t0 = time.perf_counter()
    # probes: 1 and 2 layer groups (and the encoder's marginal layer), the
    # cross entropy in 2 big chunks: ``run_cell``'s probe mode
    ce = None
    if info["kind"] == "train":
        ce = (info["batch"] * info["seq"]) // 2
    rec = run_cell(arch, shape, multi_pod=False, cfg_override=cfg, ce_chunk=ce, probes=True)
    if rec["status"] != "ok":
        return {"arch": arch, "shape": shape, "status": "error",
                "error": rec.get("error", "probe failed")}
    total = {"flops": rec["cost_analysis"]["flops_per_device"], "bytes": None,
             "coll_bytes": collective_bytes(rec["collectives"])}

    # hidden recurrence flops (the scans' elementwise state updates)
    seq_tokens = info["batch"] * (info["seq"] if info["kind"] != "decode" else 1)
    total["flops"] += _recurrence_flops(cfg, seq_tokens) / chips

    mem_model = analytic_memory_bytes(cfg, shape, chips=chips)
    compute_s = total["flops"] / PEAK_FLOPS_BF16
    memory_s = mem_model / HBM_BW
    coll_s = total["coll_bytes"] / ICI_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": coll_s}
    dominant = max(terms, key=terms.get)

    # MODEL_FLOPS: 6*N_active*D train, 2*N_active*D inference
    n_total = _n_params(cfg)
    frac_active = cfg.active_params_count() / max(cfg.params_count(), 1)
    n_active = n_total * min(frac_active, 1.0)
    mult = 6.0 if info["kind"] == "train" else 2.0
    model_flops = mult * n_active * tokens
    counted_total = total["flops"] * chips
    ratio = model_flops / max(counted_total, 1.0)

    # step time bound & roofline fraction
    step_bound = max(terms.values())
    mfu_bound = (model_flops / chips / PEAK_FLOPS_BF16) / max(step_bound, 1e-12)

    return {
        "arch": arch, "shape": shape, "status": "ok", "chips": chips,
        "tokens_per_step": tokens,
        "per_device": total,
        "terms": terms,
        "memory_s_hlo_raw": None,
        "dominant": dominant,
        "model_flops": model_flops,
        "hlo_flops_total": counted_total,
        "useful_ratio": ratio,
        "roofline_fraction_bound": mfu_bound,
        "n_params": n_total,
        "n_active": n_active,
        "meta_s": round(time.perf_counter() - t0, 2),
    }


def _ms(x) -> str:
    return "—" if x is None else f"{x * 1e3:.2f}ms"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all", choices=["all"] + list(SHAPES))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--opt", default="",
                    help="comma list: fused_ce,moe_local_dispatch,onehot_cache"
                         " (writes <arch>__<shape>__<opts>.json)")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)
    opts = tuple(o for o in args.opt.split(",") if o)

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    archs = sorted(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    suffix = ("__" + "+".join(opts)) if opts else ""
    for arch in archs:
        for shape in shapes:
            path = outdir / f"{arch}__{shape}{suffix}.json"
            if path.exists() and not args.force:
                print(f"[roofline] {arch}/{shape}{suffix}: cached")
                continue
            try:
                rec = analyze_cell(arch, shape, opts=opts)
                rec["opts"] = list(opts)
            except Exception as e:  # noqa: BLE001 -- report and continue
                rec = {"arch": arch, "shape": shape, "status": "error",
                       "error": f"{type(e).__name__}: {e}"}
            path.write_text(json.dumps(rec, indent=1))
            if rec["status"] == "ok":
                t = rec["terms"]
                print(f"[roofline] {arch}/{shape}: compute={_ms(t['compute_s'])} "
                      f"memory={_ms(t['memory_s'])} coll={_ms(t['collective_s'])} "
                      f"dom={rec['dominant']} useful={rec['useful_ratio']:.2f} "
                      f"roofline<={rec['roofline_fraction_bound']:.2%} "
                      f"meta={rec['meta_s']}s", flush=True)
            else:
                print(f"[roofline] {arch}/{shape}: {rec['status']} "
                      f"{rec.get('error', rec.get('reason', ''))[:120]}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
