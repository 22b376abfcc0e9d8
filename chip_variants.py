"""Time the design choices of the ``coded_accum`` kernel on one NVIDIA card.

    python3 chip_variants.py

Builds ``src/repro_torch/kernels/csrc/coded_accum.cu`` as it is and in
variants that each undo one choice of its design, runs every build at the
main path's width (s = 16384, r = t = 8192, m = n = 2, one worker with 4
live slots, f32, seed 0), and prints one JSON line per run, in turns
(each variant, then each again in reverse order):

* ``kernel``       -- the source as it is;
* ``cvt_split``    -- the TF32 split by ``cvt.rna.tf32.f32`` (big and small)
                      in place of the integer rounding;
* ``one_pass``     -- one TF32 MMA a step (1xTF32): the cost of one pass,
                      and the error the kernel's three passes avoid;
* ``no_promotion`` -- the MMA sum over all of s, never promoted into the
                      round-to-nearest total.

Each line has the time (CUDA events, median of 5 after a warm-up), the
error against the plain version (``kernels.ref``, f32) and against an f64
product, and the tolerance ``chip_smoke.py`` holds the kernel to.  Then the
kernel itself with bf16 x bf16 and f32 x bf16 operands (one and two MMAs a
step), and the cuBLAS f32 yardstick of ``chip_smoke.py`` (the port's
``_local_dense_scan``).  It exits nonzero where no CUDA device is present or
a build fails.  Only ``kernel`` is ever used by the port.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent

_CVT_BIG = "big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"
_CVT_SMALL = "small = __float_as_uint(x - __uint_as_float(big));"
#: variant -> the edits of the source that make it
VARIANTS = {
    "kernel": [],
    "cvt_split": [
        (_CVT_BIG, 'asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));'),
        (_CVT_SMALL, 'asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) '
                     ': "f"(x - __uint_as_float(big)));')],
    "one_pass": [
        ("constexpr bool A_SPLIT = sizeof(TA) == 4;", "constexpr bool A_SPLIT = false;"),
        ("constexpr bool B_SPLIT = sizeof(TB) == 4;", "constexpr bool B_SPLIT = false;")],
    "no_promotion": [
        ("constexpr int PROMOTE = 4;", "constexpr int PROMOTE = 1 << 30;")],
}
S, R, T, M, N = 16384, 8192, 8192, 2, 2
COLS, WEIGHTS = [0, 1, 2, 3], [0.5, -1.25, 2.0, 0.75]


def build_variant(name: str) -> tuple[str, pathlib.Path, list[str]]:
    from repro_torch.kernels import build

    text = (build.CSRC / "coded_accum.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise SystemExit(f"chip_variants: {name}: source has no {old!r}")
        text = text.replace(old, new)
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(text)
    lib = out / f"libcoded_accum_{name}.so"
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           str(out / f"{name}.cu")], capture_output=True, text=True,
                          timeout=900)
    if proc.returncode:
        raise SystemExit(f"chip_variants: nvcc failed on {name}:\n{proc.stderr}")
    log = proc.stdout + proc.stderr
    return name, lib, sorted({ln.split(":", 1)[1].strip() for ln in log.splitlines()
                              if "Used" in ln and "registers" in ln}
                             | {f"{x} bytes spilled" for x in
                                re.findall(r"(\d+) bytes spill stores", log)})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device; this runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core.coded_matmul import _local_dense_scan
    from repro_torch.kernels import build, ref

    info = cs.phase_device()
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(build_variant, VARIANTS))

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn(S, R, device=dev, generator=gen)
    B = torch.randn(S, T, device=dev, generator=gen)
    cols = torch.tensor(COLS, dtype=torch.int32, device=dev)
    wts = torch.tensor(WEIGHTS, dtype=torch.float32, device=dev)
    br, bt = R // M, T // N
    plain = ref.coded_accum_ref(A, B, cols, wts, M, N)
    exact = torch.zeros((br, bt), dtype=torch.float64, device=dev)
    for c, w in zip(COLS, WEIGHTS):
        i, j = divmod(c, N)
        exact += w * (A[:, i * br:(i + 1) * br].double().T
                      @ B[:, j * bt:(j + 1) * bt].double())
    tol = cs.sum_tol(S * len(COLS), float(plain.abs().max()))
    flops = len(COLS) * 2 * S * br * bt

    def launcher(lib: pathlib.Path, Ax: torch.Tensor, Bx: torch.Tensor):
        fn = ctypes.CDLL(str(lib)).coded_accum
        fn.argtypes = build.SIGNATURES["coded_accum"]["coded_accum"]
        fn.restype = ctypes.c_int
        codes = {torch.float32: 0, torch.bfloat16: 1}

        def run():
            out = torch.empty((br, bt), dtype=torch.float32, device=dev)
            err = fn(Ax.data_ptr(), codes[Ax.dtype], Bx.data_ptr(), codes[Bx.dtype],
                     cols.data_ptr(), wts.data_ptr(), out.data_ptr(), S, R, T, br, bt,
                     N, len(COLS), 1, torch.cuda.current_stream().cuda_stream)
            cs.check(err == 0, f"launch failed: cudaError_t {err}")
            return out
        return run

    for name, lib, ptxas in built + built[::-1]:
        run = launcher(lib, A, B)
        got = run()
        torch.cuda.synchronize()
        ms = cs.time_ms(run)
        cs.emit(variant=name, operands="f32 x f32", ms=ms, tflops=flops / ms / 1e9,
                err_vs_plain=float((got - plain).abs().max()),
                err_vs_f64=float((got.double() - exact).abs().max()),
                plain_err_vs_f64=float((plain.double() - exact).abs().max()),
                tol=tol, ptxas=ptxas)
    kernel_lib = built[0][1]
    for Ax, Bx, what in ((A.bfloat16(), B.bfloat16(), "bf16 x bf16"),
                         (A, B.bfloat16(), "f32 x bf16")):
        ms = cs.time_ms(launcher(kernel_lib, Ax, Bx))
        cs.emit(variant="kernel", operands=what, ms=ms, tflops=flops / ms / 1e9)
    lib_ms = cs.time_ms(lambda: _local_dense_scan(A, B, cols.cpu().numpy(),
                                                   wts.cpu().numpy(), M, N))
    cs.emit(library="the port's _local_dense_scan: 4 torch.matmul calls, TF32 off",
            library_ms=lib_ms, device=info["nvidia_smi"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
