"""The paper's own experiment configuration (Section V): sparse Bernoulli
matrices, m = n = 4, N = 16+ workers -- used by benchmarks and examples,
not an LM architecture."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class SparseCodeExperiment:
    r: int = 150_000
    s: int = 150_000
    t: int = 150_000
    nnz_a: int = 600_000
    nnz_b: int = 600_000
    m: int = 4
    n: int = 4
    num_workers: int = 16
    num_stragglers: int = 2
    distribution: str = "wave_soliton"


PAPER_SQUARE = SparseCodeExperiment()
PAPER_TALL = SparseCodeExperiment(r=300_000, s=150_000, t=3_000_000)
PAPER_FAT = SparseCodeExperiment(r=150_000, s=300_000, t=150_000)

# CPU-budget variants used by the default benchmark run (same density
# regime, dimensions scaled so a full sweep finishes in seconds).
BENCH_SQUARE = SparseCodeExperiment(r=6000, s=6000, t=6000, nnz_a=24_000, nnz_b=24_000)
BENCH_TALL = SparseCodeExperiment(r=12_000, s=6000, t=24_000, nnz_a=24_000, nnz_b=24_000)
BENCH_FAT = SparseCodeExperiment(r=6000, s=12_000, t=6000, nnz_a=24_000, nnz_b=24_000)
