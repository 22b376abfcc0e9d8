"""The one generator of every traffic mix: a mix file's parameters in, the
failure pattern of each apply out.

A mix (``traffic/<mix>.json``) says how many workers are dead in each
apply (``dead_per_apply``).  With none dead every apply is the same (the
steady mix).  Otherwise the seed deals the workers into dead sets of that
size, one for each apply of a cycle, so that a cycle loses every worker
once; a deal whose sets the configuration's code cannot all decode from
their survivors is dealt again.  So the seed moves which workers die
together and in what order, and every cycle of every run does the same
work: every worker's launch, each worker dead in one apply.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

TRAFFIC_DIR = pathlib.Path(__file__).resolve().parent / "traffic"
#: deals tried before a mix is refused as one the code cannot decode
DEALS = 1000


def load_mix(name: str) -> dict:
    path = TRAFFIC_DIR / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r}: {path} is missing")
    return json.loads(path.read_text())


def decodable(coefficients: np.ndarray, alive: np.ndarray) -> bool:
    """Whether the alive workers' rows of the code still have full column
    rank (the code decodes from them)."""
    return int(np.linalg.matrix_rank(coefficients[alive])) == coefficients.shape[1]


def cycle(mix: dict, coefficients, seed: int) -> list[tuple[int, ...]]:
    """The dead set of each apply of a cycle, in order: [()] where every
    worker is alive."""
    M = np.asarray(coefficients, dtype=np.float64)
    N = M.shape[0]
    k = int(mix["dead_per_apply"])
    if k == 0:
        return [()]
    if not 0 < k <= N:
        raise ValueError(f"dead_per_apply {k} outside (0, {N}]")
    rng = np.random.default_rng([int(seed), 1])
    for _ in range(DEALS):
        order = rng.permutation(N)
        deal = [tuple(sorted(int(w) for w in order[i:i + k]))
                for i in range(0, N - N % k, k)]
        if all(decodable(M, survivors(dead, N)) for dead in deal):
            return deal
    raise ValueError(f"no deal of {N} workers into dead sets of {k} that the code decodes")


def survivors(dead: tuple[int, ...], workers: int) -> np.ndarray | None:
    """The survivor mask of a dead set (None where every worker is alive)."""
    if not dead:
        return None
    mask = np.ones(workers, dtype=bool)
    mask[list(dead)] = False
    return mask
