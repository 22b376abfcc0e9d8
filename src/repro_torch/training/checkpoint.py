"""Checkpoints: plain and versioned, and erasure-coded across storage
targets with the paper's code.

* Plain: per-step ``params.npz`` / ``opt_state.npz`` (one ``arr_i`` a leaf
  in ``tree_leaves`` order), then an atomic flip of ``manifest.json``;
  an async saver; resume from the latest step.
* Coded: the parameters, flattened to f32, are cut into mn chunks and
  written as N > mn coded chunks ``c_k = sum_ij w^k_ij chunk_ij`` to
  distinct targets with the (P, S)-sparse code; any full-rank subset of
  the targets restores them through the hybrid peeling/rooting decoder.
  The encode and the decode run on the job's device.  The port's targets
  hold float64 sums (``compress.encode_chunks``), so a restore gives the
  f32 values back; the reference's hold f32 sums, which cost up to about
  1e-3 of the largest value at mn = 16, and restore here just as well.

The files and manifests are the JAX package's own, so a checkpoint either
package writes restores in the other.  A bf16 leaf is stored as numpy
stores the JAX stack's bfloat16 arrays: their 16-bit words under the
header ``descr '<V2'``, which plain numpy reads back as ``|V2`` words.
The port reads those words into ``torch.bfloat16`` and writes its own
bf16 leaves the same way, so an npz it writes is the reference's byte for
byte.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import os
import pathlib
import threading
import time
import zipfile

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from repro_torch.core.blocks import resolve_device
from repro_torch.core.decoder import hybrid_decode
from repro_torch.core.encoder import SparseCodeSpec, generate_coefficient_matrix
from repro_torch.training.compress import encode_chunks
from repro_torch.training.tree import tree_leaves, tree_map, tree_unflatten

#: the npy header ``descr`` numpy writes for the JAX stack's bfloat16 arrays
BF16_DESCR = "<V2"


# ----------------------------- plain checkpoints -----------------------------

def _savez(path: pathlib.Path, leaves: list) -> None:
    """``np.savez(path, *leaves)`` for tensors: the same stored zip of
    ``arr_i.npy`` members, a bf16 leaf as its words under ``BF16_DESCR``."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i, t in enumerate(leaves):
            t = t.detach().cpu().contiguous()
            with zf.open(f"arr_{i}.npy", "w", force_zip64=True) as fid:
                if t.dtype == torch.bfloat16:
                    np.lib.format.write_array_header_1_0(fid, {
                        "descr": BF16_DESCR, "fortran_order": False,
                        "shape": tuple(t.shape)})
                    fid.write(t.view(torch.int16).numpy().tobytes())
                else:
                    np.lib.format.write_array(fid, t.numpy(), allow_pickle=False)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """A loaded leaf as a tensor on ``device``; 2-byte void words are bf16."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _loadz(path: pathlib.Path, template) -> dict:
    """The npz's ``arr_i`` as a tree like ``template``, each leaf on the
    device of the template's leaf at its place."""
    with np.load(path) as z:
        arrays = [z[f"arr_{i}"] for i in range(len(z.files))]
    where = tree_leaves(template)
    if len(arrays) != len(where):
        raise ValueError(f"{path} holds {len(arrays)} leaves, the template {len(where)}")
    return tree_unflatten(template, [_tensor(a, t.device) for a, t in zip(arrays, where)])


def save_checkpoint(directory, step: int, params: dict, opt_state: dict | None = None,
                    extra: dict | None = None) -> pathlib.Path:
    """Atomic versioned save: write the step's directory, then flip the
    manifest."""
    directory = pathlib.Path(directory)
    step_dir = directory / f"step_{step:08d}"
    step_dir.mkdir(parents=True, exist_ok=True)
    _savez(step_dir / "params.npz", tree_leaves(params))
    if opt_state is not None:
        _savez(step_dir / "opt_state.npz", tree_leaves(opt_state))
    manifest = {"step": step, "time": time.time(), "extra": extra or {},
                "has_opt": opt_state is not None}
    tmp = directory / "manifest.json.tmp"
    tmp.write_text(json.dumps(manifest))
    tmp.replace(directory / "manifest.json")   # atomic flip
    return step_dir


def latest_step(directory) -> int | None:
    manifest = pathlib.Path(directory) / "manifest.json"
    if not manifest.exists():
        return None
    return json.loads(manifest.read_text())["step"]


def restore_checkpoint(directory, params_template: dict, opt_template: dict | None = None,
                       step: int | None = None):
    """(params[, opt_state], step) from ``step`` (None: the latest), each
    leaf in the dtype it was saved in, on its template leaf's device."""
    directory = pathlib.Path(directory)
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    step_dir = directory / f"step_{step:08d}"
    out = (_loadz(step_dir / "params.npz", params_template),)
    if opt_template is not None:
        out += (_loadz(step_dir / "opt_state.npz", opt_template),)
    return out + (step,)


class AsyncCheckpointer:
    """Saves on a background thread (training never blocks on storage);
    ``wait()`` before exit."""

    def __init__(self, directory):
        self.directory = pathlib.Path(directory)
        self._thread: threading.Thread | None = None

    def save(self, step: int, params: dict, opt_state: dict | None = None, extra=None):
        def snap(tree):  # a host copy on the caller's thread: the step updates in place
            return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)

        params = snap(params)
        opt_state = snap(opt_state) if opt_state else None
        self.wait()
        self._thread = threading.Thread(
            target=save_checkpoint,
            args=(self.directory, step, params, opt_state, extra), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


# --------------------------- coded redundancy --------------------------------

def _each_in_threads(fn, items) -> list:
    """[fn(x) for x in items] on a thread a core: each target is its own
    file, and zlib releases the interpreter lock while it (de)compresses."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        return list(pool.map(fn, items))


def save_coded_checkpoint(directory, step: int, params: dict, *, m: int = 4, n: int = 4,
                          num_targets: int = 24, seed: int = 0,
                          distribution: str = "wave_soliton", device=None) -> dict:
    """Erasure-code the parameters across ``num_targets`` storage targets,
    one coded chunk a file; any full-rank subset of the targets restores
    them.  The encode runs on ``device`` (None: the CUDA card, raising
    where there is none).  Returns the manifest (also written to disk)."""
    device = resolve_device(device)
    directory = pathlib.Path(directory)
    cdir = directory / f"coded_{step:08d}"
    cdir.mkdir(parents=True, exist_ok=True)
    leaves = tree_leaves(params)
    flat = torch.cat([t.detach().reshape(-1).to(device, torch.float32) for t in leaves])
    d = m * n
    pad = (-flat.numel()) % d
    chunks = F.pad(flat, (0, pad)).reshape(d, -1)

    spec = SparseCodeSpec(m=m, n=n, num_workers=num_targets,
                          distribution=distribution, seed=seed)
    M = generate_coefficient_matrix(spec)
    coded = [c.cpu().numpy() for c in encode_chunks(chunks, M)]

    def write(k):
        np.savez_compressed(cdir / f"target_{k:03d}.npz", coded=coded[k])

    _each_in_threads(write, range(num_targets))
    manifest = {
        "step": step, "m": m, "n": n, "num_targets": num_targets,
        "pad": int(pad), "total": int(chunks.numel()),
        "M_rows": M.toarray().tolist(),
        "leaf_shapes": [list(t.shape) for t in leaves],
        "leaf_dtypes": [str(t.dtype).removeprefix("torch.") for t in leaves],
    }
    (cdir / "coded_manifest.json").write_text(json.dumps(manifest))
    return manifest


def restore_coded_checkpoint(directory, step: int, params_template: dict,
                             available: list[int] | None = None, device=None):
    """Restore from any decodable subset of the targets.

    available: indices of the surviving target files (None: all on disk).
    The decode runs in float64 on ``device`` (None: the CUDA card, raising
    where there is none); each leaf comes back in its manifest dtype there.
    Returns (params, decode stats).  Raises ``DecodingError`` if the
    surviving coefficient rows lose full rank."""
    device = resolve_device(device)
    cdir = pathlib.Path(directory) / f"coded_{step:08d}"
    manifest = json.loads((cdir / "coded_manifest.json").read_text())
    M_full = np.asarray(manifest["M_rows"])
    if available is None:
        available = [int(p.stem.split("_")[1]) for p in sorted(cdir.glob("target_*.npz"))]
    rows = sorted(available)

    def read(k):
        with np.load(cdir / f"target_{k:03d}.npz") as z:
            return z["coded"]

    results = [torch.from_numpy(a).to(device, torch.float64)
               for a in _each_in_threads(read, rows)]
    blocks, stats = hybrid_decode(sp.csr_matrix(M_full[rows]), results)
    flat = torch.cat(blocks)
    if manifest["pad"]:
        flat = flat[: -manifest["pad"]]
    out, off = [], 0
    for shape, dtype in zip(manifest["leaf_shapes"], manifest["leaf_dtypes"]):
        size = math.prod(shape)
        out.append(flat[off:off + size].reshape(shape).to(getattr(torch, dtype)))
        off += size
    return tree_unflatten(params_template, out), stats
