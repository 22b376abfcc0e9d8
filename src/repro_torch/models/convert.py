"""Carry a model's weights across from plain arrays.

The JAX package's parameter tree -- ``embed``, ``final_norm``, ``head``
(untied only), ``groups/slot{s}/{norm1, norm2, mixer, ffn}`` (``cross``
and ``norm_x`` too in an encoder-decoder), each slot leaf stacked over
``num_groups``, and an encoder-decoder's ``encoder`` (stacked over its
layers) and ``enc_final_norm`` -- is the port's own layout
(``models.registry``), whatever the mixers (attention, mamba, rwkv and
its channel mix), so the carry is a name-for-name copy, checked leaf by
leaf against the model's parameter defs.  Only plain arrays cross:
nothing of the JAX package is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import ParamDef


def _carry(defs: dict, tree: dict, path: str, device) -> dict:
    if not isinstance(tree, dict) or set(tree) != set(defs):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"params{path}: keys {got} != {sorted(defs)}")
    out = {}
    for name, d in defs.items():
        where = f"{path}/{name}"
        if not isinstance(d, ParamDef):
            out[name] = _carry(d, tree[name], where, device)
            continue
        a = np.asarray(tree[name])
        if a.shape != d.shape:
            raise ValueError(f"params{where}: shape {a.shape} != {d.shape}")
        if not np.issubdtype(a.dtype, np.floating):
            raise ValueError(f"params{where}: dtype {a.dtype} is not a float")
        # a copy: the array may be read-only
        out[name] = torch.from_numpy(np.array(a)).to(device)
    return out


def params_from_numpy(model, tree: dict) -> dict:
    """The port's parameters for ``model`` from the JAX package's tree as
    numpy arrays, on the model's device, each leaf in its array's dtype.
    A missing or extra leaf, or a shape that differs from the model's,
    raises."""
    return _carry(model.param_defs(), tree, "", model.device)
