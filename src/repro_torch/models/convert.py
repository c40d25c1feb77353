"""Weights of the JAX package's models in the port's layout.

``params_from_jax`` takes the parameter tree of
``repro.models.transformer.Model.init`` with every leaf already a numpy
array (the caller runs ``np.asarray`` over it, so this module imports no
JAX) and returns a state dict for ``repro_torch.models.transformer.
Model.load_state_dict``. The two share the tree's names and layouts:
``blocks.l{i}`` leaves stay stacked over periods, so the conversion is a
flattening of the nested dict into dotted names.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["params_from_jax"]


def params_from_jax(tree: Mapping, prefix: str = "") -> Dict[str,
                                                             torch.Tensor]:
    """Nested dict of numpy arrays → ``{"blocks.l0.mix.wq": tensor, …}``
    (CPU tensors of the arrays' dtypes; bfloat16 arrays, which numpy
    holds as the ``ml_dtypes`` type, arrive as torch bfloat16)."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(params_from_jax(val, f"{name}."))
            continue
        arr = np.asarray(val)
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                 .copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr).copy())
        out[name] = t
    return out
