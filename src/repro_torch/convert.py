"""Converters from the reference package's objects, given as numpy arrays,
to this package's tensors — so both packages compute the same function on
the same weights in the parity tests.

Nothing here imports the reference package: a param tree is any nested
dict/list of array-likes (``jax.tree_util.tree_map(np.asarray, params)``
gives one), and a packed weight is any object with the ``PackedWeight``
attributes (``blocks``, ``header``, ``counts``, ``col_perm``, ``shape``,
``block_size``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.packing import PackedWeight


def params_from_jax(np_tree, device: "str | torch.device" = "cpu"):
    """Nested dict/list of arrays -> the same structure of torch tensors
    on ``device`` (dtypes kept)."""
    if isinstance(np_tree, dict):
        return {k: params_from_jax(v, device) for k, v in np_tree.items()}
    if isinstance(np_tree, (list, tuple)):
        return type(np_tree)(params_from_jax(v, device) for v in np_tree)
    return torch.as_tensor(np.array(np_tree), device=device)


def packed_from_jax(pw, device: "str | torch.device" = "cpu") -> PackedWeight:
    """A reference ``PackedWeight`` -> this package's, on ``device``."""
    return PackedWeight(
        blocks=torch.as_tensor(np.array(pw.blocks), device=device),
        header=torch.as_tensor(np.array(pw.header, np.int32), device=device),
        counts=torch.as_tensor(np.array(pw.counts, np.int32), device=device),
        col_perm=np.asarray(pw.col_perm),
        shape=tuple(int(s) for s in pw.shape),
        block_size=int(pw.block_size),
    )


def packed_dict_from_jax(packed: Dict, device: "str | torch.device" = "cpu"
                         ) -> Dict[str, PackedWeight]:
    return {path: packed_from_jax(pw, device) for path, pw in packed.items()}
