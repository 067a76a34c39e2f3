"""Converters from the reference package's objects, given as numpy arrays,
to this package's tensors — so both packages compute the same function on
the same weights in the parity tests.

Nothing here imports the reference package: a param tree is any nested
dict/list of array-likes (``jax.tree_util.tree_map(np.asarray, params)``
gives one), and a packed weight is any object with the ``PackedWeight``
attributes (``blocks``, ``header``, ``counts``, ``col_perm``, ``shape``,
``block_size``); a quantized one also has ``scales`` and ``granularity``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.packing import PackedWeight
from repro_torch.core.quant import QuantizedPackedWeight
from repro_torch.models.attention import KVCache


def params_from_jax(np_tree, device: "str | torch.device" = "cpu"):
    """Nested dict/list of arrays -> the same structure of torch tensors
    on ``device`` (dtypes kept)."""
    if isinstance(np_tree, dict):
        return {k: params_from_jax(v, device) for k, v in np_tree.items()}
    if isinstance(np_tree, (list, tuple)):
        return type(np_tree)(params_from_jax(v, device) for v in np_tree)
    return torch.as_tensor(np.array(np_tree), device=device)


def scores_from_jax(np_scores: Dict, device: "str | torch.device" = "cpu"
                    ) -> Dict[str, torch.Tensor]:
    """A reference scores dict ({path: array}) -> {path: tensor on
    ``device``} (dtypes kept)."""
    return {path: torch.as_tensor(np.array(s), device=device)
            for path, s in np_scores.items()}


def _layer(tree, i: int):
    """Layer ``i`` of a tree whose leaves are stacked on a leading axis."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def lm_params_from_jax(np_tree, device: "str | torch.device" = "cpu"
                       ) -> Dict:
    """A reference dense-LM param tree, whose ``layers`` are stacked arrays
    (``[L, ...]``), -> this package's layout: ``layers`` as a list of
    per-layer dicts, every leaf a torch tensor on ``device``."""
    tree = dict(np_tree)
    stacked = tree.pop("layers")
    n = len(np.asarray(stacked["ln1"]))
    out = params_from_jax(tree, device)
    out["layers"] = [params_from_jax(_layer(stacked, i), device)
                     for i in range(n)]
    return out


def lm_scores_from_jax(np_scores: Dict,
                       device: "str | torch.device" = "cpu"
                       ) -> Dict[str, torch.Tensor]:
    """A reference dense-LM scores dict, whose layer scores are stacked
    (``layers/attn/wq`` [L, m, n], ``layers/mlp/wi`` [L, n]), -> this
    package's: one entry per layer (``layers/{i}/attn/wq``) on ``device``;
    other paths as they are."""
    out = {}
    for path, s in np_scores.items():
        s = np.asarray(s)
        head, _, rest = path.partition("/")
        if head != "layers":
            out[path] = torch.as_tensor(np.array(s), device=device)
            continue
        for i in range(s.shape[0]):
            out[f"layers/{i}/{rest}"] = torch.as_tensor(np.array(s[i]),
                                                        device=device)
    return out


def kv_caches_from_jax(cache, device: "str | torch.device" = "cpu"
                       ) -> List[KVCache]:
    """A reference stacked ``KVCache`` (leaves ``[L, B, ...]``) -> one
    ``KVCache`` per layer on ``device`` (dtypes kept; bf16 arrays pass
    through fp32, which holds them exactly)."""
    def t(a, i):
        a = np.asarray(a)[i]
        if a.dtype.name == "bfloat16":
            return torch.as_tensor(a.astype(np.float32),
                                   device=device).to(torch.bfloat16)
        return torch.as_tensor(np.array(a), device=device)
    n = np.asarray(cache.length).shape[0]
    return [KVCache(*(t(a, i) for a in (cache.k, cache.v, cache.length,
                                        cache.attn_mass)))
            for i in range(n)]


def packed_from_jax(pw, device: "str | torch.device" = "cpu") -> PackedWeight:
    """A reference ``PackedWeight`` -> this package's, on ``device``
    (blocks keep their dtype: fp16 blocks stay fp16)."""
    return PackedWeight(
        blocks=torch.as_tensor(np.array(pw.blocks), device=device),
        header=torch.as_tensor(np.array(pw.header, np.int32), device=device),
        counts=torch.as_tensor(np.array(pw.counts, np.int32), device=device),
        col_perm=np.asarray(pw.col_perm),
        shape=tuple(int(s) for s in pw.shape),
        block_size=int(pw.block_size),
    )


def quantized_from_jax(qpw, device: "str | torch.device" = "cpu"
                       ) -> QuantizedPackedWeight:
    """A reference ``QuantizedPackedWeight`` -> this package's, on
    ``device`` (int8 blocks and fp32 scales as they are)."""
    return QuantizedPackedWeight(
        blocks=torch.as_tensor(np.array(qpw.blocks, np.int8), device=device),
        scales=torch.as_tensor(np.array(qpw.scales, np.float32),
                               device=device),
        header=torch.as_tensor(np.array(qpw.header, np.int32), device=device),
        counts=torch.as_tensor(np.array(qpw.counts, np.int32), device=device),
        col_perm=np.asarray(qpw.col_perm),
        shape=tuple(int(s) for s in qpw.shape),
        block_size=int(qpw.block_size),
        granularity=str(qpw.granularity))


def packed_dict_from_jax(packed: Dict, device: "str | torch.device" = "cpu"
                         ) -> Dict[str, object]:
    """A reference ``pack_model`` dict, at any precision, -> this
    package's: a weight with ``scales`` converts to a
    :class:`QuantizedPackedWeight`, any other to a :class:`PackedWeight`."""
    return {path: (quantized_from_jax(pw, device) if hasattr(pw, "scales")
                   else packed_from_jax(pw, device))
            for path, pw in packed.items()}
