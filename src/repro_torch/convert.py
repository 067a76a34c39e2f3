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
from repro_torch.models.ssm import MambaState, RWKVState


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


def _count(stacked) -> int:
    """The leading-axis length of a tree of stacked arrays."""
    while isinstance(stacked, dict):
        stacked = next(iter(stacked.values()))
    return len(np.asarray(stacked))


def _unstack(stacked, device) -> List:
    """A tree whose leaves are stacked on a leading axis -> a list of
    per-entry trees of tensors on ``device``."""
    return [params_from_jax(_layer(stacked, i), device)
            for i in range(_count(stacked))]


def lm_params_from_jax(np_tree, device: "str | torch.device" = "cpu"
                       ) -> Dict:
    """A reference LM param tree, whose stacked layers are arrays with a
    leading layer axis, -> this package's layout, every leaf a torch
    tensor on ``device``: ``layers`` (dense, MoE, SSM, the audio
    family's decoder) and ``enc_layers`` (its encoder) as lists of
    per-layer dicts; the hybrid's ``stages`` ([n_stages, period, ...]) as
    a list of stages, each a list of layer dicts, and its ``tail`` as a
    list; ``shared_attn`` as it is; the VLM's ``stages`` (``{"self":
    [n_stages, n_self, ...], "cross": [n_stages, ...]}``) as ``{"self": a
    list of stages, each a list of layer dicts, "cross": a list of layer
    dicts}``."""
    tree = dict(np_tree)
    stacked = {k: tree.pop(k) for k in ("layers", "stages", "tail",
                                        "enc_layers") if k in tree}
    out = params_from_jax(tree, device)
    for key in ("layers", "tail", "enc_layers"):
        if key in stacked:
            out[key] = _unstack(stacked[key], device)
    stages = stacked.get("stages")
    if stages is None:
        return out

    def nested(st):
        return [_unstack(_layer(st, i), device) for i in range(_count(st))]
    if set(stages) == {"self", "cross"}:
        out["stages"] = {"self": nested(stages["self"]),
                         "cross": _unstack(stages["cross"], device)}
    else:
        out["stages"] = nested(stages)
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


def _tensor(a, device) -> torch.Tensor:
    """An array as a tensor on ``device``, dtype kept (bf16 through fp32,
    which holds it exactly)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.as_tensor(a.astype(np.float32),
                               device=device).to(torch.bfloat16)
    return torch.as_tensor(np.array(a), device=device)


def kv_caches_from_jax(cache, device: "str | torch.device" = "cpu"):
    """A reference stacked ``KVCache`` -> one ``KVCache`` per layer on
    ``device`` (dtypes kept; bf16 arrays pass through fp32, which holds
    them exactly): leaves ``[L, B, ...]``, or the VLM's ``[n_stages,
    n_self, B, ...]`` taken stage by stage (``steps.init_caches``' order).
    The audio family's serve caches, the pair ``(stacked KVCache, encoder
    output)``, convert to the pair ``(list, tensor)``."""
    if not hasattr(cache, "length"):
        kv, enc = cache
        return kv_caches_from_jax(kv, device), _tensor(enc, device)
    lead = np.asarray(cache.length).ndim - 1  # axes before the batch's
    leaves = [np.asarray(a) for a in (cache.k, cache.v, cache.length,
                                      cache.attn_mass)]
    leaves = [a.reshape((-1,) + a.shape[lead:]) for a in leaves]
    return [KVCache(*(_tensor(a[i], device) for a in leaves))
            for i in range(leaves[2].shape[0])]


def states_from_jax(caches, device: "str | torch.device" = "cpu") -> List:
    """The reference's serve caches of a recurrent family -> this
    package's flat list (``models/steps.init_caches``), on ``device``.
    SSM: a stacked ``RWKVState`` (leaves ``[L, B, ...]``) -> one
    ``RWKVState`` per layer. Hybrid: ``(mamba, tail, attn)`` (a
    ``MambaState`` with leaves ``[n_stages, period, B, ...]``, one with
    ``[rem, B, ...]`` or None, a ``KVCache`` with ``[n_stages, B, ...]``)
    -> per stage its ``MambaState``s then its ``KVCache``, then the
    tail's ``MambaState``s."""
    if hasattr(caches, "wkv"):
        n = np.asarray(caches.wkv).shape[0]
        return [RWKVState(*(_tensor(np.asarray(a)[i], device)
                            for a in caches)) for i in range(n)]
    mamba, tail, attn = caches
    kv = kv_caches_from_jax(attn, device)
    h = np.asarray(mamba.h)
    out: List = []
    for s in range(h.shape[0]):
        out += [MambaState(_tensor(h[s, j], device),
                           _tensor(np.asarray(mamba.conv)[s, j], device))
                for j in range(h.shape[1])]
        out.append(kv[s])
    if tail is not None:
        out += [MambaState(_tensor(np.asarray(tail.h)[j], device),
                           _tensor(np.asarray(tail.conv)[j], device))
                for j in range(np.asarray(tail.h).shape[0])]
    return out


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
