"""ModelRunner — owns the LM's serve steps and the ledger of step shapes.

One of the three serving layers (Scheduler / KVCacheManager / ModelRunner —
see ``repro_torch.serving.engine``); the port of the reference package's
``serving/runner.py``. The runner holds the params and the prefill /
per-slot prefill / decode steps, moves their host inputs to the device
without waiting on it (pinned, asynchronous copies), and records which
step shapes it dispatched: ``compile_count`` and ``compiled_shapes()``
carry the reference's ledger keys, so a serve's shape churn compares
between the packages. PyTorch runs eagerly and compiles nothing, so
``jit_compile_count()`` is the ledger count, as the reference's own
fallback returns.

On the card the runner holds a copy of the params with every matrix in
the activation dtype (``cfg.dtype``), made once: ``linear`` casts its
weight to the activation dtype on every call, so the values are the
same, and a decode step reads bf16 weights instead of converting fp32
ones (about 30 GB less traffic per step at Minitron-4B's width). Norm
scales stay in their own dtype.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.backend import host_to_device, resolve_device
from repro_torch.models import steps as ST


def build_padded_batch(prefixes: Sequence[Optional[np.ndarray]],
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Left-pad ``prefixes`` (None = inactive slot -> one dummy token) to
    their common length. Returns ``(tokens [B, L], valid_start [B])``."""
    B = len(prefixes)
    L = max(len(p) for p in prefixes if p is not None)
    toks = np.zeros((B, L), np.int32)
    starts = np.full((B,), max(L - 1, 0), np.int32)  # dummy slots
    for i, p in enumerate(prefixes):
        if p is None:
            continue
        toks[i, L - len(p):] = p
        starts[i] = L - len(p)
    return toks, starts


# leaves with ndim >= 2 that the reference reads in fp32 whatever the
# activation dtype: RWKV6's bonus ``u`` [H, dh] (``ssm.py:205``)
FP32_LEAVES = ("u",)

# families whose prefill needs a modality input beside the tokens (vision
# embeddings, audio frames)
MODALITY_FAMILIES = ("vlm", "audio")


def require_tokens_only(cfg: ModelConfig) -> None:
    """Raise for a family the runner cannot serve: it feeds its steps
    tokens and ``valid_start`` only, as the reference's ``ModelRunner``
    does, so the VLM and audio families (whose prefill needs
    ``vision_embeds`` / ``audio_frames``) are served through
    ``models/steps.make_prefill`` and ``make_decode_step`` directly."""
    if cfg.family in MODALITY_FAMILIES:
        raise NotImplementedError(
            f"the serving engine feeds prefill tokens and valid_start only "
            f"(as the reference's ModelRunner does), so it cannot serve "
            f"family {cfg.family!r}, whose prefill needs "
            f"{'vision_embeds' if cfg.family == 'vlm' else 'audio_frames'}"
            f"; serve it through models/steps.make_prefill and "
            f"make_decode_step")


def serving_params(cfg: ModelConfig, params: Dict) -> Dict:
    """``params`` with every matrix (ndim >= 2) in the activation dtype;
    vectors (norm scales, biases, Mamba2's ``A_log``, ``dt_bias`` and
    ``D``, RWKV6's mixes and ``w_bias``) and ``FP32_LEAVES`` unchanged.
    Equal in value to what ``linear``, the embedding lookup, the Mamba2
    conv (``conv_w``) and the token mixes cast to on every call."""
    adt = getattr(torch, cfg.dtype)

    def cast(t, key=None):
        if isinstance(t, dict):
            return {k: cast(v, k) for k, v in t.items()}
        if isinstance(t, list):
            return [cast(v) for v in t]
        return t.to(adt) if t.dim() >= 2 and key not in FP32_LEAVES else t
    return cast(params)


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host array, waiting for it as a step boundary: an
    asynchronous copy into pinned memory, then the copy's event. The
    static-wave path and the synchronous per-slot prefill read their
    tokens this way; the pipelined path reads them at completion."""
    if t.device.type != "cuda":
        return t.numpy()
    host = t.to("cpu", non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    ev.synchronize()
    return host.numpy()


class ModelRunner:
    """Serve steps for one (cfg, params) pair on ``device`` (the card by
    default; ``"cpu"`` runs the kernels' plain versions)."""

    def __init__(self, cfg: ModelConfig, params: Any,
                 device: "str | torch.device" = "cuda"):
        require_tokens_only(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = (serving_params(cfg, params)
                       if self.device.type == "cuda" else params)
        self.masked = cfg.family in ST.MASKABLE_FAMILIES
        self.supports_slot_prefill = cfg.family in ST.SLOT_PREFILL_FAMILIES
        self._prefill = ST.make_prefill(cfg)
        self._decode = ST.make_decode_step(cfg)
        self._prefill_slot = (ST.make_prefill_slot(cfg)
                              if self.supports_slot_prefill else None)
        self._compiled: set = set()
        # step calls by kind: each runs every layer's attention once, so a
        # serve's attention-kernel launches are layers x calls
        self.calls = {"prefill": 0, "prefill_slot": 0, "decode": 0}

    def _to_device(self, arr) -> torch.Tensor:
        return host_to_device(arr, self.device, np.int32)

    # -- steps -------------------------------------------------------------
    def prefill(self, tokens: np.ndarray, valid_start: Optional[np.ndarray],
                caches: Any) -> Tuple[torch.Tensor, Any]:
        """Whole-batch prefill of ``tokens`` [B, L] (left-padded; pad depth
        per row in ``valid_start``). Returns (next_token [B], caches)."""
        batch = {"tokens": self._to_device(tokens)}
        if self.masked and valid_start is not None:
            batch["valid_start"] = self._to_device(valid_start)
        self._compiled.add(("prefill",) + tokens.shape)
        self.calls["prefill"] += 1
        return self._prefill(self.params, batch, caches)

    def prefill_slot(self, prompt: np.ndarray, caches: Any, slot: int,
                     bucket_len: int) -> Tuple[int, Any]:
        """Prefill one prompt into batch row ``slot`` of the live caches,
        padded to ``bucket_len`` (from ``KVCacheManager.admit``). Returns
        (next_token as int, caches): :meth:`prefill_slot_async`, then the
        token read as a step boundary."""
        tok, caches = self.prefill_slot_async(prompt, caches, slot,
                                              bucket_len)
        return int(to_host(tok)[0]), caches

    def prefill_slot_async(self, prompt: np.ndarray, caches: Any, slot: int,
                           bucket_len: int) -> Tuple[torch.Tensor, Any]:
        """Per-slot prefill that returns the next token as a device tensor
        ([1]) without waiting for it — the pipelined continuous path
        chains it into the decode token vector."""
        if self._prefill_slot is None:
            raise RuntimeError(
                f"per-slot prefill unsupported for family "
                f"'{self.cfg.family}' — use the whole-batch prefill path")
        P = len(prompt)
        row = np.zeros((1, bucket_len), np.int32)
        row[0, bucket_len - P:] = prompt
        batch = {"tokens": self._to_device(row),
                 "valid_start": self._to_device([bucket_len - P])}
        self._compiled.add(("prefill_slot", bucket_len))
        self.calls["prefill_slot"] += 1
        return self._prefill_slot(self.params, batch, caches, slot)

    def decode(self, tokens: "np.ndarray | torch.Tensor", caches: Any,
               valid_start: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, Any]:
        """One decode step for every slot. ``tokens`` [B]: host ints or the
        previous step's device tensor."""
        self._compiled.add(("decode", len(tokens)))
        self.calls["decode"] += 1
        if isinstance(tokens, torch.Tensor):
            tok = tokens.to(torch.int32)
        else:
            tok = self._to_device(np.asarray(tokens))
        return self._decode(self.params, tok[:, None], caches,
                            valid_start=valid_start)

    # -- compile observability ---------------------------------------------
    @property
    def compile_count(self) -> int:
        """Distinct step shapes dispatched so far (the ledger)."""
        return len(self._compiled)

    def compiled_shapes(self) -> List[Tuple]:
        return sorted(self._compiled)

    def jit_compile_count(self) -> int:
        """The ledger count: eager PyTorch compiles no step, and this is
        what the reference returns where its jit caches cannot be read."""
        return self.compile_count
