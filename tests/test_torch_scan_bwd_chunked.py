"""The chunked forms of the scans' backward kernels (``csrc/mamba_scan_bwd.cu``
and ``csrc/wkv6_bwd.cu`` from ``BWD_CHUNK_MIN`` steps on) as tensor code on
the CPU: ``mamba_scan_bwd_chunked_plain`` and ``wkv6_bwd_chunked_plain``
take the kernels' chunks and sub-chunks and their three phases (the
chunks' start states forward, their end adjoints in reverse, each chunk's
gradients from those two) and form every decay factor as the forward
kernels do (running products of decays <= 1; no division, no log). They
are held against the plain backward loops and, for the WKV, against
``jax.vjp`` of the reference's ``_wkv_sequential``, on inputs made with
numpy from a seed, in the three decay regimes of
``test_torch_scan_chunked``: model-like, strong (down to exactly 0) and
exactly 1.

Gate, as the card's (``chip_smoke.SCAN_BWD_TOL``): every gradient within
1e-5 x max(1, max|plain|) (a chunk's sums run in another order than the
loop's); no NaN.
"""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import _wkv_sequential

from repro_torch.kernels.ssm_scan import ops as SS
from test_torch_scan_chunked import (LENGTHS, REGIMES, _mamba_inputs,
                                     _within, _wkv_inputs)

CSRC = pathlib.Path(SS.__file__).resolve().parents[1] / "csrc"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The chunked versions run many small tensor ops: with several test
    workers on the machine, intra-op threads contend and the module takes
    minutes instead of seconds. One thread here; the count is restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grads_out(args, seed):
    """dy [B, S, H, dh] and the final state's gradient, drawn with numpy."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(t.shape)
                                  .astype(np.float32))
                 for t in (args[0], args[-1]))


def _all_within(got, ref):
    assert len(got) == len(ref)
    for a, r in zip(got, ref):
        assert a.shape == r.shape
        assert not bool(torch.isnan(a).any())
        _within(a, r)


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("dh,N", [(16, 8), (64, 64)], ids=["dh16-N8",
                                                             "dh64-N64"])
def test_mamba_bwd_chunked_matches_plain(dh, N, S, regime):
    args = _mamba_inputs(S, dh, N, regime)
    if regime == "strong":
        assert bool((args[2] == 0).any())  # decays of exactly 0
    grads = _grads_out(args, seed=S)
    _all_within(SS.mamba_scan_bwd_chunked_plain(*args, *grads),
                SS.mamba_scan_bwd_plain(*args, *grads))


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("dh", [16, 64])
def test_wkv6_bwd_chunked_matches_plain(dh, S, regime):
    args = _wkv_inputs(S, dh, regime)
    if regime == "strong":
        assert bool((args[3] == 0).any())  # decays of exactly 0
    grads = _grads_out(args, seed=S)
    _all_within(SS.wkv6_bwd_chunked_plain(*args, *grads),
                SS.wkv6_bwd_plain(*args, *grads))


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("S", [65, 200])
def test_wkv6_bwd_chunked_matches_reference(S, regime):
    """The chunked backward against ``jax.vjp`` of the reference's
    sequential WKV on the same numpy inputs and output gradients."""
    args = _wkv_inputs(S, 16, regime, seed=1)
    grads = _grads_out(args, seed=2)
    _, vjp = jax.vjp(_wkv_sequential, *(jnp.asarray(t.numpy())
                                        for t in args))
    ref = vjp(tuple(jnp.asarray(t.numpy()) for t in grads))
    _all_within(SS.wkv6_bwd_chunked_plain(*args, *grads),
                [torch.from_numpy(np.array(r)) for r in ref])


@pytest.mark.parametrize("kind,source", [("mamba", "mamba_scan_bwd.cu"),
                                         ("wkv6", "wkv6_bwd.cu")])
def test_bwd_form_and_the_kernels_constants(kind, source):
    """``bwd_form`` picks the chunked backward from ``BWD_CHUNK_MIN`` steps
    on, and the kernel's source holds that threshold."""
    first = SS.BWD_CHUNK_MIN[kind]
    assert SS.bwd_form(kind, 1) == "sequential"
    assert SS.bwd_form(kind, first - 1) == "sequential"
    assert SS.bwd_form(kind, first) == "chunked"
    got = re.findall(r"constexpr int kBwdChunkMin = (\d+);",
                     (CSRC / source).read_text())
    assert got == [str(first)]
