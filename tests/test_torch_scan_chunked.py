"""The chunked forms of the recurrent scan kernels (``csrc/mamba_scan.cu``
and ``csrc/wkv6.cu`` from ``CHUNK_MIN`` steps on) as tensor code on the CPU:
``mamba_scan_chunked_plain`` and ``wkv6_chunked_plain`` take the kernels'
chunk and sub-chunk lengths and form every decay factor as they do (running
products of decays <= 1; no division, no log). They are held against the
plain loops and, for the WKV, against the reference's ``_wkv_sequential``,
on inputs made with numpy from a seed, in three decay regimes: model-like,
strong (down to exactly 0: Mamba2's dt |A| past ~104, RWKV6's w_raw up to
+5) and exactly 1.

Gates, as the card's (``tests/test_torch_gpu.py``): y within 1e-5 x max(1,
max|plain y|); the final state within 1e-5 x max(1, max|plain state|) (a
chunk's sums run in another order than the loop's, so the state is not
bitwise); no NaN; S split as S1 + (S - S1) with the state carried within
the same bounds against one pass.
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import _wkv_sequential

from repro_torch.kernels.ssm_scan import ops as SS

TOL = 1e-5
CSRC = pathlib.Path(SS.__file__).resolve().parents[1] / "csrc"
LENGTHS = [1, 37, 64, 65, 200, 500]
REGIMES = ["model", "strong", "one"]


def _mamba_inputs(S, dh, N, regime, B=2, H=2, seed=0):
    """x, dt, decay, B, C, h0 as the model makes them: dt through softplus,
    decay exp(-dt A) with A of 1..16."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))
    if regime == "strong":
        dt = dt * 40.0
    A = np.linspace(1.0, 16.0, H)
    decay = np.ones((B, S, H)) if regime == "one" else np.exp(-dt * A)
    arrs = (rng.standard_normal((B, S, H, dh)), dt, decay,
            rng.standard_normal((B, S, N)), rng.standard_normal((B, S, N)),
            0.1 * rng.standard_normal((B, H, dh, N)))
    return tuple(torch.from_numpy(a.astype(np.float32)) for a in arrs)


def _wkv_inputs(S, dh, regime, B=2, H=2, seed=0):
    """r, k, v, w, u, s0 with w = exp(-exp(w_raw)): w_raw -6 + noise (near
    1), uniform on [-6, 5] (strong), or w exactly 1."""
    rng = np.random.default_rng(seed)
    w_raw = (-6.0 + rng.standard_normal((B, S, H, dh)) if regime == "model"
             else rng.uniform(-6.0, 5.0, (B, S, H, dh)))
    w = np.ones((B, S, H, dh)) if regime == "one" else np.exp(-np.exp(w_raw))
    arrs = (*(rng.standard_normal((B, S, H, dh)) for _ in range(3)), w,
            0.1 * rng.standard_normal((H, dh)),
            0.1 * rng.standard_normal((B, H, dh, dh)))
    return tuple(torch.from_numpy(a.astype(np.float32)) for a in arrs)


def _within(got, ref):
    got, ref = (torch.as_tensor(np.array(t)) for t in (got, ref))
    assert bool(torch.isfinite(got).all())
    err = (got - ref).abs().max().item()
    tol = TOL * max(1.0, ref.abs().max().item())
    assert err <= tol, (err, tol)


def _split(args, S1):
    """The per-step inputs cut at S1: (first part, rest), the state apart."""
    S = args[0].shape[1]
    cut = lambda a, b: [t[:, a:b] if t.dim() >= 3 and t.shape[1] == S
                        else t for t in args[:-1]]
    return cut(0, S1), cut(S1, S)


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("dh,N", [(16, 8), (64, 64)], ids=["dh16-N8",
                                                             "dh64-N64"])
def test_mamba_chunked_matches_plain(dh, N, S, regime):
    args = _mamba_inputs(S, dh, N, regime)
    if regime == "strong":
        assert bool((args[2] == 0).any())  # decays of exactly 0
    y, h = SS.mamba_scan_chunked_plain(*args)
    y_ref, h_ref = SS.mamba_scan_plain(*args)
    assert y.shape == y_ref.shape and h.shape == h_ref.shape
    _within(y, y_ref)
    _within(h, h_ref)


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("dh", [16, 64])
def test_wkv6_chunked_matches_plain(dh, S, regime):
    args = _wkv_inputs(S, dh, regime)
    if regime == "strong":
        assert bool((args[3] == 0).any())  # decays of exactly 0
    y, s = SS.wkv6_chunked_plain(*args)
    y_ref, s_ref = SS.wkv6_plain(*args)
    assert y.shape == y_ref.shape and s.shape == s_ref.shape
    _within(y, y_ref)
    _within(s, s_ref)


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("S", [65, 200])
def test_wkv6_chunked_matches_reference(S, regime):
    """The chunked form against the reference's sequential WKV on the same
    numpy inputs."""
    args = _wkv_inputs(S, 16, regime, seed=1)
    y, s = SS.wkv6_chunked_plain(*args)
    y_ref, s_ref = _wkv_sequential(*(jnp.asarray(t.numpy()) for t in args))
    _within(y, y_ref)
    _within(s, s_ref)


@pytest.mark.parametrize("kind", ["mamba", "wkv6"])
@pytest.mark.parametrize("regime", ["model", "strong"])
def test_chunked_split_carries_the_state(kind, regime):
    """S 200 split as 67 + 133, the state carried: within the gates of one
    pass of the chunked form and of the plain loop."""
    if kind == "mamba":
        args = _mamba_inputs(200, 64, 8, regime)
        fn, plain = SS.mamba_scan_chunked_plain, SS.mamba_scan_plain
    else:
        args = _wkv_inputs(200, 16, regime)
        fn, plain = SS.wkv6_chunked_plain, SS.wkv6_plain
    first, rest = _split(args, 67)
    ya, sa = fn(*first, args[-1])
    yb, sb = fn(*rest, sa)
    y, s = torch.cat([ya, yb], dim=1), sb
    for ref_y, ref_s in (fn(*args), plain(*args)):
        _within(y, ref_y)
        _within(s, ref_s)


@pytest.mark.parametrize("kind,source", [("mamba", "mamba_scan.cu"),
                                         ("wkv6", "wkv6.cu")])
def test_scan_form_and_the_kernels_constants(kind, source):
    """``scan_form`` picks the chunked form from ``CHUNK_MIN`` steps on,
    and the kernel's source holds the twins' chunk, sub-chunk and
    threshold."""
    first = SS.CHUNK_MIN[kind]
    assert SS.scan_form(kind, 1) == "sequential"
    assert SS.scan_form(kind, first - 1) == "sequential"
    assert SS.scan_form(kind, first) == "chunked"
    src = (CSRC / source).read_text()
    for const, want in (("kChunkMin", first), ("kC", SS.CHUNK),
                        ("kSub", SS.SUB)):
        got = re.findall(rf"constexpr int {const} = (\d+);", src)
        assert got == [str(want)], (const, got)
