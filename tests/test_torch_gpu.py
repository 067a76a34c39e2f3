"""The port's CUDA kernels and engine on the card. Every test here is marked
``gpu`` and skips without an NVIDIA GPU. The file imports neither JAX nor
the reference package, so it also runs where only PyTorch is installed
(``--noconftest`` skips the suite's JAX-importing ``conftest.py``):

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import DEIT_SMALL, MINITRON_4B
from repro_torch.core import packed_runner as PR
from repro_torch.core import quant as Q
from repro_torch.core import token_pruning as TTP
from repro_torch.core.packing import pack_weight
from repro_torch.kernels import backend
from repro_torch.kernels.flash_attention import (
    attention_causal_bwd_plain, attention_causal_lse_plain,
    attention_causal_plain, attention_plain, flash_attention)
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.core.quant import dequantize_blocks
from repro_torch.kernels.sbmm import (sbmm, sbmm_plain, sbmm_quant_raw,
                                      sbmm_raw)
from repro_torch.kernels.token_drop import token_drop, token_drop_plain
from repro_torch.kernels.token_drop.ops import MAX_TOKENS
from repro_torch.kernels.token_package import (token_package,
                                               token_package_plain)
from repro_torch.launch.serve_vision import make_requests
from repro_torch.models import model as M
from repro_torch.models import pruning_glue as PG
from repro_torch.serving import EngineConfig, Request, ServeEngine
from repro_torch.serving.runner import serving_params
from repro_torch.serving.vision import VisionEngine, VisionEngineConfig

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return backend.resolve_device("cuda")


def test_kernels_match_plain_on_card(dev):
    """Each CUDA kernel against its plain version on the card, at small
    main-path-like shapes (an empty block column, a one-key row, padded
    TDM rows)."""
    g = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 64)).astype(np.float32)
    mask = np.zeros((4, 4), np.float32)
    for c, n in enumerate((1, 4, 2, 0)):
        mask[rng.choice(4, n, replace=False), c] = 1.0
    pk = pack_weight(w, mask, 16, device=dev)
    x = torch.randn((70, 64), generator=g).to(dev)
    y = sbmm(x, pk)
    ref = x @ pk.to_dense()
    torch.testing.assert_close(y, ref, atol=1e-4, rtol=1e-4)

    q, k, v = (torch.randn((3, 40, 4, 64), generator=g).to(dev)
               for _ in range(3))
    kv = torch.tensor([40, 23, 1], dtype=torch.int32, device=dev)
    o, s = flash_attention(q, k, v, kv, collect_scores=True)
    o_ref, p_ref = attention_plain(q, k, v, kv)
    torch.testing.assert_close(o, o_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, p_ref.mean(1), atol=1e-5, rtol=1e-4)
    assert bool((s[1, 23:] == 0).all()) and bool((s[2, 1:] == 0).all())
    o_all = flash_attention(q, k, v)  # no kv_len: every key is valid
    torch.testing.assert_close(o_all, attention_plain(q, k, v)[0],
                               atol=1e-4, rtol=1e-4)
    kv0 = torch.tensor([40, 0, 1], dtype=torch.int32, device=dev)
    o, s = flash_attention(q, k, v, kv0, collect_scores=True)
    o_ref, p_ref = attention_plain(q, k, v, kv0)  # row 1 has no key (C1)
    torch.testing.assert_close(o, o_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, p_ref.mean(1), atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(s[1], torch.full_like(s[1], 1 / 40),
                               atol=0, rtol=1e-6)

    z = torch.randn((2, 40, 384), generator=g).to(dev)
    sc = torch.rand((2, 40), generator=g).to(dev)
    sc[1, 30:] = 0
    out = token_drop(z, sc, 20)
    ref = TTP.tdm(z, sc, None, k=20)[0]
    assert torch.equal(out[:, :21], ref[:, :21])  # CLS and kept rows: copies
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


def test_tier_and_soft_kernels_match_plain_on_card(dev):
    """The fp16/int8 SBMM entry points, fp16 attention and the soft TDM's
    token_package against their plain versions on the card."""
    g = torch.Generator().manual_seed(1)
    rng = np.random.default_rng(1)
    w = rng.standard_normal((64, 64)).astype(np.float32)
    mask = np.zeros((4, 4), np.float32)
    for c, n in enumerate((1, 4, 2, 0)):
        mask[rng.choice(4, n, replace=False), c] = 1.0
    pk = pack_weight(w, mask, 16, device=dev)
    x = torch.randn((70, 64), generator=g).to(dev)
    before = backend.launches()
    for precision, granularity in (("fp16", "block"), ("int8", "block"),
                                   ("int8", "channel")):
        q = Q.quantize_packed(pk, precision, granularity)
        ref = x @ q.to_dense().float()
        torch.testing.assert_close(sbmm(x, q), ref, atol=1e-4, rtol=1e-4)

    q, k, v = (torch.randn((3, 40, 4, 64), generator=g).to(dev).half()
               for _ in range(3))
    kv = torch.tensor([40, 23, 1], dtype=torch.int32, device=dev)
    o, s = flash_attention(q, k, v, kv, collect_scores=True)
    o_ref, p_ref = attention_plain(q, k, v, kv)
    assert o.dtype == torch.float16
    # one fp16 rounding of fp32 sums taken in another order
    torch.testing.assert_close(o.float(), o_ref.float(), atol=2e-3,
                               rtol=2e-3)
    torch.testing.assert_close(s, p_ref.mean(1), atol=1e-5, rtol=1e-4)
    kv0 = torch.tensor([0, 23, 1], dtype=torch.int32, device=dev)
    o, s = flash_attention(q, k, v, kv0, collect_scores=True)
    o_ref, p_ref = attention_plain(q, k, v, kv0)  # row 0 has no key (C1)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=2e-3,
                               rtol=2e-3)
    torch.testing.assert_close(s, p_ref.mean(1), atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(s[0], torch.full_like(s[0], 1 / 40),
                               atol=0, rtol=1e-6)

    z = torch.randn((3, 40, 384), generator=g).to(dev)
    sc = torch.rand((3, 40), generator=g).to(dev)
    sc[1, 30:] = 0
    sc[2, 20:] = 0
    for mass, pos, kk in ((None, None, 15), (torch.rand(3, generator=g),
                                             torch.tensor([38, 28, 18]),
                                             12)):
        if mass is not None:
            mass, pos = mass.to(dev), pos.to(dev)
        out, m = token_package(z, sc, kk, pkg_mass=mass, pkg_pos=pos)
        out_ref, m_ref = token_package_plain(z, sc, kk, mass, pos)
        assert torch.equal(out[:, :kk + 1], out_ref[:, :kk + 1])
        torch.testing.assert_close(out, out_ref, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(m, m_ref, atol=1e-5, rtol=1e-5)
    after = backend.launches()
    for name in ("sbmm_f16w", "sbmm_i8_block", "sbmm_i8_channel",
                 "flash_attention_f16", "token_package_f32"):
        assert after[name] > before[name], name


# ---------------------------------------------------------------------------
# the non-causal attention entry points
# ---------------------------------------------------------------------------
FLASH_NS = (1, 17, 64, 65, 197)


def _device_kernels(fn, n=10):
    """(name, launches) of the device work of ``n`` calls of ``fn``, from
    the second of two profiled runs: the first warms the profiler up (a
    process's first session can miss its first kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
    return [(e.key, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]


@pytest.mark.parametrize("Dh", [16, 64])
@pytest.mark.parametrize("tier", ["f32", "f16"])
def test_flash_attention_on_card(dev, tier, Dh):
    """One non-causal entry point at N in {1, 17, 64, 65, 197}, B = 4
    rows with ``kv_len`` 0 (no key: the mean of V over all N keys,
    probabilities 1/N), 1, N and N + 3 (acts as N): o within 1e-4 (fp32)
    or 2e-3 (fp16) of the largest plain element and the head-mean scores
    within 1e-4 of theirs, exactly 0 at masked keys, all finite; two calls
    bitwise equal; each row's bits those of the row computed alone (B = 1)
    and, for a row with keys, with 13 tokens of padding past ``kv_len``;
    a misaligned q gives the same bits; one device kernel per call without
    scores."""
    dt = torch.float32 if tier == "f32" else torch.float16
    entry = f"flash_attention_{tier}"
    rule_o = 1e-4 if tier == "f32" else 2e-3
    H = 3
    g = torch.Generator().manual_seed(Dh)

    def rand(*shape):
        return torch.randn(shape, generator=g).to(dev, dt)

    for N in FLASH_NS:
        lens = [0, 1, N, N + 3]
        B = len(lens)
        q, k, v = rand(B, N, H, Dh), rand(B, N, H, Dh), rand(B, N, H, Dh)
        kv = torch.tensor(lens, dtype=torch.int32, device=dev)
        before = backend.launches()[entry]
        o, sc = flash_attention(q, k, v, kv, collect_scores=True)
        again = flash_attention(q, k, v, kv, collect_scores=True)
        assert backend.launches()[entry] == before + 2
        assert torch.equal(o, again[0]) and torch.equal(sc, again[1])
        o_ref, p_ref = attention_plain(q, k, v, kv)
        s_ref = p_ref.mean(1)
        assert o.dtype == dt and bool(torch.isfinite(o.float()).all())
        assert (o.float() - o_ref.float()).abs().max() <= \
            rule_o * o_ref.float().abs().max(), N
        assert (sc - s_ref).abs().max() <= 1e-4 * s_ref.abs().max(), N
        assert bool((sc[1, 1:] == 0).all())
        torch.testing.assert_close(sc[0], torch.full_like(sc[0], 1 / N),
                                   atol=0, rtol=1e-6)
        for b in range(B):
            one = flash_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                  kv[b:b + 1], collect_scores=True)
            assert torch.equal(one[0][0], o[b]) and \
                torch.equal(one[1][0], sc[b]), (N, b)
            if lens[b] <= 0:
                continue  # a row without a key spans all N: padding moves it
            pad = [torch.cat([t[b:b + 1], rand(1, 13, H, Dh)], dim=1)
                   for t in (q, k, v)]
            op, sp = flash_attention(*pad, kv[b:b + 1].clamp(max=N),
                                     collect_scores=True)
            assert torch.equal(op[0, :N], o[b]) and \
                torch.equal(sp[0, :N], sc[b]), (N, b)
            assert bool((sp[0, N:] == 0).all())
        qm = torch.empty(q.numel() + 1, dtype=dt, device=dev)[1:].view_as(q)
        qm.copy_(q)
        assert qm.data_ptr() % 16 != 0
        assert torch.equal(flash_attention(qm, k, v, kv), o)
        kernels = _device_kernels(lambda: flash_attention(q, k, v, kv))
        assert sum(n for _, n in kernels) == 10, kernels
        assert all(f"{entry}_kernel" in name for name, _ in kernels), kernels


def test_engine_on_card_matches_cpu_and_oracle(dev):
    """The reduced DeiT-Small served on the card goes through all three
    kernels and agrees with the same engine on the CPU (plain versions)
    and with its own offline oracle, within 1e-4 (fp32, other summation
    orders)."""
    cfg = DEIT_SMALL.reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    scores = PG.init_scores(cfg, params, torch.Generator().manual_seed(7))
    vc = VisionEngineConfig(max_batch=3, planner="full")
    outs = {}
    for device in ("cpu", dev):
        eng = VisionEngine.from_pruned(cfg, params, scores, vc=vc,
                                       device=device)
        backend.reset_launches()
        outs[str(device)] = eng.serve(make_requests(cfg, 6, 2, seed=0))
        launches = backend.launches()
    assert all(launches[n] > 0 for n in ("sbmm_f32", "flash_attention_f32",
                                         "token_drop_f32")), launches
    card, cpu = outs[str(dev)], outs["cpu"]
    assert sorted(card) == sorted(cpu) == list(range(6))
    for uid in card:
        np.testing.assert_allclose(card[uid], cpu[uid], atol=1e-4, rtol=1e-4)
    for r in make_requests(cfg, 6, 2, seed=0):
        ref = PR.forward_vit_packed(
            cfg, eng.segments.params, eng.segments.packed, r.patches[None],
            segments=eng.segments,
            schedule=PR.keep_schedule(cfg, r_t=r.r_t)).logits[0]
        np.testing.assert_allclose(card[r.uid], ref.cpu().numpy(),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("depth", [1, 2])
def test_engine_waits_on_card_only_at_step_events(dev, depth):
    """A serve on the card waits on the card only through the pipeline's
    per-step event: under sync debug mode "error" any other host sync (a
    copy from pageable memory, an ``.item()``) raises. ``token_tile=8``
    pads tokens, so the per-row ``n_valid`` copy is exercised too."""
    cfg = DEIT_SMALL.reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    scores = PG.init_scores(cfg, params, torch.Generator().manual_seed(7))
    eng = VisionEngine.from_pruned(
        cfg, params, scores, device=dev,
        vc=VisionEngineConfig(max_batch=3, token_tile=8,
                              pipeline_depth=depth))
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = eng.serve(make_requests(cfg, 6, 2, seed=0))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert sorted(out) == list(range(6))
    assert any(masked for _, _, masked, _ in eng.segments.compiled_tiles())


def test_soft_int8_serve_on_card_matches_oracle(dev):
    """A soft int8 serve with token-padded tiles (``token_tile=8``: each
    package pinned at its row's ``n_valid - 2``) goes through the int8 SBMM
    and token_package, waits on the card only at the pipeline's step
    events, and agrees with the offline oracle at int8 within 1e-4
    (relative to max(1, |ref|)) with top-1 equal. The reduced model has a
    TDM at every layer here, so package masses chain."""
    cfg = DEIT_SMALL.reduced()
    cfg = cfg.replace(pruning=dataclasses.replace(
        cfg.pruning, tdm_layers=tuple(range(cfg.num_layers))))
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    scores = PG.init_scores(cfg, params, torch.Generator().manual_seed(7))
    eng = VisionEngine.from_pruned(
        cfg, params, scores, device=dev,
        vc=VisionEngineConfig(max_batch=3, token_tile=8, precision="int8"))
    reqs = make_requests(cfg, 6, 2, seed=0)
    for r in reqs:
        r.soft_prune = True
    backend.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = eng.serve(reqs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches = backend.launches()
    assert launches["sbmm_i8_channel"] > 0 and \
        launches["token_package_f32"] > 0, launches
    assert eng.stats()["dequant_dispatches"] > 0
    assert any(masked for _, _, masked, *_ in eng.segments.compiled_tiles())
    for r in reqs:
        ref = PR.forward_vit_packed(
            cfg, eng.segments.params, eng.segments.packed, r.patches[None],
            segments=eng.segments, soft=True, precision="int8",
            schedule=PR.keep_schedule(cfg, r_t=r.r_t)).logits[0]
        ref = ref.cpu().numpy()
        scale = max(1.0, float(np.abs(ref).max()))
        assert float(np.abs(out[r.uid] - ref).max()) <= 1e-4 * scale
        assert int(np.argmax(out[r.uid])) == int(np.argmax(ref))


# ---------------------------------------------------------------------------
# the SBMM entry points
# ---------------------------------------------------------------------------
SBMM_MS = (1, 5, 64, 65, 197, 788)
SBMM_KINDS = {"sbmm_f32": ("fp32", None), "sbmm_f16w": ("fp16", None),
              "sbmm_i8_block": ("int8", "block"),
              "sbmm_i8_channel": ("int8", "channel")}


def _interleave_padding(header, *per_slot, rng):
    """Move each header row's -1 padding in among its live slots, which
    keep their order, and each per-slot tensor (blocks, scales) with it."""
    C, S = header.shape
    order = np.empty((C, S), np.int64)
    for c in range(C):
        n = int((header[c] >= 0).sum())
        at = np.sort(rng.choice(S, n, replace=False))
        order[c, at] = np.arange(n)
        order[c, np.setdiff1d(np.arange(S), at)] = np.arange(n, S)
    idx = torch.from_numpy(order).to(header.device)
    return [torch.stack([t[c][idx[c]] for c in range(C)])
            for t in (header, *per_slot)]


def _sbmm_weight(dev, entry):
    """A [384, 376] weight at r_b ~0.5 with block column counts spread
    from 0 (an empty column) to 24, so the heaviest-first permutation is
    not the identity; N = 376 leaves the last block column half used."""
    rng = np.random.default_rng(3)
    K, N = 384, 376
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    mask = (rng.random((K // 16, -(-N // 16))) < 0.5).astype(np.float32)
    mask[:, 5] = 0.0
    mask[:, 7] = 1.0
    pk = pack_weight(w, mask, 16, device=dev)
    assert not np.array_equal(pk.col_perm, np.arange(pk.n_cols))
    assert int(pk.counts.min()) == 0
    precision, granularity = SBMM_KINDS[entry]
    return Q.quantize_packed(pk, precision, granularity or "block")


@pytest.mark.parametrize("entry", list(SBMM_KINDS))
def test_sbmm_entry_point_on_card(dev, entry):
    """One SBMM entry point at M in {1, 5, 64, 65, 197, 788}: within 1e-4
    of the largest plain element; each row's bits independent of M and of
    the row tile (every row of the 788-row call recomputed alone, and the
    first M rows at every M); the logical-order store bitwise the
    stored-order output un-permuted; exactly one device kernel per
    ``sbmm()`` call; a misaligned x raises; a header with its -1 padding
    moved in among the live slots gives the stored-order output's bits."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    q = _sbmm_weight(dev, entry)
    quant = isinstance(q, Q.QuantizedPackedWeight)
    K, N = q.shape
    C = q.n_cols
    g = torch.Generator().manual_seed(4)
    x = torch.randn((max(SBMM_MS), K), generator=g).to(dev)
    blocks = dequantize_blocks(q.blocks, q.scales) if quant else q.blocks
    inv = np.argsort(q.col_perm)
    before = backend.launches()[entry]
    y_all = sbmm(x, q)
    for M in SBMM_MS:
        y = sbmm(x[:M], q)
        ref = sbmm_plain(x[:M], blocks, q.header, q.col_map, N)
        assert y.shape == (M, N) and y.is_contiguous()
        torch.testing.assert_close(y, ref, rtol=0,
                                   atol=1e-4 * ref.abs().max().item())
        assert torch.equal(y, y_all[:M])
        raw = (sbmm_quant_raw(x[:M], q.blocks, q.header, q.scales) if quant
               else sbmm_raw(x[:M], q.blocks, q.header))
        assert torch.equal(raw.view(M, C, 16)[:, inv].reshape(M, -1)[:, :N],
                           y)
    for r in range(x.shape[0]):
        assert torch.equal(sbmm(x[r:r + 1], q)[0], y_all[r]), r
    header, blk, *sc = _interleave_padding(
        q.header, q.blocks, *([q.scales] if quant else []),
        rng=np.random.default_rng(5))
    hdr = header.cpu().numpy()
    assert ((hdr[:, :-1] < 0) & (hdr[:, 1:] >= 0)).any()
    assert torch.equal(sbmm_quant_raw(x, blk, header, sc[0]) if quant
                       else sbmm_raw(x, blk, header), raw)
    assert backend.launches()[entry] == before + 2 + 2 * len(SBMM_MS) + \
        x.shape[0]

    sbmm(x, q)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            sbmm(x, q)
        torch.cuda.synchronize()
    kernels = [(e.key, e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    assert sum(n for _, n in kernels) == 20, kernels
    assert all(f"{entry}_kernel" in k for k, _ in kernels), kernels

    misaligned = torch.empty(8 * K + 1, device=dev)[1:].view(8, K)
    with pytest.raises(ValueError, match="16-byte aligned"):
        sbmm(misaligned, q)


# ---------------------------------------------------------------------------
# the TDM kernels
# ---------------------------------------------------------------------------
TDM_CASES = (  # B, N, D, real tokens per row (token-padded past them)
    (1, 2, 16, (2,)),
    (3, 17, 64, (17, 9, 4)),
    (8, 65, 32, (65, 64, 40, 33, 20, 9, 5, 4)),
    (4, 197, 384, (197, 180, 160, 140)),
    (2, MAX_TOKENS, 64, (MAX_TOKENS, 700)),
)


def _tdm_inputs(dev, B, N, D, n_valid, ties, seed):
    """z and scores of a token-padded TDM tile: random scores normalised
    per row, or with ``ties`` three levels (integers in [0, 3) / 8, so most
    rows tie); padded rows score exactly 0."""
    g = torch.Generator().manual_seed(seed)
    z = torch.randn((B, N, D), generator=g)
    s = (torch.randint(0, 3, (B, N), generator=g).float() / 8 if ties
         else torch.rand((B, N), generator=g))
    for b, n in enumerate(n_valid):
        s[b, n:] = 0.0
    if not ties:
        s = s / s.sum(dim=1, keepdim=True)
    return z.to(dev), s.to(dev)


def _assert_tdm_matches(out, ref, k, mass=None, mass_ref=None):
    """CLS and kept rows bitwise the plain version's; the fused or package
    row and the new mass within 1e-5."""
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    assert torch.equal(out[:, :k + 1], ref[:, :k + 1])
    torch.testing.assert_close(out[:, k + 1], ref[:, k + 1], atol=1e-5,
                               rtol=1e-5)
    if mass is not None:
        torch.testing.assert_close(mass, mass_ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("case", TDM_CASES, ids=lambda c: f"B{c[0]}-N{c[1]}")
def test_token_drop_on_card(dev, case, ties):
    """token_drop against its plain version at k = 1, the largest k every
    row can fill with real tokens and k = N - 1; each row at the first two
    computed alone (its real tokens only) bitwise equal to its row of the
    padded tile."""
    B, N, D, n_valid = case
    z, s = _tdm_inputs(dev, B, N, D, n_valid, ties, seed=N + B)
    for k in sorted({1, min(n_valid) - 1, N - 1}):
        out = token_drop(z, s, k)
        _assert_tdm_matches(out, token_drop_plain(z, s, k), k)
        if k > min(n_valid) - 1:
            continue
        for b, n in enumerate(n_valid):
            one = token_drop(z[b:b + 1, :n].contiguous(), s[b:b + 1, :n], k)
            assert torch.equal(one[0], out[b]), (k, b)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("case", TDM_CASES, ids=lambda c: f"B{c[0]}-N{c[1]}")
def test_token_package_on_card(dev, case, ties):
    """token_package against its plain version: the first soft TDM (no
    package) at k = 1 and N - 1; then with carried masses and the package
    of row b at body index 0, n_valid - 2 or mid-row (b mod 3), int64
    positions on tie-heavy scores and int32 (as the engine passes them)
    on random ones, at k = 1 and the largest k every row can fill; each
    row computed alone bitwise equal to its row of the padded tile."""
    B, N, D, n_valid = case
    z, s = _tdm_inputs(dev, B, N, D, n_valid, ties, seed=7 * N + B)
    for k in sorted({1, N - 1}):
        out, m = token_package(z, s, k)
        ref, m_ref = token_package_plain(z, s, k)
        _assert_tdm_matches(out, ref, k, m, m_ref)
    if min(n_valid) < 3:
        return  # a package needs one more real body row than it keeps
    rng = np.random.default_rng(N)
    pos = torch.tensor([(0, n - 2, int(rng.integers(1, max(2, n - 2))))[b % 3]
                        for b, n in enumerate(n_valid)],
                       dtype=torch.int64 if ties else torch.int32,
                       device=dev)
    mass = torch.rand((B,), generator=torch.Generator().manual_seed(B)
                      ).to(dev)
    for k in sorted({1, min(n_valid) - 2}):
        out, m = token_package(z, s, k, mass, pos)
        ref, m_ref = token_package_plain(z, s, k, mass, pos)
        _assert_tdm_matches(out, ref, k, m, m_ref)
        for b, n in enumerate(n_valid):
            one, m1 = token_package(z[b:b + 1, :n].contiguous(),
                                    s[b:b + 1, :n], k, mass[b:b + 1],
                                    pos[b:b + 1])
            assert torch.equal(one[0], out[b]) and torch.equal(m1[0], m[b])


def test_token_drop_and_token_package_one_kernel_per_call(dev):
    """At the main path's shapes each wrapper call is exactly one device
    kernel, its own, with no copy, fill or pre-pass beside it: token_drop,
    and token_package without a package and with int32 (the engine's) and
    int64 positions; one launch counted per call."""
    B, N, D = 4, 197, 384
    z, s = _tdm_inputs(dev, B, N, D, (197, 180, 160, 140), True, seed=1)
    mass = torch.rand((B,), generator=torch.Generator().manual_seed(2)
                      ).to(dev)
    pos = torch.tensor([195, 178, 158, 138], dtype=torch.int32, device=dev)
    pos64 = pos.long()
    calls = {
        "token_drop_f32": [lambda: token_drop(z, s, 138)],
        "token_package_f32": [
            lambda: token_package(z, s, 138),
            lambda: token_package(z, s, 70, mass, pos),
            lambda: token_package(z, s, 70, mass, pos64)]}
    for entry, fns in calls.items():
        for fn in fns:
            before = backend.launches()[entry]
            kernels = _device_kernels(fn)
            assert sum(n for _, n in kernels) == 10, kernels
            assert all(f"{entry}_kernel" in k for k, _ in kernels), kernels
            assert backend.launches()[entry] == before + 22  # 2 x (1 + 10)


def test_token_drop_and_token_package_raise_above_max_tokens(dev):
    """The kernels take at most MAX_TOKENS tokens; above it the wrappers
    raise before any launch, and the plain version does not stand in."""
    z = torch.zeros((1, MAX_TOKENS + 1, 16), device=dev)
    s = torch.rand((1, MAX_TOKENS + 1), device=dev)
    before = backend.launches()
    with pytest.raises(ValueError, match="at most"):
        token_drop(z, s, 5)
    with pytest.raises(ValueError, match="at most"):
        token_package(z, s, 5, torch.ones(1, device=dev))
    assert backend.launches() == before


# ---------------------------------------------------------------------------
# the dense LM path
# ---------------------------------------------------------------------------
BF16_ULP = 2.0 ** -7  # one bf16 ulp, relative to the largest element


def _causal_case(dev, B, Nq, Hq, KV, Dh, S, q_offset, kv_len, kv_start,
                 seed=0):
    """The causal kernel the wrapper picks (``flash_decode_bf16`` for
    Nq == 1, ``flash_prefill_bf16`` otherwise) and its plain version on the
    same bf16 operands: launched once per call, two calls bitwise equal;
    output rows with a valid key within one bf16 ulp of the largest plain
    element (both round fp32 sums taken in another order), rows without
    one exactly 0 (the plain version averages V there); at Nq == 1 the
    head-mean probabilities within 1e-6, exactly 0 at masked keys."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, Nq, Hq, Dh), generator=g).to(dev, torch.bfloat16)
    k, v = (torch.randn((B, S, KV, Dh), generator=g).to(dev, torch.bfloat16)
            for _ in range(2))
    bounds = [torch.tensor(x, dtype=torch.int32, device=dev)
              for x in (q_offset, kv_len, kv_start)]
    decode = Nq == 1
    entry = "flash_decode_bf16" if decode else "flash_prefill_bf16"
    other = "flash_prefill_bf16" if decode else "flash_decode_bf16"
    before = backend.launches()

    def kern():
        return flash_attention(q, k, v, causal=True, q_offset=bounds[0],
                               kv_len=bounds[1], kv_start=bounds[2],
                               collect_scores=decode)

    res, again = kern(), kern()
    o_ref, p_ref = attention_causal_plain(q, k, v, *bounds,
                                          collect_probs=decode)
    after = backend.launches()
    assert after[entry] == before[entry] + 2
    assert after[other] == before[other]
    o = res[0] if decode else res
    for x, y in zip(res if decode else (res,),
                    again if decode else (again,)):
        assert torch.equal(x, y)  # bitwise repeatable
    assert o.dtype == torch.bfloat16 and bool(torch.isfinite(o.float()).all())
    pos = torch.tensor(q_offset, device=dev)[:, None] + torch.arange(
        Nq, device=dev)
    real = (pos >= bounds[2][:, None]) & (bounds[2][:, None] < bounds[1][
        :, None])  # rows that see a key
    assert bool((o[~real] == 0).all())
    if bool(real.any()):
        err = (o.float() - o_ref.float()).abs().amax(dim=(2, 3))[real].max()
        assert err <= BF16_ULP * o_ref.float()[real].abs().max()
    if decode:
        scores = res[1]
        keys = torch.arange(S, device=dev)
        masked = (keys < bounds[2][:, None]) | (keys >= bounds[1][:, None])
        assert bool((scores[masked] == 0).all())
        live = real[:, 0]  # the plain version spreads a keyless row evenly
        torch.testing.assert_close(scores[live], p_ref.mean(1)[live],
                                   atol=1e-6, rtol=0)
    return o


def test_causal_kernel_matches_plain_on_card(dev):
    """Both causal kernels at the reduced LM shapes (GQA 4:1, Dh 16:
    left-pad rows, a row behind a compacted prefix, a decode row at the
    buffer's end) and at full-width Minitron-4B (24 query heads over 8 KV
    heads, Dh 128: a 512-token bucket holding prompts of 500 and 384
    tokens, and a batch-4 decode against a 572-slot cache)."""
    _causal_case(dev, 3, 8, 4, 1, 16, 20, [0, 0, 4], [8, 8, 12], [0, 3, 6])
    _causal_case(dev, 3, 1, 4, 1, 16, 20, [7, 12, 19], [8, 13, 20],
                 [0, 5, 2])
    _causal_case(dev, 2, 1, 2, 2, 16, 20, [5, 9], [6, 10], [1, 0])
    for start in (12, 128):
        o = _causal_case(dev, 1, 512, 24, 8, 128, 572, [0], [512], [start])
        assert bool((o[0, :start] == 0).all())  # left-pad rows: no key
    lens = [130, 290, 420, 571]
    _causal_case(dev, 4, 1, 24, 8, 128, 572, [n - 1 for n in lens], lens,
                 [32, 56, 0, 12])


@pytest.mark.parametrize("Dh", [16, 64, 128])
def test_decode_kernel_windows_on_card(dev, Dh):
    """``flash_decode_bf16`` (64 keys per split) at GQA 3:1 over a
    1000-slot cache, one batch row per kind of window: shorter than one
    split, within one split away from its edges (``kv_start`` and
    ``kv_len`` inside it), across a split edge, across 16 splits, no
    valid key (``kv_start`` at ``kv_len``: output and probabilities 0),
    and across 11 splits from a ``kv_start`` inside the first. Each row
    decodes the last token of its cache (``q_offset`` = ``kv_len`` - 1),
    as the engine does: the plain probabilities mask by ``kv_len``
    alone."""
    lens = [5, 120, 140, 1000, 40, 700]
    starts = [0, 70, 60, 20, 40, 3]
    offs = [n - 1 for n in lens]
    o = _causal_case(dev, 6, 1, 6, 2, Dh, 1000, offs, lens, starts, seed=1)
    assert bool((o[4] == 0).all())


@pytest.mark.parametrize("Dh", [16, 64, 128])
@pytest.mark.parametrize("Hq,KV", [(6, 2), (8, 2)])
def test_prefill_kernel_shapes_on_card(dev, Dh, Hq, KV):
    """``flash_prefill_bf16`` at GQA 3:1 and 4:1: 37 positions (row
    counts 111 and 148, not multiples of the 64-row tile), two batch rows
    with other windows: a prompt after 30 cached keys whose first 9 are
    pruned away, and a left-padded prompt (``kv_start`` 20 at
    ``q_offset`` 0: its first 20 rows see no key)."""
    _causal_case(dev, 2, 37, Hq, KV, Dh, 90, [30, 0], [67, 37], [9, 20],
                 seed=2)


def test_causal_kernels_bitwise_repeatable_across_serves(dev):
    """Two serves of the reduced Minitron-4B on the card at pipeline
    depths 1 and 2 give identical tokens: the decode kernel's split
    combine takes its sums in a fixed order."""
    cfg = MINITRON_4B.reduced()
    params = serving_params(cfg, M.init_params(
        cfg, torch.Generator(dev).manual_seed(0), device=dev))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (70, 9, 130)]
    outs = []
    for depth in (1, 2):
        eng = ServeEngine(cfg, params, EngineConfig(
            max_batch=3, max_len=200, pipeline_depth=depth), device=dev)
        outs.append(eng.serve([Request(uid=i, prompt=p, max_new_tokens=12)
                               for i, p in enumerate(prompts)],
                              continuous=True))
    assert outs[0] == outs[1]


def _teacher_forced_gaps(cfg, params, req, dev):
    """For each token the engine generated, the offline forward's
    (no cache, B=1) largest logit at that position minus its logit for
    the engine's token."""
    seq = np.concatenate([req.prompt, req.generated[:-1]]).astype(np.int64)
    logits = M.forward_lm(cfg, params, torch.from_numpy(seq)[None].to(dev),
                          logits_for="all").logits[0]
    rows = logits[len(req.prompt) - 1:]
    chosen = rows.gather(1, torch.tensor(req.generated, device=dev)[:, None])
    return (rows.max(dim=1).values - chosen[:, 0]).cpu().numpy()


@pytest.mark.parametrize("continuous", [False, True])
def test_lm_engine_on_card_matches_oracle(dev, continuous):
    """Reduced Minitron-4B (bf16 activations, GQA 4:1) served on the card
    through the causal kernels, each launched once per layer of its own
    calls (prefill and decode): every request gets its tokens, the engine
    waits on the card only at step boundaries, and each token's logit in
    the teacher-forced offline forward lies within 0.05 of that position's
    largest (the CPU bound against the reference); with KV pruning on,
    prunes fire and every request still gets its tokens."""
    cfg = MINITRON_4B.reduced()
    params = serving_params(cfg, M.init_params(
        cfg, torch.Generator(dev).manual_seed(0), device=dev))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 17, 11, 30, 8)]
    for keep in (1.0, 0.5):
        eng = ServeEngine(cfg, params, EngineConfig(
            max_batch=3, max_len=64, kv_prune_keep=keep,
            kv_prune_interval=2 if keep < 1 else 0), device=dev)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=10)
                for i, p in enumerate(prompts)]
        backend.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = eng.serve(reqs, continuous=continuous)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert sorted(out) == list(range(5))
        assert all(len(t) == 10 for t in out.values())
        st = eng.stats()
        calls = (st["runner_prefill_calls"] + st["runner_prefill_slot_calls"]
                 + st["runner_decode_calls"])
        assert st["runner_decode_calls"] > 0
        n = backend.launches()
        assert n["flash_decode_bf16"] == \
            cfg.num_layers * st["runner_decode_calls"]
        assert n["flash_prefill_bf16"] == cfg.num_layers * (
            calls - st["runner_decode_calls"])
        if keep < 1:
            assert st["prune_events"] > 0
            continue
        for r in reqs:
            assert _teacher_forced_gaps(cfg, params, r, dev).max() <= 0.05


@pytest.mark.parametrize("kind", ["vision", "lm"])
def test_trace_replay_on_card_same_at_both_depths(dev, kind):
    """A short bursty trace replayed on the card through
    ``serve_trace.build_driver`` and ``TrafficHarness`` at the reduced
    configs (DeiT-Small with half the requests soft-pruned; StableLM-1.6B
    at bf16): every request served, the path's kernels launched, no host
    wait besides the step events, lifecycles, reports and outputs digests
    identical at pipeline depths 1 and 2, and the lifecycle equal to the
    same replay on the CPU (plans are host decisions)."""
    from repro_torch.launch.serve_trace import build_driver
    from repro_torch.traffic import TraceSpec, TrafficHarness, make_trace
    if kind == "vision":
        spec = TraceSpec(n=8, rate_rps=60000.0, process="bursty",
                         sizes=(16, 9, 4), r_ts=(None, 0.7),
                         deadlines_ms=(0.05, None), soft_prob=0.5)
        kernels = ("sbmm_f32", "flash_attention_f32", "token_drop_f32",
                   "token_package_f32")
    else:
        spec = TraceSpec(n=6, rate_rps=150.0, process="bursty", kind="lm",
                         prompt_sizes=(8, 16, 40), max_new_tokens=6,
                         deadlines_ms=(80.0, None))
        kernels = ("flash_prefill_bf16", "flash_decode_bf16")
    trace = make_trace(spec, seed=9)
    runs = []
    for depth, device in ((1, dev), (2, dev), (1, "cpu")):
        h = TrafficHarness(build_driver(kind, "", 2, 0, depth, "strict",
                                        0.4, 1.0, max_len=128,
                                        device=device))
        backend.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            rep = h.run(trace)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert rep["completed"] == len(trace.requests)
        if device != "cpu":
            n = backend.launches()
            assert all(n[k] > 0 for k in kernels), n
        runs.append((h.lifecycle(), rep))
    assert runs[0] == runs[1]
    assert runs[2][0] == runs[0][0]
    strip = [{k: v for k, v in rep.items() if k != "outputs_digest"}
             for _, rep in (runs[0], runs[2])]
    assert strip[0] == strip[1]


# ---------------------------------------------------------------------------
# Training (Algorithm 1): plain PyTorch on the card, no kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["block", "col", "row"])
def test_ste_gradient_on_card_matches_cpu(dev, kind):
    """The STE mask and the score gradient (the block, column or row sum
    of g ⊙ W) on the card against the CPU, with ties at the threshold:
    masks and the weight gradient equal, the score gradient within 1e-5
    relative to max(1, max|ref|) (fp32 sums in another order)."""
    from repro_torch.core import block_pruning as BP
    rng = np.random.default_rng(0)
    w = rng.standard_normal((40, 56)).astype(np.float32)
    cot = rng.standard_normal((40, 56)).astype(np.float32)
    shape = {"block": BP.score_shape(w.shape, 16), "col": (56,),
             "row": (40,)}[kind]
    s = (rng.integers(0, 4, size=shape) * 0.25).astype(np.float32)
    out = {}
    for d in ("cpu", dev):
        wt = torch.tensor(w, device=d, requires_grad=True)
        st = torch.tensor(s, device=d, requires_grad=True)
        if kind == "block":
            mw = BP.masked_weight(wt, st, 0.5, 16)
        else:
            mw = BP.masked_weight_vector(wt, st, 0.5,
                                         1 if kind == "col" else 0)
        gw, gs = torch.autograd.grad(
            (mw * torch.tensor(cot, device=d)).sum(), (wt, st))
        out[str(d)] = [t.detach().cpu() for t in (mw, gw, gs)]
    (mc, gwc, gsc), (mg, gwg, gsg) = out["cpu"], out[str(dev)]
    assert torch.equal(mc, mg) and torch.equal(gwc, gwg)
    assert ((gsg - gsc).abs().max() / max(1.0, gsc.abs().max())) <= 1e-5


@pytest.mark.parametrize("eps", [1e-8, 1.0])
def test_simultaneous_step_on_card_matches_cpu(dev, monkeypatch, eps):
    """One Algorithm-1 step of the reduced DeiT-Small from step 5 (the
    student on a blend of dense and STE-masked weights) on the card against
    the same step on the CPU: kept token indices at every TDM first, then
    the loss parts within 1e-5 relative, then params and scores after the
    update relative to max(1, |ref|): within 0.25·lr at the paper's eps
    and lr 2e-3 (2·lr for the key biases, whose exact gradient is 0),
    within 1e-5 at lr = eps = 1 (``tests/test_torch_train.py`` gives the
    reasons). No kernel wrapper launches."""
    from repro_torch.core import simultaneous as SIM
    from repro_torch.data import DataConfig, synthetic_vit_batch
    from repro_torch.optim import AdamW
    from repro_torch.tree import flatten_with_path, tree_map
    cfg = DEIT_SMALL.reduced()
    lr = 2e-3 if eps < 1.0 else 1.0
    opt = AdamW(lr=lr, eps=eps)
    state, _ = SIM.init_state(cfg, torch.Generator().manual_seed(0), opt,
                              device="cpu")
    state = state._replace(step=torch.tensor(5, dtype=torch.int32))
    teacher = M.init_params(cfg, torch.Generator().manual_seed(9), "cpu")
    step = SIM.make_simultaneous_step(cfg, cfg, opt, 20)
    b = synthetic_vit_batch(cfg, 8, DataConfig(seed=0), 0)
    inner = TTP.tdm
    res = {}
    backend.reset_launches()
    for d in ("cpu", dev):
        kept = []

        def tdm(*a, **kw):
            o = inner(*a, **kw)
            kept.append(o[1].cpu())
            return o
        monkeypatch.setattr(TTP, "tdm", tdm)
        new, m = step(tree_map(lambda t: t.to(d), state),
                      tree_map(lambda t: t.to(d), teacher),
                      {k: torch.from_numpy(v).to(d) for k, v in b.items()})
        res[str(d)] = (kept, tree_map(lambda t: t.cpu(), new),
                       {k: v.item() for k, v in m.items()})
    assert not any(backend.launches().values())
    (kc, nc, mc), (kg, ng, mg) = res["cpu"], res[str(dev)]
    assert len(kc) == len(kg) == len(cfg.pruning.tdm_layers)
    for a, c in zip(kg, kc):
        assert torch.equal(a, c)
    for k in mc:
        assert abs(mg[k] - mc[k]) <= 1e-5 * max(1.0, abs(mc[k])), k
    for tree_g, tree_c in ((ng.params, nc.params), (ng.scores, nc.scores)):
        for (path, a), (_, c) in zip(flatten_with_path(tree_g),
                                     flatten_with_path(tree_c)):
            tol = (1e-5 if eps >= 1.0 else
                   (2.0 if path[-1] == "bk" else 0.25) * lr)
            err = (a - c).abs().max() / max(1.0, c.abs().max())
            assert err <= tol, path


# ---------------------------------------------------------------------------
# LM training: the causal kernel pair (forward with lse, backward)
# ---------------------------------------------------------------------------
def _train_inputs(dev, B, N, Hq, KV, Dh, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, N, Hq, Dh), generator=g).to(dev, torch.bfloat16)
    k, v = (torch.randn((B, N, KV, Dh), generator=g).to(dev, torch.bfloat16)
            for _ in range(2))
    do = torch.randn((B, N, Hq, Dh), generator=g).to(dev, torch.bfloat16)
    return q, k, v, do


TRAIN_CASES = [  # B, N, Hq, KV, Dh, kv_start
    (2, 37, 4, 1, 16, None), (2, 37, 4, 1, 16, [0, 9]),
    (1, 130, 8, 2, 64, [5]), (2, 65, 4, 4, 64, None),
    (1, 512, 32, 32, 64, None), (2, 200, 6, 2, 64, [0, 70]),
    # the backward's tiling: N not a multiple of its 64-position tile under
    # GQA 3:1 (kv_start inside a tile, and one row past a whole tile), a
    # walk of 16 query tiles, and at Dh 16 work lists of 512 and 1024 items,
    # more than the blocks the card holds (each walks several items through
    # both of its fixed slots)
    (1, 100, 6, 2, 64, [0]), (2, 130, 24, 8, 64, [3, 70]),
    (1, 1024, 8, 2, 64, [100]), (8, 512, 16, 8, 16, None)]


@pytest.mark.parametrize("case", TRAIN_CASES,
                         ids=lambda c: f"B{c[0]}-N{c[1]}-{c[2]}x{c[3]}-"
                                       f"Dh{c[4]}-{'start' if c[5] else 'all'}")
def test_prefill_lse_and_serve_output_on_card(dev, case):
    """``flash_prefill_bf16`` asked for the log-sum-exp writes the same o,
    bit for bit, as with a null lse (the serve's call); its lse within 1e-5
    of max(1, max|plain|) of the plain ``logsumexp`` at rows with a key
    (fp32 sums in another order), -inf at rows without one."""
    B, N, Hq, KV, Dh, start = case
    q, k, v, _ = _train_inputs(dev, B, N, Hq, KV, Dh)
    st = None if start is None else torch.tensor(start, dtype=torch.int32,
                                                 device=dev)
    o_serve, _ = FA._causal_cuda(q, k, v, None, None, st, False)
    o, lse = FA._causal_cuda(q, k, v, None, None, st, False, with_lse=True)
    assert torch.equal(o, o_serve)
    assert torch.equal(o_serve, flash_attention(q, k, v, causal=True,
                                                kv_start=st))
    ref = attention_causal_lse_plain(q, k, st)
    real = torch.ones((B, N), dtype=torch.bool, device=dev)
    if st is not None:
        real = torch.arange(N, device=dev)[None] >= st[:, None]
    real = real[:, None, :].expand(B, Hq, N)
    assert bool(torch.isinf(lse[~real]).all()) and bool(
        (lse[~real] < 0).all())
    err = (lse[real] - ref[real]).abs().max().item()
    assert err <= 1e-5 * max(1.0, ref[real].abs().max().item())


@pytest.mark.parametrize("case", TRAIN_CASES,
                         ids=lambda c: f"B{c[0]}-N{c[1]}-{c[2]}x{c[3]}-"
                                       f"Dh{c[4]}-{'start' if c[5] else 'all'}")
def test_prefill_bwd_kernel_matches_plain_on_card(dev, case):
    """``flash_prefill_bwd_bf16`` through autograd (``flash_attention`` on
    inputs that require grad takes ``CausalAttention``: one forward and
    one backward launch) against ``attention_causal_bwd_plain`` on the
    same o, dO and lse: dq, dk, dv each within one bf16 ulp of its largest
    plain element (both round fp32 sums taken in another order). Pad rows
    (no key, where a ``kv_start`` is given) get dO = 0, as a loss that
    ignores them gives: the kernel's forward writes 0 there and the plain
    version averages V, so with dO = 0 both add nothing."""
    B, N, Hq, KV, Dh, start = case
    q, k, v, do = _train_inputs(dev, B, N, Hq, KV, Dh, seed=1)
    st = None if start is None else torch.tensor(start, dtype=torch.int32,
                                                 device=dev)
    if st is not None:
        pad = torch.arange(N, device=dev)[None] < st[:, None]
        do = do.masked_fill(pad[:, :, None, None], 0)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = backend.launches()
    o = flash_attention(*leaves, causal=True, kv_start=st)
    got = torch.autograd.grad(o, leaves, do)
    after = backend.launches()
    assert after["flash_prefill_bf16"] == before["flash_prefill_bf16"] + 1
    assert after["flash_prefill_bwd_bf16"] == \
        before["flash_prefill_bwd_bf16"] + 1
    _, lse = FA._causal_cuda(q, k, v, None, None, st, False, with_lse=True)
    ref = attention_causal_bwd_plain(q, k, v, o.detach(), do, lse, st)
    for name, a, r in zip("qkv", got, ref):
        assert a.dtype == torch.bfloat16 and a.shape == r.shape
        assert bool(torch.isfinite(a.float()).all()), name
        err = (a.float() - r.float()).abs().max().item()
        assert err <= BF16_ULP * r.float().abs().max().item(), (name, err)
    again = torch.autograd.grad(
        flash_attention(*leaves, causal=True, kv_start=st), leaves, do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_prefill_bwd_kernels_issue_wgmma(dev):
    """Both kernels of the backward library (dQ, dK/dV) at each head width
    run their products on wgmma: their SASS holds HGMMA and no HMMA."""
    counts, fn = {}, None
    for line in backend.disassemble("flash_prefill_bwd").splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = {"HGMMA": 0, "HMMA": 0}
        elif fn is not None:
            for op in ("HGMMA", "HMMA"):
                counts[fn][op] += op in line
    kernels = {f: c for f, c in counts.items() if "_kernel" in f}
    assert len(kernels) == 2 * len(
        FA.CAUSAL_HEAD_DIMS["flash_prefill_bwd_bf16"]), sorted(counts)
    for f, c in kernels.items():
        assert c["HGMMA"] > 0 and c["HMMA"] == 0, (f, c)


def test_causal_attention_with_grad_raises_on_card(dev):
    """What the backward kernel does not take raises: head width 128, the
    decode form, q_offset / kv_len, other dtypes."""
    q, k, v, _ = _train_inputs(dev, 1, 8, 2, 2, 128)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q.requires_grad_(True), k, v, causal=True)
    q, k, v, _ = _train_inputs(dev, 1, 8, 2, 2, 64)
    q.requires_grad_(True)
    with pytest.raises(ValueError, match="whole-sequence"):
        flash_attention(q[:, :1], k, v, causal=True)
    with pytest.raises(ValueError, match="kv_start only"):
        flash_attention(q, k, v, causal=True, kv_len=torch.full(
            (1,), 8, dtype=torch.int32, device=dev))
    with pytest.raises(TypeError, match="bf16"):
        flash_attention(q.float(), k.float(), v.float(), causal=True)


def test_lm_train_step_on_card_launches_and_matches_cpu(dev):
    """The gradient of the pruned reduced StableLM-1.6B's loss (3 layers,
    Dh 16, full remat) on the card (bf16 activations, the kernels) against
    the CPU (bf16 activations, plain attention): the forward kernel twice
    per layer (the forward and its recompute), the backward once, no other
    causal kernel; the loss within 1e-2 relative and each gradient leaf
    within 5e-2 of its largest CPU element (bf16 activations rounded at
    other places)."""
    from repro_torch.configs import STABLELM_1_6B
    from repro_torch.data import DataConfig, synthetic_lm_batch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import steps as ST
    from repro_torch.tree import flatten_with_path, tree_map
    cfg = STABLELM_1_6B.reduced()
    cfg = cfg.replace(pruning=type(cfg.pruning)(block_size=16, r_b=0.5,
                                                r_t=1.0))
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    scores = PG.init_scores(cfg, params, torch.Generator().manual_seed(7))
    b = synthetic_lm_batch(cfg, ShapeConfig("t", 64, 2, "train"),
                           DataConfig(), 0)
    fn = ST.make_grad_fn(cfg, with_pruning=True)
    res = {}
    for d in ("cpu", dev):
        backend.reset_launches()
        loss, _, g = fn(tree_map(lambda t: t.to(d), params), {
            "tokens": torch.from_numpy(b["tokens"]).to(d)},
            tree_map(lambda t: t.to(d), scores))
        res[str(d)] = (loss.item(), tree_map(lambda t: t.cpu(), g),
                       backend.launches())
    (lc, gc, nc), (lg, gg, ng) = res["cpu"], res[str(dev)]
    assert not any(nc.values())
    L = cfg.num_layers
    assert {k: v for k, v in ng.items() if v} == {
        "flash_prefill_bf16": 2 * L, "flash_prefill_bwd_bf16": L}
    assert abs(lg - lc) <= 1e-2 * abs(lc)
    for (path, a), (_, c) in zip(flatten_with_path(gg),
                                 flatten_with_path(gc)):
        assert bool(torch.isfinite(a).all()), path
        assert (a - c).abs().max() <= 5e-2 * c.abs().max(), path
