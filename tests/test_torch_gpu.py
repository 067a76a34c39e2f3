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
from repro_torch.kernels.ssm_scan import ops as SS
from repro_torch.kernels.ssm_scan.ops import CHUNK_MIN as SS_CHUNK_MIN
from repro_torch.kernels.token_drop import token_drop, token_drop_plain
from repro_torch.kernels.token_drop import ops as TD
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


def _device_kernels(fn, n=10, windows=4):
    """(name, launches) of the device work of ``n`` calls of ``fn``, from
    the first profiled window after a warm-up window (a process's first
    session can miss its first kernel) that holds device records, of at
    most ``windows``: the profiler has been seen to return a whole window
    without any, on the card as in ``chip_smoke.profile_run``. A call that
    launches nothing gives no records in every window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(windows + 1):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.count) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        if attempt > 0 and rows:
            break
    return rows


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

    kernels = _device_kernels(lambda: sbmm(x, q), n=20)
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


# the non-causal bf16 forms (label, q shape, k/v shape): Whisper-base's
# encoder self-attention, its cross-attention at prefill (a 32-token
# bucket) and decode over 1500 audio frames; Llama-3.2-Vision-90B's gated
# cross layers at prefill (64 tokens) and decode over 1601 vision tokens;
# Dh 16 at 8 and 33 keys (the reduced configs); then a case for each
# branch of the kernels' design (on a 132-SM card): the prefill over split
# keys with two warpgroups a block (8 chunks of 1000 keys) and over whole
# keys with one (Dh 128, 50 keys); the tensor-core decode at GQA 8:1 whose
# last split holds one key (65 keys in 2 splits: three warps see none of
# it), and at 32 heads a group (two head tiles, 100 keys)
NONCAUSAL_CASES = (
    ("whisper encoder", (4, 1500, 8, 64), (4, 1500, 8, 64)),
    ("whisper cross prefill", (4, 32, 8, 64), (4, 1500, 8, 64)),
    ("whisper cross decode", (4, 1, 8, 64), (4, 1500, 8, 64)),
    ("vision cross prefill", (2, 64, 64, 128), (2, 1601, 8, 128)),
    ("vision cross decode", (2, 1, 64, 128), (2, 1601, 8, 128)),
    ("Dh 16, 8 keys", (3, 5, 4, 16), (3, 8, 1, 16)),
    ("Dh 16, 33 keys", (3, 1, 4, 16), (3, 33, 1, 16)),
    ("Dh 16, 33 keys, prefill", (3, 70, 4, 16), (3, 33, 1, 16)),
    ("split keys, two warpgroups", (2, 48, 16, 64), (2, 1000, 2, 64)),
    ("whole keys, Dh 128", (2, 40, 8, 128), (2, 50, 8, 128)),
    ("decode GQA 8:1, 65 keys", (1, 1, 8, 64), (1, 65, 1, 64)),
    ("decode 32 heads a group", (2, 1, 32, 128), (2, 100, 1, 128)),
)


@pytest.mark.parametrize("case", NONCAUSAL_CASES, ids=lambda c: c[0])
def test_noncausal_bf16_kernels_match_plain_on_card(dev, case):
    """The non-causal bf16 kernels through the wrapper (any Nq and Nk,
    GQA): one launch of the prefill entry point (Nq > 1) or the decode
    entry point (Nq == 1) per call, counted under its non-causal form and
    not under the other; two calls bitwise equal; every row within one
    bf16 ulp of the largest element of the plain version (both round fp32
    sums taken in another order)."""
    _, q_shape, kv_shape = case
    g = torch.Generator().manual_seed(11)
    q = torch.randn(q_shape, generator=g).to(dev, torch.bfloat16)
    k, v = (torch.randn(kv_shape, generator=g).to(dev, torch.bfloat16)
            for _ in range(2))
    decode = q_shape[1] == 1
    entry = "flash_decode_bf16" if decode else "flash_prefill_bf16"
    form = entry + "/noncausal"
    before, forms = backend.launches(), backend.form_launches()
    o, again = flash_attention(q, k, v), flash_attention(q, k, v)
    ref = FA.attention_noncausal_plain(q, k, v)
    torch.cuda.synchronize()
    assert backend.launches()[entry] == before[entry] + 2
    assert sum(backend.launches().values()) == sum(before.values()) + 2
    assert backend.form_launches()[form] == forms[form] + 2
    assert torch.equal(o, again)
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    err = (o.float() - ref.float()).abs().max()
    assert err <= BF16_ULP * ref.float().abs().max()


@pytest.mark.parametrize("arch", ["whisper-base", "llama-3.2-vision-90b"])
def test_multimodal_serve_steps_on_card_match_cpu(dev, arch):
    """The reduced Whisper-base and Llama-3.2-Vision-90B (gates 1.0) through
    ``make_prefill`` and ``make_decode_step`` at fp32 weights and bf16
    activations: the non-causal kernels launch once per cross-attention
    (and encoder) layer of every step, and the greedy tokens of 6 steps on
    the card hold the teacher-forced oracle on the CPU (plain versions,
    the same weights): each within 0.05 of its position's largest
    logit."""
    from repro_torch.configs import get_config
    from repro_torch.models import steps as ST
    from repro_torch.tree import tree_map
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    if cfg.family == "vlm":
        for c in params["stages"]["cross"]:
            c["gate"] = torch.ones(())
    name = "vision_embeds" if cfg.family == "vlm" else "audio_frames"
    n_mod = (cfg.num_vision_tokens if cfg.family == "vlm"
             else cfg.num_audio_frames)
    rng = np.random.default_rng(0)
    lens = (3, 7)
    B, Lp, n_new = 2, 7, 6
    toks = np.zeros((B, Lp), np.int64)
    for b, n in enumerate(lens):
        toks[b, Lp - n:] = rng.integers(0, cfg.vocab_size, n)
    start = np.array([Lp - n for n in lens], np.int32)
    x = rng.standard_normal((B, n_mod, cfg.d_model)).astype(np.float32)
    card = tree_map(lambda t: t.to(dev), params)
    backend.reset_launches()
    tok, caches = ST.make_prefill(cfg)(card, {
        "tokens": torch.from_numpy(toks).to(dev),
        "valid_start": torch.from_numpy(start).to(dev),
        name: torch.from_numpy(x).to(dev)},
        ST.init_caches(cfg, B, Lp + n_new, device=dev))
    out = [tok]
    decode = ST.make_decode_step(cfg)
    vis = torch.from_numpy(x).to(dev) if cfg.family == "vlm" else None
    for _ in range(n_new - 1):
        tok, caches = decode(card, out[-1][:, None], caches,
                             vision_embeds=vis,
                             valid_start=torch.from_numpy(start).to(dev))
        out.append(tok)
    forms = backend.form_launches()
    n_cross = (M.vlm_layout(cfg)[0] if cfg.family == "vlm"
               else cfg.num_layers)
    n_enc = 0 if cfg.family == "vlm" else cfg.encoder_layers
    assert forms["flash_prefill_bf16/noncausal"] == n_cross + n_enc
    assert forms["flash_decode_bf16/noncausal"] == n_cross * (n_new - 1)
    gen = torch.stack(out, dim=1).cpu()
    for b, n in enumerate(lens):
        seq = torch.cat([torch.from_numpy(toks[b, Lp - n:]), gen[b, :-1]])
        logits = M.forward_lm(cfg, params, seq[None], **{
            name: torch.from_numpy(x[b:b + 1])}).logits[0, n - 1:]
        gap = logits.max(dim=1).values - logits.gather(
            1, gen[b][:, None])[:, 0]
        assert gap.max().item() <= 0.05


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


def _count_plain_vit(monkeypatch):
    """Count calls of the plain versions of the ViT training path's
    kernels and of what they are made of, by name."""
    from repro_torch.models import attention as A
    names = ((FA, "attention_plain"), (FA, "attention_bwd_plain"),
             (A, "flash_attention_torch"), (A, "attention_probs_row"),
             (TTP, "tdm"), (TD, "token_drop_plain"),
             (TD, "token_drop_bwd_plain"))
    calls = {name: 0 for _, name in names}
    for mod, name in names:
        def call(*a, _fn=getattr(mod, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, call)
    return calls


@pytest.mark.parametrize("shape", [(2, 17, 4, 16), (3, 70, 6, 64),
                                   (2, 197, 6, 64), (2, 1, 3, 64),
                                   (2, 33, 3, 64), (3, 72, 6, 64),
                                   (2, 100, 6, 64), (2, 140, 6, 64),
                                   (2, 197, 4, 16), (2, 300, 3, 64),
                                   (1, 600, 2, 64)])
@pytest.mark.parametrize("dprobs_form", ["none", "broadcast", "slice"])
def test_noncausal_attention_bwd_on_card(dev, shape, dprobs_form):
    """The training pair of the non-causal fp32 kernel against the plain
    versions: the forward writing lse (o and probs bitwise the serve's,
    lse within 1e-5) and ``flash_attention_bwd_f32`` (one launch a call;
    dq, dk, dv within 1e-5 x max(1, max|plain|), two launches bitwise
    equal), without the CLS probabilities' gradient and with it as the
    training step passes it (a broadcast view of dscores / H, stride 0
    over heads) and as a slice of a larger tensor (strides other than
    [H N, N, 1]); N from 1 to 600 (one key tile, one row and one key past
    a tile, several tiles in a cluster of up to 5 blocks at 300, two rounds
    of key tiles a block at 600); then ``flash_attention`` with grad on the
    card against autograd of the plain version on the CPU."""
    B, N, H, Dh = shape
    g = torch.Generator().manual_seed(21)
    q, k, v, do = (torch.randn(shape, generator=g) for _ in range(4))
    dsc = torch.randn((B, N), generator=g)
    qc, kc, vc, doc = (t.to(dev) for t in (q, k, v, do))
    o, probs, lse = FA._attention_cuda(qc, kc, vc, None, True,
                                       with_lse=True)
    o_s, probs_s, _ = FA._attention_cuda(qc, kc, vc, None, True)
    assert torch.equal(o, o_s) and torch.equal(probs, probs_s)
    lse_ref = FA.attention_lse_plain(qc, kc)
    assert (lse - lse_ref).abs().max() <= 1e-5 * max(1.0,
                                                     lse_ref.abs().max())
    dprobs = None
    if dprobs_form == "broadcast":
        dprobs = (dsc.to(dev)[:, None, :] / H).expand(B, H, N)
        assert dprobs.stride(1) == 0
    elif dprobs_form == "slice":
        big = torch.randn((B + 1, H + 2, N + 3), generator=g).to(dev)
        dprobs = big[1:, 1:H + 1, 2:N + 2]
        assert not dprobs.is_contiguous()
    before = backend.launches()["flash_attention_bwd_f32"]
    res = FA._attention_bwd_cuda(qc, kc, vc, o, doc, lse, dprobs)
    again = FA._attention_bwd_cuda(qc, kc, vc, o, doc, lse, dprobs)
    ref = FA.attention_bwd_plain(qc, kc, vc, o, doc, lse, dprobs)
    torch.cuda.synchronize()
    assert backend.launches()["flash_attention_bwd_f32"] == before + 2
    for a, b, r in zip(res, again, ref):
        assert torch.equal(a, b)
        assert (a - r).abs().max() <= 1e-5 * max(1.0, r.abs().max())
    if dprobs_form == "slice":
        return  # the autograd route below passes the broadcast form
    with_scores = dprobs_form == "broadcast"
    got = []
    for d in ("cpu", dev):
        t = [x.to(d).requires_grad_(True) for x in (q, k, v)]
        oo, sc = flash_attention(*t, collect_scores=True)
        loss = (oo * do.to(d)).sum()
        if with_scores:
            loss = loss + (sc * dsc.to(d)).sum()
        got.append([x.cpu() for x in torch.autograd.grad(loss, t)])
    for a, c in zip(got[1], got[0]):
        assert (a - c).abs().max() <= 1e-5 * max(1.0, c.abs().max())


@pytest.mark.parametrize("case", [(3, 17, 64, 12), (4, 197, 384, 138),
                                  (2, 100, 384, 70)])
@pytest.mark.parametrize("ties", [False, True])
def test_token_drop_bwd_on_card(dev, case, ties):
    """The TDM's training pair against the plain versions: the forward's
    kept indices the plain version's and its output bitwise the serve's;
    ``token_drop_bwd_f32``'s dz bitwise at CLS and the kept rows, dropped
    rows and dscores within 1e-6 x max(1, max|plain|), dscores 0 at CLS
    and the kept rows, two launches bitwise equal; then ``token_drop``
    with grad on the card against autograd of ``TP.tdm`` on the CPU."""
    B, N, D, k = case
    g = torch.Generator().manual_seed(22)
    z = torch.randn((B, N, D), generator=g)
    s = (torch.randint(0, 3, (B, N), generator=g).float() / 8 if ties
         else torch.rand((B, N), generator=g))
    dy = torch.randn((B, k + 2, D), generator=g)
    zc, sc, dyc = z.to(dev), s.to(dev), dy.to(dev)
    out, idx = TD._token_drop_cuda(zc, sc, k, True)
    assert torch.equal(out, token_drop(zc, sc, k))
    assert torch.equal(idx.long(),
                       TTP.tdm(zc, sc, None, has_cls=True, k=k)[1])
    res = TD._token_drop_bwd_cuda(zc, sc, idx, out, dyc)
    again = TD._token_drop_bwd_cuda(zc, sc, idx, out, dyc)
    dz_ref, ds_ref = TD.token_drop_bwd_plain(zc, sc, idx, out, dyc)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(res, again))
    dz, ds = res
    rows = torch.arange(B, device=dev)[:, None]
    kept = torch.cat([torch.zeros_like(idx[:, :1]), 1 + idx], 1).long()
    assert torch.equal(dz[rows, kept], dz_ref[rows, kept])
    assert bool((ds[rows, kept] == 0).all())
    for a, r in ((dz, dz_ref), (ds, ds_ref)):
        assert (a - r).abs().max() <= 1e-6 * max(1.0, r.abs().max())
    got = []
    for d in ("cpu", dev):
        tz, ts = (x.to(d).requires_grad_(True) for x in (z, s))
        o = token_drop(tz, ts, k)
        got.append((o.detach().cpu(), [x.cpu() for x in torch.autograd.grad(
            (o * dy.to(d)).sum(), (tz, ts))]))
    assert torch.equal(got[1][0], out.cpu())
    for a, c in zip(got[1][1], got[0][1]):
        assert (a - c).abs().max() <= 1e-6 * max(1.0, c.abs().max())


@pytest.mark.parametrize("eps", [1e-8, 1.0])
def test_simultaneous_step_on_card_matches_cpu(dev, monkeypatch, eps):
    """One Algorithm-1 step of the reduced DeiT-Small from step 5 (the
    student on a blend of dense and STE-masked weights) on the card against
    the same step on the CPU: kept token indices at every TDM first, then
    the loss parts within 1e-5 relative, then params and scores after the
    update relative to max(1, |ref|): within 0.25·lr at the paper's eps
    and lr 2e-3 (2·lr for the key biases, whose exact gradient is 0),
    within 1e-5 at lr = eps = 1 (``tests/test_torch_train.py`` gives the
    reasons). On the card the step launches the attention forward at every
    layer of student and teacher, its backward at every student layer and
    the TDM forward and backward at every TDM, nothing else, and no plain
    version of attention or the TDM runs there."""
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
    res = {}
    kept = []

    def card_drop(*a, _inner=TD._token_drop_cuda, **kw):
        o = _inner(*a, **kw)
        kept.append(o[1].long().cpu())
        return o

    def plain_drop(*a, _inner=TTP.tdm, **kw):
        o = _inner(*a, **kw)
        kept.append(o[1].long().cpu())
        return o
    # the kept indices: the kernel's index output on the card (training
    # asks for it), TP.tdm's on the CPU
    monkeypatch.setattr(TD, "_token_drop_cuda", card_drop)
    monkeypatch.setattr(TTP, "tdm", plain_drop)
    plain = _count_plain_vit(monkeypatch)
    for d in ("cpu", dev):
        kept = []
        backend.reset_launches()
        for name in plain:
            plain[name] = 0
        new, m = step(tree_map(lambda t: t.to(d), state),
                      tree_map(lambda t: t.to(d), teacher),
                      {k: torch.from_numpy(v).to(d) for k, v in b.items()})
        res[str(d)] = (kept, tree_map(lambda t: t.cpu(), new),
                       {k: v.item() for k, v in m.items()})
    L, T = cfg.num_layers, len(cfg.pruning.tdm_layers)
    want = {name: 0 for name in backend.ENTRY_POINTS}
    want.update(flash_attention_f32=2 * L, flash_attention_bwd_f32=L,
                token_drop_f32=T, token_drop_bwd_f32=T)
    assert backend.launches() == want
    assert not any(plain.values()), plain
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
    (1, 1024, 8, 2, 64, [100]), (8, 512, 16, 8, 16, None),
    # Granite-MoE-3B-A800M's training step: GQA 3:1, Dh 64, 8 x 512
    (8, 512, 24, 8, 64, None),
    # Dh 128 (a dK / dV item all 128 columns, two warpgroups handing P^T
    # over): ragged under GQA 4:1 with a kv_start, MHA, and
    # Llama-3.2-Vision-90B's self-attention; a kv_start inside a tile under
    # GQA 8:1; 12 items, fewer than the SMs; 512 items, several times the
    # resident blocks (hand-off buffers and fixed slots cycle over items)
    (1, 130, 8, 2, 128, [5]), (2, 100, 8, 8, 128, None),
    (2, 512, 64, 8, 128, None), (2, 200, 16, 2, 128, [0, 70]),
    (2, 130, 16, 2, 128, None), (4, 1024, 16, 8, 128, [0, 300, 0, 7])]


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


# the non-causal training pair: B, Nq, Nk, Hq, KV, Dh (Nq != Nk, GQA 8:1,
# ragged tiles both ways: Nq < 64 < Nk, Nk = 65; Whisper's encoder and
# cross-attention and Llama-3.2-Vision's cross layer at small B; at Dh 128
# 4 dK / dV items, fewer than the SMs, and 416, several times the resident
# blocks)
NONCAUSAL_TRAIN_CASES = [
    (2, 5, 65, 8, 1, 16), (3, 70, 33, 4, 1, 16), (2, 130, 200, 16, 2, 16),
    (2, 300, 300, 8, 8, 64), (2, 64, 1500, 8, 8, 64),
    (1, 100, 129, 4, 4, 64), (1, 130, 1601, 64, 8, 128),
    (2, 33, 70, 8, 1, 128), (2, 256, 1601, 64, 8, 128)]


def _noncausal_train_inputs(dev, case, seed=0):
    B, Nq, Nk, Hq, KV, Dh = case
    g = torch.Generator().manual_seed(seed)
    rand = lambda *s: torch.randn(s, generator=g).to(dev, torch.bfloat16)
    return (rand(B, Nq, Hq, Dh), rand(B, Nk, KV, Dh), rand(B, Nk, KV, Dh),
            rand(B, Nq, Hq, Dh))


@pytest.mark.parametrize("case", NONCAUSAL_TRAIN_CASES,
                         ids=lambda c: "B{}-Nq{}-Nk{}-{}x{}-Dh{}".format(*c))
def test_noncausal_lse_and_bwd_match_plain_on_card(dev, case):
    """The non-causal training pair: the prefill form writing the
    log-sum-exp gives the serve's o bit for bit and lse within 1e-5 of
    max(1, max|plain|); ``flash_attention`` on inputs that require grad
    takes ``NonCausalGQAAttention`` (one forward launch, one
    ``flash_prefill_bwd_bf16`` launch counted under its non-causal form)
    and its dq, dk, dv each lie within one bf16 ulp of the largest element
    of ``attention_noncausal_bwd_plain`` on the same o, dO and lse; two
    backward passes bitwise equal."""
    q, k, v, do = _noncausal_train_inputs(dev, case)
    o_serve = FA._noncausal_cuda(q, k, v)
    o, lse = FA._noncausal_cuda(q, k, v, with_lse=True)
    assert torch.equal(o, o_serve)
    ref = FA.attention_noncausal_lse_plain(q, k)
    assert (lse - ref).abs().max().item() <= \
        1e-5 * max(1.0, ref.abs().max().item())
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before, forms = backend.launches(), backend.form_launches()
    out = flash_attention(*leaves)
    got = torch.autograd.grad(out, leaves, do)
    after = backend.launches()
    assert torch.equal(out.detach(), o_serve)
    assert after["flash_prefill_bf16"] == before["flash_prefill_bf16"] + 1
    assert after["flash_prefill_bwd_bf16"] == \
        before["flash_prefill_bwd_bf16"] + 1
    assert sum(after.values()) == sum(before.values()) + 2
    assert backend.form_launches()["flash_prefill_bwd_bf16/noncausal"] == \
        forms["flash_prefill_bwd_bf16/noncausal"] + 1
    want = FA.attention_noncausal_bwd_plain(q, k, v, o, do, lse)
    for name, a, r in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16 and a.shape == r.shape
        assert bool(torch.isfinite(a.float()).all()), name
        err = (a.float() - r.float()).abs().max().item()
        assert err <= BF16_ULP * r.float().abs().max().item(), (name, err)
    again = torch.autograd.grad(flash_attention(*leaves), leaves, do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("arch", ["whisper-base", "llama-3.2-vision-90b"])
def test_multimodal_train_grad_on_card_launches_and_matches_cpu(dev, arch):
    """The gradient of the reduced family's loss (gates 1.0, full remat) on
    the card (bf16 activations, the kernels) against the CPU (bf16
    activations, plain attention), as the dense LM's: every attention
    through its kernel pair (the causal one twice forward and once
    backward per self-attention layer, the non-causal one likewise per
    cross layer and once each way per encoder layer), the loss within 1e-2
    relative and each gradient leaf within 5e-2 of its largest CPU
    element."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataConfig, synthetic_lm_batch
    from repro_torch.models import steps as ST
    from repro_torch.tree import flatten_with_path, tree_map
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    if cfg.family == "vlm":
        for c in params["stages"]["cross"]:
            c["gate"] = torch.ones(())
    b = synthetic_lm_batch(cfg, ShapeConfig("t", 64, 2, "train"),
                           DataConfig(), 0)
    fn = ST.make_grad_fn(cfg)
    res = {}
    for d in ("cpu", dev):
        backend.reset_launches()
        loss, _, g = fn(tree_map(lambda t: t.to(d), params),
                        {k: torch.from_numpy(v).to(d) for k, v in b.items()})
        res[str(d)] = (loss.item(), tree_map(lambda t: t.cpu(), g),
                       backend.launches(), backend.form_launches())
    (lc, gc, nc, _), (lg, gg, ng, fg) = res["cpu"], res[str(dev)]
    assert not any(nc.values())
    if cfg.family == "vlm":
        n_stages, n_self = M.vlm_layout(cfg)
        causal, cross, enc = n_stages * n_self, n_stages, 0
    else:
        causal = cross = cfg.num_layers
        enc = cfg.encoder_layers
    assert {k: v for k, v in ng.items() if v} == {
        "flash_prefill_bf16": 2 * (causal + cross) + enc,
        "flash_prefill_bwd_bf16": causal + cross + enc}
    assert fg["flash_prefill_bf16/noncausal"] == 2 * cross + enc
    assert fg["flash_prefill_bwd_bf16/noncausal"] == cross + enc
    assert abs(lg - lc) <= 1e-2 * abs(lc)
    for (path, a), (_, c) in zip(flatten_with_path(gg),
                                 flatten_with_path(gc)):
        assert bool(torch.isfinite(a).all()), path
        assert (a - c).abs().max() <= 5e-2 * c.abs().max(), path


def test_prefill_bwd_kernels_issue_wgmma(dev):
    """Both kernels of the backward library (dQ, dK/dV) in both forms
    (causal, non-causal) at each head width run their products on wgmma
    and sum without atomics: their SASS holds HGMMA, no HMMA and no
    atomic or reduction instruction."""
    atomics = {"ATOM", "ATOMS", "ATOMG", "RED", "REDG", "REDAS"}
    counts, fn = {}, None
    for line in backend.disassemble("flash_prefill_bwd").splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = {"HGMMA": 0, "HMMA": 0, "atomic": 0}
        elif fn is not None and "*/" in line:
            words = line.split("*/", 1)[1].split()
            while words and (words[0] == "{" or words[0].startswith("@")):
                words = words[1:]  # a dual-issue brace, a predicate
            op = words[0].split(".")[0] if words else ""
            if op in ("HGMMA", "HMMA"):
                counts[fn][op] += 1
            counts[fn]["atomic"] += op in atomics
    kernels = {f: c for f, c in counts.items() if "_kernel" in f}
    assert len(kernels) == 4 * len(
        FA.CAUSAL_HEAD_DIMS["flash_prefill_bwd_bf16"]), sorted(counts)
    for f, c in kernels.items():
        assert c["HGMMA"] > 0 and c["HMMA"] == 0 and c["atomic"] == 0, (f, c)


def test_causal_attention_with_grad_raises_on_card(dev):
    """What the backward kernel does not take raises: head width 32, the
    decode form, q_offset / kv_len, other dtypes."""
    q, k, v, _ = _train_inputs(dev, 1, 8, 2, 2, 32)
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


# ---------------------------------------------------------------------------
# the MoE LMs
# ---------------------------------------------------------------------------
def test_causal_kernels_at_moe_serve_shapes_on_card(dev):
    """Both causal kernels at full-width Granite-MoE-3B-A800M's heads (24
    query over 8 KV heads, GQA 3:1, Dh 64): a per-slot prefill of a
    512-token bucket holding a 500-token prompt, and a batch-4 decode,
    against a 572-slot cache."""
    o = _causal_case(dev, 1, 512, 24, 8, 64, 572, [0], [512], [12])
    assert bool((o[0, :12] == 0).all())
    lens = [130, 290, 420, 571]
    _causal_case(dev, 4, 1, 24, 8, 64, 572, [n - 1 for n in lens], lens,
                 [32, 56, 0, 12])


# y on the card within this many bf16 ulps of max|CPU y| where both route a
# token alike: both products round fp32 sums taken in another order to
# bf16, and one flipped rounding of g or u moves the output of the wo
# product and the 8-way combine
MOE_CARD_ULPS = 4


@pytest.mark.parametrize("T", [512, 4])
def test_moe_ffn_on_card_matches_cpu(dev, T):
    """One MoE layer at Granite-MoE-3B-A800M's widths (D=1536, 40 experts
    top-8, d_ff 512; bf16 weights from a seed) on T tokens (a per-slot
    prefill's 512, a batch-4 decode's 4), card against CPU. The router is
    a bf16 product, so the two may pick other experts at a near tie: every
    token whose expert set differs must owe it to experts whose CPU
    probabilities lie within 2 d of the token's k-th largest, d the
    largest card-vs-CPU probability difference. Tokens routed alike (same
    experts, same kept pairs) agree within ``MOE_CARD_ULPS`` bf16 ulps;
    the aux within 1e-3. Two card calls agree bitwise."""
    from repro_torch.configs import GRANITE_MOE_3B_A800M
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    cfg = GRANITE_MOE_3B_A800M
    g = torch.Generator().manual_seed(0)
    p = {k: v.to(torch.bfloat16)
         for k, v in MOE.init_moe_params(g, cfg).items()}
    x = torch.randn((1, T, cfg.d_model), generator=g).to(torch.bfloat16)
    pc = {k: v.to(dev) for k, v in p.items()}
    y, aux = MOE.moe_ffn(x.to(dev), pc, cfg)
    again, _ = MOE.moe_ffn(x.to(dev), pc, cfg)
    assert torch.equal(y, again)
    y_cpu, aux_cpu = MOE.moe_ffn(x, p, cfg)
    assert abs(aux.item() - aux_cpu.item()) <= 1e-3
    xf = x.reshape(T, -1)
    probs = {d: torch.softmax(L.linear(xf.to(d), pp["router"]).float(), -1)
             .cpu() for d, pp in (("cpu", p), (dev, pc))}
    d = (probs[dev] - probs["cpu"]).abs().max().item()
    r_card = MOE.route(xf.to(dev), pc, cfg)
    r_cpu = MOE.route(xf, p, cfg)
    e_card, e_cpu = (torch.sort(r.expert.cpu(), dim=1).values
                     for r in (r_card, r_cpu))
    kth = torch.sort(probs["cpu"], dim=1, descending=True).values[
        :, cfg.moe_top_k - 1]
    for t in torch.nonzero((e_card != e_cpu).any(dim=1))[:, 0].tolist():
        differ = set(e_card[t].tolist()) ^ set(e_cpu[t].tolist())
        for e in differ:
            assert abs(probs["cpu"][t, e] - kth[t]) <= 2 * d, (t, e, d)
    kept_card, kept_cpu = (r.kept.cpu().gather(1, torch.sort(
        r.expert.cpu(), dim=1).indices) for r in (r_card, r_cpu))
    alike = (e_card == e_cpu).all(dim=1) & (kept_card == kept_cpu).all(dim=1)
    if bool((e_card == e_cpu).all()):  # no flip: the capacity keeps alike
        assert bool(alike.all())
    err = (y.cpu().float() - y_cpu.float()).reshape(T, -1)[alike].abs().max()
    tol = MOE_CARD_ULPS * BF16_ULP * y_cpu.float().abs().max()
    print(f"moe_ffn T={T}: card vs CPU probabilities within d={d:.3g}; "
          f"{int((e_card != e_cpu).any(dim=1).sum())} tokens routed "
          f"otherwise, {int((~alike).sum())} not compared; y error "
          f"{err:.3g} <= {tol:.3g}; aux {aux.item():.6f} vs "
          f"{aux_cpu.item():.6f}")
    assert err <= tol


def test_moe_serve_on_card_same_at_both_depths(dev):
    """Reduced Granite-MoE-3B-A800M (bf16, GQA 4:1, Dh 16) at capacity
    factor 1.25, so that left-padded prompts drop real pairs, served on
    the card continuously at pipeline depths 1 and 2 under sync debug
    mode "error" (no wait besides the step events): identical tokens,
    every request its tokens, the causal kernels once per layer of every
    call, and each token within 0.05 of the call-for-call oracle's
    largest logit (its prefill call alone, then decode calls at B=1)."""
    from repro_torch.configs import GRANITE_MOE_3B_A800M
    from repro_torch.models import steps as ST
    from repro_torch.serving.cache_manager import KVCacheManager
    cfg = GRANITE_MOE_3B_A800M.reduced().replace(moe_capacity_factor=1.25)
    params = serving_params(cfg, M.init_params(
        cfg, torch.Generator(dev).manual_seed(0), device=dev))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (33, 9, 40, 17)]
    outs = []
    for depth in (1, 2):
        eng = ServeEngine(cfg, params, EngineConfig(
            max_batch=3, max_len=96, pipeline_depth=depth), device=dev)
        reqs = [Request(uid=i, prompt=pr, max_new_tokens=8)
                for i, pr in enumerate(prompts)]
        backend.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs.append(eng.serve(reqs, continuous=True))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        st, n = eng.stats(), backend.launches()
        assert all(len(t) == 8 for t in outs[-1].values())
        assert n["flash_decode_bf16"] == \
            cfg.num_layers * st["runner_decode_calls"]
        assert n["flash_prefill_bf16"] == \
            cfg.num_layers * st["runner_prefill_slot_calls"]
    assert outs[0] == outs[1]
    with torch.no_grad():
        for r in reqs:
            P = len(r.prompt)
            lb, _ = KVCacheManager(cfg, eng.ec, device=dev).admit(0, P, 8)
            row = torch.zeros((1, lb), dtype=torch.int32, device=dev)
            row[0, lb - P:] = torch.from_numpy(r.prompt).to(dev)
            vs = torch.tensor([lb - P], dtype=torch.int32, device=dev)
            out = M.forward_lm(cfg, params, row, mode="prefill",
                               caches=ST.init_caches(cfg, 1, 96, device=dev),
                               logits_for="last", valid_start=vs)
            logits = [out.logits[0, -1]]
            for t in r.generated[:-1]:
                out = M.forward_lm(cfg, params, torch.tensor(
                    [[t]], dtype=torch.int32, device=dev), mode="decode",
                    caches=out.caches, valid_start=vs)
                logits.append(out.logits[0, -1])
            rows = torch.stack(logits)
            chosen = rows.gather(1, torch.tensor(r.generated,
                                                 device=dev)[:, None])[:, 0]
            assert (rows.max(dim=1).values - chosen).max().item() <= 0.05


# ---------------------------------------------------------------------------
# MoE training
# ---------------------------------------------------------------------------
def test_moe_train_grad_on_card_launches_and_matches_cpu(dev, monkeypatch):
    """The gradient of the pruned reduced Granite-MoE-3B-A800M's loss (3
    layers, 4 experts top-2, a shared expert, Dh 16, GQA 4:1, capacity
    factor 1.25 so that pairs drop; full remat) on the card: the forward
    kernel twice per layer, the backward once, nothing else; two card
    backwards bitwise equal. Against the CPU, both with bf16 activations:
    a token the CPU, routing freely, sends to other experts must owe it
    to a near tie (each differing expert's CPU probability within 2 d of
    the token's k-th largest, d the layer's largest card-vs-CPU
    probability difference); with the card's routing replayed on the CPU
    (``moe.route(expert=...)``), the loss within 1e-2 relative, the aux
    within 1e-2 and each gradient leaf within 5e-2 of its largest CPU
    element, as the dense LM's."""
    from repro_torch.configs import GRANITE_MOE_3B_A800M
    from repro_torch.data import DataConfig, synthetic_lm_batch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.models import steps as ST
    from repro_torch.tree import flatten_with_path, leaves, tree_map
    cfg = GRANITE_MOE_3B_A800M.reduced().replace(moe_capacity_factor=1.25)
    cfg = cfg.replace(pruning=type(cfg.pruning)(block_size=16, r_b=0.5,
                                                r_t=1.0))
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    scores = PG.init_scores(cfg, params, torch.Generator().manual_seed(7))
    b = synthetic_lm_batch(cfg, ShapeConfig("t", 64, 2, "train"),
                           DataConfig(), 0)
    fn = ST.make_grad_fn(cfg, with_pruning=True)
    route, seen, replay = MOE.route, [], []

    def recorded(xf, p, c, capacity_factor=None):
        e = replay[len(seen)].to(xf.device) if replay else None
        r = route(xf, p, c, capacity_factor, e)
        with torch.no_grad():
            probs = torch.softmax(L.linear(xf, p["router"]).float(), -1)
        seen.append((r.expert.cpu(), probs.cpu()))
        return r
    monkeypatch.setattr(MOE, "route", recorded)

    def run(d):
        seen.clear()
        backend.reset_launches()
        out = fn(tree_map(lambda t: t.to(d), params), {
            "tokens": torch.from_numpy(b["tokens"]).to(d)},
            tree_map(lambda t: t.to(d), scores))
        return out, backend.launches(), list(seen)
    (lg, pg, gg), ng, card = run(dev)
    (lg2, _, gg2), _, _ = run(dev)
    (_, _, _), nc, free = run("cpu")
    replay.extend(e for e, _ in card)
    (lc, pc, gc), _, _ = run("cpu")
    assert not any(nc.values())
    L_ = cfg.num_layers
    assert {k: v for k, v in ng.items() if v} == {
        "flash_prefill_bf16": 2 * L_, "flash_prefill_bwd_bf16": L_}
    assert torch.equal(lg, lg2)
    assert all(torch.equal(a, b) for a, b in zip(leaves(gg), leaves(gg2)))
    K = cfg.moe_top_k
    for (e_c, p_c), (e_h, p_h) in zip(card[:L_], free[:L_]):
        d = (p_c - p_h).abs().max().item()
        s_c, s_h = (torch.sort(e, dim=1).values for e in (e_c, e_h))
        kth = torch.sort(p_h, dim=1, descending=True).values[:, K - 1]
        for t in torch.nonzero((s_c != s_h).any(dim=1))[:, 0].tolist():
            for e in set(s_c[t].tolist()) ^ set(s_h[t].tolist()):
                assert abs(p_h[t, e] - kth[t]) <= 2 * d, (t, e, d)
    assert abs(lg.item() - lc.item()) <= 1e-2 * abs(lc.item())
    assert abs(pg["aux"].item() - pc["aux"].item()) <= 1e-2
    for (path, a), (_, c) in zip(flatten_with_path(gg),
                                 flatten_with_path(gc)):
        a = a.cpu()
        assert bool(torch.isfinite(a).all()), path
        assert (a - c).abs().max() <= 5e-2 * c.abs().max(), path


@pytest.mark.parametrize("T", [512, 4096])
def test_moe_ffn_backward_on_card_is_repeatable(dev, T):
    """One MoE layer at Granite-MoE-3B-A800M's widths (D=1536, 40 experts
    top-8, d_ff 512; bf16, capacity factor 1.25, so that pairs drop and
    the spare row is written by many) under autograd on the card, twice:
    y, aux and the gradients of x, the router and the banks bitwise
    equal; finite. Capacity factor 0.5 drops pairs (random inputs route
    about evenly): a token with every pair dropped gets no gradient from
    y, only the aux's (this layer has no shared expert)."""
    from repro_torch.configs import GRANITE_MOE_3B_A800M
    from repro_torch.models import moe as MOE
    cfg = GRANITE_MOE_3B_A800M
    g = torch.Generator().manual_seed(1)
    p = {k: v.to(dev, torch.bfloat16).requires_grad_(True)
         for k, v in MOE.init_moe_params(g, cfg).items()}
    x = torch.randn((1, T, cfg.d_model), generator=g).to(
        dev, torch.bfloat16).requires_grad_(True)
    cot = torch.randn((1, T, cfg.d_model), generator=g).to(dev,
                                                           torch.bfloat16)
    out = []
    for _ in range(2):
        y, aux = MOE.moe_ffn(x, p, cfg, 0.5)
        grads = torch.autograd.grad((y.float() * cot).sum() + aux,
                                    [x, *p.values()])
        out.append((y, aux, grads))
    (y, aux, ga), (y2, aux2, gb) = out
    assert torch.equal(y, y2) and torch.equal(aux, aux2)
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))
    assert all(bool(torch.isfinite(a.float()).all()) for a in ga)
    with torch.no_grad():
        r = MOE.route(x.reshape(T, -1), p, cfg, 0.5)
    gone = ~r.kept.any(dim=1)
    assert bool(gone.any())
    # the aux's gradient reaches every token through probs.mean(0)
    (gx_aux,) = torch.autograd.grad(MOE.moe_ffn(x, p, cfg, 0.5)[1], x)
    assert torch.equal(ga[0][0, gone], gx_aux[0, gone])


def test_inplace_adamw_on_card_equals_functional(dev, monkeypatch):
    """``AdamW.update_`` against ``AdamW.update`` on the card over 3 steps
    of a tree of fp32 leaves (matrices, vectors, a 3-D bank) with random
    gradients, clipped, decay by the LM's rule and by ndim, groups small
    enough to split the tree: params and moments bitwise equal."""
    from repro_torch.models import steps as ST
    from repro_torch.optim import AdamW, adamw
    from repro_torch.tree import leaves, tree_map
    monkeypatch.setattr(adamw, "GROUP_NUMEL", 20000)
    g = torch.Generator().manual_seed(2)
    tree = {"embed": torch.randn((300, 64), generator=g),
            "layers": [{"ln": torch.randn((64,), generator=g),
                        "moe": {"wi": torch.randn((4, 64, 128), generator=g),
                                "router": torch.randn((64, 4), generator=g)}}
                       for _ in range(2)],
            "ln_f": torch.randn((64,), generator=g)}
    tree = tree_map(lambda t: t.to(dev), tree)
    opt = AdamW(lr=1e-2, grad_clip=1.0)
    tr_f, st_f = tree, opt.init(tree)
    tr_i = tree_map(torch.clone, tree)
    st_i = opt.init(tr_i)
    for step in range(3):
        grads = tree_map(lambda t: torch.randn(
            t.shape, generator=g).to(dev), tree)
        decay = ST.stacked_decay(tree) if step != 1 else None
        tr_f, st_f = opt.update(grads, st_f, tr_f, decay=decay)
        tr_i, st_i = opt.update_(tree_map(torch.clone, grads), st_i, tr_i,
                                 decay=decay)
        for a, b in zip(leaves(tr_i) + leaves(st_i.mu) + leaves(st_i.nu),
                        leaves(tr_f) + leaves(st_f.mu) + leaves(st_f.nu)):
            assert torch.equal(a, b), step


# ---------------------------------------------------------------------------
# The SSM and hybrid families' scans (kernels/ssm_scan)
# ---------------------------------------------------------------------------
# (kernel, B, S, H, dh, N, regime): full-width Zamba2-1.2B (64 Mamba2
# heads of dh 64, state 64) and RWKV6-1.6B (32 WKV heads of dh 64) at the
# serve's prefill (B 4, S 512), its re-prefill length (S 500, chunked with
# a ragged last chunk) and decode (B 4, S 1); at the prefill also strong
# decays (down to exactly 0); the reduced configs' widths on each side of
# the chunked form's first length (``CHUNK_MIN``)
SCAN_CASES = [("mamba", 4, 512, 64, 64, 64, "model"),
              ("mamba", 4, 500, 64, 64, 64, "model"),
              ("mamba", 4, 512, 64, 64, 64, "strong"),
              ("mamba", 4, 1, 64, 64, 64, "model"),
              ("mamba", 3, 37, 2, 64, 8, "model"),
              ("mamba", 3, SS_CHUNK_MIN["mamba"] - 1, 2, 64, 8, "model"),
              ("mamba", 3, SS_CHUNK_MIN["mamba"], 2, 64, 8, "strong"),
              ("wkv6", 4, 512, 32, 64, 0, "model"),
              ("wkv6", 4, 500, 32, 64, 0, "model"),
              ("wkv6", 4, 512, 32, 64, 0, "strong"),
              ("wkv6", 4, 1, 32, 64, 0, "model"),
              ("wkv6", 3, 37, 4, 16, 0, "model"),
              ("wkv6", 3, SS_CHUNK_MIN["wkv6"] - 1, 4, 16, 0, "model"),
              ("wkv6", 3, SS_CHUNK_MIN["wkv6"], 4, 16, 0, "strong")]
# y against the plain version: 1e-5 x max(1, max|plain y|), fp32 sums of dh
# or N terms in another order. The final state: bitwise in the sequential
# form (the same rounded products and sums in the same order); in the
# chunked form within 1e-5 x max(1, max|plain state|), its sums over a
# chunk's steps taken as products in another order
SCAN_TOL = 1e-5


def _scan_args(dev, kind, B, S, H, dh, N, dtype=torch.bfloat16, seed=0,
               regime="model"):
    """Inputs shaped as the model makes them, from a seed: Mamba2's dt
    through softplus and decay exp(-dt A) with A of 1..16; RWKV6's w =
    exp(-exp(-6 + noise)) (near 1, so the state grows over the
    sequence); random incoming states. ``regime="strong"``: Mamba2's dt
    scaled up to ~40, so dt A passes 104 and decays reach exactly 0;
    RWKV6's w_raw uniform on [-6, 5], so w runs from near 1 to exactly 0."""
    g = torch.Generator().manual_seed(seed)
    rand = lambda *s: torch.randn(s, generator=g)
    if kind == "mamba":
        dt = torch.nn.functional.softplus(rand(B, S, H))
        if regime == "strong":
            dt = dt * 10.0
        A = torch.linspace(1.0, 16.0, H)
        args = (rand(B, S, H, dh).to(dtype), dt, torch.exp(-dt * A),
                rand(B, S, N), rand(B, S, N), 0.1 * rand(B, H, dh, N))
    else:
        w_raw = (-6.0 + rand(B, S, H, dh) if regime == "model" else
                 -6.0 + 11.0 * torch.rand((B, S, H, dh), generator=g))
        w = torch.exp(-torch.exp(w_raw))
        args = (rand(B, S, H, dh).to(dtype), rand(B, S, H, dh).to(dtype),
                rand(B, S, H, dh).to(dtype), w, 0.1 * rand(H, dh),
                0.1 * rand(B, H, dh, dh))
    return tuple(t.to(dev) for t in args)


def _scan_fns(kind):
    from repro_torch.kernels.ssm_scan import (mamba_scan, mamba_scan_plain,
                                              wkv6, wkv6_plain)
    return (mamba_scan, mamba_scan_plain) if kind == "mamba" else \
        (wkv6, wkv6_plain)


def _within(got, ref):
    err = (got - ref).abs().max().item()
    tol = SCAN_TOL * max(1.0, ref.abs().max().item())
    assert err <= tol, (err, tol)
    return True


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize(
    "case", SCAN_CASES,
    ids=lambda c: f"{c[0]}-B{c[1]}-S{c[2]}-H{c[3]}"
    + ("" if c[6] == "model" else f"-{c[6]}"))
def test_ssm_scan_matches_plain_on_card(dev, case, dtype):
    """Each scan kernel against its plain version: y within ``SCAN_TOL``;
    the final state bitwise in the sequential form, within ``SCAN_TOL`` in
    the chunked form; two launches bitwise equal; S split as S1 + (S - S1)
    with the state carried equal to one pass (bitwise when both parts and
    the pass run sequential, else within the same bounds); one launch a
    call, no plain version on the card."""
    kind, B, S, H, dh, N, regime = case
    fn, plain = _scan_fns(kind)
    args = _scan_args(dev, kind, B, S, H, dh, N, dtype, regime=regime)
    before = backend.launches()
    y, s = fn(*args)
    entry = "mamba_scan_f32" if kind == "mamba" else "wkv6_f32"
    assert backend.launches()[entry] == before[entry] + 1
    y_ref, s_ref = plain(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    assert _within(y, y_ref)
    if SS.scan_form(kind, S) == "sequential":
        assert torch.equal(s, s_ref)
    else:
        assert _within(s, s_ref)
    y2, s2 = fn(*args)
    assert torch.equal(y, y2) and torch.equal(s, s2)
    if S > 1:
        S1 = S // 3 + 5
        seq = lambda a, b: tuple(t[:, a:b] if t.dim() >= 3 and
                                 t.shape[:2] == (B, S) else t
                                 for t in args[:-1])
        ya, sa = fn(*(t.contiguous() for t in seq(0, S1)), args[-1])
        yb, sb = fn(*(t.contiguous() for t in seq(S1, S)), sa)
        if {SS.scan_form(kind, n) for n in (S, S1, S - S1)} == \
                {"sequential"}:
            assert torch.equal(torch.cat([ya, yb], dim=1), y)
            assert torch.equal(sb, s)
        else:
            assert _within(torch.cat([ya, yb], dim=1), y)
            assert _within(sb, s)


def test_ssm_scans_raise_on_card(dev):
    """On the card a scan launches or raises: a width over 64, a
    non-contiguous operand. An input that needs a gradient raises nothing:
    the backward kernel launches."""
    fn, _ = _scan_fns("wkv6")
    wide = _scan_args(dev, "wkv6", 1, 4, 2, 80, 0)
    with pytest.raises(ValueError, match="widths of 1 to 64"):
        fn(*wide)
    args = _scan_args(dev, "wkv6", 2, 4, 2, 16, 0)
    with pytest.raises(ValueError, match="contiguous"):
        fn(args[0].transpose(0, 1).contiguous().transpose(0, 1), *args[1:])
    before = backend.launches()["wkv6_bwd_f32"]
    y, _ = fn(args[0].float().requires_grad_(),
              *(t.float() for t in args[1:3]), *args[3:])
    y.sum().backward()
    assert backend.launches()["wkv6_bwd_f32"] == before + 1
    mfn, _ = _scan_fns("mamba")
    with pytest.raises(ValueError, match="widths of 1 to 64"):
        mfn(*_scan_args(dev, "mamba", 1, 4, 2, 64, 72))


def _record_prefills(eng):
    """Wrap ``eng.runner.prefill`` to record, per request, the row of its
    last whole-batch prefill (left padding included) and how many tokens
    it had generated before it: {uid: (row, n generated)}."""
    rows, inner = {}, eng.runner.prefill

    def prefill(tokens, valid_start, caches):
        for slot, req in eng.scheduler.running.items():
            rows[req.uid] = (np.array(tokens[slot]), len(req.generated))
        return inner(tokens, valid_start, caches)
    eng.runner.prefill = prefill
    return rows


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-1.6b"])
def test_recurrent_serve_on_card_same_at_both_depths(dev, arch):
    """A reduced Zamba2 / RWKV6 serve on the card (bf16, the whole-batch
    re-prefill at every admission): depths 1 and 2 give the same tokens,
    the scan kernel launches once per recurrent layer of every prefill and
    decode call (the causal pair once per shared-block call), no plain scan
    runs, and in a ``forward_lm`` on the card over each request's row as
    last prefilled (pad tokens and all: recurrent state absorbs them) plus
    the tokens decoded after it, every such token's logit lies within 0.05
    of its position's largest."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssm_scan import ops as SS
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0),
                           device=dev)
    plain = {"n": 0}
    inner = (SS.mamba_scan_plain, SS.wkv6_plain)

    def counted(fn):
        def call(*a):
            plain["n"] += 1
            return fn(*a)
        return call
    outs, reqs, rows = [], None, None
    try:
        SS.mamba_scan_plain, SS.wkv6_plain = map(counted, inner)
        for depth in (1, 2):
            eng = ServeEngine(cfg, params, EngineConfig(
                max_batch=3, max_len=64, pipeline_depth=depth), device=dev)
            rows = _record_prefills(eng)
            rng = np.random.default_rng(1)
            reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                            .astype(np.int32), max_new_tokens=m)
                    for i, (n, m) in enumerate(((5, 6), (11, 4), (3, 8),
                                                (17, 9)))]
            before = backend.launches()
            outs.append(eng.serve(reqs, continuous=True))
            n = {k: v - before[k] for k, v in backend.launches().items()}
            st = eng.stats()
            calls = st["runner_prefill_calls"] + st["runner_decode_calls"]
            scan = "wkv6_f32" if cfg.family == "ssm" else "mamba_scan_f32"
            assert n[scan] == cfg.num_layers * calls
            if cfg.family == "hybrid":
                stages = cfg.num_layers // cfg.attn_layer_period
                assert n["flash_prefill_bf16"] == \
                    stages * st["runner_prefill_calls"]
                assert n["flash_decode_bf16"] == \
                    stages * st["runner_decode_calls"]
    finally:
        SS.mamba_scan_plain, SS.wkv6_plain = inner
    assert outs[0] == outs[1] and plain["n"] == 0
    for r in reqs:
        row, g = rows[r.uid]
        seq = np.concatenate([row, r.generated[g:-1]]).astype(np.int64)
        with torch.no_grad():
            lg = M.forward_lm(cfg, params, torch.from_numpy(seq)[None].to(
                dev)).logits[0, len(row) - 1:]
        gen = torch.tensor(r.generated[g:], device=dev)
        gap = lg.max(dim=1).values - lg.gather(1, gen[:, None])[:, 0]
        assert gap.max().item() <= 0.05


# ---------------------------------------------------------------------------
# Training the SSM and hybrid families: the scans' backward kernels
# ---------------------------------------------------------------------------
# (kernel, B, S, H, dh, N, regime, activations, nonzero states): the
# training step's widths (Zamba2-1.2B, RWKV6-1.6B) at 8 x 512 (the chunked
# form) and at the edges (S 1, each side of the chunked form's first
# length 32, S past one chunk, strong decays, fp32 activations, nonzero
# initial states and final-state gradients), and the reduced configs'
# widths (dh 64 over N 8; dh 16)
SCAN_BWD_CASES = [("mamba", 8, 512, 64, 64, 64, "model", "bf16", False),
                  ("mamba", 2, 1, 64, 64, 64, "model", "bf16", True),
                  ("mamba", 2, 31, 64, 64, 64, "model", "fp32", True),
                  ("mamba", 2, 32, 64, 64, 64, "model", "bf16", True),
                  ("mamba", 2, 70, 64, 64, 64, "strong", "bf16", True),
                  ("mamba", 3, 37, 2, 64, 8, "model", "fp32", True),
                  ("wkv6", 8, 512, 32, 64, 0, "model", "bf16", False),
                  ("wkv6", 2, 1, 32, 64, 0, "model", "bf16", True),
                  ("wkv6", 2, 31, 32, 64, 0, "model", "bf16", True),
                  ("wkv6", 2, 33, 32, 64, 0, "model", "fp32", True),
                  ("wkv6", 2, 70, 32, 64, 0, "strong", "bf16", True),
                  ("wkv6", 3, 37, 4, 16, 0, "model", "fp32", True)]
# each gradient against the plain backward's, both fp32: sums in another
# order, fused multiply-adds, and in the chunked form 3xTF32 products
SCAN_BWD_TOL = 1e-5  # x max(1, max|plain|)


@pytest.mark.parametrize(
    "case", SCAN_BWD_CASES,
    ids=lambda c: f"{c[0]}-B{c[1]}-S{c[2]}-dh{c[4]}-{c[6]}-{c[7]}"
    + ("-states" if c[8] else ""))
def test_scan_backward_matches_plain_on_card(dev, case):
    """``mamba_scan_bwd_f32`` / ``wkv6_bwd_f32`` against the plain backward
    (every gradient within ``SCAN_BWD_TOL``), one launch a call, two
    launches bitwise equal; through the autograd Function, the gradients
    in each input's dtype."""
    kind, B, S, H, dh, N, regime, act, nonzero = case
    args = _scan_args(dev, kind, B, S, H, dh, N, regime=regime)
    if act == "fp32":
        args = tuple(t.float() for t in args)
    if not nonzero:
        args = (*args[:-1], torch.zeros_like(args[-1]))
    g = torch.Generator().manual_seed(3)
    dy = torch.randn(args[0].shape, generator=g).to(dev)
    ds = (torch.randn(args[-1].shape, generator=g).to(dev) if nonzero
          else torch.zeros_like(args[-1]))
    cuda, plain, entry = (
        (SS._mamba_scan_bwd_cuda, SS.mamba_scan_bwd_plain,
         "mamba_scan_bwd_f32") if kind == "mamba" else
        (SS._wkv6_bwd_cuda, SS.wkv6_bwd_plain, "wkv6_bwd_f32"))
    before = backend.launches()[entry]
    got, again = cuda(*args, dy, ds), cuda(*args, dy, ds)
    assert backend.launches()[entry] == before + 2
    ref = plain(*args, dy, ds)
    torch.cuda.synchronize()
    for a, b, r in zip(got, again, ref):
        assert torch.equal(a, b)
        assert (a - r).abs().max().item() <= \
            SCAN_BWD_TOL * max(1.0, r.abs().max().item())
    ins = [t.clone().requires_grad_() for t in args]
    fn = SS.mamba_scan if kind == "mamba" else SS.wkv6
    y, s = fn(*ins)
    grads = torch.autograd.grad((y * dy).sum() + (s * ds).sum(), ins)
    for a, x, r in zip(grads, ins, got):
        assert a.dtype == x.dtype and torch.equal(a, r.to(x.dtype))


def test_recurrent_training_step_on_card_matches_cpu(dev):
    """One ``make_grad_fn`` of reduced Zamba2 at 1 layer of period 1 (a
    Mamba2 layer, then the shared block) and of reduced RWKV6 at 1 layer
    on the card (bf16, the scan kernels and their backward, the causal
    pair) against the CPU at fp32 (the plain versions): the loss within
    1e-3 relative and every gradient leaf finite and within 5% of its
    largest CPU element, the dense LM's gates; one backward launch per
    recurrent layer. Deeper, the reduced configs are chaotic in bf16 at
    random init, in the reference as in the port: the reference's own
    bf16 gradients lie 1.35 (Zamba2, 4 layers) and 0.25 (RWKV6, 3 layers)
    x a leaf's largest element from its fp32 ones, against 0.024 and
    0.035 at these cuts (``tools/step0_reference_witness.py``)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataConfig, synthetic_lm_batch
    from repro_torch.launch import train as LT
    from repro_torch.models import steps as ST
    from repro_torch.optim import AdamW
    from repro_torch.tree import leaves, tree_map
    cpu = torch.device("cpu")
    for arch, period in (("zamba2-1.2b", 1), ("rwkv6-1.6b", None)):
        cfg = LT.prune_config(get_config(arch).reduced()).replace(
            num_layers=1)
        if period:
            cfg = cfg.replace(attn_layer_period=period)
        st = LT.make_state_factory(cfg, AdamW(), dev, with_scores=True)()
        toks = torch.from_numpy(synthetic_lm_batch(
            cfg, ShapeConfig("t", 64, 2, "train"), DataConfig(), 0)[
                "tokens"])
        before = backend.launches()
        loss_c, _, g_c = ST.make_grad_fn(cfg, True)(
            st["params"], {"tokens": toks.to(dev)}, st["scores"])
        n = {k: v - before[k] for k, v in backend.launches().items()}
        bwd = "wkv6_bwd_f32" if cfg.family == "ssm" else "mamba_scan_bwd_f32"
        assert n[bwd] == cfg.num_layers
        loss_h, _, g_h = ST.make_grad_fn(cfg.replace(dtype="float32"), True)(
            tree_map(lambda t: t.to(cpu), st["params"]), {"tokens": toks},
            tree_map(lambda t: t.to(cpu), st["scores"]))
        assert abs(loss_c.item() - loss_h.item()) <= 1e-3 * abs(loss_h.item())
        for a, b in zip(leaves(g_c), leaves(g_h)):
            assert torch.isfinite(a).all()
            assert (a.cpu().float() - b).abs().max() <= 0.05 * b.abs().max()


def test_pruned_prefill_on_card_matches_cpu(dev):
    """``pruned_prefill_logits`` of reduced Minitron-4B (bf16 on the card:
    the causal prefill kernel per layer, the decode kernel's probabilities
    per TDM layer) against the CPU at bf16 on the same weights: the same
    tokens left and kept positions, and the card's argmax token's CPU logit
    within 0.05 of the CPU's largest (the LM's gate)."""
    from repro_torch.configs import get_config
    from repro_torch.core import token_pruning as TP
    from repro_torch.models import prefill_prune as PP
    from repro_torch.tree import tree_map
    cfg = get_config("minitron-4b").reduced()
    cfg = cfg.replace(pruning=dataclasses.replace(
        cfg.pruning, r_t=0.7, tdm_layers=(0, 2)))
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    params = tree_map(lambda t: t.to(torch.bfloat16) if t.is_floating_point()
                      else t, params)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (3, 41)))
    inner, kept = TP.drop_weights, []

    def record(s_body, k):
        top, w = inner(s_body, k)
        kept.append(sorted(top[0].tolist()))
        return top, w
    TP.drop_weights = record
    try:
        before = backend.launches()
        lc, nc = PP.pruned_prefill_logits(
            cfg, tree_map(lambda t: t.to(dev), params), toks.to(dev))
        n = {k: v - before[k] for k, v in backend.launches().items()}
        lh, nh = PP.pruned_prefill_logits(cfg, params, toks)
    finally:
        TP.drop_weights = inner
    assert nc == nh == 23  # 41 -> 30 -> 23
    assert n["flash_prefill_bf16"] == cfg.num_layers
    assert n["flash_decode_bf16"] == 2
    assert kept[:2] == kept[2:]
    top = lc.argmax(-1).cpu()
    gap = lh.max(-1).values - lh.gather(1, top[:, None])[:, 0]
    assert gap.max().item() <= 0.05
