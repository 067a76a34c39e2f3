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

from repro_torch.configs import DEIT_SMALL
from repro_torch.core import packed_runner as PR
from repro_torch.core import quant as Q
from repro_torch.core import token_pruning as TTP
from repro_torch.core.packing import pack_weight
from repro_torch.kernels import backend
from repro_torch.kernels.flash_attention import (attention_plain,
                                                 flash_attention)
from repro_torch.kernels.sbmm import sbmm
from repro_torch.kernels.token_drop import token_drop
from repro_torch.kernels.token_package import (token_package,
                                               token_package_plain)
from repro_torch.launch.serve_vision import make_requests
from repro_torch.models import model as M
from repro_torch.models import pruning_glue as PG
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
