"""The port's VisionEngine and serving layers against the reference
package, on the CPU, at the reduced DeiT-Small config.

* Same request stream through both engines: the same ExecutionPlan
  sequence, the same scheduler event stream, logits per uid within 1e-4
  (fp32, different summation orders between XLA and PyTorch).
* The port's engine against its own offline oracle (``forward_vit_packed``)
  on unmasked tiles: BITWISE. The kernels' plain versions and the eager
  CPU matmuls of embed/MLP/head compute each row the same whatever the row
  count at these widths (at DeiT-Small's full width the CPU BLAS does not,
  and on the card cuBLAS may not: ``chip_smoke.py`` holds the card to a
  tolerance instead).
* The host-side copies (planner, quality controller, scheduler) make the
  same decisions as the reference's on the same inputs.
* Device rules, launcher, and the no-JAX import rule of the port."""
import ast
import dataclasses
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import DEIT_SMALL as J_DEIT
from repro.core import packed_runner as JPR
from repro.models import model as JM
from repro.models import pruning_glue as JPG
from repro.serving import planner as JPL
from repro.serving import quality as JQ
from repro.serving import scheduler as JS
from repro.serving.vision import (VisionEngine as JEngine,
                                  VisionEngineConfig as JVC,
                                  VisionRequest as JReq)

from repro_torch import convert
from repro_torch.configs import DEIT_SMALL as T_DEIT
from repro_torch.core import packed_runner as PR
from repro_torch.kernels.backend import host_to_device
from repro_torch.launch import serve_vision as SV
from repro_torch.models import model as M
from repro_torch.models import pruning_glue as PG
from repro_torch.serving import planner as TPL
from repro_torch.serving import quality as TQ
from repro_torch.serving import scheduler as TS
from repro_torch.serving.ragged_batcher import RaggedBatcher as TBatcher
from repro_torch.serving.vision import (VisionEngine, VisionEngineConfig,
                                        VisionRequest)

REPO = pathlib.Path(__file__).resolve().parents[1]
LOGIT_TOL = 1e-4

# (n_patches, r_t, arrival_step): mixed sizes, keep rates and arrivals
MIXES = [(16, None, 0), (9, 0.5, 0), (4, 0.7, 1), (16, 0.5, 2),
         (9, None, 3), (4, 0.5, 3)]


@pytest.fixture(scope="module")
def vit():
    jcfg, tcfg = J_DEIT.reduced(), T_DEIT.reduced()
    key = jax.random.PRNGKey(0)
    jparams = JM.init_params(jcfg, key)
    jscores = JPG.init_scores(jcfg, jparams, jax.random.fold_in(key, 7))
    jmasked = JPG.apply_pruning(jcfg, jparams, jscores)
    jpacked = JPR.pack_model(jcfg, jparams, jscores)
    tmasked = convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             jmasked))
    # one reference executor for every reference engine: its jit caches
    # are shared, which keeps this file fast
    jseg = JPR.PackedVitSegments(jcfg, jmasked, jpacked,
                                 donate_activations=True)
    return (jcfg, jmasked, jpacked, jseg), (
        tcfg, tmasked, convert.packed_dict_from_jax(jpacked))


def _requests(cls, cfg, mixes):
    rng = np.random.default_rng(0)
    pdim = cfg.patch_size ** 2 * 3
    return [cls(uid=i, patches=rng.standard_normal((n, pdim)).astype(
        np.float32), r_t=r_t, arrival_step=arr)
        for i, (n, r_t, arr) in enumerate(mixes)]


def _plan_tuple(plan):
    """An ExecutionPlan of either package as plain tuples."""
    return (tuple(dataclasses.astuple(t) for t in plan.tiles),
            tuple(dataclasses.astuple(l) for l in plan.lanes),
            dataclasses.astuple(plan.stats), plan.urgent)


def _record_plans(engine):
    """Capture every committed ExecutionPlan."""
    plans = []
    commit = engine.planner.commit

    def recording(plan):
        plans.append(_plan_tuple(plan))
        return commit(plan)

    engine.planner.commit = recording
    return plans


@pytest.mark.parametrize("planner,max_batch", [("off", 3), ("full", 3),
                                               ("merge", 2)])
def test_engine_matches_reference_engine(vit, planner, max_batch):
    (jcfg, jmasked, jpacked, jseg), (tcfg, tmasked, tpacked) = vit
    jeng = JEngine(jcfg, jmasked, jpacked,
                   JVC(max_batch=max_batch, planner=planner))
    jeng.segments = jseg
    teng = VisionEngine(tcfg, tmasked, tpacked,
                        VisionEngineConfig(max_batch=max_batch,
                                           planner=planner), device="cpu")
    jplans, tplans = _record_plans(jeng), _record_plans(teng)
    jout = jeng.serve(_requests(JReq, jcfg, MIXES))
    tout = teng.serve(_requests(VisionRequest, tcfg, MIXES))
    assert tplans == jplans
    assert list(teng.events) == list(jeng.events)
    assert sorted(tout) == sorted(jout) == list(range(len(MIXES)))
    for uid in jout:
        np.testing.assert_allclose(tout[uid], np.asarray(jout[uid]),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
    st = teng.stats()
    assert st["steps"] == jeng.stats()["steps"]
    assert st["jit_compile_count"] <= st["compile_budget"]


@pytest.mark.parametrize("depth", [1, 2])
def test_engine_matches_own_offline_oracle(vit, depth):
    """Balanced buckets with token_tile=1 (no token padding): each uid
    bit-exact against the unbatched oracle at every pipeline depth (see
    the module docstring for why bitwise holds here)."""
    _, (cfg, masked, packed) = vit
    eng = VisionEngine(cfg, masked, packed,
                       VisionEngineConfig(max_batch=3, pipeline_depth=depth),
                       device="cpu")
    reqs = _requests(VisionRequest, cfg, MIXES)
    out = eng.serve(reqs)
    assert eng.stats()["batcher_padding_waste"] == 0.0  # unmasked tiles
    for r in reqs:
        ref = PR.forward_vit_packed(
            cfg, masked, packed, r.patches[None], segments=eng.segments,
            schedule=PR.keep_schedule(cfg, r_t=r.r_t)).logits[0].numpy()
        assert np.array_equal(out[r.uid], ref), f"uid {r.uid}"
        assert r.done and r.logits is not None


def test_padded_tiles_stay_close_to_oracle(vit):
    """token_tile > 1 pads rows inside the masked kernels: same math."""
    _, (cfg, masked, packed) = vit
    eng = VisionEngine(cfg, masked, packed,
                       VisionEngineConfig(max_batch=2, token_tile=8),
                       device="cpu")
    reqs = _requests(VisionRequest, cfg, MIXES[:4])
    out = eng.serve(reqs)
    assert eng.stats()["batcher_padding_waste"] > 0.0
    for r in reqs:
        ref = PR.forward_vit_packed(
            cfg, masked, packed, r.patches[None], device="cpu",
            schedule=PR.keep_schedule(cfg, r_t=r.r_t)).logits[0].numpy()
        np.testing.assert_allclose(out[r.uid], ref, atol=1e-5, rtol=1e-5)


def test_unported_request_modes_raise(vit):
    _, (cfg, masked, packed) = vit
    eng = VisionEngine(cfg, masked, packed, device="cpu")
    req = _requests(VisionRequest, cfg, MIXES[:1])[0]
    req.soft_prune = True
    with pytest.raises(NotImplementedError, match="soft"):
        eng.serve([req])
    with pytest.raises(NotImplementedError, match="fp32"):
        VisionEngineConfig(precision="int8")


# ---------------------------------------------------------------------------
# host-side copies decide like the reference
# ---------------------------------------------------------------------------
def _items(mod, rng, n, cfg):
    segs = JPR.vit_segments(cfg)
    items = []
    for _ in range(n):
        si = int(rng.integers(len(segs)))
        ntok = int(rng.integers(2, 18))
        traj = tuple(((s, segs[s], None), ntok) for s in range(si, len(segs)))
        dl = float(rng.uniform(0.0, 0.01)) if rng.random() < 0.3 else None
        items.append(mod.PlanItem(stage=traj[0][0], n_tokens=ntok,
                                  trajectory=traj, deadline_left_ms=dl))
    return items


@pytest.mark.parametrize("mode", ["off", "merge", "fuse", "full"])
def test_planner_copy_plans_like_reference(mode):
    cfg_j, cfg_t = J_DEIT.reduced(), T_DEIT.reduced()
    from repro.serving.ragged_batcher import RaggedBatcher as JBatcher
    for seed in range(4):
        ji = _items(JPL, np.random.default_rng(seed), 7, cfg_j)
        ti = _items(TPL, np.random.default_rng(seed), 7, cfg_t)
        jp = JPL.TilePlanner(JBatcher(max_batch=4), JPL.TileCostModel(cfg_j),
                             mode=mode).plan_ahead(ji, 2)
        tp = TPL.TilePlanner(TBatcher(max_batch=4), TPL.TileCostModel(cfg_t),
                             mode=mode).plan_ahead(ti, 2)
        assert [_plan_tuple(p) for p in tp] == [_plan_tuple(p) for p in jp]


@pytest.mark.parametrize("mode", ["auto", "degrade"])
def test_quality_copy_resolves_like_reference(mode):
    jq = JQ.QualityController(JQ.QualityConfig(mode=mode), num_slots=4)
    tq = TQ.QualityController(TQ.QualityConfig(mode=mode), num_slots=4)
    rng = np.random.default_rng(1)
    for _ in range(20):
        sched = tuple(float(v) for v in rng.choice([1.0, 0.7, 0.5], 3))
        kw = dict(done=int(rng.integers(0, 3)),
                  preference=[None, "strict", "degrade"][rng.integers(3)],
                  queue_depth=int(rng.integers(0, 12)))
        assert tq.resolve(sched, **kw) == jq.resolve(sched, **kw)


@pytest.mark.parametrize("policy", ["fifo", "shortest_prompt_first",
                                    "prune_pressure_aware"])
def test_scheduler_copy_admits_like_reference(policy):
    def run(mod, req_cls, cfg):
        s = mod.Scheduler(2, policy=policy)
        reqs = _requests(req_cls, cfg, MIXES)
        for i, r in enumerate(reqs):
            r.prune_load = float((7 * i) % 5)
        s.submit(reqs)
        order = []
        while s.has_work():
            s.schedule()
            for slot in sorted(s.running):
                order.append(s.running[slot].uid)
                s.retire(slot)
        return order, list(s.events), s.stats()
    assert run(TS, VisionRequest, T_DEIT.reduced()) == \
        run(JS, JReq, J_DEIT.reduced())


# ---------------------------------------------------------------------------
# launcher and device rules
# ---------------------------------------------------------------------------
def test_serve_launcher_runs_on_cpu(monkeypatch, capsys):
    res = SV.serve(num_requests=4, slots=2, device="cpu")
    assert sorted(res["outputs"]) == [0, 1, 2, 3]
    assert all(np.isfinite(v).all() for v in res["outputs"].values())
    monkeypatch.setattr(sys, "argv", ["serve_vision", "--device", "cpu",
                                      "--requests", "3", "--json"])
    SV.main()
    assert '"top1"' in capsys.readouterr().out


def test_default_device_is_the_card(vit):
    """Without a GPU every entry point refuses its default device; only an
    explicit device='cpu' runs."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    _, (cfg, masked, packed) = vit
    x = np.zeros((1, 4, cfg.patch_size ** 2 * 3), np.float32)
    calls = [
        lambda: VisionEngine(cfg, masked, packed),
        lambda: PR.PackedVitSegments(cfg, masked, packed),
        lambda: PR.forward_vit_packed(cfg, masked, packed, x),
        lambda: M.init_params(cfg, torch.Generator().manual_seed(0)),
        lambda: SV.serve(num_requests=1),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_host_to_device_keeps_values_on_cpu():
    """The engine's host-to-device copy (pinned and asynchronous on the
    card) gives the values at the asked dtype; exact on the CPU."""
    a = np.arange(6, dtype=np.float64).reshape(2, 3)
    t = host_to_device(a, torch.device("cpu"))
    assert t.dtype == torch.float32 and t.shape == (2, 3)
    np.testing.assert_array_equal(t.numpy(), a.astype(np.float32))
    nv = host_to_device([3, 1], torch.device("cpu"), np.int32)
    assert nv.dtype == torch.int32 and nv.tolist() == [3, 1]


def test_port_imports_no_jax_and_no_reference_package():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (f, name)
