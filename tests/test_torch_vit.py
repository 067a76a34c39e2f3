"""The port's ViT, pruning glue and packed runner against the reference
package, on the CPU, at the reduced DeiT-Small config (3 layers, D=64,
4 heads, 32 px / 8 px patches, TDM at layer 1).

Weights come from the reference's seeded init and are converted, so both
packages compute the same function; inputs are numpy arrays from a seed.
Tolerance: 1e-5 per op and 1e-4 on logits (fp32, different summation
orders between XLA and PyTorch) at the fp32 and int8 tiers — the int8
weights and scales are bit-identical, and the arithmetic is fp32 — and
2e-3 at the fp16 tier, whose attention output is rounded to fp16 after
fp32 sums taken in another order (the reference's own fp16 bound);
structural outputs (masks, headers, permutations, plans, quantized blocks)
must be equal. The soft-TDM tests use a variant of the reduced config with
a TDM at every layer, so the package mass chains through two soft TDMs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import DEIT_SMALL as J_DEIT
from repro.core import packed_runner as JPR
from repro.core import quant as JQ
from repro.models import model as JM
from repro.models import pruning_glue as JPG

from repro_torch import convert
from repro_torch.configs import DEIT_SMALL as T_DEIT
from repro_torch.configs import get_config
from repro_torch.core import packed_runner as PR
from repro_torch.core import quant as Q
from repro_torch.models import model as M
from repro_torch.models import pruning_glue as PG

LOGIT_TOL = 1e-4
OP_TOL = 1e-5
TIER_TOL = {"fp32": LOGIT_TOL, "int8": LOGIT_TOL, "fp16": 2e-3}


@pytest.fixture(scope="module")
def vit():
    jcfg, tcfg = J_DEIT.reduced(), T_DEIT.reduced()
    key = jax.random.PRNGKey(0)
    jparams = JM.init_params(jcfg, key)
    jscores = JPG.init_scores(jcfg, jparams, jax.random.fold_in(key, 7))
    j = dict(cfg=jcfg, params=jparams, scores=jscores,
             masked=JPG.apply_pruning(jcfg, jparams, jscores),
             packed=JPR.pack_model(jcfg, jparams, jscores))
    tparams = convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             jparams))
    tscores = {p: torch.as_tensor(np.array(s)) for p, s in jscores.items()}
    t = dict(cfg=tcfg, params=tparams, scores=tscores,
             masked=PG.apply_pruning(tcfg, tparams, tscores),
             packed=convert.packed_dict_from_jax(j["packed"]))
    return j, t


def _all_tdm(cfg):
    """The config with a TDM at every layer (soft TDMs chain)."""
    return cfg.replace(pruning=dataclasses.replace(
        cfg.pruning, tdm_layers=tuple(range(cfg.num_layers))))


def _patches(cfg, B, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, n, cfg.patch_size ** 2 * 3)).astype(
        np.float32)


def test_configs_match_reference():
    assert dataclasses.asdict(T_DEIT) == dataclasses.asdict(J_DEIT)
    assert dataclasses.asdict(T_DEIT.reduced()) == \
        dataclasses.asdict(J_DEIT.reduced())
    assert get_config("deit-small") is T_DEIT
    with pytest.raises(KeyError):
        get_config("llama")


def test_converters(vit):
    j, t = vit
    flat_j = jax.tree_util.tree_flatten_with_path(j["params"])[0]
    flat_t = list(PG.flatten_with_path(t["params"]))
    assert len(flat_j) == len(flat_t)
    for (pj, lj), (pt, lt) in zip(flat_j, flat_t):
        assert JPG._path_str(pj) == PG._path_str(pt)
        assert np.array_equal(np.asarray(lj), lt.numpy())
    for path, pj in j["packed"].items():
        pt = t["packed"][path]
        assert np.array_equal(np.asarray(pj.blocks), pt.blocks.numpy())
        assert np.array_equal(np.asarray(pj.header), pt.header.numpy())
        assert np.array_equal(np.asarray(pj.counts), pt.counts.numpy())
        assert np.array_equal(pj.col_perm, pt.col_perm)
        assert pt.shape == tuple(pj.shape)
        assert pt.block_size == pj.block_size
        assert pt.nbytes() == pj.nbytes()


def test_masks_masking_and_packing_equal(vit):
    j, t = vit
    hm_j = JPG.hard_masks(j["cfg"], j["params"], j["scores"])
    hm_t = PG.hard_masks(t["cfg"], t["params"], t["scores"])
    assert sorted(hm_j) == sorted(hm_t)
    for p in hm_j:
        assert np.array_equal(np.asarray(hm_j[p]), hm_t[p].numpy()), p
    # masking multiplies by exact 0/1: bitwise
    for (pj, lj), (_, lt) in zip(
            jax.tree_util.tree_flatten_with_path(j["masked"])[0],
            PG.flatten_with_path(t["masked"])):
        assert np.array_equal(np.asarray(lj), lt.numpy()), pj
    packed_t = PR.pack_model(t["cfg"], t["params"], t["scores"])
    assert sorted(packed_t) == sorted(j["packed"])
    for p, pj in j["packed"].items():
        pt = packed_t[p]
        assert np.array_equal(np.asarray(pj.header), pt.header.numpy())
        assert np.array_equal(pj.col_perm, pt.col_perm)
        assert np.array_equal(np.asarray(pj.counts), pt.counts.numpy())
        assert np.array_equal(np.asarray(pj.blocks), pt.blocks.numpy())


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("use_tdm", [None, False])
def test_segment_plan_and_trajectories_equal(full, use_tdm):
    jcfg = J_DEIT if full else J_DEIT.reduced()
    tcfg = T_DEIT if full else T_DEIT.reduced()
    assert PR.vit_segments(tcfg, use_tdm) == JPR.vit_segments(jcfg, use_tdm)
    side = tcfg.image_size // tcfg.patch_size
    for n in sorted({1, side, (side - 1) ** 2, side ** 2}):
        for r in (None, 0.5, 0.7, 1.0):
            assert PR.keep_schedule(tcfg, r, use_tdm) == \
                JPR.keep_schedule(jcfg, r, use_tdm)
            assert PR.token_trajectory(tcfg, n, r, use_tdm) == \
                JPR.token_trajectory(jcfg, n, r, use_tdm)
            if r is not None:
                assert PR.tdm_keep_count(n + 1, r) == \
                    JPR.tdm_keep_count(n + 1, r)
    if full and use_tdm is None:
        # the paper's trajectory for a 196-patch image at r_t = 0.7
        traj = PR.token_trajectory(tcfg, 196)
        assert [traj[0]] + [traj[i] for i, s in
                            enumerate(PR.vit_segments(tcfg))
                            if s[0] == "tdm"] == [197, 140, 100, 72]


def test_each_segment_matches_reference(vit):
    """Every segment of the plan on a token-padded batch of 2 (row 1 has
    3 padded tokens), fed the same input in both packages."""
    j, t = vit
    cfg = t["cfg"]
    jseg = JPR.PackedVitSegments(j["cfg"], j["masked"], j["packed"])
    tseg = PR.PackedVitSegments(cfg, t["masked"], t["packed"], device="cpu")
    assert tseg.plan == jseg.plan
    n_patch = (cfg.image_size // cfg.patch_size) ** 2
    x = _patches(cfg, 2, n_patch)
    n_real = np.array([n_patch + 1, n_patch - 2], np.int32)  # after embed
    for seg in tseg.plan:
        kind = seg[0]
        nv = n_real if kind in ("layers", "tdm") else None
        k = PR.tdm_keep_count(int(n_real.min()), cfg.pruning.r_t) \
            if kind == "tdm" else None
        y_j = np.asarray(jseg.run(seg, jnp.asarray(x), n_valid=nv, k=k))
        y_t = tseg.run(seg, torch.from_numpy(x), n_valid=nv, k=k).numpy()
        assert y_t.shape == y_j.shape, seg
        for b in range(2):
            rows = slice(None) if kind == "head" else (
                slice(None, k + 2) if kind == "tdm" else
                slice(None, int(n_real[b])))
            np.testing.assert_allclose(
                y_t[b][rows], y_j[b][rows], atol=OP_TOL * 10,
                rtol=OP_TOL * 10, err_msg=f"{seg} row {b}")
        x = np.array(y_j)  # writable copy for torch.from_numpy
        if kind == "tdm":
            n_real = np.full(2, k + 2, np.int32)
    assert tseg.compile_count == len(tseg.plan)
    assert tseg.jit_compile_count() == tseg.compile_count


@pytest.mark.parametrize("use_tdm,schedule", [(None, None), (False, None),
                                              (True, (0.5,))])
def test_forward_vit_packed_matches_reference(vit, use_tdm, schedule):
    j, t = vit
    cfg = t["cfg"]
    x = _patches(cfg, 2, (cfg.image_size // cfg.patch_size) ** 2, seed=3)
    y_j = np.asarray(JPR.forward_vit_packed(
        j["cfg"], j["masked"], j["packed"], jnp.asarray(x), use_tdm=use_tdm,
        schedule=schedule).logits)
    y_t = PR.forward_vit_packed(cfg, t["masked"], t["packed"], x,
                                use_tdm=use_tdm, schedule=schedule,
                                device="cpu").logits.numpy()
    np.testing.assert_allclose(y_t, y_j, atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("use_tdm", [None, False])
def test_masked_dense_reference_matches_reference(vit, use_tdm):
    j, t = vit
    cfg = t["cfg"]
    x = _patches(cfg, 2, (cfg.image_size // cfg.patch_size) ** 2, seed=4)
    y_j = np.asarray(JPR.masked_dense_reference(
        j["cfg"], j["params"], j["scores"], jnp.asarray(x),
        use_tdm=use_tdm).logits)
    y_t = PR.masked_dense_reference(cfg, t["params"], t["scores"],
                                    torch.from_numpy(x),
                                    use_tdm=use_tdm).logits.numpy()
    np.testing.assert_allclose(y_t, y_j, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    # and the packed path agrees with it inside the port
    y_p = PR.forward_vit_packed(cfg, t["masked"], t["packed"], x,
                                use_tdm=use_tdm, device="cpu").logits.numpy()
    np.testing.assert_allclose(y_p, y_t, atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_init_params_layout_and_seed(vit):
    j, _ = vit
    cfg = T_DEIT.reduced()
    p1 = M.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    p2 = M.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    shapes_j = [(JPG._path_str(p), tuple(l.shape)) for p, l in
                jax.tree_util.tree_flatten_with_path(j["params"])[0]]
    shapes_t = [(PG._path_str(p), tuple(l.shape)) for p, l in
                PG.flatten_with_path(p1)]
    assert shapes_t == shapes_j
    for (_, a), (_, b) in zip(PG.flatten_with_path(p1),
                              PG.flatten_with_path(p2)):
        assert torch.equal(a, b)
    scores = PG.init_scores(cfg, p1, torch.Generator().manual_seed(7))
    assert sorted(scores) == sorted(j["scores"])


def test_patchify_matches_reference():
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        M.patchify(torch.from_numpy(img), 8).numpy(),
        np.asarray(JM.patchify(jnp.asarray(img), 8)))


def test_unported_modes_raise(vit):
    """Soft TDM and the fp16/int8 tiers are ported (their parity tests
    follow), and so is causal attention with the dense LM path
    (``test_torch_lm.py``), and every LM family (``test_torch_moe.py``,
    ``test_torch_ssm.py``, ``test_torch_multimodal.py``); what is still
    unported raises: the fused QKV projection (a training lever of the
    reference's ``launch/perf.py``) and stacked layers in the pruning
    glue."""
    _, t = vit
    cfg = t["cfg"]
    x = _patches(cfg, 1, 16)
    for soft in (False, True):
        for precision in Q.PRECISIONS:
            y = PR.forward_vit_packed(cfg, t["masked"], t["packed"], x,
                                      soft=soft, precision=precision,
                                      device="cpu").logits
            assert y.shape == (1, cfg.num_classes)
    with pytest.raises(NotImplementedError, match="fuse_qkv"):
        M.init_params(get_config("deit-small").replace(fuse_qkv=True),
                      torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="stacked layer axes"):
        PG.init_scores(cfg, {"layers": {"attn": {"wq": torch.zeros(
            (2, 4, 4))}}}, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("full", [False, True])
def test_soft_trajectories_equal(full):
    jcfg = J_DEIT if full else _all_tdm(J_DEIT.reduced())
    tcfg = T_DEIT if full else _all_tdm(T_DEIT.reduced())
    side = tcfg.image_size // tcfg.patch_size
    for n in sorted({1, 2, side, (side - 1) ** 2, side ** 2}):
        for r in (None, 0.5, 0.7, 1.0):
            assert PR.token_trajectory(tcfg, n, r, soft=True) == \
                JPR.token_trajectory(jcfg, n, r, soft=True)
            for has_pkg in (False, True):
                if r is not None and n >= 2:
                    assert PR.tdm_soft_keep_count(n + 1, r, has_pkg) == \
                        JPR.tdm_soft_keep_count(n + 1, r, has_pkg)


@pytest.mark.parametrize("precision", Q.PRECISIONS)
@pytest.mark.parametrize("granularity", Q.GRANULARITIES)
def test_quantized_packed_dicts_bit_identical(vit, precision, granularity):
    """The port quantizes the converted fp32 dict to the very blocks and
    scales the reference quantizes, and converts the reference's
    quantized dict to the same; sizes and errors agree."""
    j, t = vit
    qj = JQ.quantize_packed_dict(j["packed"], precision, granularity)
    for qt in (Q.quantize_packed_dict(t["packed"], precision, granularity),
               convert.packed_dict_from_jax(qj)):
        assert sorted(qt) == sorted(qj)
        for path, wj in qj.items():
            wt = qt[path]
            assert type(wt).__name__ == type(wj).__name__
            np.testing.assert_array_equal(wt.blocks.numpy(),
                                          np.asarray(wj.blocks))
            assert str(wt.blocks.dtype) == \
                f"torch.{np.asarray(wj.blocks).dtype}"
            if precision == "int8":
                np.testing.assert_array_equal(wt.scales.numpy(),
                                              np.asarray(wj.scales))
                assert wt.granularity == granularity
            np.testing.assert_array_equal(wt.header.numpy(),
                                          np.asarray(wj.header))
            np.testing.assert_array_equal(wt.col_perm, wj.col_perm)
        assert Q.packed_dict_nbytes(qt) == JQ.packed_dict_nbytes(qj)
        assert Q.max_abs_error(t["packed"], qt) == \
            JQ.max_abs_error(j["packed"], qj)


@pytest.fixture(scope="module")
def soft_vit(vit):
    """The reduced model with a TDM at every layer, as both packages'
    segment executors."""
    j, t = vit
    jcfg, tcfg = _all_tdm(j["cfg"]), _all_tdm(t["cfg"])
    return (JPR.PackedVitSegments(jcfg, j["masked"], j["packed"]),
            PR.PackedVitSegments(tcfg, t["masked"], t["packed"],
                                 device="cpu"))


@pytest.mark.parametrize("precision", Q.PRECISIONS)
def test_each_soft_segment_matches_reference(soft_vit, precision):
    """Every segment of the all-TDM plan, soft, on a masked batch of 2 (row
    1 has 3 padded tokens at the first TDM; later TDMs pin each row's
    package at ``n_valid - 2``), fed the same input and package masses in
    both packages. Per-row package positions that differ within a tile are
    held against the reference in ``test_torch_kernels.py``."""
    jseg, tseg = soft_vit
    cfg = tseg.cfg
    assert tseg.plan == jseg.plan
    tol = TIER_TOL[precision] * 10 if precision == "fp16" else OP_TOL * 10
    n_patch = (cfg.image_size // cfg.patch_size) ** 2
    x = _patches(cfg, 2, n_patch, seed=5)
    n_real = np.array([n_patch + 1, n_patch - 2], np.int32)
    mass = None
    ordinal = 0
    for seg in tseg.plan:
        kind = seg[0]
        nv = n_real if kind in ("layers", "tdm") else None
        if kind != "tdm":
            y_j = np.asarray(jseg.run(seg, jnp.asarray(x), n_valid=nv,
                                      precision=precision))
            y_t = tseg.run(seg, torch.from_numpy(x), n_valid=nv,
                           precision=precision).numpy()
        else:
            k = PR.tdm_soft_keep_count(int(n_real.min()), cfg.pruning.r_t,
                                       has_pkg=ordinal > 0)
            y_j, m_j = jseg.run(
                seg, jnp.asarray(x), n_valid=nv, k=k, soft=True,
                pkg_mass=None if mass is None else jnp.asarray(mass),
                precision=precision)
            y_t, m_t = tseg.run(
                seg, torch.from_numpy(x), n_valid=nv, k=k, soft=True,
                pkg_mass=None if mass is None else torch.from_numpy(mass),
                precision=precision)
            y_j, y_t = np.asarray(y_j), y_t.numpy()
            np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j),
                                       atol=tol, rtol=tol)
            mass = np.array(m_j)
            ordinal += 1
        assert y_t.shape == y_j.shape, seg
        for b in range(2):
            rows = slice(None) if kind == "head" else (
                slice(None, k + 2) if kind == "tdm" else
                slice(None, int(n_real[b])))
            np.testing.assert_allclose(
                y_t[b][rows], y_j[b][rows], atol=tol, rtol=tol,
                err_msg=f"{seg} row {b}")
        x = np.array(y_j)
        if kind == "tdm":
            n_real = np.full(2, k + 2, np.int32)
    assert ordinal == cfg.num_layers
    marker = ("soft",) if precision == "fp32" else ("soft", precision)
    tdm_keys = [key for key in tseg.compiled_tiles()
                if key[0][0] == "tdm" and key[4:] == marker]
    assert len(tdm_keys) == ordinal


@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("precision", Q.PRECISIONS)
def test_forward_vit_packed_tiers_match_reference(vit, soft, precision):
    """The offline oracle at every tier, hard and soft, with the package
    mass chaining through the all-TDM plan, against the reference's."""
    j, t = vit
    jcfg, tcfg = _all_tdm(j["cfg"]), _all_tdm(t["cfg"])
    x = _patches(tcfg, 2, (tcfg.image_size // tcfg.patch_size) ** 2, seed=6)
    y_j = np.asarray(JPR.forward_vit_packed(
        jcfg, j["masked"], j["packed"], jnp.asarray(x), soft=soft,
        precision=precision).logits)
    y_t = PR.forward_vit_packed(tcfg, t["masked"], t["packed"], x,
                                soft=soft, precision=precision,
                                device="cpu").logits.numpy()
    tol = TIER_TOL[precision]
    np.testing.assert_allclose(y_t, y_j, atol=tol, rtol=tol)
    assert (y_t.argmax(-1) == y_j.argmax(-1)).all()


def test_fused_soft_lane_matches_segments(soft_vit):
    """An express lane over soft steps (``run_fused``), entered after the
    first soft TDM with its package mass as the seed, equals the segments
    run one by one, at the int8 tier."""
    _, tseg = soft_vit
    cfg = tseg.cfg
    x = torch.from_numpy(_patches(cfg, 1, 16, seed=7))
    h = tseg.run(("embed",), x)
    h, mass = tseg.run(("tdm", 0), h, k=PR.tdm_soft_keep_count(
        17, cfg.pruning.r_t, False), soft=True, precision="int8")
    steps, y, m, n = [], h, mass, h.shape[1]
    for seg in tseg.plan[2:]:
        if seg[0] == "tdm":
            k = PR.tdm_soft_keep_count(n, cfg.pruning.r_t, True)
            steps.append((seg, k, True))
            y, m = tseg.run(seg, y, k=k, soft=True, pkg_mass=m,
                            precision="int8")
            n = k + 2
        else:
            steps.append((seg, None))
            y = tseg.run(seg, y, precision="int8")
    fused = tseg.run_fused(tuple(steps), h, pkg_mass=mass.reshape(1),
                           precision="int8")
    assert torch.equal(fused, y)
    assert tseg.fused_trajectory_count == 1


@pytest.mark.parametrize("n_valid", [(5, 6), (0, 5), (5,)])
def test_segments_reject_n_valid_outside_the_tile(vit, n_valid):
    _, t = vit
    seg = PR.PackedVitSegments(t["cfg"], t["masked"], t["packed"],
                               device="cpu")
    x = torch.zeros((2, 5, t["cfg"].d_model))
    with pytest.raises(ValueError, match="n_valid"):
        seg.run(("layers", 0, 1), x, n_valid=np.array(n_valid))
