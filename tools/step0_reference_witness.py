#!/usr/bin/env python3
"""How far bf16 alone moves step 0's gradients in the reference package,
and whether the port's bf16 path lies where the reference's does. CPU
only: it imports the JAX package beside the port, as the port's tests do.

At full width and a cut depth, with ``launch/train``'s ``--prune`` config
(block 16, r_b 0.5), batch 2 x 128 tokens of ``synthetic_lm_batch`` step
0, weights and scores from the reference's seeded init (key 0, scores
folded with 7) converted by ``convert``, it takes the gradient of step
0's loss (the STE through the scores plus the regularizer) four times:
the reference at fp32 and at bf16 (``jax.value_and_grad``), the port at
fp32 and at bf16 (``models/steps.make_grad_fn``). Per leaf, relative to
its largest reference fp32 element, it prints the worst three of the
following, and the worst relative Frobenius norm of each:

* ``ref bf16 - ref fp32``: the reference's own bf16 distance (the witness
  a card-against-CPU gate has to allow where bf16 is chaotic);
* ``port bf16 - ref bf16``: the port's bf16 path against the reference's;
* ``port fp32 - ref fp32``: the two fp32 paths;
* ``port bf16 - port fp32``: the port's own bf16 distance.

Every row goes to ``build/step0_reference_witness.json``. With
``--reduced``, the configs' reduced widths (the CPU tests' and the card
tests'); a spec's layers 0 keeps the config's depth.

    PYTHONPATH=src python3 tools/step0_reference_witness.py [--reduced] \
        [zamba2-1.2b:1:1 zamba2-1.2b:2:1 zamba2-1.2b:7 rwkv6-1.6b:2]
        # arch:layers[:period]

Full width takes memory: about 12 GiB at Zamba2's 7 layers.
"""
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

DEFAULT = ("zamba2-1.2b:1:1", "zamba2-1.2b:2:1", "zamba2-1.2b:7",
           "rwkv6-1.6b:2")
BATCH, SEQ = 2, 128
PRUNE = dict(block_size=16, r_b=0.5, r_t=1.0)  # launch/train's --prune


def _cut(cfg, layers, period, reduced):
    if reduced:
        cfg = cfg.reduced()
    pruning = type(cfg.pruning)(**PRUNE, lambda_reg=cfg.pruning.lambda_reg)
    cfg = cfg.replace(num_layers=layers or cfg.num_layers, pruning=pruning)
    return cfg if period is None else cfg.replace(attn_layer_period=period)


def reference_grads(jcfg, jp, js, tokens):
    """jax.value_and_grad of the reference's pruned step-0 loss, as
    ``steps.make_train_step``'s ``loss_fn``: (loss, grads)."""
    import jax
    import jax.numpy as jnp
    from repro.models import model as JM
    from repro.models import pruning_glue as JPG

    def loss_fn(tr):
        params = JPG.apply_pruning(jcfg, tr["params"], tr["scores"])
        total, _ = JM.lm_loss(jcfg, params, {"tokens": jnp.asarray(tokens)})
        return total + jcfg.pruning.lambda_reg * JPG.regularizer(tr["scores"])

    loss, g = jax.jit(jax.value_and_grad(loss_fn))(
        {"params": jp, "scores": js})
    return float(loss), jax.tree_util.tree_map(np.asarray, g)


def port_grads(tcfg, tp, ts, tokens):
    import torch
    from repro_torch.models import steps as ST
    loss, _, g = ST.make_grad_fn(tcfg, True)(
        tp, {"tokens": torch.from_numpy(tokens)}, ts)
    return float(loss), g


def flat_port(g):
    """{path: fp64 array} of a port gradient tree {"params", "scores"}."""
    from repro_torch.tree import flatten_with_path, path_str
    out = {}
    for path, t in flatten_with_path(g):
        out[path_str(path)] = t.detach().double().numpy()
    return out


def flat_reference(jg):
    """The reference's gradient tree in the port's layout and paths."""
    from repro_torch import convert
    return flat_port({"params": convert.lm_params_from_jax(jg["params"]),
                      "scores": convert.lm_scores_from_jax(jg["scores"])})


def one(spec, reduced=False):
    import jax
    from repro.configs import get_config as j_get_config
    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.data import DataConfig as JDataConfig
    from repro.data import pipeline as JDP
    from repro.models import model as JM
    from repro.models import pruning_glue as JPG
    from repro_torch import convert
    from repro_torch.configs import get_config

    arch, layers, *rest = spec.split(":")
    period = int(rest[0]) if rest else None
    jcfg = _cut(j_get_config(arch), int(layers), period, reduced)
    tcfg = _cut(get_config(arch), int(layers), period, reduced)
    key = jax.random.PRNGKey(0)
    jp = JM.init_params(jcfg.replace(dtype="float32"), key)
    js = JPG.init_scores(jcfg, jp, jax.random.fold_in(key, 7))
    tokens = JDP.synthetic_lm_batch(
        jcfg, JShapeConfig("t", SEQ, BATCH, "train"), JDataConfig(),
        0)["tokens"]
    tp = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    ts = convert.lm_scores_from_jax(jax.tree_util.tree_map(np.asarray, js))

    losses, grads = {}, {}
    for dt in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        losses[f"ref {dt}"], g = reference_grads(
            jcfg.replace(dtype=dt), jp, js, tokens)
        grads[f"ref {dt}"] = flat_reference(g)
        t1 = time.perf_counter()
        losses[f"port {dt}"], g = port_grads(
            tcfg.replace(dtype=dt), tp, ts, tokens)
        grads[f"port {dt}"] = flat_port(g)
        print(f"{spec} {dt}: reference {t1 - t0:.1f} s, port "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
    pairs = {"ref bf16 - ref fp32": ("ref bfloat16", "ref float32"),
             "port bf16 - ref bf16": ("port bfloat16", "ref bfloat16"),
             "port fp32 - ref fp32": ("port float32", "ref float32"),
             "port bf16 - port fp32": ("port bfloat16", "port float32")}
    ref = grads["ref float32"]
    rows = {}
    for path, r in ref.items():
        m = float(np.abs(r).max())
        rows[path] = {"max_ref_fp32": m}
        n = float(np.linalg.norm(r))
        for name, (a, b) in pairs.items():
            diff = grads[a][path] - grads[b][path]
            rows[path][name] = float(np.abs(diff).max()) / m if m else \
                float("inf")
            rows[path][name + " (Frobenius)"] = \
                float(np.linalg.norm(diff)) / n if n else float("inf")
    print(f"{spec}: losses " + ", ".join(
        f"{k} {v:.6f}" for k, v in losses.items()), flush=True)
    for name in pairs:
        worst = sorted(rows, key=lambda p: -rows[p][name])[:3]
        fro = max(rows[p][name + " (Frobenius)"] for p in rows)
        print(f"{spec}: {name}, per leaf / max|ref fp32|: " + ", ".join(
            f"{rows[p][name]:.4g} ({p})" for p in worst)
            + f"; worst |d|_F / |ref fp32|_F {fro:.4g}", flush=True)
    return {"losses": losses, "rows": rows}


def main(argv):
    reduced = "--reduced" in argv
    specs = [a for a in argv if a != "--reduced"] or DEFAULT
    out = {spec: one(spec, reduced) for spec in specs}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "step0_reference_witness.json"),
              "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1:])
