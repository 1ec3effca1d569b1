"""How far two computations of one yolov7 train step lie apart on the CPU,
which sets the tolerances of the train-step tests and of `chip_smoke.py`
phase 7 (c). Not a test: run it from the repo root with

    JAX_PLATFORMS=cpu python -m tests.torch_port_train_noise

It prints one line a measurement:

  * bf16 against fp32: one step of the JAX package and one of the port,
    each in bf16 and in fp32 from the same weights on the same batch (OTA,
    SGD): the loss items' largest relative difference and the cosine
    similarity of the two parameter updates;
  * the step's sensitivity: one fp32 JAX step against the same step with
    the input images scaled by 1 + 1e-7 N(0, 1), and against the port's
    step (the relative L2 distance of the parameter updates);
  * three fp32 steps in a row of both packages from equal init (no resync):
    the relative L2 distance of the updates after each step;
  * the loss items of one fp32 step, port against JAX, from the same state
    on eight random batches: their largest relative difference (what the
    trainer test's loss limit rests on).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from chip_smoke import train_batch
from tests._torch_port_util import jax_training_model, to_jax_tree, to_numpy
from yolo_series_tpu.losses import LossHyp as JHyp
from yolo_series_tpu.losses import make_compute_loss_ota as jloss_ota
from yolo_series_tpu.train.optim import OptimConfig as JOpt
from yolo_series_tpu.train.step import init_train_state as jinit
from yolo_series_tpu.train.step import make_train_step as jmake
from yolo_series_tpu_torch.losses import LossHyp, make_compute_loss_ota
from yolo_series_tpu_torch.train.optim import OptimConfig
from yolo_series_tpu_torch.train.step import init_train_state, make_train_step

torch.set_num_threads(4)
LR = np.asarray([0.01, 0.01, 0.01], np.float32)
MOM = np.float32(0.937)


def flat(tree):
    return np.concatenate([np.ravel(np.asarray(x, np.float64))
                           for x in jax.tree_util.tree_leaves(tree)])


def jax_steps(model, data, dtype, n=1, scale=None):
    jplan, params, state = model[:3]
    ts = jinit(jax.tree_util.tree_map(jnp.asarray, params),
               jax.tree_util.tree_map(jnp.asarray, state), JOpt())
    step = jmake(jplan, jloss_ota(jplan.head, JHyp()), JOpt(), compute_dtype=dtype)
    images = data[0].astype(np.float32) / 255.0 if scale is not None else data[0]
    if scale is not None:
        images = (images * scale).astype(np.float32)
    out = []
    for _ in range(n):
        ts, m = step(ts, jnp.asarray(images), jnp.asarray(data[1]), jnp.asarray(data[2]),
                     jnp.asarray(LR), jnp.asarray(MOM))
        out.append((flat(to_numpy(ts.params)) - flat(params),
                    {k: float(v) for k, v in m.items()}))
    return out


def port_steps(model, data, dtype, n=1):
    params, tplan, tp, ts0 = model[1], model[3], model[4], model[5]
    ts = init_train_state(tp, ts0, OptimConfig(), device="cpu")
    step = make_train_step(tplan, make_compute_loss_ota(tplan.head, LossHyp()), OptimConfig(),
                           compute_dtype=dtype)
    out = []
    for _ in range(n):
        ts, m = step(ts, *data, LR, MOM)
        out.append((flat(to_jax_tree(ts.params)) - flat(params),
                    {k: float(v) for k, v in m.items()}))
    return out


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def cos(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def items_err(a, b):
    return max(abs(a[k] - b[k]) / abs(b[k]) for k in b)


def main():
    for width, img in ((0.25, 128), (1.0, 256)):
        model = jax_training_model(width, seed=0)
        data = train_batch(np.random.default_rng(7), 2, img)
        (j16, jm16), = jax_steps(model, data, jnp.bfloat16)
        (j32, jm32), = jax_steps(model, data, jnp.float32)
        (t16, tm16), = port_steps(model, data, torch.bfloat16)
        (t32, tm32), = port_steps(model, data, torch.float32)
        print(f"width {width}, {img} px, batch 2: bf16 against fp32: JAX items "
              f"{items_err(jm16, jm32):.3g}, update cosine {cos(j16, j32):.4f}; port items "
              f"{items_err(tm16, tm32):.3g}, cosine {cos(t16, t32):.4f}; fp32 port against "
              f"JAX update cosine {cos(t32, j32):.8f}", flush=True)
    model = jax_training_model(0.25, seed=0, stats_seed=1)
    for seed in (0, 1):
        data = train_batch(np.random.default_rng(seed), 2, 128)
        (j32, _), = jax_steps(model, data, jnp.float32)
        noise = 1 + 1e-7 * np.random.default_rng(seed + 10).standard_normal(data[0].shape)
        (jp, _), = jax_steps(model, data, jnp.float32, scale=noise)
        (t32, _), = port_steps(model, data, torch.float32)
        print(f"seed {seed}, width 0.25, 128 px: one fp32 step's update, relative L2: JAX "
              f"with the input x (1 + 1e-7 N(0, 1)) {rel_l2(jp, j32):.3g}, the port "
              f"{rel_l2(t32, j32):.3g}", flush=True)
        jn = jax_steps(model, data, jnp.float32, n=3)
        tn = port_steps(model, data, torch.float32, n=3)
        print(f"seed {seed}: three fp32 steps in a row, port against JAX, relative L2 of "
              f"the updates after each: "
              + ", ".join(f"{rel_l2(t, j):.3g}" for (t, _), (j, _) in zip(tn, jn)), flush=True)
    errs = []
    for seed in range(8):
        data = train_batch(np.random.default_rng(100 + seed), 2, 128)
        (_, jm), = jax_steps(model, data, jnp.float32)
        (_, tm), = port_steps(model, data, torch.float32)
        errs.append(items_err(tm, jm))
    print("one fp32 step's loss items, port against JAX, largest relative difference on "
          "8 batches: " + ", ".join(f"{e:.3g}" for e in errs), flush=True)


if __name__ == "__main__":
    main()
