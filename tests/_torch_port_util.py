"""Shared helpers of the port's CPU parity tests (tests/test_torch_port_*.py).

Weights are drawn by the JAX package, edited through the port
(`chip_smoke.liven`) and handed to both packages as numpy trees
(`models/convert.from_jax_params` into the port), so both run the same
numbers.
"""

import numpy as np

from yolo_series_tpu_torch.models.convert import to_jax_tree  # noqa: F401 (re-exported)

DEPLOY_CFG = "yolo_series_tpu/models/cfg/deploy/yolov7.yaml"
PORT_DEPLOY_CFG = "yolo_series_tpu_torch/models/cfg/deploy/yolov7.yaml"
TRAINING_CFG = "yolo_series_tpu/models/cfg/training/yolov7.yaml"
PORT_TRAINING_CFG = "yolo_series_tpu_torch/models/cfg/training/yolov7.yaml"


def deploy_cfg(width=1.0, path=DEPLOY_CFG, nc=None):
    import yaml

    with open(path) as f:
        d = yaml.safe_load(f)
    d["width_multiple"] = width
    if nc is not None:
        d["nc"] = nc
    return d


def training_cfg(width=1.0, nc=None):
    """yolov7's training form (IDetect head) at `width`."""
    return deploy_cfg(width, TRAINING_CFG, nc)


def nms_chain(k, offset=0.0):
    """One greedy-NMS suppression chain of k score-sorted xyxy boxes: each
    overlaps the next at IoU 0.54 and the one after at 0.25, so greedy
    keeps every other box and the fixpoint needs k passes."""
    x0 = np.arange(k, dtype=np.float64) * 18.0
    boxes = np.stack([x0, np.full(k, 100.0), x0 + 60.0, np.full(k, 160.0)], -1)
    return (boxes + offset).astype(np.float32)


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    return np.asarray(tree)


def assert_trees_close(got, want, rel, what=""):
    """Every leaf of the port's tree `got` (back in JAX form) against the
    JAX tree `want`: max |got - want| <= rel x max(|want|) of that leaf
    (a leaf of zeros must be zeros). Same structure and shapes."""
    import jax

    g = jax.tree_util.tree_leaves_with_path(to_jax_tree(got))
    w = jax.tree_util.tree_leaves_with_path(to_numpy(want))
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (path, a), (_, b) in zip(g, w):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, (what, path)
        err, scale = np.abs(a - b).max(initial=0.0), np.abs(b).max(initial=0.0)
        assert err <= rel * scale, (what, jax.tree_util.keystr(path), err, scale)


def rel_l2(got, want, before=None):
    """Relative L2 distance of two trees of numpy arrays in the JAX layout
    over all their leaves: |got - want| / |want - before|, before a tree of
    zeros when None (with it, the distance of two updates of one tree)."""
    import jax

    g, w = ([np.asarray(a, np.float64) for a in jax.tree_util.tree_leaves(t)]
            for t in (got, want))
    b = ([np.asarray(a, np.float64) for a in jax.tree_util.tree_leaves(before)]
         if before is not None else [0.0] * len(w))
    num = sum(float(np.square(x - y).sum()) for x, y in zip(g, w))
    den = sum(float(np.square(y - z).sum()) for y, z in zip(w, b))
    return (num / den) ** 0.5


def jax_training_model(width=0.25, seed=0, stats_seed=None):
    """yolov7 training form (IDetect) at `width`, weights drawn by the JAX
    package (seed), unlivened: (jax plan, params_np, state_np, port plan,
    port params, port state). With stats_seed, every BN running mean is
    N(0, 0.2) and every running var U(0.5, 1.5) (so the shifted one-pass
    moments are centred off zero)."""
    import jax

    from yolo_series_tpu.models.model import Model
    from yolo_series_tpu_torch.models.convert import from_jax_params
    from yolo_series_tpu_torch.models.graph import compile_graph

    cfg = training_cfg(width)
    m = Model.from_yaml(cfg, key=jax.random.PRNGKey(seed))
    params, state = to_numpy(m.params), to_numpy(m.state)
    if stats_seed is not None:
        rng = np.random.default_rng(stats_seed)

        def draw(path, a):
            name = jax.tree_util.keystr(path[-1:])
            if "mean" in name:
                return rng.normal(0, 0.2, a.shape).astype(np.float32)
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)

        state = jax.tree_util.tree_map_with_path(draw, state)
    tplan = compile_graph(cfg)
    tp, ts = from_jax_params(tplan, params, state)
    return m.plan, params, state, tplan, tp, ts


def jax_model(width=0.5, seed=0, size=128, candidates=150, cfg=None):
    """JAX yolov7 (deploy form unless `cfg` is given) at `width`: (plan,
    params_np, state_np), unfused. The random init is edited by
    `chip_smoke.liven` (through the port, on `size` px noise frames) so the
    model detects what is in the image, with about `candidates` anchors per
    image above conf 0.25 (IDetect's implicit layers, near identity at
    init, stay as drawn)."""
    import jax
    import torch

    from chip_smoke import liven
    from yolo_series_tpu.models.model import Model
    from yolo_series_tpu_torch.models.convert import from_jax_params
    from yolo_series_tpu_torch.models.graph import compile_graph

    cfg = deploy_cfg(width) if cfg is None else cfg
    m = Model.from_yaml(cfg, key=jax.random.PRNGKey(seed))
    state = to_numpy(m.state)
    tplan = compile_graph(cfg)
    tp, ts = from_jax_params(tplan, to_numpy(m.params), state)
    x = np.random.default_rng(seed).integers(0, 256, (2, size, size, 3))
    liven(tplan, tp, ts, torch.from_numpy(x / 255.0).float(),
          candidates=candidates)
    return m.plan, to_jax_tree(tp), state


# the P6 family (ReOrg stem, four levels; training form IAuxDetect)
P6_MODELS = ("yolov7-w6", "yolov7-e6", "yolov7-d6", "yolov7-e6e")


def zoo_cfg(name, kind="training", width=1.0, nc=None):
    """The JAX package's cfg `kind/name.yaml` as a dict at `width`."""
    return deploy_cfg(width, f"yolo_series_tpu/models/cfg/{kind}/{name}.yaml", nc)


def port_drawn_model(cfg, seed=0, stats_seed=None):
    """`cfg` with weights drawn by the port (`init_model`, a torch.Generator
    seeded with `seed`): (jax plan, params_np, state_np in the JAX layout,
    port plan, port params, port state). Drawing on the port's side takes
    well under a second where the JAX package's eager init of a P6 model
    takes ~25 s; both packages still get the same numbers. With
    stats_seed, every BN running mean is N(0, 0.2) and every running var
    U(0.5, 1.5)."""
    import torch

    from yolo_series_tpu.models.graph import compile_graph as jcompile
    from yolo_series_tpu_torch.models.convert import to_jax_params
    from yolo_series_tpu_torch.models.graph import compile_graph
    from yolo_series_tpu_torch.models.model import init_model

    tplan = compile_graph(cfg)
    tp, ts = init_model(tplan, torch.Generator().manual_seed(seed))
    if stats_seed is not None:
        gen = torch.Generator().manual_seed(stats_seed)

        def draw(tree):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    if k == "mean" and isinstance(v, torch.Tensor):
                        v.normal_(0.0, 0.2, generator=gen)
                    elif k == "var" and isinstance(v, torch.Tensor):
                        v.uniform_(0.5, 1.5, generator=gen)
                    else:
                        draw(v)
            elif isinstance(tree, (list, tuple)):
                for v in tree:
                    draw(v)

        draw(ts)
    params, state = to_jax_params(tplan, tp, ts)
    return jcompile(cfg), params, state, tplan, tp, ts
