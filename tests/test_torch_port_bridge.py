"""The reference `.pt` bridge of the port (`models/torch_import`,
`models/torch_export`, `train/checkpoints.load_checkpoint_any`) against the
JAX package's on the CPU: a state dict written by either package's
exporter reads back through the other's importer to the same trees, bit
for bit, for yolov7's training and deploy forms and the P6 training forms
(w6 with IAuxDetect, e6e with DownC and Shortcut), unfused and fused;
`.pt` files (a state dict, and `{"model", "ema"}` dicts of fp16 tensors)
load through `load_checkpoint_any` and the Detector; Focus and the IBin
head bridge as the JAX package's do; a stray key, a block or head that
neither package knows, and a `.pt` without a cfg raise."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests._torch_port_util import port_drawn_model, zoo_cfg
from yolo_series_tpu.models import reparam as jreparam
from yolo_series_tpu.models.torch_export import export_state_dict as jexport
from yolo_series_tpu.models.torch_import import import_state_dict as jimport
from yolo_series_tpu_torch.infer.detector import Detector
from yolo_series_tpu_torch.models import layers as TL
from yolo_series_tpu_torch.models import reparam as treparam
from yolo_series_tpu_torch.models.convert import from_jax_params, to_jax_params
from yolo_series_tpu_torch.models.model import tree_leaves as leaves
from yolo_series_tpu_torch.models.torch_export import (export_state_dict,
                                                       load_into_reference_model)
from yolo_series_tpu_torch.models.torch_import import import_state_dict
from yolo_series_tpu_torch.train.checkpoints import load_checkpoint_any

torch.set_num_threads(2)

# (cfg kind, name, width, fused)
MODELS = {
    "yolov7_training": ("training", "yolov7", 0.25, False),
    "yolov7_deploy_fused": ("deploy", "yolov7", 0.25, True),
    "w6_training": ("training", "yolov7-w6", 0.125, False),
    "w6_training_fused": ("training", "yolov7-w6", 0.125, True),
    "e6e_training": ("training", "yolov7-e6e", 0.125, False),
}


def _model(case):
    kind, name, width, fused = MODELS[case]
    cfg = zoo_cfg(name, kind, width)
    jplan, params, state, tplan, tp, ts = port_drawn_model(cfg, seed=1, stats_seed=2)
    if fused:
        tp, ts = treparam.fuse_model(tplan, tp, ts)
        params, state = to_jax_params(tplan, tp, ts)
    return cfg, jplan, params, state, tplan, tp, ts


def _same_trees(got, want):
    """The port's trees equal, leaf for leaf and bit for bit, with the same
    structure (dict keys, list lengths)."""
    def walk(a, b, path=""):
        if isinstance(b, dict):
            assert isinstance(a, dict) and set(a) == set(b), path
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(b, (list, tuple)):
            assert isinstance(a, (list, tuple)) and len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/{i}")
        else:
            assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape, path
            assert torch.equal(a, b), path
    walk(got, want)


@pytest.mark.parametrize("case", sorted(MODELS))
def test_jax_export_reads_into_the_port(case):
    """JAX `export_state_dict` -> the port's `import_state_dict` gives the
    trees of `from_jax_params` on the same JAX trees, bit for bit."""
    _, jplan, params, state, tplan, _, _ = _model(case)
    sd = jexport(jplan, params, state)
    got = import_state_dict(tplan, sd)
    _same_trees(got, from_jax_params(tplan, params, state))


@pytest.mark.parametrize("case", sorted(MODELS))
def test_port_export_reads_into_jax(case):
    """The port's `export_state_dict` is JAX's, key for key and bit for bit
    (the head's anchors and anchor_grid buffers too), and JAX's
    `import_state_dict` of it gives back JAX's trees exactly."""
    _, jplan, params, state, tplan, tp, ts = _model(case)
    sd = export_state_dict(tplan, tp, ts)
    want = jexport(jplan, params, state)
    assert set(sd) == set(want)
    for k in want:
        assert sd[k].dtype == np.float32 and sd[k].shape == want[k].shape, k
        np.testing.assert_array_equal(sd[k], want[k], err_msg=k)
    jp, js = jimport(jplan, sd)
    for got, ref in ((jp, params), (js, state)):
        g = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, got))
        w = jax.tree_util.tree_leaves_with_path(ref)
        assert [p for p, _ in g] == [p for p, _ in w]
        for (path, a), (_, b) in zip(g, w):
            np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
    if case.startswith("w6"):
        assert "model.122.m2.3.weight" in sd and sd["model.122.anchor_grid"].shape == \
            (4, 1, 3, 1, 1, 2)


def test_import_copies_values():
    """The imported trees hold copies: writing into the source state dict's
    tensors afterwards changes nothing."""
    _, _, _, _, tplan, tp, ts = _model("w6_training")
    sd = {k: torch.from_numpy(v) for k, v in export_state_dict(tplan, tp, ts).items()}
    got, _ = import_state_dict(tplan, sd)
    before = [t.clone() for t in leaves(got)]
    for v in sd.values():
        v.add_(1.0)
    assert all(torch.equal(a, b) for a, b in zip(leaves(got), before))


@pytest.fixture(scope="module")
def w6(tmp_path_factory):
    """w6 training form (width 0.125) and its cfg file."""
    cfg, _, _, _, tplan, tp, ts = _model("w6_training")
    import yaml

    path = tmp_path_factory.mktemp("w6") / "w6.yaml"
    path.write_text(yaml.dump(cfg))
    return str(path), tplan, tp, ts


def _fp16(t):
    return t.to(torch.float16).to(torch.float32)


@pytest.mark.parametrize("form", ["state_dict", "model_ema_none", "ema_preferred"])
def test_pt_files_load_through_load_checkpoint_any(w6, tmp_path, form):
    """A `.pt` written by `torch.save`: a plain fp32 state dict; the
    reference's `{"model": state_dict, "ema": None}` with fp16 tensors; and
    such a dict whose "ema" is set, which is preferred (attempt_load's
    order) unless prefer_ema=False. Each loads through
    `load_checkpoint_any(path, cfg)` into fp32 trees equal to the source
    (fp16-rounded where it was stored in fp16)."""
    cfg, tplan, tp, ts = w6
    sd = {k: torch.from_numpy(v) for k, v in export_state_dict(tplan, tp, ts).items()}
    half = {k: v.half() for k, v in sd.items()}
    other = {k: (v + 1.0).half() for k, v in sd.items()}
    blob = {"state_dict": sd, "model_ema_none": {"model": half, "ema": None},
            "ema_preferred": {"model": half, "ema": other, "epoch": 3}}[form]
    path = tmp_path / "w.pt"
    torch.save(blob, path)
    plan, params, state = load_checkpoint_any(str(path), cfg)
    assert len(plan.layers) == len(tplan.layers)
    if form == "state_dict":
        want_p, want_s = tp, ts
    else:
        src = other if form == "ema_preferred" else half
        want_p, want_s = import_state_dict(tplan, {k: v.float() for k, v in src.items()})
        assert all(torch.equal(a, _fp16(a)) for a in leaves(params))
    _same_trees(params, want_p)
    _same_trees(state, want_s)
    if form == "ema_preferred":
        _, p_model, _ = load_checkpoint_any(str(path), cfg, prefer_ema=False)
        _same_trees(p_model, import_state_dict(tplan, {k: v.float()
                                                       for k, v in half.items()})[0])


def test_detector_takes_a_pt(w6, tmp_path):
    """`Detector.from_checkpoint(x.pt, cfg)` (the detect CLI's path) loads
    and fuses a `.pt` and detects on the CPU, like the same trees given
    directly."""
    cfg, tplan, tp, ts = w6
    path = tmp_path / "w.pt"
    torch.save({"model": {k: torch.from_numpy(v).half() for k, v in
                          export_state_dict(tplan, tp, ts).items()}, "ema": None}, path)
    det = Detector.from_checkpoint(str(path), cfg=cfg, img_size=128, device="cpu",
                                   conf_thres=0.0)
    hp, hs = import_state_dict(tplan, {k: torch.from_numpy(v).half().float() for k, v in
                                       export_state_dict(tplan, tp, ts).items()})
    ref = Detector(tplan, *treparam.fuse_model(tplan, hp, hs), img_size=128, device="cpu",
                   conf_thres=0.0)
    img = np.random.default_rng(0).integers(0, 256, (100, 140, 3), np.uint8)
    got, want = det([img]), ref([img])
    assert len(got) == 1 and len(got[0]) > 0
    np.testing.assert_array_equal(got[0], want[0])


def test_pt_needs_a_cfg(tmp_path):
    path = tmp_path / "w.pt"
    torch.save({}, path)
    with pytest.raises(ValueError, match="--cfg is required"):
        load_checkpoint_any(str(path))


def test_strict_refuses_a_stray_key(w6):
    """A key no block reads raises under strict (the default) and is left
    out with strict=False; the bookkeeping buffers (num_batches_tracked)
    and the head's anchors never count as stray."""
    _, tplan, tp, ts = w6
    sd = export_state_dict(tplan, tp, ts)
    sd["model.3.bn.num_batches_tracked"] = np.zeros((), np.float32)
    import_state_dict(tplan, sd)
    sd["model.3.extra.weight"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="model.3.extra.weight"):
        import_state_dict(tplan, sd)
    got, _ = import_state_dict(tplan, sd, strict=False)
    _same_trees(got, tp)


@dataclasses.dataclass(frozen=True)
class NoSuchBlock(TL.Block):
    """Stands in for a block that neither package knows."""

    c1: int


@dataclasses.dataclass(frozen=True)
class NoSuchHead:
    """Stands in for a head that neither package knows."""

    nc: int = 80


def test_unported_blocks_raise_naming_their_item(w6):
    """The block and head once refused here (Focus, item 16 (c); IBin,
    item 15) bridge both ways now: yolov7 at width 0.25 with a Focus
    layer and an IBin head exports the keys and values of the JAX
    exporter, and JAX's state dict imports to the JAX importer's trees,
    unfused and fused."""
    cfg = zoo_cfg("yolov7", "training", 0.25)
    cfg["backbone"][1] = [-1, 1, "Focus", [64, 3]]
    cfg["head"][-1] = [cfg["head"][-1][0], 1, "IBin", ["nc", "anchors"]]
    jplan, params, state, tplan, tp, ts = port_drawn_model(cfg, seed=1, stats_seed=2)
    assert isinstance(tplan.layers[1].block, TL.Focus)
    assert type(tplan.head).__name__ == "IBin"
    for fused in (False, True):
        if fused:
            tp, ts = treparam.fuse_model(tplan, tp, ts)
            params, state = to_jax_params(tplan, tp, ts)
        want = jexport(jplan, params, state)
        got = export_state_dict(tplan, tp, ts)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
        wp, ws = jimport(jplan, want)
        gp, gs = import_state_dict(tplan, want)
        _same_trees(gp, from_jax_params(tplan, jax.tree_util.tree_map(np.asarray, wp),
                                        jax.tree_util.tree_map(np.asarray, ws))[0])


def test_unknown_block_or_head_raises_naming_no_item(w6):
    """A block or head class that neither package knows raises
    NotImplementedError naming no ROADMAP item, in the importer and the
    exporter."""
    _, tplan, tp, ts = w6
    sd = export_state_dict(tplan, tp, ts)
    layers = list(tplan.layers)
    layers[1] = dataclasses.replace(layers[1], block=NoSuchBlock(3))
    plan = dataclasses.replace(tplan, layers=tuple(layers))
    with pytest.raises(NotImplementedError, match="NoSuchBlock.*no ROADMAP item"):
        import_state_dict(plan, sd)
    with pytest.raises(NotImplementedError, match="NoSuchBlock.*no ROADMAP item"):
        export_state_dict(plan, tp, ts)
    layers = list(tplan.layers)
    layers[-1] = dataclasses.replace(layers[-1], block=NoSuchHead())
    with pytest.raises(NotImplementedError, match="NoSuchHead.*no ROADMAP item"):
        import_state_dict(dataclasses.replace(tplan, layers=tuple(layers)), sd)


def test_load_into_reference_model(w6):
    """`load_into_reference_model` copies every exported key into a module
    with the reference's keys (here a stand-in that registers them as
    buffers, with `num_batches_tracked` beside each BN), and refuses a
    module that lacks one of them or has one the export lacks."""
    _, tplan, tp, ts = w6
    sd = export_state_dict(tplan, tp, ts)

    class Ref(torch.nn.Module):
        def __init__(self, keys):
            super().__init__()
            self.flat = {}
            for k in keys:
                self.flat[k] = torch.zeros(sd[k].shape if k in sd else ())

        def state_dict(self, *a, **kw):
            return dict(self.flat)

        def load_state_dict(self, new, strict=True):
            unexpected = [k for k in new if k not in self.flat]
            for k, v in new.items():
                if k in self.flat:
                    self.flat[k].copy_(v)
            missing = [k for k in self.flat if k not in new]
            return missing, unexpected

    bn_tracked = [k.replace("running_mean", "num_batches_tracked") for k in sd
                  if k.endswith("running_mean")]
    ref = load_into_reference_model(Ref(list(sd) + bn_tracked), tplan, tp, ts)
    for k, v in sd.items():
        np.testing.assert_array_equal(ref.flat[k].numpy(), v)
    with pytest.raises(ValueError, match="rejected"):
        load_into_reference_model(Ref(list(sd)[1:]), tplan, tp, ts)
    with pytest.raises(ValueError, match="not exported"):
        load_into_reference_model(Ref(list(sd) + ["model.0.extra"]), tplan, tp, ts)


def test_fused_jax_tree_reads_back():
    """A fused P6 tree written by JAX (`reparam.fuse_model` of JAX, the lead
    convs with ia / im folded, the aux convs kept) reads into the port as
    `from_jax_params` gives it."""
    _, jplan, params, state, tplan, _, _ = _model("w6_training")
    jp, js = jreparam.fuse_model(jplan, jax.tree_util.tree_map(np.asarray, params),
                                 jax.tree_util.tree_map(np.asarray, state))
    jp, js = (jax.tree_util.tree_map(np.asarray, t) for t in (jp, js))
    got = import_state_dict(tplan, jexport(jplan, jp, js))
    assert set(got[0]["layers"][-1]) == {"m", "m2"}
    _same_trees(got, from_jax_params(tplan, jp, js))
