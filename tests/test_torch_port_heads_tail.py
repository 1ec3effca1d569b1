"""The IBin and IKeypoint heads in the port against the JAX package on the
CPU, with what they bring: `SigmoidBin`, the bin-OTA loss, the ranking
losses, the keypoint NMS (`batched_nms_kpt`) and a pose model built from
yolov7-w6 (an IBin model's train step and trainer step:
tests/test_torch_port_heads_tail_train.py). Same numpy inputs and
weights on both sides, fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import clustered_boxes
from tests._torch_port_util import port_drawn_model, zoo_cfg
from tests.test_torch_port_p6_train import BS, NC
from yolo_series_tpu.losses import LossHyp as JHyp
from yolo_series_tpu.losses.bin import SigmoidBin as JBin
from yolo_series_tpu.losses.bin_ota import make_compute_loss_bin_ota as jbin_ota
from yolo_series_tpu.losses.ranking import alrp_loss as jalrp
from yolo_series_tpu.losses.ranking import ap_loss as jap
from yolo_series_tpu.losses.ranking import rank_sort_loss as jrank_sort
from yolo_series_tpu.models import heads as JH
from yolo_series_tpu.models import reparam as jreparam
from yolo_series_tpu.models.layers import Ctx as JCtx
from yolo_series_tpu.models.model import apply_model as japply
from yolo_series_tpu.models.torch_export import export_state_dict as jexport
from yolo_series_tpu.models.torch_import import import_state_dict as jimport
from yolo_series_tpu.ops import nms as jnms
from yolo_series_tpu_torch.losses import LossHyp, SigmoidBin, make_compute_loss_bin_ota
from yolo_series_tpu_torch.losses.ranking import alrp_loss, ap_loss, rank_sort_loss
from yolo_series_tpu_torch.models import heads as TH
from yolo_series_tpu_torch.models import layers as TL
from yolo_series_tpu_torch.models import reparam as treparam
from yolo_series_tpu_torch.models.convert import to_jax_tree
from yolo_series_tpu_torch.models.model import apply_model
from yolo_series_tpu_torch.models.torch_export import export_state_dict
from yolo_series_tpu_torch.models.torch_import import import_state_dict
from yolo_series_tpu_torch.ops import nms as tnms
from yolo_series_tpu_torch.ops import nms_keep

torch.set_num_threads(2)

REL = 1e-5


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(got, want, rel=REL, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30), err_msg=what)


# ------------------------------------------------------------------ heads ---

ANC = ((10, 13, 16, 30, 33, 23), (30, 61, 62, 45, 59, 119), (116, 90, 156, 198, 373, 326))
ANC = tuple(tuple(v / s for v in row) for row, s in zip(ANC, (8, 16, 32)))
HEADS = {"IBin": dict(nc=80), "IBin7": dict(nc=5, bin_count=7),
         "IKeypoint": dict(nc=1, nkpt=17), "IKeypoint5": dict(nc=2, nkpt=5)}


@pytest.mark.parametrize("name", sorted(HEADS))
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_head_matches_jax(name, fused):
    """The head (tests/test_zoo.py:132's shapes: three levels of 32, 64,
    128 channels on 16, 8, 4 cells, bias priors applied) in eval, its
    `pred` and raw maps, and in training its raw maps, against JAX; with
    `fused`, after `reparam.fuse_head_implicit` on both sides. IKeypoint's
    channel axis is read as (na, no) after the det and kpt concat, and its
    keypoints decode from raw logits."""
    cls = name.rstrip("0123456789")
    kw = dict(anchors=ANC, ch=(32, 64, 128), strides=(8.0, 16.0, 32.0), **HEADS[name])
    jh, th = getattr(JH, cls)(**kw), getattr(TH, cls)(**kw)
    assert repr(jh) == repr(th) and jh.no == th.no
    tp, _ = th.init(torch.Generator().manual_seed(0))
    tp = th.init_biases(tp)
    if fused:
        tp = treparam.fuse_head_implicit(th, tp)
    jp = _jax(to_jax_tree(tp))
    if fused:
        assert "ia" not in tp and set(tp) == set(jreparam.fuse_head_implicit(
            jh, _jax(to_jax_tree(th.init(torch.Generator().manual_seed(0))[0]))))
    rng = np.random.default_rng(1)
    xs = [rng.normal(0, 1, (2, 16 // 2 ** i, 16 // 2 ** i, c)).astype(np.float32)
          for i, c in enumerate((32, 64, 128))]
    txs = [torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))) for x in xs]
    for training in (True, False):
        want, _ = jh.apply(jp, {}, [jnp.asarray(x) for x in xs], JCtx(training=training))
        got, _ = th.apply(tp, {}, txs, TL.Ctx(training=training))
        assert set(got) == set(want)
        for g, w in zip(got["raw"], want["raw"]):
            assert g.shape == w.shape
            _close(g.numpy(), w, what=f"{name} raw")
    assert got["pred"].shape == want["pred"].shape
    _close(got["pred"].numpy(), want["pred"], what=f"{name} pred")
    cols = {"IBin": 85, "IBin7": 10, "IKeypoint": 57, "IKeypoint5": 22}[name]
    assert got["raw"][0].shape[-1] == th.no and want["pred"].shape[-1] == cols


def test_sigmoid_bin_decode_ties_and_loss_match_jax():
    """`SigmoidBin.forward`: tied bin maxima take the first bin, as
    `jnp.argmax` does (bit-equal decode); `training_loss` with and without
    a validity mask, with label smoothing and the MSE term on and off:
    the loss and its gradient within REL of JAX's."""
    rng = np.random.default_rng(0)
    for bins, smooth, reg in ((21, 0.0, True), (10, 0.1, False), (21, 0.0, False)):
        jb, tb = (cls(bins, 0.0, 4.0, use_loss_regression=reg, smooth_eps=smooth)
                  for cls in (JBin, SigmoidBin))
        np.testing.assert_array_equal(tb.bins().numpy(), np.asarray(jb.bins()))
        pred = rng.uniform(0, 1, (64, tb.length)).astype(np.float32)
        pred[:32, 3] = pred[:32, 7] = 1.0                    # ties between two bins
        pred[32:40, 1:] = 0.5                                # every bin tied
        np.testing.assert_array_equal(tb.forward(torch.from_numpy(pred)).numpy(),
                                      np.asarray(jb.forward(jnp.asarray(pred))))
        raw = rng.normal(0, 2, (64, tb.length)).astype(np.float32)
        target = rng.uniform(0, 4, 64).astype(np.float32)
        target[:8] = tb.bins().numpy()[:8] + tb.step / 2     # halfway: argmin's tie
        valid = rng.uniform(0, 1, 64) < 0.7
        for v in (None, valid):
            def jf(r):
                return jb.training_loss(r, jnp.asarray(target),
                                        None if v is None else jnp.asarray(v))
            (jl, jd), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(raw))
            rt = torch.from_numpy(raw).requires_grad_()
            tl, td = tb.training_loss(rt, torch.from_numpy(target),
                                      None if v is None else torch.from_numpy(v))
            (tg,) = torch.autograd.grad(tl, [rt])
            np.testing.assert_allclose(float(tl), float(jl), rtol=REL)
            _close(td.detach().numpy(), jd)
            _close(tg.numpy(), jg)


# --------------------------------------------------------------- bin-OTA ---

def _ibin_tiny(width=0.25, nc=NC, act=None):
    """yolov7-tiny's training cfg with its IDetect retargeted to IBin
    (tests/test_losses.py:141-160), its activations `act` when given."""
    cfg = zoo_cfg("yolov7-tiny", "training", width, nc)
    cfg["head"][-1][2] = "IBin"
    if act is not None:
        for row in cfg["backbone"] + cfg["head"]:
            row[3] = [act if a == "leaky_relu:0.1" else a for a in row[3]]
    return cfg


def _labels(rng, m=8, nc=NC):
    labels = np.zeros((BS, m, 5), np.float32)
    mask = np.zeros((BS, m), bool)
    for b in range(BS):
        k = int(rng.integers(3, m))
        labels[b, :k, 0] = rng.integers(0, nc, k)
        labels[b, :k, 1:3] = rng.uniform(0.2, 0.8, (k, 2))
        labels[b, :k, 3:5] = rng.uniform(0.05, 0.4, (k, 2))
        mask[b, :k] = True
    return labels, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_bin_ota_loss_matches_jax(seed):
    """The bin-OTA loss on random raw maps of the retargeted IBin head (256
    px, batch 2): the total and the items within 1e-5, and the raw maps'
    gradients within 1e-4 of their largest |value|. The assignment decodes
    w, h through the bins, and the box term adds their BCE."""
    jplan, _, _, tplan, _, _ = port_drawn_model(_ibin_tiny(nc=80))
    assert isinstance(tplan.head, TH.IBin) and tplan.head.no == 80 + 3 + 44
    rng = np.random.default_rng(seed)
    raw = [rng.normal(0, 1, (BS, 3, 256 // s, 256 // s, tplan.head.no)).astype(np.float32)
           for s in (8, 16, 32)]
    labels, mask = _labels(rng, nc=80)
    jlf, tlf = jbin_ota(jplan.head, JHyp()), make_compute_loss_bin_ota(tplan.head, LossHyp())

    def jf(r):
        return jlf(r, jnp.asarray(labels), jnp.asarray(mask))

    (jtot, jitems), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        [jnp.asarray(r) for r in raw])
    rt = [torch.from_numpy(r).requires_grad_() for r in raw]
    ttot, titems = tlf(rt, torch.from_numpy(labels), torch.from_numpy(mask))
    tg = torch.autograd.grad(ttot, rt)
    np.testing.assert_allclose(float(ttot), float(jtot), rtol=REL)
    for k in ("box", "obj", "cls"):
        np.testing.assert_allclose(float(titems[k]), float(jitems[k]), rtol=REL, err_msg=k)
    for g, w in zip(tg, jg):
        _close(g.numpy(), w, 1e-4, "raw grad")


# --------------------------------------------------------------- ranking ---

def _ranking_case(seed, n=96):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, n).astype(np.float32)
    logits[10:20] = logits[0]                                # tied logits
    targets = np.zeros(n, np.float32)
    fg = rng.choice(n, 14, replace=False)
    targets[fg] = rng.uniform(0.3, 1.0, 14)
    targets[fg[:4]] = targets[fg[4]]                         # tied qualities
    valid = np.ones(n, bool)
    valid[-12:] = False                                      # padding
    quality = rng.uniform(0.2, 1.0, n).astype(np.float32)
    return logits, targets, valid, quality


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ranking_losses_match_jax(seed):
    """RankSort (its identity-update gradient), AP and aLRP (plain
    gradients): values and gradients within REL of JAX's, with tied
    logits, tied qualities, padding, and the hard step (delta 0)."""
    logits, targets, valid, quality = _ranking_case(seed)
    j = [jnp.asarray(a) for a in (logits, targets, valid, quality)]
    t = [torch.from_numpy(a) for a in (logits, targets, valid, quality)]
    cases = [("rank_sort", lambda x, d: jrank_sort(x, j[1], j[2], d),
              lambda x, d: rank_sort_loss(x, t[1], t[2], d), (0.5, 0.0)),
             ("ap", lambda x, d: jap(x, j[1], j[2], d),
              lambda x, d: ap_loss(x, t[1], t[2], d), (1.0, 0.0)),
             ("alrp_cls", lambda x, d: jalrp(x, j[1], j[3], j[2], d)[0],
              lambda x, d: alrp_loss(x, t[1], t[3], t[2], d)[0], (1.0,)),
             ("alrp_loc", lambda x, d: jalrp(x, j[1], j[3], j[2], d)[1],
              lambda x, d: alrp_loss(x, t[1], t[3], t[2], d)[1], (1.0,))]
    for name, jf, tf, deltas in cases:
        for d in deltas:
            jv, jg = jax.value_and_grad(lambda x: jf(x, d))(j[0])
            x = t[0].clone().requires_grad_()
            tv = tf(x, d)
            # the hard step (delta 0) has no gradient: JAX's zeros
            tg = torch.autograd.grad(tv, [x])[0] if tv.requires_grad else torch.zeros_like(x)
            np.testing.assert_allclose(float(tv), float(jv), rtol=REL, err_msg=name)
            _close(tg.numpy(), jg, REL, f"{name} grad delta {d}")


# ------------------------------------------------------------- kpt NMS ---

def _kpt_pred(rng, b=2, a=600, nkpt=17, img=640.0):
    """IKeypoint-shaped decoded rows (b, a, 6 + 3 nkpt): clustered boxes,
    obj and cls in (0, 1), scores tied in runs, rows below conf."""
    pred = np.zeros((b, a, 6 + 3 * nkpt), np.float32)
    for i in range(b):
        boxes, scores = clustered_boxes(rng, a)
        pred[i, :, 0:2] = (boxes[:, 0:2] + boxes[:, 2:4]) / 2
        pred[i, :, 2:4] = boxes[:, 2:4] - boxes[:, 0:2]
        pred[i, :, 4] = np.sqrt(np.clip(scores, 0, 1))
        pred[i, :, 5] = np.sqrt(np.clip(scores, 0, 1))
    pred[:, :40:2, 4:6] = pred[:, 1:41:2, 4:6]                 # tied scores
    pred[:, -50:, 4] = 0.01                                    # below conf
    pred[..., 6:] = rng.uniform(0, img, (b, a, 3 * nkpt))
    return pred


@pytest.mark.parametrize("max_det,max_nms", [(300, 256), (20, 256), (300, 1024)])
# 600 rows: max_nms 1024 takes them all
def test_batched_nms_kpt_matches_jax(max_det, max_nms):
    """`batched_nms_kpt` against JAX's on the same rows, ties and all:
    counts, boxes, scores, classes and keypoints equal; max_det 20 takes
    the overflow path (more survivors than rows). The keep-mask is
    `nms_keep.nms_keep_mask`'s (K1 on the card), and the keypoints ride
    the same scatter as the boxes."""
    pred = _kpt_pred(np.random.default_rng(3))
    want = jnms.batched_nms_kpt(jnp.asarray(pred), max_det=max_det, max_nms=max_nms)
    calls = []
    real = nms_keep.nms_keep_mask

    def spy(boxes, valid, thr):
        calls.append(boxes.shape)
        return real(boxes, valid, thr)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nms_keep, "nms_keep_mask", spy)
        got = tnms.batched_nms_kpt(torch.from_numpy(pred), max_det=max_det, max_nms=max_nms)
    assert calls == [(2, min(max_nms, pred.shape[1]), 4)]
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[0].max()) == max_det if max_det == 20 else int(got[0].min()) < max_det


def pose_cfg(width, nc=1):
    """The pose model of upstream yolov7's cfg/yolov7-w6-pose.yaml built
    from the port's w6 training cfg: nc 1, the four aux convs and the
    IAuxDetect row replaced by IKeypoint [nc, anchors, 17] over the four
    lead convs."""
    cfg = zoo_cfg("yolov7-w6", "training", width, nc)
    assert cfg["head"][-1][2] == "iauxdetect" and len(cfg["head"][-1][0]) == 8
    cfg["head"] = cfg["head"][:-5] + [[cfg["head"][-1][0][:4], 1, "IKeypoint",
                                       ["nc", "anchors", 17]]]
    return cfg


def test_pose_model_and_kpt_nms_match_jax():
    """The slice as a whole: the w6 pose model (width 0.125, 128 px),
    unfused and fused, its eval `pred` against JAX's, then
    `batched_nms_kpt` (conf 0.001) on JAX's `pred`: every output equal."""
    jplan, params, state, tplan, tp, ts = port_drawn_model(pose_cfg(0.125), seed=0,
                                                           stats_seed=1)
    assert isinstance(tplan.head, TH.IKeypoint) and tplan.head.nl == 4
    x = np.random.default_rng(4).uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    jfwd = jax.jit(lambda p, s, xx: japply(jplan, p, s, xx)[0]["pred"])
    for fused in (False, True):
        if fused:
            tp, ts = treparam.fuse_model(tplan, tp, ts)
            params, state = to_jax_tree(tp), to_jax_tree(ts)
        want = jfwd(_jax(params), _jax(state), jnp.asarray(x))
        with torch.no_grad():
            got = apply_model(tplan, tp, ts, torch.from_numpy(x))[0]["pred"]
        assert got.shape == want.shape == (2, 3 * (16 ** 2 + 8 ** 2 + 4 ** 2 + 2 ** 2), 57)
        _close(got.numpy(), want, REL, f"pose pred fused={fused}")
        jo = jnms.batched_nms_kpt(want, conf_thres=0.001)
        to = tnms.batched_nms_kpt(torch.from_numpy(np.array(want)), conf_thres=0.001)
        assert int(to[0].min()) > 0
        for g, w in zip(to, jo):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_pose_model_bridges_like_jax(fused):
    """The `.pt` bridge of the IKeypoint head (its `m_kpt` convs beside
    `m`, `ia` and `im`; fused: folded into `m`): the port's state dict
    equals JAX's, key for key, and JAX's imports to JAX's trees."""
    jplan, params, state, tplan, tp, ts = port_drawn_model(pose_cfg(0.125), seed=0,
                                                           stats_seed=1)
    if fused:
        tp, ts = treparam.fuse_model(tplan, tp, ts)
    want = jexport(jplan, _jax(to_jax_tree(tp)), _jax(to_jax_tree(ts)))
    got = export_state_dict(tplan, tp, ts)
    assert sorted(got) == sorted(want)
    assert any(".m_kpt.3.weight" in k for k in got) and fused != any(".ia.0." in k for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    wp, ws = jimport(jplan, want)
    gp, gs = import_state_dict(tplan, want)
    for g, w in zip(jax.tree_util.tree_leaves(to_jax_tree(gp)),
                    jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, wp))):
        np.testing.assert_array_equal(g, w)
