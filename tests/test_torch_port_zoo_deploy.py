"""The deploy side of the rest of the zoo in the port against the JAX
package on the CPU, for each of the 14 cfgs of
tests/test_torch_port_zoo_cfgs.py: `fuse_model` (Bottleneck, SPP, Stem
and the CSP wrappers fused child by child, the repeats of an n_seq row
each), the fast stem's phase fold (the same layers as JAX's
`make_fast_stem`: yolov3, yolov3-spp, yolov4-csp and yolor-csp(-x) fold
layers 0-1, yolor-p6/w6 layers 1-2 after the ReOrg, the rest nothing),
the fused stem (K2) and ELAN span (K3) finders declining, the reference
`.pt` bridge both ways, and the bf16-free `ServingEngine` of yolov7-tiny
and yolov3-spp against JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import feature_error, image_rows, liven
from tests._torch_port_util import assert_trees_close, port_drawn_model
from tests.test_torch_port_zoo_cfgs import SIZE, ZOO_CFGS, zoo_dict
from yolo_series_tpu.models import faststem as jfaststem
from yolo_series_tpu.models import reparam as jreparam
from yolo_series_tpu.models.model import apply_model as japply
from yolo_series_tpu.models.torch_export import export_state_dict as jexport
from yolo_series_tpu.ops import pallas_elan as jelan
from yolo_series_tpu.ops import pallas_stem as jstem
from yolo_series_tpu_torch.infer.serving import ServingEngine, serving_transforms
from yolo_series_tpu_torch.models import reparam as treparam
from yolo_series_tpu_torch.models.convert import to_jax_params
from yolo_series_tpu_torch.models.faststem import make_fast_stem
from yolo_series_tpu_torch.models.model import apply_model
from yolo_series_tpu_torch.models.model import tree_leaves as leaves
from yolo_series_tpu_torch.models.torch_export import export_state_dict
from yolo_series_tpu_torch.models.torch_import import import_state_dict
from yolo_series_tpu_torch.ops import fused_elan, fused_stem

torch.set_num_threads(2)

# the layers the fast stem folds into phase space, per cfg (none elsewhere)
FOLDED = {**{f"baseline/{n}": (0, 1) for n in ("yolov3", "yolov3-spp", "yolov4-csp",
                                                "yolor-csp", "yolor-csp-x")},
          "baseline/yolor-p6": (1, 2), "baseline/yolor-w6": (1, 2)}


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _images(seed):
    return np.random.default_rng(seed).uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)


def _outputs(out):
    return out["raw"] + [out["pred"]]


@pytest.fixture(scope="module", params=ZOO_CFGS)
def fused(request):
    """(cfg, jax plan, JAX's fused trees, port plan, unfused and fused port
    trees) from the same weights, BN running stats off (0, 1)."""
    cfg = request.param
    jplan, params, state, tplan, tp, ts = port_drawn_model(zoo_dict(cfg), seed=2, stats_seed=3)
    jfp, jfs = jreparam.fuse_model(jplan, _jax(params), _jax(state))
    fp, fs = treparam.fuse_model(tplan, tp, ts)
    return cfg, jplan, jfp, jfs, tplan, (tp, ts), (fp, fs)


def test_fuse_model_exact(fused):
    """`fuse_model`: the same plan, every conv of every block (each repeat
    of an n_seq row) fused to {w, b}, the fused forward within 1e-5 of the
    unfused one (raws and preds, of each tensor's largest |value|), and
    the fused trees within 1e-6 of JAX's `fuse_model` of the same weights."""
    cfg, _, jfp, jfs, tplan, (tp, ts), (fp, fs) = fused
    assert not any(isinstance(d, dict) and "bn" in d for d in _dicts(fp))
    x = torch.from_numpy(_images(1))
    want, _ = apply_model(tplan, tp, ts, x)
    got, _ = apply_model(tplan, fp, fs, x)
    for g, w in zip(_outputs(got), _outputs(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * w.abs().max().item())
    assert_trees_close(fp, jfp, 1e-6, f"{cfg} fused params")
    assert_trees_close(fs, jfs, 1e-6, f"{cfg} fused state")


def _dicts(tree):
    if isinstance(tree, dict):
        yield tree
        for v in tree.values():
            yield from _dicts(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _dicts(v)


def test_fast_stem_matches_jax(fused):
    """`make_fast_stem(max_pairs=2)` (what the serving engine and the
    Detector apply) folds the layers of FOLDED, as JAX's does on the same
    fused weights: the same plan (block reprs, widths, strides, routes,
    PhasedConv's activation LeakyReLU or SiLU alike), the same params bit
    for bit (JAX folds the port's fused trees), and the folded forward
    within 1e-5 of the fused one."""
    cfg, jplan, _, _, tplan, _, (fp, fs) = fused
    jplan2, jp2, _ = jfaststem.make_fast_stem(jplan, *map(_jax, to_jax_params(tplan, fp, fs)),
                                              max_pairs=2)
    plan2, p2, s2 = make_fast_stem(tplan, fp, fs, max_pairs=2)
    folded = tuple(i for i, (a, b) in enumerate(zip(tplan.layers, plan2.layers))
                   if a.block != b.block)
    assert folded == FOLDED.get(cfg, ())
    for a, b in zip(jplan2.layers, plan2.layers):
        assert (repr(a.block), a.cout, a.stride, a.frm) == (repr(b.block), b.cout, b.stride,
                                                            b.frm), a.index
    for i in folded:
        assert type(plan2.layers[i].block).__name__ == "PhasedConv"
        assert plan2.layers[i].block.act == tplan.layers[i].block.act
    assert_trees_close(p2, jp2, 0.0, f"{cfg} folded params")
    x = torch.from_numpy(_images(2))
    want, _ = apply_model(tplan, fp, fs, x)
    got, _ = apply_model(plan2, p2, s2, x)
    for g, w in zip(_outputs(got), _outputs(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * w.abs().max().item())


def test_fused_finders_decline(fused):
    """No cfg of the rest of the zoo holds yolov7's k3 stem at strides s1,
    s2, s1, s2 (K2) or a flat ELAN span of four chained SiLU 3 x 3 convs
    (K3): tiny's stem starts at stride 2 and its spans have two 3 x 3s
    (LeakyReLU in tiny, SiLU in tiny-silu); the baselines' layer 2 is a
    Bottleneck, a Stem or a ReOrg starts them, and their chains sit inside
    CSP blocks. Both packages' finders decline, and the serving transforms
    leave every conv to cuDNN but the fast stem's fold."""
    cfg, jplan, jfp, _, tplan, _, (fp, fs) = fused
    assert not fused_stem._stem_matches(tplan, fp)
    assert not jstem._stem_matches(jplan, jfp)
    assert fused_elan.find_elan_spans(tplan, fp) == ()
    assert jelan.find_elan_spans(jplan, jfp) == ()
    plan2, _, _ = serving_transforms(tplan, fp, fs)
    names = {type(s.block).__name__ for s in plan2.layers}
    assert not names & {"FusedStem", "FusedELAN"}
    assert ("PhasedConv" in names) == (cfg in FOLDED)


def test_pt_bridge_matches_jax(fused):
    """The reference `.pt` keys (`model.{i}.<...>`; an n_seq row's repeats
    `model.{i}.{r}.cv1...`, the CSP wrappers' inner blocks `m.{j}`): the
    port's `export_state_dict` equals JAX's key for key and bit for bit,
    unfused and fused, and the port's import of it gives the port's trees
    back, bit for bit."""
    cfg, jplan, _, _, tplan, (tp, ts), (fp, fs) = fused
    for p, s in ((tp, ts), (fp, fs)):
        sd = export_state_dict(tplan, p, s)
        want = jexport(jplan, *to_jax_params(tplan, p, s))
        assert set(sd) == set(want)
        for k in want:
            assert sd[k].dtype == np.float32 and sd[k].shape == want[k].shape, k
            np.testing.assert_array_equal(sd[k], want[k], err_msg=k)
        back_p, back_s = import_state_dict(tplan, sd)
        for a, b in zip(leaves(back_p) + leaves(back_s), leaves(p) + leaves(s)):
            assert torch.equal(a, b)
    if cfg == "baseline/yolov3":
        assert "model.8.7.cv2.conv.weight" in sd      # the 8th repeat of layer 8
    if cfg == "baseline/x50-csp":
        assert "model.1.m.2.cv2.conv.weight" in sd    # ResXCSPC's third inner Res


@pytest.mark.parametrize("cfg", ["deploy/yolov7-tiny", "baseline/yolov3-spp"])
def test_serving_engine_matches_jax(cfg):
    """The fp32 `ServingEngine` at width 0.25, 128 px, batch 2, against the
    JAX engine on the same livened weights (about 60 candidates an image
    pass conf 0.25). Neither holds a fused stem or span; yolov3-spp's fast
    stem folds layers 0-1 in both. The engines compute the same fp32
    function: the head inputs within 1e-5 relative RMS, and each image's
    detections equal in count and class, boxes within 1e-3 px, scores
    within 1e-5."""
    from yolo_series_tpu.infer.serving import ServingEngine as JaxEngine
    from yolo_series_tpu.models.graph import compile_graph as jcompile

    _, _, _, tplan, tp, ts = port_drawn_model(zoo_dict(cfg, width=0.25), seed=6)
    calib = np.random.default_rng(6).integers(0, 256, (2, SIZE, SIZE, 3)) / 255.0
    liven(tplan, tp, ts, torch.from_numpy(calib).float(), candidates=60)
    params, state = to_jax_params(tplan, tp, ts)
    jplan = jcompile(zoo_dict(cfg, width=0.25))
    jp, js = jreparam.fuse_model(jplan, _jax(params), _jax(state))
    fp, fs = treparam.fuse_model(tplan, tp, ts)
    kw = dict(batch_size=2, img_size=SIZE, max_det=100, max_nms=512)
    jeng = JaxEngine(jplan, jp, js, dtype=jnp.float32, **kw)
    teng = ServingEngine(tplan, fp, fs, dtype=torch.float32, device="cpu", **kw)
    names = [type(layer.block).__name__ for layer in teng.plan.layers]
    assert names == [type(layer.block).__name__ for layer in jeng.plan.layers]
    assert names.count("PhasedConv") == (2 if cfg in FOLDED else 0)
    x = np.random.default_rng(7).integers(0, 255, (2, SIZE, SIZE, 3), np.uint8)
    want, got = jeng.infer(x), teng.infer(x)
    xf = x.astype(np.float32) / 255.0
    jfeats, _ = japply(jeng.plan, jeng._params, jeng._state, jnp.asarray(xf),
                       return_head_inputs=True)
    with torch.inference_mode():
        tfeats, _ = apply_model(teng.plan, teng._params, teng._state, torch.from_numpy(xf),
                                return_head_inputs=True)
    assert feature_error(tfeats, [torch.from_numpy(np.array(f)) for f in jfeats]) < 1e-5
    for i in range(2):
        a, b = image_rows(got, i), image_rows(want, i)
        assert len(b["scores"]) > 5
        np.testing.assert_array_equal(a["classes"], b["classes"])
        np.testing.assert_allclose(a["boxes"], b["boxes"], rtol=0, atol=1e-3)
        np.testing.assert_allclose(a["scores"], b["scores"], rtol=0, atol=1e-5)
