"""E-ELAN spans on the fused ELAN kernel (K3): yolov7-e6e's plan, the span
counts of the other P6 and x models, the shortcut folded into the output
conv's epilogue, and the e6e serving engine against the benchmark's plain
fp32 reference (`benchmark/reference/yolo.py`), on the CPU through the
kernels' plain versions. The `cuda` tests hold the residual epilogue and
E-ELAN pairs against their plain versions on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_port_eelan.py -q
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

from benchmark.harness import common, compare, flops
from benchmark.reference import yolo as ref
from yolo_series_tpu_torch.infer.serving import ServingEngine, conv_silu_ops, serving_transforms
from yolo_series_tpu_torch.models.faststem import _Passthrough
from yolo_series_tpu_torch.models.graph import compile_graph
from yolo_series_tpu_torch.models.layers import ConvBnAct
from yolo_series_tpu_torch.models.model import apply_model, init_model
from yolo_series_tpu_torch.models.reparam import fuse_model
from yolo_series_tpu_torch.models.torch_import import import_state_dict
from yolo_series_tpu_torch.ops import conv_silu, fused_elan
from yolo_series_tpu_torch.ops.fused_elan import FusedELAN

torch.set_num_threads(2)

DEPLOY = Path(__file__).resolve().parents[1] / "yolo_series_tpu_torch/models/cfg/deploy"
E6E_STARTS = (3, 13, 25, 35, 47, 57, 69, 79, 91, 101,
              117, 127, 142, 152, 167, 177, 190, 200, 213, 223, 236, 246)


def _deploy(name):
    return yaml.safe_load((DEPLOY / f"{name}.yaml").read_text())


def _meta(plan, device="meta"):
    """Fused params of every plain conv, on the meta device by default: the
    rewrites' shapes with nothing drawn (the fused stem's phase fold reads
    its weights on the host: zeros on the CPU for it)."""
    lp = [{"w": torch.zeros(b.c2, b.c1, b.k, b.k, device=device),
           "b": torch.zeros(b.c2, device=device)} if isinstance(b := s.block, ConvBnAct)
          else {} for s in plan.layers]
    return {"layers": lp}, {"layers": [{} for _ in plan.layers]}


def test_e6e_plan_full_width():
    """find_elan_spans finds e6e's 22 E-ELAN spans (10 backbone, 12 head)
    at full width; in each pair the second span reads the pair's input;
    the rewrite folds the 11 Shortcuts into the second spans' output convs."""
    plan = compile_graph(_deploy("yolov7-e6e"))
    params, state = _meta(plan)
    spans = fused_elan.find_elan_spans(plan, params)
    assert tuple(i for i, _ in spans) == E6E_STARTS
    assert [o for _, o in spans] == ["backbone"] * 10 + ["head"] * 12
    assert {n for _, _, n in fused_elan.span_chains(plan, params)} == {6}
    for (i1, _), (i2, _) in zip(spans[::2], spans[1::2]):
        assert i2 == i1 + 10 and plan.layers[i2].frm == plan.layers[i2 + 1].frm == i1 - 1
    before = (fused_elan.make_fused_elan.spans, fused_elan.make_fused_elan.shortcuts)
    fused, _, _ = fused_elan.make_fused_elan(plan, params, state)
    after = (fused_elan.make_fused_elan.spans, fused_elan.make_fused_elan.shortcuts)
    assert (after[0] - before[0], after[1] - before[1]) == (22, 11)
    for k, (i, _) in enumerate(spans):
        end = i + 9
        blk = fused.layers[end].block
        assert isinstance(blk, FusedELAN) and blk.n == 6
        # the passthroughs carry what x4 read: the pair's input, for both spans
        assert fused.layers[i].frm == plan.layers[i].frm
        assert all(fused.layers[j].frm == -1 for j in range(i + 1, end))
        if k % 2:
            assert blk.residual and fused.layers[end].frm == (-1, spans[k - 1][0] + 9)
            assert type(plan.layers[end + 1].block).__name__ == "Shortcut"
            assert isinstance(fused.layers[end + 1].block, _Passthrough)
        else:
            assert not blk.residual and fused.layers[end].frm == -1


@pytest.mark.parametrize("name,spans,n,folded", [
    ("yolov7", 8, 4, 0), ("yolov7-w6", 11, 4, 0), ("yolov7x", 8, 6, 0),
    ("yolov7-e6", 11, 6, 0), ("yolov7-d6", 11, 8, 0), ("yolov7-e6e", 22, 6, 11)])
def test_span_counts(name, spans, n, folded):
    """The spans the finder takes in each deploy cfg, their chain length,
    and the Shortcuts folded (e6e's alone add two fused spans)."""
    plan = compile_graph(_deploy(name))
    params, state = _meta(plan)
    chains = fused_elan.span_chains(plan, params)
    assert len(chains) == spans and {c[2] for c in chains} == {n}
    fused, _, _ = fused_elan.make_fused_elan(plan, params, state)
    assert sum(isinstance(s.block, FusedELAN) and s.block.residual
               for s in fused.layers) == folded


@pytest.mark.parametrize("name", ["yolov7", "yolov7-w6", "yolov7-e6e"])
def test_conv_silu_ops_is_the_frozen_count(name):
    """The engine's count of the operations it hands to conv_silu equals
    the benchmark's frozen count of the same convs (yolov7, w6) and of the
    198 span convs of e6e's configuration, a batch of 8."""
    cfg = common.load_json(common.BENCH / "configs" / f"{name}.json")
    k = cfg["kernels"]["conv_silu"]
    plan = compile_graph(cfg["cfg_deploy"])
    fused, _, _ = serving_transforms(plan, *_meta(plan, "meta" if name == "yolov7-e6e" else "cpu"))
    assert k["batch"] * conv_silu_ops(plan, fused, cfg["img"]) == k["ops"]
    net = ref.Net(cfg["cfg_deploy"])
    _, ops, _ = flops.bound_ms(net, cfg["img"], k["batch"], k["layers"])
    assert ops == k["ops"]


def test_conv_silu_ops_of_an_engines_own_plan_is_zero():
    """An engine built from another engine's plan (already rewritten): the
    rewrites find nothing more to hand to conv_silu, and the count reads 0
    instead of failing on a fused block."""
    cfg = common.load_json(common.BENCH / "configs" / "yolov7.json")
    plan = compile_graph(cfg["cfg_deploy"])
    fused, params, state = serving_transforms(plan, *_meta(plan, "cpu"))
    again, _, _ = serving_transforms(fused, params, state)
    assert conv_silu_ops(fused, again, cfg["img"]) == 0
    assert conv_silu_ops(plan, fused, cfg["img"]) > 0


def _bf16(gen, shape, std=1.0):
    return (torch.randn(shape, generator=gen) * std).to(torch.bfloat16)


def test_conv_silu_plain_adds_the_residual_before_one_round():
    """conv_silu_plain(..., r) is silu(conv + b) + r in fp32, rounded to
    bf16 once: not the bf16 sum of the rounded conv output and r."""
    gen = torch.Generator().manual_seed(4)
    x, w, b = _bf16(gen, (2, 6, 7, 64)), _bf16(gen, (1, 1, 64, 32), 0.1), _bf16(gen, (32,))
    r = _bf16(gen, (2, 6, 7, 32))
    got = conv_silu.conv_silu_plain(x, w, b, r=r)
    y = F.silu(F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                        b.float())).permute(0, 2, 3, 1)
    assert torch.equal(got, (y + r.float()).to(torch.bfloat16))
    twice = (conv_silu.conv_silu_plain(x, w, b).float() + r.float()).to(torch.bfloat16)
    assert not torch.equal(got, twice)
    assert torch.equal(conv_silu.conv_silu_plain(x, w, b, r=torch.zeros_like(r)),
                       conv_silu.conv_silu_plain(x, w, b))


def _pair_cfg(order):
    """A stem conv, then one E-ELAN pair of `order` at 64 -> 64 channels
    (x4, x5 32 wide, six chained 3x3 of 32), its Shortcut, and a head."""
    cat = [[-1, -3, -5, -7, -8]] if order == "backbone" else [[-1, -2, -3, -4, -5, -6, -7, -8]]
    span = lambda first: ([[-1 if first else -11, 1, "conv", [32, 1, 1]],  # noqa: E731
                           [-2 if first else -12, 1, "conv", [32, 1, 1]]]
                          + [[-1, 1, "conv", [32, 3, 1]]] * 6
                          + [[cat[0], 1, "concat", [1]], [-1, 1, "conv", [64, 1, 1]]])
    return {"nc": 3, "depth_multiple": 1.0, "width_multiple": 1.0,
            "anchors": [[10, 13, 16, 30, 33, 23]],
            "backbone": [[-1, 1, "conv", [64, 3, 2]], [-1, 1, "conv", [64, 1, 1]]]
            + span(True) + span(False) + [[[-1, -11], 1, "shortcut", [1]]],
            "head": [[[22], 1, "detect", ["nc", "anchors"]]]}


@pytest.mark.parametrize("order", ["backbone", "head"])
def test_eelan_pair_fused_against_unfused(order):
    """One E-ELAN pair and its Shortcut, rewritten (two FusedELAN blocks,
    the second adding the first's output), against the fused-conv plan in
    fp32: the pair's output (the head's input). The rewrite runs the
    kernel's plain version, which rounds each of a span's nine stages to
    bf16 (2^-9 relative RMS each, carried through the chain and the sum):
    within 1% relative RMS (0.37% read). Leaving the residual out gives
    ~67%."""
    plan = compile_graph(_pair_cfg(order))
    params, state = init_model(plan, torch.Generator().manual_seed(5))
    fp, fs = fuse_model(plan, params, state)
    assert fused_elan.span_chains(plan, fp) == ((2, order, 6), (12, order, 6))
    plan2, p2, s2 = fused_elan.make_fused_elan(plan, fp, fs)
    assert plan2.layers[21].block.residual and plan2.layers[21].frm == (-1, 11)
    assert isinstance(plan2.layers[22].block, _Passthrough)
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(6))
    out = plan2.layers[21]
    no_res = dataclasses.replace(out, frm=-1,
                                 block=dataclasses.replace(out.block, residual=False))
    plan3 = dataclasses.replace(plan2, layers=plan2.layers[:21] + (no_res,) + plan2.layers[22:])
    with torch.inference_mode():
        (want,), (got,), (unsummed,) = (apply_model(*m, x, return_head_inputs=True)[0]
                                        for m in ((plan, fp, fs), (plan2, p2, s2),
                                                  (plan3, p2, s2)))
    assert _rel_rms(got, want) < 1e-2
    assert _rel_rms(unsummed, want) > 0.2


def _rel_rms(got, want):
    return ((got - want).pow(2).mean() / want.pow(2).mean()).sqrt().item()


def _head_inputs(net, sd, x):
    """The reference's inputs to its Detect layer, per level (NCHW fp32)."""
    run = ref._Run(sd, "eval", None, None)
    saved = {}
    for L in net.layers:
        inp = [x if f < 0 else saved[f] for f in L["frm"]]
        if L["kind"] in ("detect", "idetect"):
            return inp
        saved[L["i"]] = run.layer(L, inp)


def test_e6e_serving_engine_against_the_reference():
    """The e6e `ServingEngine` on the CPU (fp32, full width, 128 px, batch
    2; its 22 spans on the plain K3, 11 Shortcuts folded) on weights the
    reference draws and livens, against the reference's fp32 forward. The
    spans round each of their 198 conv stages to bf16 (2^-9 relative RMS
    each) where the reference keeps fp32, so the head inputs lie within 5%
    relative RMS (1.3-1.4% read; a wrong slice, tap or residual gives
    ~100%), while the same fused plan without the rewrites, all fp32, lies
    within 1e-4 (the import and the fold are exact, to fp32's summation
    order); the detections pass the benchmark's own check, `det_gap` under
    the cell's limit 0.25 (rounding moves a detection's score or corners by
    a few hundredths)."""
    cfg = _deploy("yolov7-e6e")
    nms = dict(conf_thres=0.25, iou_thres=0.45, max_det=100, max_nms=1024)
    frames = np.random.default_rng(11).integers(0, 256, (2, 128, 128, 3), np.uint8)
    x = torch.from_numpy(frames)
    net, sd = ref.make_weights(cfg, 2**31 + 21, "cpu", x, nms["conf_thres"])
    plan = compile_graph(cfg)
    fp, fs = fuse_model(plan, *import_state_dict(plan, {k: v for k, v in sd.items()}))
    eng = ServingEngine(plan, fp, fs, batch_size=2, img_size=128, dtype=torch.float32,
                        device="cpu", **nms)
    names = [type(s.block).__name__ for s in eng.plan.layers]
    assert names.count("FusedELAN") == 22
    assert sum(s.block.residual for s in eng.plan.layers if isinstance(s.block, FusedELAN)) == 11
    xf = x.permute(0, 3, 1, 2).float() / 255.0
    with torch.inference_mode():
        feats, _ = apply_model(eng.plan, eng._params, eng._state, x.float() / 255.0,
                               return_head_inputs=True)
        exact, _ = apply_model(plan, fp, fs, x.float() / 255.0, return_head_inputs=True)
        want = _head_inputs(net, sd, xf)
        raws = net.forward(sd, xf)
    assert len(feats) == len(want) == 4
    for g, e, w in zip(feats, exact, want):   # the port's maps are NHWC
        assert _rel_rms(g.permute(0, 3, 1, 2), w) < 0.05
        assert _rel_rms(e.permute(0, 3, 1, 2), w) < 1e-4
    host = eng.infer(frames)
    boxes, scores = ref.decode(net, raws, 128)
    gaps = [compare.detection_gaps({k: v[j] for k, v in host.items()}, boxes[j], scores[j], nms)
            for j in range(2)]
    r = compare.widest(gaps, nms["iou_thres"])
    assert r["served"] > 0 and r["det_gap"] < 0.25, r


# ------------------------------------------------------------ the card ---

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the residual epilogue is CUDA code")
    return torch.device("cuda")


def _e6e_spans():
    """(H, cin, ct, cc, cout, order, n, residual) of e6e's spans at 1280 px."""
    plan = compile_graph(_deploy("yolov7-e6e"))
    fused, _, _ = fused_elan.make_fused_elan(plan, *_meta(plan))
    return [(int(1280 / s.stride), b.c1, b.ct, b.cc, b.c2, b.order, b.n, b.residual)
            for s in fused.layers if isinstance(b := s.block, FusedELAN)]


@pytest.mark.cuda
def test_residual_epilogue_at_e6e_output_shapes():
    """The output launch of each of e6e's 11 residual spans (its concat
    -> cout at its size, batch 2) with a drawn residual, against the plain
    version: within one bf16 rounding of sums taken in another order and
    SiLU's fast exp (2^-7 of max(|plain|, 1)). With a zero residual the
    residual instantiation gives the plain instantiation's bits."""
    dev = _card()
    gen = torch.Generator().manual_seed(8)
    for h, _, ct, cc, cout, order, n, residual in _e6e_spans():
        if not residual:
            continue
        _, cat = fused_elan.concat_slots(order, ct, cc, n)
        x = _bf16(gen, (2, h, h, cat)).to(dev)
        w = _bf16(gen, (1, 1, cat, cout), cat ** -0.5).to(dev)
        b, r = _bf16(gen, (cout,), 0.1).to(dev), _bf16(gen, (2, h, h, cout)).to(dev)
        y = torch.empty_like(r)
        conv_silu.launch(x, w, b, y, h=h, c=cat, stride=1, pad_t=0, pad_l=0, r=r)
        torch.cuda.synchronize()
        want = conv_silu.conv_silu_plain(x, w, b, r=r).float()
        err = ((y.float() - want).abs() / want.abs().clamp(min=1.0)).max().item()
        assert err <= 2 ** -7, (h, cat, cout, err)
        y0, yz = torch.empty_like(r), torch.empty_like(r)
        conv_silu.launch(x, w, b, y0, h=h, c=cat, stride=1, pad_t=0, pad_l=0)
        conv_silu.launch(x, w, b, yz, h=h, c=cat, stride=1, pad_t=0, pad_l=0,
                         r=torch.zeros_like(r))
        torch.cuda.synchronize()
        assert torch.equal(y0, yz)


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["backbone", "head"])
def test_eelan_pair_on_the_card(order):
    """e6e's first backbone pair (320 px) or first head pair (160 px) at
    1280 px, batch 2: the two spans through K3, the second adding the
    first's output, against the plain versions; each span within chip_smoke's
    K2/K3 tolerance (2e-2 of max(|plain|, 1): stage outputs may land on the
    neighbouring bf16 value, carried through the chain)."""
    dev = _card()
    gen = torch.Generator().manual_seed(9)
    spans = [s for s in _e6e_spans() if s[5] == order][:2]
    h, cin, ct, cc, cout, _, n, _ = spans[0]
    _, cat = fused_elan.concat_slots(order, ct, cc, n)

    def params():
        p = {"w4": _bf16(gen, (1, 1, cin, ct), cin ** -0.5), "b4": _bf16(gen, (ct,), 0.1),
             "w5": _bf16(gen, (1, 1, cin, ct), cin ** -0.5), "b5": _bf16(gen, (ct,), 0.1),
             "wc0": _bf16(gen, (3, 3, ct, cc), (9 * ct) ** -0.5), "bc0": _bf16(gen, (cc,), 0.1),
             "wc": _bf16(gen, (n - 1, 3, 3, cc, cc), (9 * cc) ** -0.5),
             "bc": _bf16(gen, (n - 1, cc), 0.1),
             "w11": _bf16(gen, (1, 1, cat, cout), cat ** -0.5), "b11": _bf16(gen, (cout,), 0.1)}
        return fused_elan.merge_x45({k: v.to(dev) for k, v in p.items()})

    p1, p2 = params(), params()
    x = _bf16(gen, (2, h, h, cin)).to(dev)
    launches = conv_silu.launch.launches
    y1 = fused_elan.fused_elan(x, p1, order)
    y2 = fused_elan.fused_elan(x, p2, order, y1)
    torch.cuda.synchronize()
    assert conv_silu.launch.launches - launches == 2 * (n + 2)
    w1 = fused_elan.fused_elan_plain(x, p1, order)
    w2 = fused_elan.fused_elan_plain(x, p2, order, y1)
    for got, want in ((y1, w1), (y2, w2)):
        err = ((got.float() - want.float()).abs()
               / want.float().abs().clamp(min=1.0)).max().item()
        assert err <= 2e-2, err
