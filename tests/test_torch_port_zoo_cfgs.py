"""The rest of the zoo's cfgs in the port against the JAX package on the
CPU: the three yolov7-tiny cfgs (SP, LeakyReLU) and the 11 baselines
(Bottleneck, SPP, Stem and the BottleneckCSP / ResCSP / ResXCSP wrappers;
yolor-p6/w6/d6/e6 with a four-level IDetect). Each copy is JAX's byte
for byte and compiles to JAX's plan, and its eval and training forwards
agree with JAX's on the same weights. Width 0.125 (x50-csp 0.5: its 3 x 3
convs have 32 groups, so every group holds a channel only from width
0.5), 128 px, batch 2, fp32."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port_util import assert_trees_close, port_drawn_model, zoo_cfg
from yolo_series_tpu.models.graph import compile_graph as jcompile
from yolo_series_tpu.models.model import apply_model as japply
from yolo_series_tpu_torch.models import heads as TH
from yolo_series_tpu_torch.models.graph import compile_graph
from yolo_series_tpu_torch.models.model import apply_model

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the 14 cfgs this slice ports, as "kind/name"
ZOO_CFGS = (["training/yolov7-tiny", "deploy/yolov7-tiny", "deploy/yolov7-tiny-silu"]
            + [f"baseline/{n}" for n in ("yolov3", "yolov3-spp", "yolov4-csp", "yolor-csp",
                                         "yolor-csp-x", "r50-csp", "x50-csp", "yolor-p6",
                                         "yolor-w6", "yolor-d6", "yolor-e6")])
# the head each cfg compiles to: Detect for the deploy forms and the
# yolov3 / yolov4 baselines, IDetect for the rest, yolor-P6 included (four
# levels, no IAuxDetect)
DETECT = {"deploy/yolov7-tiny", "deploy/yolov7-tiny-silu", "baseline/yolov3",
          "baseline/yolov3-spp", "baseline/yolov4-csp"}
P6 = {f"baseline/yolor-{m}" for m in ("p6", "w6", "d6", "e6")}
SIZE = 128


def zoo_width(cfg):
    return 0.5 if cfg.endswith("x50-csp") else 0.125


def zoo_dict(cfg, width=None, nc=None):
    """The JAX package's cfg as a dict at `width` (the test width unless
    given)."""
    kind, name = cfg.split("/")
    return zoo_cfg(name, kind, zoo_width(cfg) if width is None else width, nc)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("cfg", ZOO_CFGS)
def test_cfg_compiles_like_jax(cfg):
    """The port's copy of the cfg is the JAX package's, byte for byte, and
    compiles to the same plan: each layer's block (type and config: the
    activation's canonical name, the CSP wrappers' n, shortcut and groups),
    routes, widths, strides and repeats, the save list, and the head's
    type, nc, input widths, strides and normalized anchors. yolor-csp-x and
    yolor-d6/e6 run at width 1.25 (csp-x at depth 1.33), through
    `make_divisible` and the inner-n rounding."""
    port = ROOT / "yolo_series_tpu_torch/models/cfg" / f"{cfg}.yaml"
    ref = ROOT / "yolo_series_tpu/models/cfg" / f"{cfg}.yaml"
    assert port.read_bytes() == ref.read_bytes()
    jp, tp = jcompile(str(ref)), compile_graph(str(port))
    assert len(jp.layers) == len(tp.layers) and jp.save == tp.save and jp.nc == tp.nc
    for a, b in zip(jp.layers, tp.layers):
        assert (a.index, a.frm, a.cout, a.stride, a.n_seq, a.is_head) == \
            (b.index, b.frm, b.cout, b.stride, b.n_seq, b.is_head), a.index
        assert repr(a.block) == repr(b.block), a.index
    head = TH.Detect if cfg in DETECT else TH.IDetect
    nl = 4 if cfg in P6 else 3
    assert type(tp.head) is head and len(tp.head.ch) == nl
    assert tp.strides == (8.0, 16.0, 32.0, 64.0)[:nl]
    if "tiny" in cfg:
        # tiny-silu's rows leave the act at the reference Conv's default (True)
        act = True if cfg.endswith("silu") else "leaky_relu:0.1"
        convs = [s.block for s in tp.layers if type(s.block).__name__ == "ConvBnAct"]
        assert len(convs) == 55 and {c.act for c in convs} == {act}
    if cfg == "baseline/yolov3":   # the [-1, 8, bottleneck] rows: 8 repeats
        assert sorted({s.n_seq for s in tp.layers}) == [1, 2, 4, 8]


# The eval forward carries fp32 rounding only: the raws and the decoded
# predictions within EVAL_REL of each tensor's largest |value| (1.8e-7
# measured). In training every BN renormalizes with the batch's moments,
# and a random network's BN amplifies the two libraries' fp32 rounding as
# it goes: the training raws lie up to 2.4e-3 (yolor-d6 and -e6, at their
# 2 x 2 P6 level) of each map's largest |value| from JAX's, 1.7e-5
# (tiny) to 8.6e-5 (x50-csp) elsewhere. So, as for the yolov7 P6 family
# (tests/test_torch_port_p6.py), the training raws within TRAIN_REL and
# the new BN state within STATE_REL.
EVAL_REL, TRAIN_REL, STATE_REL = 1e-5, 2e-2, 1e-3


@pytest.mark.parametrize("cfg", ZOO_CFGS)
def test_forward_matches_jax(cfg):
    """Eval (raws and the decoded predictions) and training (raws and the
    new BN state) of the same weights on the same images, both packages."""
    jplan, params, state, tplan, tp, ts = port_drawn_model(zoo_dict(cfg), seed=0,
                                                           stats_seed=1)
    x = np.random.default_rng(0).uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    nl = len(tplan.head.ch)
    for training in (False, True):
        fn = jax.jit(lambda p, s, xx, t=training: japply(jplan, p, s, xx, training=t))
        want, want_s = fn(_jax(params), _jax(state), jnp.asarray(x))
        got, got_s = apply_model(tplan, tp, ts, torch.from_numpy(x), training=training)
        assert len(got["raw"]) == len(want["raw"]) == nl
        rel = TRAIN_REL if training else EVAL_REL
        for g, w in zip(got["raw"], want["raw"]):
            w = np.asarray(w)
            assert g.shape == w.shape
            assert np.isfinite(w).all()
            np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                       atol=rel * np.abs(w).max())
        if training:
            assert set(got) == {"raw"}
            assert_trees_close(got_s, want_s, STATE_REL, f"{cfg} BN state")
        else:
            w = np.asarray(want["pred"])
            cells = sum((SIZE // int(s)) ** 2 for s in tplan.strides)
            assert got["pred"].shape == w.shape == (2, 3 * cells, 85)
            np.testing.assert_allclose(got["pred"].numpy(), w, rtol=0,
                                       atol=EVAL_REL * np.abs(w).max())
