"""The port's (params, state) trees -> a reference state dict (counterpart
of `yolo_series_tpu/models/torch_export.py`), the inverse of
`models/torch_import.py` over the same blocks.

`export_state_dict` gives a flat {torch key: fp32 numpy array} dict: keys
`model.{i}.<...>`, conv weights OIHW, the implicit layers' (C,) vectors
as (1, C, 1, 1), and the head's buffers: `anchors` normalized by the
strides (yolo.py:538), `anchor_grid` in pixels, (nl, 1, na, 1, 1, 2)
(yolo.py:40-42). `torch.save` of it (or of `{"model": it, "ema": None}`)
is a `.pt` that `load_torch_checkpoint` reads back, and
`load_into_reference_model` copies it into an instantiated reference
`models.yolo.Model`. A Swin v2 attention whose k third of the qkv bias is
not zero raises ValueError: the reference has no k bias to hold it. The serving transforms' blocks (FusedStem, FusedELAN,
PhasedConv) and the int8 trees have no reference form: export the fused
deploy model they were made from.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from yolo_series_tpu_torch.models import attention as ATT
from yolo_series_tpu_torch.models import extra as X
from yolo_series_tpu_torch.models import layers as L
from yolo_series_tpu_torch.models.graph import GraphPlan
from yolo_series_tpu_torch.models.torch_import import (_HEADS, _STATELESS, child_torch_name,
                                                       unported)


def _np(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def _bn(out, prefix: str, p, s):
    out[f"{prefix}.weight"] = _np(p["scale"])
    out[f"{prefix}.bias"] = _np(p["bias"])
    out[f"{prefix}.running_mean"] = _np(s["mean"])
    out[f"{prefix}.running_var"] = _np(s["var"])


def _convbn(out, prefix: str, p, s):
    out[f"{prefix}.conv.weight"] = _np(p["w"])
    if "bn" in p:
        _bn(out, f"{prefix}.bn", p["bn"], s["bn"])
    else:
        out[f"{prefix}.conv.bias"] = _np(p["b"])


def _repconv(out, prefix: str, p, s, block: L.RepConv):
    if "w" in p:   # the fused deploy form
        out[f"{prefix}.rbr_reparam.weight"] = _np(p["w"])
        out[f"{prefix}.rbr_reparam.bias"] = _np(p["b"])
        return
    out[f"{prefix}.rbr_dense.0.weight"] = _np(p["dense"]["w"])
    _bn(out, f"{prefix}.rbr_dense.1", p["dense"]["bn"], s["dense"]["bn"])
    out[f"{prefix}.rbr_1x1.0.weight"] = _np(p["one"]["w"])
    _bn(out, f"{prefix}.rbr_1x1.1", p["one"]["bn"], s["one"]["bn"])
    if block.has_identity:
        _bn(out, f"{prefix}.rbr_identity", p["idbn"], s["idbn"])


def _lin(out, prefix: str, p, bias: bool = True):
    """{w: (in, out)[, b]} -> nn.Linear's (out, in) weight [and bias]."""
    out[f"{prefix}.weight"] = _np(p["w"]).T.copy()
    if bias:
        out[f"{prefix}.bias"] = _np(p["b"])


def _window_attention(out, prefix: str, p, blk: ATT.WindowAttention):
    _lin(out, f"{prefix}.proj", p["proj"])
    if not blk.v2:
        _lin(out, f"{prefix}.qkv", p["qkv"])
        out[f"{prefix}.relative_position_bias_table"] = _np(p["rel_bias"])
        return
    out[f"{prefix}.qkv.weight"] = _np(p["qkv"]["w"]).T.copy()
    b = _np(p["qkv"]["b"])
    c = b.shape[0] // 3
    if not np.allclose(b[c:2 * c], 0.0):
        # the reference v2 has no k bias (common.py:1711-1728); dropping a
        # nonzero one would change the exported attention
        raise ValueError(f"{prefix}: nonzero k-bias slice (max {np.abs(b[c:2 * c]).max():.3e})"
                         " cannot be exported to the reference Swin v2 (k bias is "
                         "structurally zero there)")
    out[f"{prefix}.q_bias"] = b[:c]
    out[f"{prefix}.v_bias"] = b[2 * c:]
    out[f"{prefix}.logit_scale"] = _np(p["logit_scale"])
    _lin(out, f"{prefix}.cpb_mlp.0", p["cpb1"])
    _lin(out, f"{prefix}.cpb_mlp.2", p["cpb2"], bias=False)


def _swin_block(out, prefix: str, p, s, blk: ATT.SwinTransformerBlock):
    if blk.c1 != blk.c2:
        _convbn(out, f"{prefix}.conv", p["conv"], s["conv"])
    for i in range(blk.num_layers):
        lp, t = p[f"m{i}"], f"{prefix}.blocks.{i}"
        for norm in ("norm1", "norm2"):
            out[f"{t}.{norm}.weight"] = _np(lp[norm]["scale"])
            out[f"{t}.{norm}.bias"] = _np(lp[norm]["bias"])
        _window_attention(out, f"{t}.attn", lp["attn"], blk.children()[f"m{i}"]._attn())
        _lin(out, f"{t}.mlp.fc1", lp["fc1"])
        _lin(out, f"{t}.mlp.fc2", lp["fc2"])


def _transformer_block(out, prefix: str, p, s, blk: ATT.TransformerBlock):
    if blk.c1 != blk.c2:
        _convbn(out, f"{prefix}.conv", p["conv"], s["conv"])
    _lin(out, f"{prefix}.linear", p["pos"])
    for i in range(blk.num_layers):
        t, tp = f"{prefix}.tr.{i}", p[f"tr{i}"]
        for name in ("q", "k", "v", "fc1", "fc2"):
            _lin(out, f"{t}.{name}", tp[name], bias=False)
        out[f"{t}.ma.in_proj_weight"] = _np(tp["in_proj"]["w"]).T.copy()
        out[f"{t}.ma.in_proj_bias"] = _np(tp["in_proj"]["b"])
        _lin(out, f"{t}.ma.out_proj", tp["out_proj"])


def _oihw(w) -> np.ndarray:
    """An HWIO leaf (OREPA's branches) -> OIHW."""
    return np.ascontiguousarray(_np(w).transpose(3, 2, 0, 1))


def _orepa3x3(out, prefix: str, p, s):
    """The reference's fixed buffers (average and prior kernels, id_tensor)
    are functions of the shape, already right in an instantiated module."""
    for leaf, key in (("origin", "weight_rbr_origin"), ("avg_conv", "weight_rbr_avg_conv"),
                      ("pfir_conv", "weight_rbr_pfir_conv"),
                      ("kxk_kxk", "weight_rbr_1x1_kxk_conv2"), ("dw", "weight_rbr_gconv_dw"),
                      ("pw", "weight_rbr_gconv_pw")):
        out[f"{prefix}.{key}"] = _oihw(p[leaf])
    conv1 = _np(p["kxk_1x1"])[0, 0].T   # (t, i) = idconv1 + id
    ident = np.eye(conv1.shape[0], conv1.shape[1], dtype=conv1.dtype)
    out[f"{prefix}.weight_rbr_1x1_kxk_idconv1"] = (conv1 - ident)[:, :, None, None]
    out[f"{prefix}.vector"] = _np(p["vector"])
    _bn(out, f"{prefix}.bn", p["bn"], s["bn"])


def _repconv_orepa(out, prefix: str, p, s, blk: X.RepConvOREPA):
    if "w" in p:   # the deploy form (switch_to_deploy)
        out[f"{prefix}.rbr_reparam.weight"] = _np(p["w"])
        out[f"{prefix}.rbr_reparam.bias"] = _np(p["b"])
        return
    _orepa3x3(out, f"{prefix}.rbr_dense", p["rbr_dense"], s["rbr_dense"])
    out[f"{prefix}.rbr_1x1.conv.weight"] = _np(p["rbr_1x1"]["w"])
    _bn(out, f"{prefix}.rbr_1x1.bn", p["rbr_1x1"]["bn"], s["rbr_1x1"]["bn"])
    if blk.has_identity:
        _bn(out, f"{prefix}.rbr_identity", p["idbn"], s["idbn"])


def _robust(out, prefix: str, p, s, blk):
    if isinstance(blk, X.RobustConv):
        _convbn(out, f"{prefix}.conv_dw", p["conv_dw"], s["conv_dw"])
        out[f"{prefix}.conv1x1.weight"] = _np(p["conv1x1"]["w"])
        out[f"{prefix}.conv1x1.bias"] = _np(p["conv1x1"]["b"])
    else:
        _convbn(out, f"{prefix}.conv_strided", p["conv_strided"], s["conv_strided"])
        # the mirrored (out, in) kernel -> ConvTranspose2d's (in, out, kh, kw)
        w = _np(p["deconv"]["w"]).transpose(1, 0, 2, 3)[:, :, ::-1, ::-1]
        out[f"{prefix}.conv_deconv.weight"] = np.ascontiguousarray(w)
        out[f"{prefix}.conv_deconv.bias"] = _np(p["deconv"]["b"])
    if "gamma" in p:
        out[f"{prefix}.gamma"] = _np(p["gamma"])


def export_block(block, out: Dict[str, np.ndarray], prefix: str, p, s):
    """Write one non-head block's keys under `prefix` into `out`."""
    if isinstance(p, dict) and "wq" in p:
        raise ValueError(f"{prefix}: an int8 tree has no reference form; export "
                         "the fused fp model it was quantized from")
    if isinstance(block, L.RepConv):
        return _repconv(out, prefix, p, s, block)
    if isinstance(block, L.Focus):
        return _convbn(out, f"{prefix}.conv", p, s)
    if isinstance(block, L.ConvBnAct):
        return _convbn(out, prefix, p, s)
    if isinstance(block, X.RepConvOREPA):
        return _repconv_orepa(out, prefix, p, s, block)
    if isinstance(block, X.OREPA3x3):
        return _orepa3x3(out, prefix, p, s)
    if isinstance(block, ATT.SwinTransformerBlock):
        return _swin_block(out, prefix, p, s, block)
    if isinstance(block, ATT.TransformerBlock):
        return _transformer_block(out, prefix, p, s, block)
    if isinstance(block, (X.RobustConv, X.RobustConv2)):
        return _robust(out, prefix, p, s, block)
    if isinstance(block, X.MixConv2d):
        for i in range(len(block.k)):
            out[f"{prefix}.m.{i}.weight"] = _np(p[f"m{i}"]["w"])
        return _bn(out, f"{prefix}.bn", p["bn"], s["bn"])
    if isinstance(block, X.Sum):
        if block.weight:
            out[f"{prefix}.w"] = _np(p["w"])
        return None
    if isinstance(block, X.Classify):
        out[f"{prefix}.conv.weight"] = _np(p["w"])
        out[f"{prefix}.conv.bias"] = _np(p["b"])
        return None
    if isinstance(block, X.FReLU):
        out[f"{prefix}.conv.weight"] = _np(p["w"])
        return _bn(out, f"{prefix}.bn", p["bn"], s["bn"])
    if isinstance(block, L.PlainConv):
        out[f"{prefix}.weight"] = _np(p["w"])
        out[f"{prefix}.bias"] = _np(p["b"])
        return None
    if isinstance(block, L.BatchNorm2d):
        return _bn(out, prefix, p, s)
    if isinstance(block, (L.ImplicitA, L.ImplicitM)):
        out[f"{prefix}.implicit"] = _np(p["v"]).reshape(1, -1, 1, 1)
        return None
    if isinstance(block, L.Composite):
        for name, child in block.children().items():
            export_block(child, out, f"{prefix}.{child_torch_name(block, name)}", p[name],
                         s.get(name, {}))
        return None
    if isinstance(block, _STATELESS):
        return None
    raise unported("block", type(block).__name__)


def _head(head, out, prefix: str, p):
    if type(head) not in _HEADS:
        raise unported("head", type(head).__name__)
    for kind in ("m", "m2", "m_kpt"):
        for i, mp in enumerate(p.get(kind, ())):
            out[f"{prefix}.{kind}.{i}.weight"] = _np(mp["w"])
            out[f"{prefix}.{kind}.{i}.bias"] = _np(mp["b"])
    for kind in ("ia", "im"):
        for i, v in enumerate(p.get(kind, ())):
            out[f"{prefix}.{kind}.{i}.implicit"] = _np(v["v"]).reshape(1, -1, 1, 1)
    out[f"{prefix}.anchors"] = np.asarray(head.anchors, np.float32).reshape(
        head.nl, head.na, 2)
    out[f"{prefix}.anchor_grid"] = head.anchors_grid().reshape(head.nl, 1, head.na,
                                                               1, 1, 2)


def export_state_dict(plan: GraphPlan, params, state) -> Dict[str, np.ndarray]:
    """The port's (params, state) for `plan` -> a flat reference state dict
    of fp32 numpy arrays, keys 'model.{i}.<...>'."""
    out: Dict[str, np.ndarray] = {}
    for spec, p, s in zip(plan.layers, params["layers"], state["layers"]):
        prefix = f"model.{spec.index}"
        if spec.is_head:
            _head(spec.block, out, prefix, p)
        elif spec.n_seq > 1:
            for r in range(spec.n_seq):
                export_block(spec.block, out, f"{prefix}.{r}", p[r], s[r])
        else:
            export_block(spec.block, out, prefix, p, s)
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


# buffers of the reference that the export leaves out: bookkeeping, and
# fixed functions of the shapes (Swin's position index and coordinate
# table, common.py:1389-1406, 1693-1721; OREPA's average, prior and
# identity kernels, common.py:1102-1135)
_FIXED = {"num_batches_tracked", "relative_position_index", "relative_coords_table",
          "weight_rbr_avg_avg", "weight_rbr_prior", "id_tensor"}


def load_into_reference_model(ref_model, plan: GraphPlan, params, state):
    """Copy the exported weights into an instantiated reference torch
    `Model` (yolo.py:508) and return it. Every exported key must land, and
    only the reference's bookkeeping and fixed buffers (`_FIXED`: functions
    of the shapes, right in the instantiated module) may be missing from
    the export."""
    sd = {k: torch.from_numpy(v) for k, v in export_state_dict(plan, params, state).items()}
    missing, unexpected = ref_model.load_state_dict(sd, strict=False)
    if unexpected:
        raise ValueError(f"keys the reference model rejected: {unexpected[:8]}")
    missing = [k for k in missing if k.rsplit(".", 1)[-1] not in _FIXED]
    if missing:
        raise ValueError(f"reference keys not exported: {missing[:8]}")
    return ref_model
