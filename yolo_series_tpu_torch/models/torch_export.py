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
`models.yolo.Model`. The serving transforms' blocks (FusedStem, FusedELAN,
PhasedConv) and the int8 trees have no reference form: export the fused
deploy model they were made from.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from yolo_series_tpu_torch.models import heads as H
from yolo_series_tpu_torch.models import layers as L
from yolo_series_tpu_torch.models.graph import GraphPlan
from yolo_series_tpu_torch.models.torch_import import _STATELESS, child_torch_name, unported


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


def export_block(block, out: Dict[str, np.ndarray], prefix: str, p, s):
    """Write one non-head block's keys under `prefix` into `out`."""
    if isinstance(p, dict) and "wq" in p:
        raise ValueError(f"{prefix}: an int8 tree has no reference form; export "
                         "the fused fp model it was quantized from")
    if isinstance(block, L.RepConv):
        return _repconv(out, prefix, p, s, block)
    if isinstance(block, L.ConvBnAct):
        return _convbn(out, prefix, p, s)
    if isinstance(block, L.PlainConv):
        out[f"{prefix}.weight"] = _np(p["w"])
        out[f"{prefix}.bias"] = _np(p["b"])
        return None
    if isinstance(block, (L.ImplicitA, L.ImplicitM)):
        out[f"{prefix}.implicit"] = _np(p["v"]).reshape(1, -1, 1, 1)
        return None
    if isinstance(block, L.Composite):
        for name, child in block.children().items():
            export_block(child, out, f"{prefix}.{child_torch_name(name)}", p[name],
                         s.get(name, {}))
        return None
    if isinstance(block, _STATELESS):
        return None
    raise unported("block", type(block).__name__)


def _head(head, out, prefix: str, p):
    if type(head) not in (H.Detect, H.IDetect, H.IAuxDetect):
        raise unported("head", type(head).__name__)
    for kind in ("m", "m2"):
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


def load_into_reference_model(ref_model, plan: GraphPlan, params, state):
    """Copy the exported weights into an instantiated reference torch
    `Model` (yolo.py:508) and return it. Every exported key must land, and
    only the reference's bookkeeping buffers (`num_batches_tracked`) may be
    missing from the export."""
    sd = {k: torch.from_numpy(v) for k, v in export_state_dict(plan, params, state).items()}
    missing, unexpected = ref_model.load_state_dict(sd, strict=False)
    if unexpected:
        raise ValueError(f"keys the reference model rejected: {unexpected[:8]}")
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing:
        raise ValueError(f"reference keys not exported: {missing[:8]}")
    return ref_model
