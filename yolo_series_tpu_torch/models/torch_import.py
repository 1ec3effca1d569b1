"""Reference `.pt` checkpoints -> the port's (params, state) trees
(counterpart of `yolo_series_tpu/models/torch_import.py`).

The upstream YOLOv7 repository and its forks publish their weights as
`.pt` files: a dict whose `model` (and `ema`) entry is the pickled
`models.yolo.Model`, or a plain state dict. `import_state_dict` maps a
flat state dict (`model.{i}.<...>` keys, numpy or torch values) onto a
`GraphPlan` of the port: conv weights stay OIHW, the implicit layers'
(1, C, 1, 1) buffers flatten to (C,), every value becomes a new fp32
tensor on the CPU (copied, never aliased: an in-place update of the
source cannot reach the imported trees).

Scope: the blocks the port compiles (ConvBnAct, RepConv, the composite
blocks SPP, SPPCSPC, DownC, Stem, Bottleneck, Res and the
BottleneckCSP / ResCSP / ResXCSP A/B/C wrappers, the stateless MP, SP,
ReOrg, Shortcut, Concat and Upsample, ImplicitA / ImplicitM) and the
Detect, IDetect and IAuxDetect heads, in their training (BN, RepConv
branches, implicit layers) and fused deploy forms. The JAX importer's
other branches raise NotImplementedError naming their ROADMAP queue 1
item (`graph.roadmap_item`): Ghost*, Focus and BatchNorm2d are item 16 (c);
OREPA, Swin, Transformer, RobustConv, MixConv2d and the rest of
`models/extra.py` and `models/attention.py` item 16 (d); the IBin and
IKeypoint heads item 15.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from yolo_series_tpu_torch.models import heads as H
from yolo_series_tpu_torch.models import layers as L
from yolo_series_tpu_torch.models.graph import GraphPlan, roadmap_item

# stateless blocks: no keys in the state dict
_STATELESS = (L.MP, L.SP, L.ReOrg, L.Concat, L.Upsample, L.Shortcut)


def unported(kind: str, name: str) -> NotImplementedError:
    """The error for a head or block of the reference the port does not
    hold, naming its ROADMAP queue 1 item (`graph.roadmap_item`; a class of
    the JAX package's models/extra.py or models/attention.py that the DSL
    does not name, such as OREPA3x3, is item 16 (d))."""
    item = roadmap_item(name) or "16 (d)"
    return NotImplementedError(
        f"{kind} {name} is not ported yet: ROADMAP queue 1, item {item}")


def child_torch_name(name: str) -> str:
    """A composite block's child name -> its attribute path in the
    reference module: the CSP wrappers' inner blocks m0, m1, ... are the
    reference's nn.Sequential `m` (m.0, m.1, ...)."""
    if name[0] == "m" and name[1:].isdigit():
        return f"m.{name[1:]}"
    return name


class _SD:
    """A flat state dict with consumption tracking."""

    def __init__(self, sd: Mapping[str, Any]):
        self.sd = sd
        self.used = set()

    def get(self, key: str) -> torch.Tensor:
        self.used.add(key)
        v = self.sd[key]
        if isinstance(v, torch.Tensor):
            return v.detach().to("cpu", torch.float32, copy=True)
        return torch.from_numpy(np.array(v, dtype=np.float32, copy=True))

    def has(self, key: str) -> bool:
        return key in self.sd

    def unused(self):
        """Keys no block read, but for the reference's bookkeeping buffers
        (`num_batches_tracked`) and the head's anchors, which the cfg gives."""
        return [k for k in self.sd if k not in self.used
                and not k.endswith("num_batches_tracked")
                and not k.endswith("anchors") and not k.endswith("anchor_grid")]


def _bn(sd: _SD, prefix: str):
    return ({"scale": sd.get(f"{prefix}.weight"), "bias": sd.get(f"{prefix}.bias")},
            {"mean": sd.get(f"{prefix}.running_mean"),
             "var": sd.get(f"{prefix}.running_var")})


def _convbn(sd: _SD, prefix: str):
    """Reference Conv (common.py:99): conv.weight with bn.*, or fused
    conv.weight + conv.bias."""
    w = sd.get(f"{prefix}.conv.weight")
    if sd.has(f"{prefix}.bn.weight"):
        bnp, bns = _bn(sd, f"{prefix}.bn")
        return {"w": w, "bn": bnp}, {"bn": bns}
    return {"w": w, "b": sd.get(f"{prefix}.conv.bias")}, {}


def _repconv(sd: _SD, prefix: str, block: L.RepConv):
    if sd.has(f"{prefix}.rbr_reparam.weight"):
        return ({"w": sd.get(f"{prefix}.rbr_reparam.weight"),
                 "b": sd.get(f"{prefix}.rbr_reparam.bias")}, {})
    dp, ds = _bn(sd, f"{prefix}.rbr_dense.1")
    op, os_ = _bn(sd, f"{prefix}.rbr_1x1.1")
    params = {"dense": {"w": sd.get(f"{prefix}.rbr_dense.0.weight"), "bn": dp},
              "one": {"w": sd.get(f"{prefix}.rbr_1x1.0.weight"), "bn": op}}
    state = {"dense": {"bn": ds}, "one": {"bn": os_}}
    if block.has_identity:
        params["idbn"], state["idbn"] = _bn(sd, f"{prefix}.rbr_identity")
    return params, state


def import_block(block, sd: _SD, prefix: str) -> Tuple[Any, Any]:
    """(params, state) of one non-head block from the keys under `prefix`."""
    if isinstance(block, L.RepConv):
        return _repconv(sd, prefix, block)
    if isinstance(block, L.ConvBnAct):
        return _convbn(sd, prefix)
    if isinstance(block, L.PlainConv):
        return {"w": sd.get(f"{prefix}.weight"), "b": sd.get(f"{prefix}.bias")}, {}
    if isinstance(block, (L.ImplicitA, L.ImplicitM)):
        return {"v": sd.get(f"{prefix}.implicit").reshape(-1)}, {}
    if isinstance(block, L.Composite):
        params, state = {}, {}
        for name, child in block.children().items():
            params[name], state[name] = import_block(child, sd,
                                                     f"{prefix}.{child_torch_name(name)}")
        return params, state
    if isinstance(block, _STATELESS):
        return {}, {}
    raise unported("block", type(block).__name__)


def _head(head, sd: _SD, prefix: str):
    if type(head) not in (H.Detect, H.IDetect, H.IAuxDetect):
        raise unported("head", type(head).__name__)
    nl = head.nl
    params: Dict[str, Any] = {"m": [{"w": sd.get(f"{prefix}.m.{i}.weight"),
                                     "b": sd.get(f"{prefix}.m.{i}.bias")}
                                    for i in range(nl)]}
    # a fused checkpoint has the implicit layers folded into m
    if isinstance(head, (H.IDetect, H.IAuxDetect)) and sd.has(f"{prefix}.ia.0.implicit"):
        for kind in ("ia", "im"):
            params[kind] = [{"v": sd.get(f"{prefix}.{kind}.{i}.implicit").reshape(-1)}
                            for i in range(nl)]
    if isinstance(head, H.IAuxDetect) and sd.has(f"{prefix}.m2.0.weight"):
        params["m2"] = [{"w": sd.get(f"{prefix}.m2.{i}.weight"),
                         "b": sd.get(f"{prefix}.m2.{i}.bias")} for i in range(nl)]
    return params, {}


def import_state_dict(plan: GraphPlan, state_dict: Mapping[str, Any], strict: bool = True):
    """A reference flat state dict (keys 'model.{i}.<...>', numpy or torch
    values) -> the port's (params, state) for `plan`, fp32 on the CPU.
    strict: a key that no block reads raises ValueError."""
    sd = _SD(state_dict)
    params, state = [], []
    for spec in plan.layers:
        prefix = f"model.{spec.index}"
        if spec.is_head:
            p, s = _head(spec.block, sd, prefix)
        elif spec.n_seq > 1:
            ps, ss = zip(*[import_block(spec.block, sd, f"{prefix}.{r}")
                           for r in range(spec.n_seq)])
            p, s = list(ps), list(ss)
        else:
            p, s = import_block(spec.block, sd, prefix)
        params.append(p)
        state.append(s)
    if strict:
        left = sd.unused()
        if left:
            raise ValueError(f"unmatched torch keys: {left[:10]} "
                             f"(+{max(len(left) - 10, 0)} more)")
    return {"layers": params}, {"layers": state}


def load_torch_checkpoint(path: str, plan: GraphPlan, prefer_ema: bool = True):
    """A reference `.pt` -> the port's (params, state) for `plan`.

    The file holds a dict with `model` (and `ema`, preferred when it is
    set, as the reference's attempt_load prefers it, experimental.py:253)
    or is itself the model or a state dict; the model is a state dict or a
    pickled module. fp16 values become fp32. The file is unpickled in full
    (`weights_only=False`), as the JAX loader does: a pickled module needs
    the reference's own code (its `models` and `utils` packages)
    importable, a state dict needs nothing but torch. Load only files you
    trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    model = ckpt
    if isinstance(ckpt, dict):
        ema = ckpt.get("ema")
        model = ema if prefer_ema and ema is not None else ckpt.get("model", ckpt)
    sd = model.state_dict() if hasattr(model, "state_dict") else model
    return import_state_dict(plan, sd)
