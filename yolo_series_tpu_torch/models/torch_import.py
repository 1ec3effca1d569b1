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

Scope: every block and head the port compiles, as the JAX importer maps
them, in their training (BN, RepConv and OREPA branches, implicit layers)
and fused deploy forms. `nn.Linear` weights (out, in) become the port's
(in, out) `w`; Swin v2's q / v biases pack around a zero k third; OREPA's
branch kernels become the HWIO leaves `models/extra.py` keeps, its
1x1-kxk matrix the reference's idconv1 plus its identity buffer;
RobustConv2's `ConvTranspose2d` weight becomes its mirrored (out, in)
`w`. The reference's fixed buffers (Swin's position index and coordinate
table, OREPA's average and prior kernels, IBin's bin tables) are made
anew from the shapes and count as read. A block class that neither
package knows raises NotImplementedError.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from yolo_series_tpu_torch.models import attention as ATT
from yolo_series_tpu_torch.models import extra as X
from yolo_series_tpu_torch.models.extra import _hwio
from yolo_series_tpu_torch.models import heads as H
from yolo_series_tpu_torch.models import layers as L
from yolo_series_tpu_torch.models.graph import GraphPlan

# stateless blocks: no keys in the state dict
_STATELESS = (L.MP, L.SP, L.ReOrg, L.Concat, L.Upsample, L.Shortcut, L.Chuncat,
              L.Foldcut, L.Contract, L.Expand)
_HEADS = (H.Detect, H.IDetect, H.IAuxDetect, H.IBin, H.IKeypoint)
# Ghost's children -> the reference's attribute paths (common.py:244-255)
_GHOST_NAMES = {"conv0": "conv.0", "conv1": "conv.1", "conv2": "conv.2",
                "short_dw": "shortcut.0", "short_pw": "shortcut.1"}


def unported(kind: str, name: str) -> NotImplementedError:
    """The error for a head or block class that neither package knows."""
    return NotImplementedError(f"unknown {kind} {name}: no ROADMAP item: neither package "
                               "knows it")


def child_torch_name(block, name: str) -> str:
    """A composite block's child name -> its attribute path in the
    reference module: Ghost's convs and shortcut; the CSP wrappers' inner
    blocks m0, m1, ... are the reference's nn.Sequential `m` (m.0, m.1,
    ...), but STCSP* / ST2CSP* hold one SwinTransformer(2)Block named
    plain `m` (common.py:1611, :1973)."""
    if isinstance(block, L.Ghost):
        return _GHOST_NAMES[name]
    if name[0] == "m" and name[1:].isdigit():
        if isinstance(block.children()[name], ATT.SwinTransformerBlock):
            return "m"
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


def _lin(sd: _SD, prefix: str, bias: bool = True):
    """nn.Linear (out, in) -> {w: (in, out)[, b]}."""
    p = {"w": sd.get(f"{prefix}.weight").T.contiguous()}
    if bias:
        p["b"] = sd.get(f"{prefix}.bias")
    return p


def _window_attention(sd: _SD, prefix: str, blk: ATT.WindowAttention):
    sd.used.add(f"{prefix}.relative_position_index")   # a fixed buffer
    p = {"proj": _lin(sd, f"{prefix}.proj")}
    if blk.v2:
        sd.used.add(f"{prefix}.relative_coords_table")
        # v2 packs q_bias, zeros, v_bias beside a bias-free qkv weight
        # (common.py:1727-1731)
        qb, vb = sd.get(f"{prefix}.q_bias"), sd.get(f"{prefix}.v_bias")
        p["qkv"] = {"w": sd.get(f"{prefix}.qkv.weight").T.contiguous(),
                    "b": torch.cat([qb, torch.zeros_like(qb), vb])}
        p["logit_scale"] = sd.get(f"{prefix}.logit_scale")
        p["cpb1"] = _lin(sd, f"{prefix}.cpb_mlp.0")
        p["cpb2"] = _lin(sd, f"{prefix}.cpb_mlp.2", bias=False)
    else:
        p["qkv"] = _lin(sd, f"{prefix}.qkv")
        p["rel_bias"] = sd.get(f"{prefix}.relative_position_bias_table")
    return p


def _swin_layer(sd: _SD, prefix: str, blk: ATT.SwinTransformerLayer):
    return {"norm1": {"scale": sd.get(f"{prefix}.norm1.weight"),
                      "bias": sd.get(f"{prefix}.norm1.bias")},
            "norm2": {"scale": sd.get(f"{prefix}.norm2.weight"),
                      "bias": sd.get(f"{prefix}.norm2.bias")},
            "attn": _window_attention(sd, f"{prefix}.attn", blk._attn()),
            "fc1": _lin(sd, f"{prefix}.mlp.fc1"), "fc2": _lin(sd, f"{prefix}.mlp.fc2")}


def _swin_block(sd: _SD, prefix: str, blk: ATT.SwinTransformerBlock):
    params, state = {}, {}
    if blk.c1 != blk.c2:
        params["conv"], state["conv"] = _convbn(sd, f"{prefix}.conv")
    for i in range(blk.num_layers):
        params[f"m{i}"] = _swin_layer(sd, f"{prefix}.blocks.{i}", blk.children()[f"m{i}"])
        state[f"m{i}"] = {}
    return params, state


def _transformer_block(sd: _SD, prefix: str, blk: ATT.TransformerBlock):
    params, state = {}, {}
    if blk.c1 != blk.c2:
        params["conv"], state["conv"] = _convbn(sd, f"{prefix}.conv")
    params["pos"] = _lin(sd, f"{prefix}.linear")
    for i in range(blk.num_layers):
        t = f"{prefix}.tr.{i}"
        params[f"tr{i}"] = {
            "q": _lin(sd, f"{t}.q", bias=False), "k": _lin(sd, f"{t}.k", bias=False),
            "v": _lin(sd, f"{t}.v", bias=False),
            "in_proj": {"w": sd.get(f"{t}.ma.in_proj_weight").T.contiguous(),
                        "b": sd.get(f"{t}.ma.in_proj_bias")},
            "out_proj": _lin(sd, f"{t}.ma.out_proj"),
            "fc1": _lin(sd, f"{t}.fc1", bias=False), "fc2": _lin(sd, f"{t}.fc2", bias=False),
        }
    return params, state


def _id_tensor(c, cig):
    """OREPA's fixed identity buffer (c, c / groups, 1, 1) (common.py:1122-1129),
    which an export leaves out."""
    t = torch.zeros((c, cig, 1, 1))
    for i in range(c):
        t[i, i % cig, 0, 0] = 1.0
    return t


def _orepa3x3(sd: _SD, prefix: str):
    for buf in ("weight_rbr_avg_avg", "weight_rbr_prior"):
        sd.used.add(f"{prefix}.{buf}")   # fixed buffers, made anew
    if sd.has(f"{prefix}.weight_rbr_1x1_kxk_idconv1"):
        # the effective internal matrix (idconv1 + id).squeeze(), (t, i)
        # (common.py:1184-1186); the port's is its transpose (i, t)
        idconv1 = sd.get(f"{prefix}.weight_rbr_1x1_kxk_idconv1")
        conv1 = idconv1 + (sd.get(f"{prefix}.id_tensor") if sd.has(f"{prefix}.id_tensor")
                           else _id_tensor(*idconv1.shape[:2]))
    else:
        conv1 = sd.get(f"{prefix}.weight_rbr_1x1_kxk_conv1")
    bnp, bns = _bn(sd, f"{prefix}.bn")
    return {"origin": _hwio(sd.get(f"{prefix}.weight_rbr_origin")),
            "avg_conv": _hwio(sd.get(f"{prefix}.weight_rbr_avg_conv")),
            "pfir_conv": _hwio(sd.get(f"{prefix}.weight_rbr_pfir_conv")),
            "kxk_1x1": conv1[:, :, 0, 0].T.contiguous()[None, None],
            "kxk_kxk": _hwio(sd.get(f"{prefix}.weight_rbr_1x1_kxk_conv2")),
            "dw": _hwio(sd.get(f"{prefix}.weight_rbr_gconv_dw")),
            "pw": _hwio(sd.get(f"{prefix}.weight_rbr_gconv_pw")),
            "vector": sd.get(f"{prefix}.vector"), "bn": bnp}, {"bn": bns}


def _repconv_orepa(sd: _SD, prefix: str, blk: X.RepConvOREPA):
    if sd.has(f"{prefix}.rbr_reparam.weight"):
        return ({"w": sd.get(f"{prefix}.rbr_reparam.weight"),
                 "b": sd.get(f"{prefix}.rbr_reparam.bias")}, {})
    dp, ds = _orepa3x3(sd, f"{prefix}.rbr_dense")
    bnp, bns = _bn(sd, f"{prefix}.rbr_1x1.bn")
    params = {"rbr_dense": dp,
              "rbr_1x1": {"w": sd.get(f"{prefix}.rbr_1x1.conv.weight"), "bn": bnp}}
    state = {"rbr_dense": ds, "rbr_1x1": {"bn": bns}}
    if blk.has_identity:
        params["idbn"], state["idbn"] = _bn(sd, f"{prefix}.rbr_identity")
    return params, state


def _robust(sd: _SD, prefix: str, blk):
    """RobustConv (conv_dw + conv1x1) or RobustConv2 (conv_strided +
    conv_deconv), with the layer scale gamma when the reference has one."""
    params, state = {}, {}
    if isinstance(blk, X.RobustConv):
        params["conv_dw"], state["conv_dw"] = _convbn(sd, f"{prefix}.conv_dw")
        params["conv1x1"] = {"w": sd.get(f"{prefix}.conv1x1.weight"),
                             "b": sd.get(f"{prefix}.conv1x1.bias")}
    else:
        params["conv_strided"], state["conv_strided"] = _convbn(sd, f"{prefix}.conv_strided")
        # ConvTranspose2d's (in, out, kh, kw) -> the mirrored (out, in) kernel
        wt = sd.get(f"{prefix}.conv_deconv.weight")
        params["deconv"] = {"w": wt.transpose(0, 1).flip(2, 3).contiguous(),
                            "b": sd.get(f"{prefix}.conv_deconv.bias")}
    if sd.has(f"{prefix}.gamma"):
        params["gamma"] = sd.get(f"{prefix}.gamma")
    return params, state


def import_block(block, sd: _SD, prefix: str) -> Tuple[Any, Any]:
    """(params, state) of one non-head block from the keys under `prefix`."""
    if isinstance(block, L.RepConv):
        return _repconv(sd, prefix, block)
    if isinstance(block, L.Focus):
        return _convbn(sd, f"{prefix}.conv")
    if isinstance(block, L.ConvBnAct):
        return _convbn(sd, prefix)
    if isinstance(block, X.RepConvOREPA):
        return _repconv_orepa(sd, prefix, block)
    if isinstance(block, X.OREPA3x3):
        return _orepa3x3(sd, prefix)
    if isinstance(block, ATT.SwinTransformerBlock):
        return _swin_block(sd, prefix, block)
    if isinstance(block, ATT.TransformerBlock):
        return _transformer_block(sd, prefix, block)
    if isinstance(block, (X.RobustConv, X.RobustConv2)):
        return _robust(sd, prefix, block)
    if isinstance(block, X.MixConv2d):
        params = {f"m{i}": {"w": sd.get(f"{prefix}.m.{i}.weight")}
                  for i in range(len(block.k))}
        params["bn"], bns = _bn(sd, f"{prefix}.bn")
        return params, {"bn": bns}
    if isinstance(block, X.Sum):
        return ({"w": sd.get(f"{prefix}.w")} if block.weight else {}), {}
    if isinstance(block, X.Classify):
        return {"w": sd.get(f"{prefix}.conv.weight"), "b": sd.get(f"{prefix}.conv.bias")}, {}
    if isinstance(block, X.FReLU):
        bnp, bns = _bn(sd, f"{prefix}.bn")
        return {"w": sd.get(f"{prefix}.conv.weight"), "bn": bnp}, {"bn": bns}
    if isinstance(block, L.PlainConv):
        return {"w": sd.get(f"{prefix}.weight"), "b": sd.get(f"{prefix}.bias")}, {}
    if isinstance(block, L.BatchNorm2d):
        return _bn(sd, prefix)
    if isinstance(block, (L.ImplicitA, L.ImplicitM)):
        return {"v": sd.get(f"{prefix}.implicit").reshape(-1)}, {}
    if isinstance(block, L.Composite):
        params, state = {}, {}
        for name, child in block.children().items():
            params[name], state[name] = import_block(
                child, sd, f"{prefix}.{child_torch_name(block, name)}")
        return params, state
    if isinstance(block, _STATELESS):
        return {}, {}
    raise unported("block", type(block).__name__)


def _head(head, sd: _SD, prefix: str):
    if type(head) not in _HEADS:
        raise unported("head", type(head).__name__)
    nl = head.nl

    def convs(kind):
        return [{"w": sd.get(f"{prefix}.{kind}.{i}.weight"),
                 "b": sd.get(f"{prefix}.{kind}.{i}.bias")} for i in range(nl)]

    params: Dict[str, Any] = {"m": convs("m")}
    if isinstance(head, H.IBin):   # SigmoidBin's buffers are fixed tables
        for wh in ("w", "h"):
            sd.used.add(f"{prefix}.{wh}_bin_sigmoid.bins")
            sd.used.add(f"{prefix}.{wh}_bin_sigmoid.BCEbins.pos_weight")
    # a fused checkpoint has the implicit layers folded into m
    if type(head) is not H.Detect and sd.has(f"{prefix}.ia.0.implicit"):
        for kind in ("ia", "im"):
            params[kind] = [{"v": sd.get(f"{prefix}.{kind}.{i}.implicit").reshape(-1)}
                            for i in range(nl)]
    if isinstance(head, H.IAuxDetect) and sd.has(f"{prefix}.m2.0.weight"):
        params["m2"] = convs("m2")
    if isinstance(head, H.IKeypoint):
        params["m_kpt"] = convs("m_kpt")
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
