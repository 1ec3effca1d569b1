"""YAML model-graph compiler (counterpart of `yolo_series_tpu/models/graph.py`).

Compiles the `[from, n, module, args]` graph DSL (reference
models/yolo.py:736-813 `parse_model`) into a static `GraphPlan`, with the
JAX package's rules: `make_divisible` width scaling, strides propagated
through each block's `stride_factor`, anchors order-checked and
normalized, and module names resolved through an explicit registry — no
eval(). Accepts the canonical lowercase names and the reference's names.

Every module name the JAX package's compiler accepts is registered here,
with its blocks in the port's `models/layers.py`, `models/extra.py` and
`models/attention.py` and its heads (detect, idetect, iauxdetect, ibin,
ikeypoint) in `models/heads.py`; the implicit layers implicita /
implicitm take their width from their input. A name that neither package
knows raises NotImplementedError. An iauxdetect row routes 2 x nl inputs,
lead maps then aux maps: nl comes from the anchors, and the lead inputs'
strides are the head's. An ibin row's third argument is its bin count, an
ikeypoint row's its keypoint count.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import yaml

from yolo_series_tpu_torch.models import attention as ATT
from yolo_series_tpu_torch.models import extra as X
from yolo_series_tpu_torch.models import heads as H
from yolo_series_tpu_torch.models import layers as L


def make_divisible(x, divisor=8):
    return math.ceil(x / divisor) * divisor


# name normalization: reference DSL name -> canonical
_REF_NAMES = {
    "Conv": "conv", "nn.Conv2d": "conv2d", "DWConv": "dwconv",
    "GhostConv": "ghostconv", "RepConv": "repconv", "DownC": "downc",
    "SPP": "spp", "SPPF": "sppf", "SPPCSPC": "sppcspc",
    "GhostSPPCSPC": "ghostsppcspc", "Focus": "focus", "Stem": "stem",
    "GhostStem": "ghoststem", "Bottleneck": "bottleneck",
    "BottleneckCSPA": "bottleneckcspa", "BottleneckCSPB": "bottleneckcspb",
    "BottleneckCSPC": "bottleneckcspc",
    "Res": "res", "ResCSPA": "rescspa", "ResCSPB": "rescspb", "ResCSPC": "rescspc",
    "ResX": "resx", "ResXCSPA": "resxcspa", "ResXCSPB": "resxcspb",
    "ResXCSPC": "resxcspc",
    "Ghost": "ghost", "GhostCSPA": "ghostcspa", "GhostCSPB": "ghostcspb",
    "GhostCSPC": "ghostcspc",
    "MP": "mp", "SP": "sp", "ReOrg": "reorg", "Concat": "concat",
    "Chuncat": "chuncat", "Shortcut": "shortcut", "Foldcut": "foldcut",
    "nn.Upsample": "upsample", "Upsample": "upsample",
    "nn.BatchNorm2d": "batchnorm2d", "Contract": "contract", "Expand": "expand",
    "Detect": "detect", "IDetect": "idetect", "IAuxDetect": "iauxdetect",
    "IBin": "ibin", "IKeypoint": "ikeypoint",
    "RobustConv": "robustconv", "RobustConv2": "robustconv2",
    "CrossConv": "crossconv", "Sum": "sum", "MixConv2d": "mixconv2d",
    "SwinTransformerBlock": "swintransformerblock",
    "SwinTransformer2Block": "swintransformer2block",
    "STCSPA": "stcspa", "STCSPB": "stcspb", "STCSPC": "stcspc",
    "ST2CSPA": "st2cspa", "ST2CSPB": "st2cspb", "ST2CSPC": "st2cspc",
    "TransformerBlock": "transformerblock",
    "RepConv_OREPA": "repconv_orepa",
    "Classify": "classify", "FReLU": "frelu",
    "ImplicitA": "implicita", "ImplicitM": "implicitm",
}
# conv-family modules: args start [c2, ...] and get width scaling
_CONV_FAMILY = {
    "conv", "conv2d", "dwconv", "ghostconv", "repconv", "downc", "spp", "sppf",
    "sppcspc", "ghostsppcspc", "focus", "stem", "ghoststem", "bottleneck",
    "bottleneckcspa", "bottleneckcspb", "bottleneckcspc",
    "res", "rescspa", "rescspb", "rescspc", "resx", "resxcspa", "resxcspb",
    "resxcspc", "ghost", "ghostcspa", "ghostcspb", "ghostcspc",
    "robustconv", "robustconv2", "crossconv", "mixconv2d",
    "swintransformerblock", "swintransformer2block",
    "stcspa", "stcspb", "stcspc", "st2cspa", "st2cspb", "st2cspc",
    "transformerblock", "repconv_orepa", "classify",
}
# subset that takes an inner repeat count inserted at args[2]
_TAKES_N = {
    "downc", "sppcspc", "ghostsppcspc", "bottleneckcspa", "bottleneckcspb",
    "bottleneckcspc", "rescspa", "rescspb", "rescspc", "resxcspa", "resxcspb",
    "resxcspc", "ghostcspa", "ghostcspb", "ghostcspc",
    "stcspa", "stcspb", "stcspc", "st2cspa", "st2cspb", "st2cspc",
}


def _swin2block(c1, c2, num_heads, num_layers, window_size=7):
    """SwinTransformer2Block: v2 layers, window 7 by default, not v1's 8
    (common.py:1947)."""
    return ATT.SwinTransformerBlock(c1, c2, num_heads, num_layers,
                                    window_size=window_size, v2=True)


_BLOCK_CLASSES = {
    "conv": L.ConvBnAct, "dwconv": L.DWConv, "ghostconv": L.GhostConv,
    "repconv": L.RepConv, "downc": L.DownC, "spp": L.SPP, "sppf": L.SPPF,
    "sppcspc": L.SPPCSPC, "focus": L.Focus, "stem": L.Stem,
    "bottleneck": L.Bottleneck, "bottleneckcspa": L.BottleneckCSPA,
    "bottleneckcspb": L.BottleneckCSPB, "bottleneckcspc": L.BottleneckCSPC,
    "res": L.Res, "rescspa": L.ResCSPA, "rescspb": L.ResCSPB, "rescspc": L.ResCSPC,
    "resx": L.ResX, "resxcspa": L.ResXCSPA, "resxcspb": L.ResXCSPB,
    "resxcspc": L.ResXCSPC,
    "ghost": L.Ghost, "ghostcspa": L.GhostCSPA, "ghostcspb": L.GhostCSPB,
    "ghostcspc": L.GhostCSPC,
    "mp": L.MP, "sp": L.SP, "reorg": L.ReOrg, "foldcut": L.Foldcut,
    "batchnorm2d": L.BatchNorm2d, "contract": L.Contract, "expand": L.Expand,
    "conv2d": L.PlainConv, "implicita": L.ImplicitA, "implicitm": L.ImplicitM,
    "ghostsppcspc": X.GhostSPPCSPC, "ghoststem": X.GhostStem,
    "robustconv": X.RobustConv, "robustconv2": X.RobustConv2,
    "crossconv": X.CrossConv, "mixconv2d": X.MixConv2d,
    "repconv_orepa": X.RepConvOREPA, "classify": X.Classify, "frelu": X.FReLU,
    "swintransformerblock": ATT.SwinTransformerBlock,
    "swintransformer2block": _swin2block,
    "stcspa": ATT.STCSPA, "stcspb": ATT.STCSPB, "stcspc": ATT.STCSPC,
    "st2cspa": ATT.ST2CSPA, "st2cspb": ATT.ST2CSPB, "st2cspc": ATT.ST2CSPC,
    "transformerblock": ATT.TransformerBlock,
}
_HEAD_CLASSES = {"detect": H.Detect, "idetect": H.IDetect,
                 "iauxdetect": H.IAuxDetect, "ibin": H.IBin,
                 "ikeypoint": H.IKeypoint}


def _not_ported(m: str, i: int) -> NotImplementedError:
    return NotImplementedError(f"unknown module {m!r} (layer {i}): no ROADMAP item: "
                               "neither package knows it")


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    index: int
    frm: Union[int, Tuple[int, ...]]   # resolved absolute input indices (-1 ok)
    block: Any                         # Block or head instance
    cout: int
    stride: float
    is_head: bool = False
    n_seq: int = 1                     # sequential repeats (distinct params)


@dataclasses.dataclass(frozen=True)
class GraphPlan:
    layers: Tuple[LayerSpec, ...]
    save: Tuple[int, ...]
    nc: int
    names: Tuple[str, ...] = ()

    @property
    def head(self):
        return self.layers[-1].block

    @property
    def strides(self):
        return self.head.strides


def _norm_module(m: str) -> str:
    return _REF_NAMES.get(m, m.lower())


def _norm_act(a):
    """The reference's eval()-style 'None'/'True'/'False' strings to Python
    values, activation specs to canonical names."""
    if isinstance(a, str):
        if a == "None":
            return None
        if a in ("True", "False"):
            return a == "True"
        if a.startswith("nn.") or a in L.ACTIVATIONS or a.startswith("leaky_relu"):
            return L.get_activation(a)[0]
    return a


def check_anchor_order(anchors: np.ndarray, strides: Sequence[float]) -> np.ndarray:
    """Flip anchor rows if their area order disagrees with stride order
    (reference utils/autoanchor.py:12-20)."""
    a = anchors.reshape(len(strides), -1, 2)
    areas = a.prod(-1).mean(-1)
    if np.sign(areas[-1] - areas[0]) != np.sign(strides[-1] - strides[0]):
        a = a[::-1].copy()
    return a


def compile_graph(cfg: Union[str, dict], ch: int = 3,
                  nc: Optional[int] = None,
                  anchors: Optional[list] = None) -> GraphPlan:
    """Compile a model cfg (path or dict) into a GraphPlan."""
    if isinstance(cfg, str):
        with open(cfg) as f:
            d = yaml.safe_load(f)
    else:
        d = dict(cfg)
    if nc is not None:
        d["nc"] = nc
    if anchors is not None:
        d["anchors"] = anchors

    nc_ = d["nc"]
    gd = d.get("depth_multiple", 1.0)
    gw = d.get("width_multiple", 1.0)
    anchors_cfg = d["anchors"]
    na = (len(anchors_cfg[0]) // 2) if isinstance(anchors_cfg, list) else anchors_cfg
    no = na * (nc_ + 5)

    rows = list(d["backbone"]) + list(d["head"])
    channels: List[int] = [ch]
    strides: List[float] = [1.0]
    layers: List[LayerSpec] = []
    save: set = set()
    head_row = None

    for i, (f, n, m, args) in enumerate(rows):
        name = _norm_module(m)
        args = list(args)
        n_eff = max(round(n * gd), 1) if n > 1 else n

        def ch_at(j):
            # channels[0] is the input image; layer i lives at channels[i+1]
            return channels[j + 1] if j >= 0 else channels[len(layers) + 1 + j]

        def st_at(j):
            return strides[j + 1] if j >= 0 else strides[len(layers) + 1 + j]

        if name in _HEAD_CLASSES:
            args = [nc_ if a == "nc" else anchors_cfg if a == "anchors" else a
                    for a in args]
            head_ch = tuple(ch_at(x) for x in f)
            anc = args[1] if len(args) > 1 else anchors_cfg
            if isinstance(anc, int):
                anc = [list(range(anc * 2))] * len(f)
            anc_np = np.asarray(anc, np.float32).reshape(len(anc), -1, 2)
            # IAuxDetect routes lead then aux maps: the lead's are the first nl
            nl = len(anc) if name == "iauxdetect" else len(f)
            lead_strides = tuple(st_at(x) for x in f[:nl])
            anc_np = check_anchor_order(anc_np, lead_strides)
            anc_norm = anc_np / np.asarray(lead_strides, np.float32)[:, None, None]
            extra = {}
            if len(args) > 2 and isinstance(args[2], int):
                # the third argument: nkpt (IKeypoint, yolo.py:214), bin_count
                # (IBin, yolo.py:437)
                if name == "ikeypoint":
                    extra["nkpt"] = args[2]
                elif name == "ibin":
                    extra["bin_count"] = args[2]
            head = _HEAD_CLASSES[name](
                nc=args[0] if args else nc_,
                anchors=tuple(tuple(r.reshape(-1).tolist()) for r in anc_norm),
                ch=head_ch, strides=lead_strides, **extra)
            frm_h = tuple(j if j == -1 else (i + j if j < 0 else j) for j in f)
            spec = LayerSpec(i, frm_h, head, 0, 0.0, is_head=True)
            layers.append(spec)
            channels.append(0)
            strides.append(0.0)
            save.update(x % i for x in f if x != -1)
            head_row = spec
            continue

        if name in _CONV_FAMILY:
            c1 = ch_at(f)
            c2 = args[0]
            if c2 != no:
                c2 = make_divisible(c2 * gw, 8)
            bargs = [c1, c2] + args[1:]
            if name in _TAKES_N:
                bargs.insert(2, n_eff)
                n_eff = 1
            bargs = [_norm_act(a) for a in bargs]
            bargs = [tuple(a) if isinstance(a, list) else a for a in bargs]
            block = _BLOCK_CLASSES[name](*bargs)
            cout = block.cout
            stride = st_at(f) * (block.stride_factor ** n_eff
                                 if block.stride_factor != 1.0 else 1.0)
        elif name == "concat":
            cins = tuple(ch_at(x) for x in f)
            sts = {st_at(x) for x in f}
            if len(sts) != 1:
                raise ValueError(f"concat inputs at different strides: layer {i}")
            block = L.Concat(cins)
            cout = block.cout
            stride = sts.pop()
        elif name == "chuncat":
            block = L.Chuncat(tuple(ch_at(x) for x in f))
            cout = block.cout
            stride = st_at(f[0])
        elif name == "shortcut":
            block = L.Shortcut(tuple(ch_at(x) for x in f))
            cout = block.cout
            stride = st_at(f[0])
        elif name == "sum":
            block = X.Sum(tuple(ch_at(x) for x in f),
                          weight=bool(args[1]) if len(args) > 1 else False)
            cout = block.cout
            stride = st_at(f[0])
        elif name == "upsample":
            # reference rows: [None, 2, 'nearest']
            scale = int(args[1]) if len(args) > 1 else int(args[0])
            block = L.Upsample(ch_at(f), scale)
            cout = block.cout
            stride = st_at(f) / scale
        elif name in _BLOCK_CLASSES:
            bargs = [ch_at(f)] + [tuple(a) if isinstance(a, list) else a
                                  for a in args]
            block = _BLOCK_CLASSES[name](*bargs)
            cout = block.cout
            stride = st_at(f) * block.stride_factor
        else:
            raise _not_ported(m, i)

        if isinstance(f, list):
            frm = tuple(j if j == -1 else (i + j if j < 0 else j) for j in f)
        else:
            frm = f if f == -1 else (i + f if f < 0 else f)
        layers.append(LayerSpec(i, frm, block, cout, stride, n_seq=n_eff))
        channels.append(cout)
        strides.append(stride)
        fl = f if isinstance(f, list) else [f]
        save.update(x % i for x in fl if x != -1)

    if head_row is None:
        raise ValueError("model cfg has no detection head")

    names = tuple(d.get("names", [str(j) for j in range(nc_)]))
    return GraphPlan(tuple(layers), tuple(sorted(save)), nc_, names)
