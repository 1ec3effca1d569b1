"""YAML model-graph compiler (counterpart of `yolo_series_tpu/models/graph.py`).

Compiles the `[from, n, module, args]` graph DSL (reference
models/yolo.py:736-813 `parse_model`) into a static `GraphPlan`, with the
JAX package's rules: `make_divisible` width scaling, strides propagated
through each block's `stride_factor`, anchors order-checked and
normalized, and module names resolved through an explicit registry — no
eval(). Accepts the canonical lowercase names and the reference's names.

The modules of every shipped cfg are ported: conv, mp, sp, reorg,
concat, shortcut, upsample, spp, sppcspc, repconv, downc, stem,
bottleneck, res, resx, the CSP wrappers bottleneckcsp{a,b,c},
rescsp{a,b,c} and resxcsp{a,b,c}, the heads detect, idetect and
iauxdetect, and the implicit layers implicita / implicitm, which take
their width from their input. Any other module raises
NotImplementedError naming the ROADMAP queue 1 item that ports it. An
iauxdetect row routes 2 x nl inputs, lead maps then aux maps: nl comes
from the anchors, and the lead inputs' strides are the head's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import yaml

from yolo_series_tpu_torch.models import heads as H
from yolo_series_tpu_torch.models import layers as L


def make_divisible(x, divisor=8):
    return math.ceil(x / divisor) * divisor


# name normalization: reference DSL name -> canonical
_REF_NAMES = {
    "Conv": "conv", "RepConv": "repconv", "DownC": "downc", "SPP": "spp",
    "SPPCSPC": "sppcspc", "Stem": "stem", "Bottleneck": "bottleneck",
    "BottleneckCSPA": "bottleneckcspa", "BottleneckCSPB": "bottleneckcspb",
    "BottleneckCSPC": "bottleneckcspc",
    "Res": "res", "ResCSPA": "rescspa", "ResCSPB": "rescspb", "ResCSPC": "rescspc",
    "ResX": "resx", "ResXCSPA": "resxcspa", "ResXCSPB": "resxcspb",
    "ResXCSPC": "resxcspc",
    "MP": "mp", "SP": "sp", "ReOrg": "reorg", "Concat": "concat",
    "Shortcut": "shortcut", "nn.Upsample": "upsample", "Upsample": "upsample",
    "Detect": "detect", "IDetect": "idetect", "IAuxDetect": "iauxdetect",
    "ImplicitA": "implicita", "ImplicitM": "implicitm",
    "nn.Conv2d": "conv2d", "nn.BatchNorm2d": "batchnorm2d",
}
# conv-family modules: args start [c2, ...] and get width scaling
_CONV_FAMILY = {
    "conv", "repconv", "downc", "spp", "sppcspc", "stem", "bottleneck",
    "bottleneckcspa", "bottleneckcspb", "bottleneckcspc",
    "res", "rescspa", "rescspb", "rescspc", "resx", "resxcspa", "resxcspb",
    "resxcspc",
}
# subset that takes an inner repeat count inserted at args[2]
_TAKES_N = {
    "downc", "sppcspc", "bottleneckcspa", "bottleneckcspb", "bottleneckcspc",
    "rescspa", "rescspb", "rescspc", "resxcspa", "resxcspb", "resxcspc",
}
_BLOCK_CLASSES = {
    "conv": L.ConvBnAct, "repconv": L.RepConv, "downc": L.DownC, "spp": L.SPP,
    "sppcspc": L.SPPCSPC, "stem": L.Stem, "bottleneck": L.Bottleneck,
    "bottleneckcspa": L.BottleneckCSPA, "bottleneckcspb": L.BottleneckCSPB,
    "bottleneckcspc": L.BottleneckCSPC,
    "res": L.Res, "rescspa": L.ResCSPA, "rescspb": L.ResCSPB, "rescspc": L.ResCSPC,
    "resx": L.ResX, "resxcspa": L.ResXCSPA, "resxcspb": L.ResXCSPB,
    "resxcspc": L.ResXCSPC,
    "mp": L.MP, "sp": L.SP, "reorg": L.ReOrg, "implicita": L.ImplicitA,
    "implicitm": L.ImplicitM,
}
_HEAD_CLASSES = {"detect": H.Detect, "idetect": H.IDetect,
                 "iauxdetect": H.IAuxDetect}
# the ROADMAP queue 1 item of each module the port does not compile: the
# zoo blocks no shipped cfg uses (16 (c)), those of the JAX package's
# models/extra.py and models/attention.py (16 (d)), the other heads (15)
_ITEMS = {
    "16 (c)": ("conv2d", "dwconv", "ghostconv", "sppf", "focus", "ghost",
               "ghostcspa", "ghostcspb", "ghostcspc", "chuncat", "foldcut",
               "batchnorm2d", "contract", "expand"),
    "16 (d)": ("ghostsppcspc", "ghoststem", "robustconv", "robustconv2",
               "crossconv", "mixconv2d", "repconv_orepa", "classify", "frelu",
               "sum", "swintransformerblock", "swintransformer2block", "stcspa",
               "stcspb", "stcspc", "st2cspa", "st2cspb", "st2cspc",
               "transformerblock"),
    "15": ("ibin", "ikeypoint"),
}
_NAME_ITEM = {name: item for item, names in _ITEMS.items() for name in names}


def roadmap_item(module: str) -> Optional[str]:
    """The ROADMAP queue 1 item that ports a module of the reference DSL
    (its reference or canonical name), None for a name no package knows."""
    return _NAME_ITEM.get(_norm_module(module))


def _not_ported(m: str, i: int) -> NotImplementedError:
    item = roadmap_item(m)
    where = (f"ROADMAP queue 1, item {item}" if item is not None
             else "no ROADMAP item: neither package knows it")
    return NotImplementedError(f"module {m!r} (layer {i}) is not ported yet: {where}")


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
            head = _HEAD_CLASSES[name](
                nc=args[0] if args else nc_,
                anchors=tuple(tuple(r.reshape(-1).tolist()) for r in anc_norm),
                ch=head_ch, strides=lead_strides)
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
        elif name == "shortcut":
            block = L.Shortcut(tuple(ch_at(x) for x in f))
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
