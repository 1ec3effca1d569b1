"""Plain fp32 reference of the YOLOv7 family's layers, built from a cfg
dict (a configuration file's "cfg_deploy" or "cfg_training") and a flat
state dict in the upstream checkpoint's layout (`model.{i}.<...>` keys,
upstream models/common.py and models/yolo.py).

Blocks: conv (Conv2d without bias, BatchNorm2d, SiLU), repconv (3x3 and
1x1 branches with their BNs, the identity BN where c1 == c2 and stride 1,
SiLU of the sum), sppcspc (cv1..cv7, max pools 5, 9, 13), downc (cv2 of
cv1 at stride 2 beside cv3 of a 2x2 max pool, concatenated), mp (2x2 max
pool), concat, shortcut (the sum of two inputs), upsample (nearest), reorg
(space to depth), detect and idetect (ImplicitA before, ImplicitM after
each level's 1x1 conv).

Nothing here reads the program under test: the weights are drawn from the
seed by this module, and the forward is torch.nn.functional in fp32 with
TF32 off (the caller's `fp32_exact`). BN runs as the state dict says:
`mode="eval"` uses the running statistics, `mode="train"` the batch's
(updating copies of the running statistics with momentum 0.03, as upstream
sets it); `mode="settle"` sets each BN's gain as it goes (`liven`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import torch
import torch.nn.functional as F

BN_EPS = 1e-3        # upstream initialize_weights: eps 1e-3, momentum 0.03
BN_MOMENTUM = 0.03
ACT_GAIN = 0.2       # a BN output's RMS after `liven`: SiLU's input
# the head's raw logits after `liven`: (std, mean) of the box, objectness
# and class channels; the objectness mean is set by bisection
HEAD = {"box": (0.5, 0.0), "obj": (2.0, None), "cls": (3.0, -4.0)}
CANDIDATES = 100     # anchors an image above conf_thres after `liven`


@contextlib.contextmanager
def fp32_exact():
    """fp32 convolutions and matmuls without TF32, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Net:
    """The layer list of a cfg dict with every layer's channels."""

    def __init__(self, cfg: dict, ch: int = 3):
        self.nc = int(cfg["nc"])
        self.anchors = [list(map(float, a)) for a in cfg["anchors"]]
        self.na = len(self.anchors[0]) // 2
        self.no = self.nc + 5
        self.layers: List[dict] = []
        chs: List[int] = []
        rows = list(cfg["backbone"]) + list(cfg["head"])
        for i, (frm, n, kind, args) in enumerate(rows):
            if n != 1:
                raise ValueError(f"layer {i}: repeats are not used by these cfgs")
            frms = list(frm) if isinstance(frm, list) else [frm]
            frms = [f if f >= 0 else i + f for f in frms]
            c_in = [ch if f < 0 else chs[f] for f in frms]
            c1 = c_in[0]
            if kind in ("conv", "repconv"):
                c2, k, s = args
            elif kind == "concat":
                c2, k, s = sum(c_in), 0, 1
            elif kind == "shortcut":
                if len(c_in) != 2 or c_in[0] != c_in[1]:
                    raise ValueError(f"layer {i}: shortcut of {c_in} channels")
                c2, k, s = c1, 0, 1
            elif kind == "downc":
                c2, k, s = args[0], 3, 2
                if c2 % 2:
                    raise ValueError(f"layer {i}: downc of {c2} channels, not even")
            elif kind in ("mp", "upsample"):
                c2, k, s = c1, 0, 1
            elif kind == "reorg":
                c2, k, s = 4 * c1, 0, 1
            elif kind == "sppcspc":
                c2, k, s = args[0], 0, 1
            elif kind in ("detect", "idetect"):
                c2, k, s = 0, 1, 1
            else:
                raise ValueError(f"layer {i}: block {kind} is not in the reference")
            self.layers.append({"i": i, "frm": frms, "kind": kind, "c1": c1,
                                "c_in": c_in, "c2": c2, "k": k, "s": s})
            chs.append(c2)
        self.head = self.layers[-1]
        self.nl = len(self.head["frm"])
        # the last layer that reads each layer's output
        self.last_use = {f: L["i"] for L in self.layers for f in L["frm"]}

    # -- the state dict's entries ------------------------------------------
    def entries(self):
        """[(key, shape, init)] of every tensor, in layer order; init is
        "w" (conv weight), "bn_w", "zero", "one", "ia", "im" or "n"."""
        out = []

        def conv(p, c1, c2, k):
            out.append((f"{p}.conv.weight", (c2, c1, k, k), "w"))
            bn(f"{p}.bn", c2)

        def bn(p, c):
            out.extend([(f"{p}.weight", (c,), "bn_w"), (f"{p}.bias", (c,), "zero"),
                    (f"{p}.running_mean", (c,), "zero"), (f"{p}.running_var", (c,), "one"),
                    (f"{p}.num_batches_tracked", (), "n")])

        for L in self.layers:
            p, c1, c2, k = f"model.{L['i']}", L["c1"], L["c2"], L["k"]
            if L["kind"] == "conv":
                conv(p, c1, c2, k)
            elif L["kind"] == "repconv":
                out.append((f"{p}.rbr_dense.0.weight", (c2, c1, k, k), "w"))
                bn(f"{p}.rbr_dense.1", c2)
                out.append((f"{p}.rbr_1x1.0.weight", (c2, c1, 1, 1), "w"))
                bn(f"{p}.rbr_1x1.1", c2)
                if c1 == c2 and L["s"] == 1:
                    bn(f"{p}.rbr_identity", c2)
            elif L["kind"] == "sppcspc":
                c_ = c2
                for name, a, b, kk in (("cv1", c1, c_, 1), ("cv2", c1, c_, 1),
                                       ("cv3", c_, c_, 3), ("cv4", c_, c_, 1),
                                       ("cv5", 4 * c_, c_, 1), ("cv6", c_, c_, 3),
                                       ("cv7", 2 * c_, c2, 1)):
                    conv(f"{p}.{name}", a, b, kk)
            elif L["kind"] == "downc":
                for name, a, b, kk in (("cv1", c1, c1, 1), ("cv2", c1, c2 // 2, k),
                                       ("cv3", c1, c2 // 2, 1)):
                    conv(f"{p}.{name}", a, b, kk)
            elif L["kind"] in ("detect", "idetect"):
                for j, c in enumerate(L["c_in"]):
                    if L["kind"] == "idetect":
                        out.append((f"{p}.ia.{j}.implicit", (1, c, 1, 1), "ia"))
                    out.append((f"{p}.m.{j}.weight", (self.na * self.no, c, 1, 1), "w"))
                    out.append((f"{p}.m.{j}.bias", (self.na * self.no,), "zero"))
                    if L["kind"] == "idetect":
                        out.append((f"{p}.im.{j}.implicit", (1, self.na * self.no, 1, 1),
                                    "im"))
        return out

    def draw(self, seed: int, device) -> Dict[str, torch.Tensor]:
        """A state dict from `seed`, made on `device` in one normal draw:
        conv weights N(0, 1 / fan_in), BN gains 1, biases and means 0,
        variances 1, ImplicitA N(0, 0.02), ImplicitM N(1, 0.02) (upstream
        yolo.py's inits). `liven` then sets the BNs and the head."""
        ent = self.entries()
        normal = [math.prod(s) for _, s, init in ent if init in ("w", "ia", "im")]
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        z = torch.randn(sum(normal), generator=gen, device=device)
        sd, off = {}, 0
        for key, shape, init in ent:
            if init in ("w", "ia", "im"):
                n = math.prod(shape)
                t = z[off:off + n].view(shape)
                off += n
                if init == "w":
                    t = t * (1.0 / math.sqrt(math.prod(shape[1:])))
                else:
                    t = t * 0.02 + (1.0 if init == "im" else 0.0)
            elif init == "n":
                t = torch.zeros((), dtype=torch.long, device=device)
            else:
                t = torch.full(shape, 1.0 if init in ("one", "bn_w") else 0.0, device=device)
            sd[key] = t.contiguous()
        return sd

    # -- the forward -------------------------------------------------------
    def forward(self, sd, x, mode="eval", cast=None, new_state=None):
        """x: (B, 3, H, W) fp32 in [0, 1]. Returns the head's raw maps, per
        level (B, na, ny, nx, no). mode: "eval", "train" or "settle" (module
        docstring); in "train", new_state (a dict) receives the updated
        running statistics under their keys. cast: a dtype (float8) that
        every conv's input, weight and output are rounded to, one scale a
        tensor, around the fp32 conv (the lower-precision control)."""
        run = _Run(sd, mode, cast, new_state)
        saved: Dict[int, torch.Tensor] = {}
        for L in self.layers:
            inp = [x if f < 0 else saved[f] for f in L["frm"]]
            if L["kind"] in ("detect", "idetect"):
                return run.head(L, inp, self)
            saved[L["i"]] = run.layer(L, inp)
            for f in [f for f in saved if self.last_use.get(f, -1) <= L["i"]]:
                del saved[f]
        raise ValueError("the cfg has no head")

    def strides(self, img: int, raws) -> List[float]:
        return [img / r.shape[2] for r in raws]


def _rounded(t: torch.Tensor, dtype) -> torch.Tensor:
    """t rounded to `dtype` with one scale for the tensor (its largest
    magnitude at the format's largest value), back in t's dtype; the
    gradient passes straight through."""
    s = t.detach().abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    q = (t.detach() / s).to(dtype).to(t.dtype) * s
    return t + (q - t).detach()


class _Run:
    def __init__(self, sd, mode, cast, new_state):
        self.sd, self.mode, self.cast, self.new_state = sd, mode, cast, new_state
        self.settle_rms = ACT_GAIN

    def bn(self, p, x):
        sd = self.sd
        if self.mode == "eval":
            return F.batch_norm(x, sd[f"{p}.running_mean"], sd[f"{p}.running_var"],
                                sd[f"{p}.weight"], sd[f"{p}.bias"], False, 0.0, BN_EPS)
        if self.mode == "settle":
            # the running statistics stay (0, 1): the BN scales its input by
            # its gain alone, set so that its output has RMS `settle_rms`
            rms = float(x.square().mean().sqrt())
            sd[f"{p}.weight"].fill_(self.settle_rms / max(rms, 1e-12) * math.sqrt(1.0 + BN_EPS))
            return F.batch_norm(x, sd[f"{p}.running_mean"], sd[f"{p}.running_var"],
                                sd[f"{p}.weight"], sd[f"{p}.bias"], False, 0.0, BN_EPS)
        rm = sd[f"{p}.running_mean"].detach().clone()
        rv = sd[f"{p}.running_var"].detach().clone()
        out = F.batch_norm(x, rm, rv, sd[f"{p}.weight"], sd[f"{p}.bias"], True,
                           BN_MOMENTUM, BN_EPS)
        if self.new_state is not None:
            self.new_state[f"{p}.running_mean"] = rm
            self.new_state[f"{p}.running_var"] = rv
        return out

    def conv2d(self, x, w, b=None, s=1, pad=0):
        if self.cast is None:
            return F.conv2d(x, w, b, s, pad)
        y = F.conv2d(_rounded(x, self.cast), _rounded(w, self.cast), b, s, pad)
        return _rounded(y, self.cast)

    def conv(self, p, x, k, s, act=True):
        y = self.bn(f"{p}.bn", self.conv2d(x, self.sd[f"{p}.conv.weight"], None, s, k // 2))
        return F.silu(y) if act else y

    def layer(self, L, inp):
        p, kind, x = f"model.{L['i']}", L["kind"], inp[0]
        if kind == "conv":
            return self.conv(p, x, L["k"], L["s"])
        if kind == "concat":
            return torch.cat(inp, 1)
        if kind == "shortcut":
            return inp[0] + inp[1]
        if kind == "mp":
            return F.max_pool2d(x, 2, 2)
        if kind == "upsample":
            return F.interpolate(x, scale_factor=2.0, mode="nearest")
        if kind == "reorg":
            return torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2], x[..., ::2, 1::2],
                              x[..., 1::2, 1::2]], 1)
        if kind == "repconv":
            sd, k, s = self.sd, L["k"], L["s"]
            self.settle_rms = ACT_GAIN / math.sqrt(3.0)
            y = self.bn(f"{p}.rbr_dense.1",
                        self.conv2d(x, sd[f"{p}.rbr_dense.0.weight"], None, s, k // 2))
            y = y + self.bn(f"{p}.rbr_1x1.1",
                            self.conv2d(x, sd[f"{p}.rbr_1x1.0.weight"], None, s, 0))
            if f"{p}.rbr_identity.weight" in sd:
                y = y + self.bn(f"{p}.rbr_identity", x)
            self.settle_rms = ACT_GAIN
            return F.silu(y)
        if kind == "sppcspc":
            x1 = self.conv(f"{p}.cv4", self.conv(f"{p}.cv3", self.conv(f"{p}.cv1", x, 1, 1),
                                                 3, 1), 1, 1)
            pools = [F.max_pool2d(x1, k, 1, k // 2) for k in (5, 9, 13)]
            y1 = self.conv(f"{p}.cv6", self.conv(f"{p}.cv5", torch.cat([x1] + pools, 1), 1, 1),
                           3, 1)
            y2 = self.conv(f"{p}.cv2", x, 1, 1)
            return self.conv(f"{p}.cv7", torch.cat([y1, y2], 1), 1, 1)
        if kind == "downc":
            s = L["s"]
            y1 = self.conv(f"{p}.cv2", self.conv(f"{p}.cv1", x, 1, 1), L["k"], s)
            y2 = self.conv(f"{p}.cv3", F.max_pool2d(x, s, s), 1, 1)
            return torch.cat([y1, y2], 1)
        raise ValueError(kind)

    def head(self, L, inp, net):
        p, sd, out = f"model.{L['i']}", self.sd, []
        for j, x in enumerate(inp):
            if L["kind"] == "idetect":
                x = x + sd[f"{p}.ia.{j}.implicit"]
            y = self.conv2d(x, sd[f"{p}.m.{j}.weight"], sd[f"{p}.m.{j}.bias"])
            if L["kind"] == "idetect":
                y = y * sd[f"{p}.im.{j}.implicit"]
            b, _, ny, nx = y.shape
            out.append(y.view(b, net.na, net.no, ny, nx).permute(0, 1, 3, 4, 2).contiguous())
        return out


def decode(net: Net, raws, img: int):
    """Raw maps -> every anchor's (boxes (B, A, 4) xyxy pixels, scores (B, A,
    nc) = objectness x class probability), upstream Detect's inference
    decode (yolo.py:55-57) and non_max_suppression's score (general.py)."""
    boxes, scores = [], []
    for j, r in enumerate(raws):
        b, na, ny, nx, no = r.shape
        stride = img / ny
        y = torch.sigmoid(r.double())
        gy, gx = torch.meshgrid(torch.arange(ny, device=r.device, dtype=torch.float64),
                                torch.arange(nx, device=r.device, dtype=torch.float64),
                                indexing="ij")
        grid = torch.stack([gx, gy], -1)
        anc = torch.tensor(net.anchors[j], dtype=torch.float64, device=r.device).view(na, 1, 1, 2)
        xy = (y[..., 0:2] * 2.0 - 0.5 + grid) * stride
        wh = (y[..., 2:4] * 2.0) ** 2 * anc
        xyxy = torch.cat([xy - wh / 2, xy + wh / 2], -1)
        boxes.append(xyxy.reshape(b, -1, 4))
        scores.append((y[..., 5:] * y[..., 4:5]).reshape(b, -1, net.nc))
    return torch.cat(boxes, 1), torch.cat(scores, 1)


@torch.no_grad()
def liven(net: Net, sd, frames: torch.Tensor, conf_thres: float = 0.25,
          candidates: int = CANDIDATES):
    """Make a drawn state dict detect (in place): a random init fades the
    activations through ~100 layers and its objectness prior passes no
    anchor. On `frames` (B, 3, H, W) fp32, layer by layer (a settling
    forward): every BN keeps running statistics (0, 1) and bias 0, and its
    gain is set so that its output has RMS ACT_GAIN (a repconv's three
    ACT_GAIN / sqrt(3)): SiLU then works near its linear range, and no BN
    subtracts a large mean, which would amplify rounding. Then the head's
    weights are scaled so that its box, objectness and class logits have
    HEAD's std and its biases HEAD's mean (moderate box sizes and one class
    ahead of the rest, as a trained head gives, where a random head gives
    boxes of a hundredth of a pixel and 80 near-tied classes), and one
    objectness bias is chosen, by bisection, with which about `candidates`
    anchors an image score above conf_thres."""
    with fp32_exact():
        raws = net.forward(sd, frames, mode="settle")
    p = f"model.{net.head['i']}"
    groups = {"box": slice(0, 4), "obj": slice(4, 5), "cls": slice(5, net.no)}
    for j, r in enumerate(raws):
        w = sd[f"{p}.m.{j}.weight"].view(net.na, net.no, -1)
        b = sd[f"{p}.m.{j}.bias"].view(net.na, net.no)
        for name, sl in groups.items():
            std, mean = HEAD[name]
            w[:, sl].mul_(std / float(r[..., sl].float().std()))
            b[:, sl] = 0.0 if mean is None else mean
    with fp32_exact():
        raws = net.forward(sd, frames, mode="eval")
    obj = torch.cat([r[..., 4].reshape(r.shape[0], -1) for r in raws], 1)
    cls = torch.cat([torch.sigmoid(r[..., 5:]).amax(-1).reshape(r.shape[0], -1)
                     for r in raws], 1)
    lo, hi = -30.0, 30.0
    for _ in range(40):
        mid = (lo + hi) / 2
        n = ((torch.sigmoid(obj + mid) * cls) > conf_thres).sum(1).float().mean()
        lo, hi = (lo, mid) if n > candidates else (mid, hi)
    for j in range(net.nl):
        sd[f"{p}.m.{j}.bias"].view(net.na, net.no)[:, 4] = lo
    return lo


def make_weights(cfg: dict, seed: int, device, frames: torch.Tensor,
                 conf_thres: float = 0.25):
    """(net, state dict) of `cfg` drawn from `seed` and livened on `frames`
    (B, H, W, 3) uint8 on `device`."""
    net = Net(cfg)
    sd = net.draw(seed, device)
    liven(net, sd, frames.permute(0, 3, 1, 2).float() / 255.0, conf_thres)
    return net, sd
