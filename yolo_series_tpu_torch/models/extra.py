"""The long-tail block zoo (counterpart of `yolo_series_tpu/models/extra.py`):
robust, cross and mixed convs, the weighted Sum, the Ghost variants of
SPPCSPC and Stem, the classification head, FReLU, and the OREPA
re-parameterization family.

Reference: RobustConv / RobustConv2 (common.py:114-144), CrossConv / Sum /
MixConv2d (experimental.py:10-66), GhostSPPCSPC (common.py:282-293),
GhostStem (common.py:296-304), OREPA_3x3_RepConv's six-branch weight
generator (common.py:1072-1222), RepConv_OREPA (common.py:1224-1360),
Classify (common.py:1015-1025), FReLU (utils/activations.py).

Weight layouts. Conv weights named `w` are OIHW, as everywhere in the
port (`models/convert` permutes them from the JAX package's HWIO).
OREPA3x3's seven 4-D branch leaves (`origin`, `avg_conv`, `pfir_conv`,
`kxk_1x1`, `kxk_kxk`, `dw`, `pw`) are not named `w`: they stay in the
JAX package's HWIO layout, `weight_gen` composes the kernel in HWIO as
the JAX package does, and only the generated kernel is permuted to OIHW
(so `from_jax_tree` / `to_jax_tree` carry those leaves unchanged).
RobustConv2's transposed-conv weight `deconv.w` is a 4-D `w`, so it is
the permuted JAX leaf: (c2, c1, s, s) holding the JAX package's
spatially mirrored kernel (`jax.lax.conv_transpose` correlates the
dilated input), which `apply` mirrors back for `F.conv_transpose2d`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from yolo_series_tpu_torch.models.layers import (
    SPPCSPC, Block, Composite, ConvBnAct, GhostConv, Stem, _leaky, autopad, batch_norm,
    bn_init, conv2d, conv_bias_init, conv_kernel_init, get_activation,
)


def _hwio(w):
    """An OIHW kernel -> HWIO (OREPA's branch leaves)."""
    return w.permute(2, 3, 1, 0).contiguous()


@dataclasses.dataclass(frozen=True)
class RobustConv(Composite):
    """A large-kernel depthwise ConvBnAct, a 1x1 conv with bias, and a
    per-channel layer scale `gamma` (common.py:114-128)."""

    c1: int
    c2: int
    k: int = 7
    s: int = 1
    p: Optional[int] = None
    g: int = 1
    act: Any = True
    layer_scale: float = 1e-6

    @property
    def cout(self):
        return self.c2

    @property
    def stride_factor(self):
        return float(self.s)

    def children(self):
        return {"conv_dw": ConvBnAct(self.c1, self.c1, self.k, self.s, self.p, self.c1,
                                     self.act)}

    def init(self, gen):
        params, state = Composite.init(self, gen)
        params["conv1x1"] = {"w": conv_kernel_init(gen, 1, 1, self.c1, self.c2),
                             "b": conv_bias_init(gen, self.c2, self.c1)}
        if self.layer_scale > 0:
            params["gamma"] = torch.full((self.c2,), self.layer_scale)
        return params, state

    def apply(self, params, state, x, ctx):
        call, new_state = self._call(params, state, ctx)
        y = call("conv_dw", x)
        y = conv2d(y, params["conv1x1"]["w"], params["conv1x1"]["b"], 1, 0, 1, ctx.dtype)
        if "gamma" in params:
            y = y * params["gamma"].to(y.dtype)[:, None, None]
        return y, new_state


@dataclasses.dataclass(frozen=True)
class RobustConv2(Composite):
    """A strided depthwise ConvBnAct, then an s x s / stride-s transposed
    conv back up, and the layer scale (common.py:131-144)."""

    c1: int
    c2: int
    k: int = 7
    s: int = 4
    p: Optional[int] = None
    g: int = 1
    act: Any = True
    layer_scale: float = 1e-6

    @property
    def cout(self):
        return self.c2

    # the strided conv downsamples by s, the transposed conv upsamples by s
    stride_factor = 1.0

    def children(self):
        return {"conv_strided": ConvBnAct(self.c1, self.c1, self.k, self.s, self.p,
                                          self.c1, self.act)}

    def init(self, gen):
        params, state = Composite.init(self, gen)
        bound = 1.0 / math.sqrt(self.c1 * self.s * self.s)
        params["deconv"] = {
            "w": (torch.rand((self.c2, self.c1, self.s, self.s), generator=gen) * 2 - 1) * bound,
            "b": (torch.rand((self.c2,), generator=gen) * 2 - 1) * bound}
        if self.layer_scale > 0:
            params["gamma"] = torch.full((self.c2,), self.layer_scale)
        return params, state

    def apply(self, params, state, x, ctx):
        call, new_state = self._call(params, state, ctx)
        y = call("conv_strided", x)
        # (c2, c1, s, s) mirrored -> ConvTranspose2d's (c1, c2, s, s)
        w = params["deconv"]["w"].flip(2, 3).transpose(0, 1).to(ctx.dtype)
        y = F.conv_transpose2d(y.to(ctx.dtype), w, params["deconv"]["b"].to(ctx.dtype),
                               stride=self.s)
        if "gamma" in params:
            y = y * params["gamma"].to(y.dtype)[:, None, None]
        return y, new_state


@dataclasses.dataclass(frozen=True)
class CrossConv(Composite):
    """A (1, k) then a (k, 1) ConvBnAct, the stride factored the same way,
    plus x when shortcut and c1 == c2 (experimental.py:10-22)."""

    c1: int
    c2: int
    k: int = 3
    s: int = 1
    g: int = 1
    e: float = 1.0
    shortcut: bool = False

    @property
    def cout(self):
        return self.c2

    @property
    def stride_factor(self):
        return float(self.s)

    def children(self):
        c_ = int(self.c2 * self.e)
        return {
            "cv1": ConvBnAct(self.c1, c_, (1, self.k), (1, self.s)),
            "cv2": ConvBnAct(c_, self.c2, (self.k, 1), (self.s, 1), None, self.g),
        }

    def apply(self, params, state, x, ctx):
        call, new_state = self._call(params, state, ctx)
        y = call("cv2", call("cv1", x))
        if self.shortcut and self.c1 == self.c2:
            y = x + y
        return y, new_state


@dataclasses.dataclass(frozen=True)
class Sum(Block):
    """The sum of n inputs, with weight=True weighted by 2 sigmoid(w) from
    the second on (experimental.py:25-44)."""

    cins: Tuple[int, ...]
    weight: bool = False

    @property
    def cout(self):
        return self.cins[0]

    def init(self, gen):
        if self.weight:
            return {"w": -torch.arange(1.0, len(self.cins)) / 2.0}, {}
        return {}, {}

    def apply(self, params, state, xs, ctx):
        y = xs[0]
        if self.weight:
            w = torch.sigmoid(params["w"]) * 2.0
            for i, xi in enumerate(xs[1:]):
                y = y + xi * w[i].to(xi.dtype)
        else:
            for xi in xs[1:]:
                y = y + xi
        return y, state


@dataclasses.dataclass(frozen=True)
class MixConv2d(Block):
    """Convs of mixed kernels over channel groups, BN, LeakyReLU(0.1) and
    the residual (experimental.py:47-66). The groups' widths follow the
    JAX package's `np.linspace` split."""

    c1: int
    c2: int
    k: Tuple[int, ...] = (1, 3)
    s: int = 1
    equal_ch: bool = True

    @property
    def cout(self):
        return self.c2

    @property
    def stride_factor(self):
        return float(self.s)

    def _splits(self):
        groups = len(self.k)
        idx = np.floor(np.linspace(0, groups - 1e-6, self.c2)).astype(int)
        return [int((idx == g).sum()) for g in range(groups)]

    def init(self, gen):
        params = {f"m{i}": {"w": conv_kernel_init(gen, k, k, self.c1, c_)}
                  for i, (k, c_) in enumerate(zip(self.k, self._splits()))}
        params["bn"], bns = bn_init(self.c2)
        return params, {"bn": bns}

    def apply(self, params, state, x, ctx):
        y = torch.cat([conv2d(x, params[f"m{i}"]["w"], None, self.s, k // 2, 1, ctx.dtype)
                       for i, k in enumerate(self.k)], dim=1)
        y, bns = batch_norm(params["bn"], state["bn"], y, ctx)
        return x + _leaky(0.1)(y), {"bn": bns}


class GhostSPPCSPC(SPPCSPC):
    """SPPCSPC with GhostConv stages (common.py:282-293)."""

    def children(self):
        c_ = int(2 * self.c2 * self.e)
        return {
            "cv1": GhostConv(self.c1, c_, 1, 1),
            "cv2": GhostConv(self.c1, c_, 1, 1),
            "cv3": GhostConv(c_, c_, 3, 1),
            "cv4": GhostConv(c_, c_, 1, 1),
            "cv5": GhostConv(4 * c_, c_, 1, 1),
            "cv6": GhostConv(c_, c_, 3, 1),
            "cv7": GhostConv(2 * c_, self.c2, 1, 1),
        }


class GhostStem(Stem):
    """Stem with GhostConv stages (common.py:296-304)."""

    def children(self):
        c_ = int(self.c2 / 2)
        return {
            "cv1": GhostConv(self.c1, c_, 3, 2),
            "cv2": GhostConv(c_, c_, 1, 1),
            "cv3": GhostConv(c_, c_, 3, 2),
            "cv4": GhostConv(2 * c_, self.c2, 1, 1),
        }


# ------------------------------------------------------------ OREPA ---


def _fre_prior(out_channels: int, k: int = 3) -> np.ndarray:
    """The fixed frequency prior (reference fre_init, common.py:1160-1171)."""
    t = np.zeros((out_channels, k, k), np.float32)
    half = out_channels / 2
    for i in range(out_channels):
        for h in range(k):
            for w in range(k):
                if i < half:
                    t[i, h, w] = math.cos(math.pi * (h + 0.5) * (i + 1) / 3)
                else:
                    t[i, h, w] = math.cos(math.pi * (w + 0.5) * (i + 1 - half) / 3)
    return t


@dataclasses.dataclass(frozen=True)
class OREPA3x3(Block):
    """OREPA 3x3 conv: the kernel is generated at each call as a
    `vector`-gated sum of five branches (origin, average, frequency
    prior, 1x1-kxk, depthwise-separable), then one conv and BN (reference
    OREPA_3x3_RepConv.weight_gen, common.py:1173-1222). `deploy` folds
    the generated kernel and BN into one {w, b} conv.

    The branch leaves keep the JAX package's HWIO layout (module
    docstring). `vector` has the reference's row count, the phantom
    identity row included (c1 == c2 and s == 1): `weight_gen` never reads
    it, as in the reference and the JAX package."""

    c1: int
    c2: int
    k: int = 3
    s: int = 1
    g: int = 1
    act: Any = None
    expand: int = 8

    @property
    def cout(self):
        return self.c2

    @property
    def stride_factor(self):
        return float(self.s)

    @property
    def has_identity(self):
        return self.c1 == self.c2 and self.s == 1

    def init(self, gen):
        cig = self.c1 // self.g
        k = self.k
        n_branch = 5 + (1 if self.has_identity else 0)
        vec = [0.25, 0.25, 0.0, 0.5, 0.5] + [0.0] * (n_branch - 5)
        # kxk_1x1 is the effective internal matrix (the reference's zero
        # deviation plus its identity buffer), identity at init
        eye = torch.zeros((1, 1, cig, self.c1))
        for t in range(self.c1):
            eye[0, 0, t % cig, t] = 1.0
        params = {
            "origin": _hwio(conv_kernel_init(gen, k, k, cig, self.c2)),
            "avg_conv": _hwio(conv_kernel_init(gen, 1, 1, cig, self.c2)),
            "pfir_conv": _hwio(conv_kernel_init(gen, 1, 1, cig, self.c2)),
            "kxk_1x1": eye,
            "kxk_kxk": _hwio(conv_kernel_init(gen, k, k, cig, self.c2)),
            "dw": _hwio(conv_kernel_init(gen, k, k, 1, self.c1 * self.expand)),
            "pw": _hwio(conv_kernel_init(gen, 1, 1, self.c1 * self.expand, self.c2)),
            "vector": torch.tensor(vec)[:, None].repeat(1, self.c2),
        }
        params["bn"], bns = bn_init(self.c2)
        return params, {"bn": bns}

    def weight_gen(self, params):
        """The effective kernel, OIHW (composed in HWIO, the JAX package's
        order of operations, then permuted)."""
        k = self.k
        v = params["vector"]
        w = params["origin"] * v[0]
        w = w + params["avg_conv"] * (1.0 / (k * k)) * v[1]
        prior = torch.from_numpy(_fre_prior(self.c2, k).transpose(1, 2, 0)).to(w.device)
        w = w + params["pfir_conv"] * prior[:, :, None, :] * v[2]
        w_kxk = torch.einsum("ab,hwbo->hwao", params["kxk_1x1"][0, 0], params["kxk_kxk"])
        w = w + w_kxk * v[3]
        dw = params["dw"].reshape(k, k, self.c1, self.expand)
        pw = dw_pw_reshape(params["pw"], self.c1, self.expand)
        w = w + torch.einsum("hwce,ceo->hwco", dw, pw) * v[4]
        return w.permute(3, 2, 0, 1)

    def apply(self, params, state, x, ctx):
        _, fn = get_activation(self.act if self.act is not None else False)
        if "w" in params:   # deployed
            return fn(conv2d(x, params["w"], params["b"], self.s, self.k // 2, self.g,
                             ctx.dtype)), state
        y = conv2d(x, self.weight_gen(params), None, self.s, self.k // 2, self.g, ctx.dtype)
        y, bns = batch_norm(params["bn"], state["bn"], y, ctx)
        return fn(y), {"bn": bns}

    def deploy(self, params, state):
        from yolo_series_tpu_torch.models.reparam import fuse_conv_bn

        w, b = fuse_conv_bn(self.weight_gen(params), params["bn"], state["bn"])
        return {"w": w, "b": b}, {}


def dw_pw_reshape(pw, c1, expand):
    """(1, 1, C*E, O) HWIO pointwise kernel -> its (C, E, O) grouped view, for
    composing with the depthwise branch."""
    return pw[0, 0].reshape(c1, expand, pw.shape[-1])


@dataclasses.dataclass(frozen=True)
class RepConvOREPA(Composite):
    """RepConv with an OREPA 3x3 branch, a 1x1 conv + BN branch and the
    identity BN (reference RepConv_OREPA, common.py:1224-1360); `deploy`
    collapses them into one 3x3 {w, b} conv (switch_to_deploy,
    common.py:1323-1345), as the JAX package's `reparam.fuse_model` calls
    it."""

    c1: int
    c2: int
    k: int = 3
    s: int = 1
    p: Optional[int] = None
    g: int = 1
    act: Any = True

    @property
    def cout(self):
        return self.c2

    @property
    def stride_factor(self):
        return float(self.s)

    @property
    def has_identity(self):
        return self.c1 == self.c2 and self.s == 1

    def children(self):
        return {"rbr_dense": OREPA3x3(self.c1, self.c2, 3, self.s, self.g)}

    def init(self, gen):
        params, state = Composite.init(self, gen)
        bnp, bns = bn_init(self.c2)
        params["rbr_1x1"] = {"w": conv_kernel_init(gen, 1, 1, self.c1 // self.g, self.c2),
                             "bn": bnp}
        state["rbr_1x1"] = {"bn": bns}
        if self.has_identity:
            params["idbn"], state["idbn"] = bn_init(self.c1)
        return params, state

    def apply(self, params, state, x, ctx):
        _, fn = get_activation(self.act)
        if "w" in params:   # deployed: one conv
            return fn(conv2d(x, params["w"], params["b"], self.s, 1, self.g, ctx.dtype)), state
        new_state = dict(state)
        y, new_state["rbr_dense"] = self.children()["rbr_dense"].apply(
            params["rbr_dense"], state["rbr_dense"], x, ctx)
        y1 = conv2d(x, params["rbr_1x1"]["w"], None, self.s, 0, self.g, ctx.dtype)
        y1, bns = batch_norm(params["rbr_1x1"]["bn"], state["rbr_1x1"]["bn"], y1, ctx)
        new_state["rbr_1x1"] = {"bn": bns}
        y = y + y1
        if self.has_identity:
            yid, new_state["idbn"] = batch_norm(params["idbn"], state["idbn"],
                                                x.to(y.dtype), ctx)
            y = y + yid
        return fn(y), new_state

    def deploy(self, params, state):
        from yolo_series_tpu_torch.models.reparam import _bn_as_conv, fuse_conv_bn

        dp, _ = self.children()["rbr_dense"].deploy(params["rbr_dense"], state["rbr_dense"])
        w1, b1 = fuse_conv_bn(params["rbr_1x1"]["w"], params["rbr_1x1"]["bn"],
                              state["rbr_1x1"]["bn"])
        w, b = dp["w"] + F.pad(w1, (1, 1, 1, 1)), dp["b"] + b1
        if self.has_identity:
            wi, bi = _bn_as_conv(self.c1, self.g, params["idbn"], state["idbn"])
            w, b = w + wi, b + bi
        return {"w": w, "b": b}, {}


@dataclasses.dataclass(frozen=True)
class Classify(Composite):
    """Classification head: global average pool to 1 x 1 (of each input,
    concatenated), a conv with bias, flattened to (B, c2) (reference
    common.py:1015-1025)."""

    c1: int
    c2: int
    k: int = 1
    s: int = 1
    p: Optional[int] = None
    g: int = 1

    @property
    def cout(self):
        return self.c2

    def children(self):
        return {}

    def init(self, gen):
        fan_in = (self.c1 // self.g) * self.k * self.k
        return {"w": conv_kernel_init(gen, self.k, self.k, self.c1 // self.g, self.c2),
                "b": conv_bias_init(gen, self.c2, fan_in)}, {}

    def apply(self, params, state, x, ctx):
        xs = x if isinstance(x, (list, tuple)) else [x]
        y = torch.cat([xi.mean((2, 3), keepdim=True) for xi in xs], dim=1)
        y = conv2d(y, params["w"], params["b"], self.s, autopad(self.k, self.p), self.g,
                   ctx.dtype)
        return y.reshape(y.shape[0], -1), state


@dataclasses.dataclass(frozen=True)
class FReLU(Block):
    """Funnel activation: max(x, BN(depthwise k x k conv of x)) (reference
    utils/activations.py FReLU)."""

    c1: int
    k: int = 3

    @property
    def cout(self):
        return self.c1

    def init(self, gen):
        params, state = {"w": conv_kernel_init(gen, self.k, self.k, 1, self.c1)}, {}
        params["bn"], state["bn"] = bn_init(self.c1)
        return params, state

    def apply(self, params, state, x, ctx):
        y = conv2d(x, params["w"], None, 1, self.k // 2, self.c1, ctx.dtype)
        y, bns = batch_norm(params["bn"], state["bn"], y, ctx)
        return torch.maximum(x, y), {"bn": bns}
