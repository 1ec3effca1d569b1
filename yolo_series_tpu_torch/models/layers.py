"""Deploy blocks of yolov7 (counterpart of `yolo_series_tpu/models/layers.py`).

Each block is a frozen dataclass of static config with `init(generator)`
-> (params, state) and `apply(params, state, x, ctx)` -> (y, state), the
same contract as the JAX blocks, so the JAX param trees map one to one
onto the port's (`models/convert.py`) and the plan rewrites of the deploy
transforms stay plain tree edits. Params are dicts of tensors; conv
weights are OIHW. Activations are NCHW tensors, kept in `channels_last`
memory by the model, so a permute gives kernels contiguous NHWC.

Every block of the JAX module is here: ConvBnAct (BN, fused {w, b} or
int8 {wq, sw, b[, sx]} form), PlainConv (detect-head convs and the
`nn.Conv2d` layer), DWConv, MP, SP, ReOrg, Focus, Contract / Expand,
Upsample, Concat, Chuncat, Shortcut, Foldcut, SPP, SPPF, SPPCSPC,
GhostConv, Ghost, RepConv, DownC, Stem, Bottleneck, Res (and ResX, a
grouped Res), the CSP wrappers BottleneckCSPA/B/C, ResCSPA/B/C,
ResXCSPA/B/C and GhostCSPA/B/C, the standalone BatchNorm2d, and the
implicit-knowledge layers ImplicitA / ImplicitM of IDetect and IAuxDetect,
with every activation of the JAX package's table. The blocks of the JAX
package's `models/extra.py` and `models/attention.py` are in the port's
modules of the same names.

The space-to-depth blocks (ReOrg, Focus, Contract) and Expand, Chuncat
and Foldcut order their channels as the JAX package's NHWC blocks do: a
block's output channel c here is channel c there.

In training (`Ctx.training`) BN normalizes with the batch's moments and
returns the new running stats, which every block hands back as its new
state; BN and the non-overlapping max pool have the JAX package's custom
gradients (`BnTrainCore`, `MaxPoolTiled`). Under a process group
(`Ctx.group`, the counterpart of `Ctx.axis_name`) BN is SyncBN: its moments
and its backward's sums are the global batch's (`torch.distributed`
all-reduces), so N ranks normalize as one process does on the whole batch.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from yolo_series_tpu_torch.parallel.dist import world_size

BN_EPS = 1e-3       # layers.BN_EPS of the JAX package
BN_MOMENTUM = 0.03  # layers.BN_MOMENTUM of the JAX package


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Per-forward context: the working dtype of the convs, and the int8
    calibration hook `observer(path, x)`, fired at every conv input with
    the conv's param path (set only while an observer is given).

    training: BN takes the batch's moments and updates its running stats.
    bn_shards > 1: per-replica BN, the global batch split into this many
    contiguous groups, each normalized with its own moments; the running
    stats follow group 0 (`_batch_norm_per_replica`).
    group: the `torch.distributed` process group whose ranks each hold an
    equal contiguous slice of the global batch (the JAX `axis_name`): BN's
    moments are synced over it (SyncBN), unless bn_shards > 1, and then
    each rank holds bn_shards / world of the groups."""

    dtype: torch.dtype = torch.float32
    observer: Any = None
    path: str = ""
    training: bool = False
    bn_shards: int = 1
    group: Any = None


class _LeakyReLU(torch.autograd.Function):
    """F.leaky_relu with JAX's gradient at 0 (`jax.nn.leaky_relu` is
    where(x >= 0, x, slope * x), so x = 0 takes slope 1; torch's takes
    the negative side's)."""

    @staticmethod
    def forward(ctx, x, slope):
        ctx.save_for_backward(x)
        ctx.slope = slope
        return F.leaky_relu(x, slope)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, g * ctx.slope), None


def _leaky(slope):
    return lambda x: _LeakyReLU.apply(x, slope)


ACTIVATIONS = {
    "silu": F.silu,
    "relu": F.relu,
    "relu6": F.relu6,
    "hardswish": F.hardswish,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
    "sigmoid": torch.sigmoid,
    "identity": lambda x: x,
}
# the reference's torch module names (lowercased) -> canonical names
_MODULE_NAMES = {"silu": "silu", "relu": "relu", "relu6": "relu6",
                 "hardswish": "hardswish", "mish": "mish", "identity": "identity"}


@functools.lru_cache(maxsize=None)
def _resolve(s: str) -> Tuple[str, Any]:
    if s.startswith("nn."):  # reference-format module string
        low = s[3:].split("(")[0].lower()
        if low in _MODULE_NAMES:
            return _MODULE_NAMES[low], ACTIVATIONS[_MODULE_NAMES[low]]
        if low == "leakyrelu":
            inner = s[s.index("(") + 1:s.rindex(")")]
            slope = float(inner) if inner else 0.01
            return f"leaky_relu:{slope}", _leaky(slope)
        raise ValueError(f"unsupported activation spec {s!r}")
    if s.startswith("leaky_relu"):
        slope = float(s.split(":")[1]) if ":" in s else 0.01
        return f"leaky_relu:{slope}", _leaky(slope)
    if s in ACTIVATIONS:
        return s, ACTIVATIONS[s]
    raise ValueError(f"unsupported activation spec {s!r}")


def get_activation(spec) -> Tuple[str, Any]:
    """Resolve an activation spec to (canonical_name, fn), as the JAX
    package's `get_activation` does: the canonical strings ('silu',
    'leaky_relu:0.1'; a bare 'leaky_relu' has slope 0.01), booleans (True
    -> silu, False/None -> identity: the reference Conv's `act=True`
    default) and the reference YAML's module strings ('nn.LeakyReLU(0.1)',
    'nn.SiLU()'). An unknown spec raises ValueError."""
    if spec is True:
        return "silu", ACTIVATIONS["silu"]
    if spec is False or spec is None:
        return "identity", ACTIVATIONS["identity"]
    return _resolve(str(spec).strip())


def autopad(k, p=None):
    """'same' padding for odd kernels (reference common.py:23)."""
    if p is not None:
        return p
    if isinstance(k, (tuple, list)):
        return tuple(x // 2 for x in k)
    return k // 2


def _pair(k):
    return (k, k) if isinstance(k, int) else tuple(k)


def conv_kernel_init(gen: torch.Generator, kh, kw, cin_per_group, cout):
    """torch kaiming_uniform(a=sqrt(5)) == U(+-1/sqrt(fan_in)); OIHW."""
    bound = 1.0 / math.sqrt(cin_per_group * kh * kw)
    u = torch.rand((cout, cin_per_group, kh, kw), generator=gen)
    return (u * 2.0 - 1.0) * bound


def conv_bias_init(gen: torch.Generator, cout, fan_in):
    bound = 1.0 / math.sqrt(fan_in)
    return (torch.rand((cout,), generator=gen) * 2.0 - 1.0) * bound


def bn_init(c):
    params = {"scale": torch.ones(c), "bias": torch.zeros(c)}
    state = {"mean": torch.zeros(c), "var": torch.ones(c)}
    return params, state


def _c(v):
    """(C,) -> (C, 1, 1), to broadcast over NCHW channels."""
    return v[:, None, None]


_AXES = (0, 2, 3)   # the N, H, W axes of NCHW


def _pmean(t, group):
    """The mean of t over the group's ranks (their slices are equally
    large, so the mean of their means is the global batch's): t itself
    with no group, and t bit for bit at world 1."""
    if group is None:
        return t
    t = t.contiguous()
    dist.all_reduce(t, group=group)
    return t / world_size(group)


def _bn_train_moments(x, m0, group=None):
    """Training batch moments of NCHW x in fp32 (`_bn_train_moments` of the
    JAX package): the shifted one-pass form, centred on the running mean m0,
    for C >= 64, the two-pass form below. The two round differently, so the
    port takes the JAX package's form at each C. Under a group the moments
    are the global batch's: the one-pass form's (mc, msq) averaged over the
    ranks in one all-reduce; the two-pass form's mean, then the variance
    about that global mean, in two."""
    xf = x.float()
    if x.shape[1] >= 64:
        xc = xf - _c(m0)
        mc, msq = _pmean(torch.stack([xc.mean(_AXES), xc.square().mean(_AXES)]), group)
        return m0 + mc, torch.clamp(msq - mc.square(), min=0.0)
    mean = _pmean(xf.mean(_AXES), group)
    return mean, _pmean((xf - _c(mean)).square().mean(_AXES), group)


class BnTrainCore(torch.autograd.Function):
    """Training-mode BN (moments, normalize, affine) with the JAX package's
    custom gradient (`_bn_train_core`, layers.py:183-239): it saves only
    (x, mean, var, scale), x in its own dtype, and its backward recomputes
    x-hat, the classic BN training backward, plus the exact cotangents of
    the mean and var outputs (zero in the train step, where they only feed
    the running stats). Returns (y in x's dtype, mean, var).

    Under a process group (SyncBN) the moments are the global batch's, and
    the backward all-reduces its channel sums (sg, sgx), with the mean's
    and var's cotangents when they are given, in one collective and
    divides by the global n, as the JAX `_bn_train_core_bwd` does with
    `axis_name`. It returns this rank's own sums as the scale and bias
    grads, though: the train step sums the ranks' grads once more, where
    under pjit JAX has no second reduction."""

    @staticmethod
    def forward(ctx, x, scale, bias, m0, group=None):
        mean, var = _bn_train_moments(x, m0, group)
        ctx.group = group
        inv = torch.rsqrt(var + BN_EPS) * scale
        y = (x.float() - _c(mean)) * _c(inv) + _c(bias)
        ctx.save_for_backward(x, mean, var, scale)
        # an unused output's cotangent arrives as None, not as a tensor of
        # zeros, so the train step (mean and var unused) pays no pass for it
        ctx.set_materialize_grads(False)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy, gm, gv):
        x, mean, var, scale = ctx.saved_tensors
        xf = x.float()
        inv = torch.rsqrt(var + BN_EPS)
        xc = xf - _c(mean)
        xhat = xc * _c(inv)
        gyf = torch.zeros_like(xf) if gy is None else gy.float()
        sg = gyf.sum(_AXES)
        sgx = (gyf * xhat).sum(_AXES)
        n = x.shape[0] * x.shape[2] * x.shape[3]
        dscale, dbias = sgx, sg
        if ctx.group is not None:
            # the mean and var are the global batch's: every rank's
            # cotangents of them reach every rank's x, like the sums
            cots = [g for g in (gm, gv) if g is not None]
            sums = torch.stack([sg, sgx, *(g.float() for g in cots)])
            dist.all_reduce(sums, group=ctx.group)
            sg, sgx = sums[0], sums[1]
            if gm is not None:
                gm = sums[2]
            if gv is not None:
                gv = sums[-1]
            n = n * world_size(ctx.group)
        dx = _c(scale * inv) * (gyf - _c(sg / n) - xhat * _c(sgx / n))
        if gm is not None:
            dx = dx + _c(gm / n)
        if gv is not None:
            dx = dx + _c(gv * (2.0 / n)) * xc
        return dx.to(x.dtype), dscale, dbias, None, None


def _running(bn_state, mean, var, n):
    """The running stats after one batch of n values a channel: momentum
    BN_MOMENTUM, the unbiased variance."""
    unbiased = var.detach() * (n / max(n - 1, 1))
    m = BN_MOMENTUM
    return {"mean": (1 - m) * bn_state["mean"] + m * mean.detach(),
            "var": (1 - m) * bn_state["var"] + m * unbiased}


def batch_norm(bn_params, bn_state, x, ctx: Optional[Ctx] = None):
    """BatchNorm over NCHW channels in fp32 -> (y in x's dtype, new state).
    In inference the running stats, unchanged; in training the batch's
    moments and the updated running stats (`layers.batch_norm` of the JAX
    package). Under `ctx.group`, SyncBN: the moments and the running stats'
    n are the global batch's; with bn_shards > 1 as well, this rank
    normalizes its bn_shards / world groups alone."""
    scale, bias = bn_params["scale"], bn_params["bias"]
    if ctx is not None and ctx.training:
        world = world_size(ctx.group)
        if ctx.bn_shards > 1:
            if ctx.bn_shards % world:
                raise ValueError(f"{ctx.bn_shards} BN groups do not split over {world} ranks")
            return _batch_norm_per_replica(bn_params, bn_state, x, ctx.bn_shards // world)
        y, mean, var = BnTrainCore.apply(x, scale, bias, bn_state["mean"].detach(), ctx.group)
        n = x.shape[0] * x.shape[2] * x.shape[3] * world
        return y, _running(bn_state, mean, var, n)
    inv = torch.rsqrt(bn_state["var"] + BN_EPS) * scale
    y = (x.float() - _c(bn_state["mean"])) * _c(inv) + _c(bias)
    return y.to(x.dtype), bn_state


def _batch_norm_per_replica(bn_params, bn_state, x, g):
    """Per-replica (unsynced) BN (`_batch_norm_per_replica` of the JAX
    package): the batch splits into g contiguous groups, each normalized
    with its own two-pass moments, through plain autograd; the running
    stats follow group 0."""
    b = x.shape[0]
    if b % g:
        raise ValueError(f"batch {b} does not split into {g} BN groups")
    xf = x.float().reshape(g, b // g, *x.shape[1:])
    axes = (1, 3, 4)
    mean = xf.mean(axes)                                     # (g, C)
    var = (xf - mean[:, None, :, None, None]).square().mean(axes)
    new_state = _running(bn_state, mean[0], var[0], (b // g) * x.shape[2] * x.shape[3])
    inv = torch.rsqrt(var + BN_EPS) * bn_params["scale"]     # (g, C)
    y = (xf - mean[:, None, :, None, None]) * inv[:, None, :, None, None] \
        + _c(bn_params["bias"])
    return y.reshape(x.shape).to(x.dtype), new_state


def conv2d(x, w, b=None, stride=1, padding=0, groups=1, dtype=None):
    """NCHW x OIHW convolution in `dtype` (x's dtype when None). padding:
    int, symmetric (ph, pw), or ((top, bottom), (left, right))."""
    dtype = dtype or x.dtype
    if (isinstance(padding, (tuple, list)) and padding
            and isinstance(padding[0], (tuple, list))):
        (pt, pb), (pl, pr) = padding
        if pt == pb and pl == pr:
            padding = (pt, pl)
        else:
            x = F.pad(x, (pl, pr, pt, pb))
            padding = 0
    return F.conv2d(x.to(dtype), w.to(dtype),
                    None if b is None else b.to(dtype),
                    _pair(stride), padding, 1, groups)


class MaxPoolTiled(torch.autograd.Function):
    """Non-overlapping k x k / stride-k max pool with the JAX package's
    gradient (`_max_pool_tiled`, layers.py:317-349): each input belongs to
    one window, and a window's gradient is split equally among the inputs
    that tie for its max (torch's max_pool2d routes it to one of them)."""

    @staticmethod
    def forward(ctx, x, k):
        m = F.max_pool2d(x, k, k)
        ctx.save_for_backward(x, m)
        ctx.k = k
        return m

    @staticmethod
    def backward(ctx, g):
        x, m = ctx.saved_tensors
        k = ctx.k
        n, c, ho, wo = m.shape
        xr = x.reshape(n, c, ho, k, wo, k)
        mask = xr == m[:, :, :, None, :, None]
        cnt = mask.sum((3, 5), keepdim=True)
        gr = torch.where(mask, g[:, :, :, None, :, None] / cnt, torch.zeros((), dtype=g.dtype,
                                                                             device=g.device))
        return gr.reshape(x.shape), None


def max_pool(x, k, s, padding):
    """Max pool with implicit -inf padding (torch semantics). The
    non-overlapping case takes `MaxPoolTiled` under the JAX package's
    condition (layers.py:352-357), so its gradient splits ties as JAX's."""
    if (s == k and padding == 0 and x.ndim == 4 and x.shape[2] % k == 0
            and x.shape[3] % k == 0 and x.is_floating_point()):
        return MaxPoolTiled.apply(x, k)
    return F.max_pool2d(x, k, s, padding)


def max_pool_pyramid(x, ks: Sequence[int]):
    """Stride-1 SAME max pools for increasing odd kernels, chained where
    possible: pooling a k1-pooled map with kernel kc gives the
    (k1 + kc - 1) pool exactly, so (5, 9, 13) costs three 5x5 pools
    (`max_pool_pyramid` of the JAX package, layers.py:367)."""
    outs = []
    prev, prev_k = x, 1
    for k in ks:
        kc = k - prev_k + 1
        if kc < 1 or kc % 2 == 0:  # non-chainable sequence: pool from x
            prev, prev_k = max_pool(x, k, 1, k // 2), k
        else:
            prev, prev_k = max_pool(prev, kc, 1, kc // 2), k
        outs.append(prev)
    return outs


class Block:
    """Base: subclasses are frozen dataclasses with static config.

    `cout` and `stride_factor` drive the graph compiler's channel and
    stride propagation."""

    cout: int
    stride_factor: float = 1.0

    def init(self, gen: torch.Generator):
        raise NotImplementedError

    def apply(self, params, state, x, ctx: Ctx):
        raise NotImplementedError


class Composite(Block):
    """Block made of named children; subclasses provide `children()`."""

    def children(self) -> Dict[str, Block]:
        raise NotImplementedError

    def init(self, gen):
        params, state = {}, {}
        for name, child in self.children().items():
            params[name], state[name] = child.init(gen)
        return params, state

    def _call(self, params, state, ctx):
        """(call, new_state): call(name, x) applies the child `name` and
        records its new state in new_state."""
        kids = self.children()
        new_state = dict(state)

        def call(name, x):
            c = (dataclasses.replace(ctx, path=f"{ctx.path}/{name}")
                 if ctx.observer is not None else ctx)
            y, new_state[name] = kids[name].apply(params[name], state[name], x, c)
            return y

        return call, new_state


def _int8_conv(params, x, stride, padding, groups):
    """The int8 deploy form ({wq, sw, b[, sx]}, `infer/quant.py`) on fp32."""
    from yolo_series_tpu_torch.infer.quant import int8_conv

    return int8_conv(x.float(), params["wq"], params["sw"], params["b"], stride,
                     padding, groups, params.get("sx"))


@dataclasses.dataclass(frozen=True)
class ConvBnAct(Block):
    """Conv + BN + act (reference Conv, common.py:99-111). After
    re-parameterization params hold a fused bias `b` instead of `bn`."""

    c1: int
    c2: int
    k: Any = 1
    s: Any = 1
    p: Optional[int] = None
    g: int = 1
    act: Any = True

    @property
    def cout(self):
        return self.c2

    @property
    def stride_factor(self):
        return float(self.s if isinstance(self.s, int) else max(self.s))

    def init(self, gen):
        kh, kw = _pair(self.k)
        w = conv_kernel_init(gen, kh, kw, self.c1 // self.g, self.c2)
        bnp, bns = bn_init(self.c2)
        return {"w": w, "bn": bnp}, {"bn": bns}

    def apply(self, params, state, x, ctx):
        _, fn = get_activation(self.act)
        pad = autopad(self.k, self.p)
        if ctx.observer is not None:
            ctx.observer(ctx.path, x)
        if "wq" in params:  # int8 deploy form (infer/quant.py)
            y = _int8_conv(params, x, self.s, pad, self.g)
            return fn(y).to(x.dtype), state
        if "bn" in params:
            y = conv2d(x, params["w"], None, self.s, pad, self.g, ctx.dtype)
            y, bns = batch_norm(params["bn"], state["bn"], y, ctx)
            return fn(y), {"bn": bns}
        # fused deploy form
        return fn(conv2d(x, params["w"], params["b"], self.s, pad, self.g,
                         ctx.dtype)), state


@dataclasses.dataclass(frozen=True)
class PlainConv(Block):
    """Bare nn.Conv2d with bias (the detect-head 1x1 convs)."""

    c1: int
    c2: int
    k: int = 1
    s: int = 1
    p: Optional[int] = None
    g: int = 1

    @property
    def cout(self):
        return self.c2

    @property
    def stride_factor(self):
        return float(self.s)

    def init(self, gen):
        fan_in = (self.c1 // self.g) * self.k * self.k
        return {"w": conv_kernel_init(gen, self.k, self.k, self.c1 // self.g,
                                      self.c2),
                "b": conv_bias_init(gen, self.c2, fan_in)}, {}

    def apply(self, params, state, x, ctx):
        pad = self.p if self.p is not None else 0
        if ctx.observer is not None:
            ctx.observer(ctx.path, x)
        if "wq" in params:
            return _int8_conv(params, x, self.s, pad, self.g).to(x.dtype), state
        return conv2d(x, params["w"], params["b"], self.s, pad, self.g,
                      ctx.dtype), state


def DWConv(c1, c2, k=1, s=1, act=True):
    """Depthwise conv (reference common.py:147): groups = gcd(c1, c2)."""
    return ConvBnAct(c1, c2, k, s, None, math.gcd(c1, c2), act)


@dataclasses.dataclass(frozen=True)
class MP(Block):
    """MaxPool k=s (reference common.py:30); default 2x2/2 downsample."""

    c1: int
    k: int = 2

    @property
    def cout(self):
        return self.c1

    @property
    def stride_factor(self):
        return float(self.k)

    def init(self, gen):
        return {}, {}

    def apply(self, params, state, x, ctx):
        return max_pool(x, self.k, self.k, 0), state


@dataclasses.dataclass(frozen=True)
class SP(Block):
    """Stride-1 same-padded max pool (reference common.py:39). In training
    its gradient goes to the first maximum of a tied window in both
    libraries."""

    c1: int
    k: int = 3
    s: int = 1

    @property
    def cout(self):
        return self.c1

    def init(self, gen):
        return {}, {}

    def apply(self, params, state, x, ctx):
        return max_pool(x, self.k, self.s, self.k // 2), state


@dataclasses.dataclass(frozen=True)
class ReOrg(Block):
    """Space-to-depth 2x (reference common.py:48): (B, C, H, W) -> (B, 4C,
    H/2, W/2), the channel blocks in the reference's slice order
    [::2, ::2], [1::2, ::2], [::2, 1::2], [1::2, 1::2] on (h, w)."""

    c1: int

    @property
    def cout(self):
        return self.c1 * 4

    stride_factor = 2.0

    def init(self, gen):
        return {}, {}

    def apply(self, params, state, x, ctx):
        return _space_to_depth(x), state


def _space_to_depth(x):
    """(B, C, H, W) -> (B, 4C, H/2, W/2): the slices at (row, column)
    offsets (0, 0), (1, 0), (0, 1), (1, 1), concatenated in that order."""
    y = torch.cat([x[:, :, ::2, ::2], x[:, :, 1::2, ::2], x[:, :, ::2, 1::2],
                   x[:, :, 1::2, 1::2]], dim=1)
    return y.contiguous(memory_format=torch.channels_last)


@dataclasses.dataclass(frozen=True)
class Focus(Block):
    """Space-to-depth, then a ConvBnAct on the 4 x c1 channels (reference
    common.py:796-806), with ReOrg's slice order. Its params are the
    conv's own ({w, bn}, fused {w, b}, int8 {wq, sw, b[, sx]})."""

    c1: int
    c2: int
    k: int = 1
    s: int = 1
    p: Optional[int] = None
    g: int = 1
    act: Any = True

    @property
    def cout(self):
        return self.c2

    stride_factor = 2.0

    def _conv(self):
        return ConvBnAct(self.c1 * 4, self.c2, self.k, self.s, self.p, self.g, self.act)

    def init(self, gen):
        return self._conv().init(gen)

    def apply(self, params, state, x, ctx):
        return self._conv().apply(params, state, _space_to_depth(x), ctx)


@dataclasses.dataclass(frozen=True)
class Contract(Block):
    """Space-to-depth by `gain` (reference common.py:824): input channel ci
    at offset (gh, gw) of its gain x gain cell becomes output channel
    (gh * gain + gw) * c + ci, the JAX package's NHWC order."""

    c1: int
    gain: int = 2

    @property
    def cout(self):
        return self.c1 * self.gain ** 2

    @property
    def stride_factor(self):
        return float(self.gain)

    def init(self, gen):
        return {}, {}

    def apply(self, params, state, x, ctx):
        b, c, h, w = x.shape
        g = self.gain
        y = x.reshape(b, c, h // g, g, w // g, g).permute(0, 3, 5, 1, 2, 4)
        y = y.reshape(b, g * g * c, h // g, w // g)
        return y.contiguous(memory_format=torch.channels_last), state


@dataclasses.dataclass(frozen=True)
class Expand(Block):
    """The inverse of Contract (reference common.py:837)."""

    c1: int
    gain: int = 2

    @property
    def cout(self):
        return self.c1 // self.gain ** 2

    @property
    def stride_factor(self):
        return 1.0 / self.gain

    def init(self, gen):
        return {}, {}

    def apply(self, params, state, x, ctx):
        b, c, h, w = x.shape
        g = self.gain
        y = x.reshape(b, g, g, c // (g * g), h, w).permute(0, 3, 4, 1, 5, 2)
        y = y.reshape(b, c // (g * g), h * g, w * g)
        return y.contiguous(memory_format=torch.channels_last), state


@dataclasses.dataclass(frozen=True)
class Upsample(Block):
    """nn.Upsample nearest, integer scale."""

    c1: int
    scale: int = 2

    @property
    def cout(self):
        return self.c1

    @property
    def stride_factor(self):
        return 1.0 / self.scale

    def init(self, gen):
        return {}, {}

    def apply(self, params, state, x, ctx):
        return F.interpolate(x, scale_factor=self.scale, mode="nearest"), state


@dataclasses.dataclass(frozen=True)
class Concat(Block):
    """Channel concat of the routed inputs (reference common.py:56)."""

    cins: Tuple[int, ...]

    @property
    def cout(self):
        return sum(self.cins)

    def init(self, gen):
        return {}, {}

    def apply(self, params, state, xs, ctx):
        return torch.cat(list(xs), dim=1), state


@dataclasses.dataclass(frozen=True)
class Chuncat(Block):
    """Each input split in half on channels, the first halves concatenated,
    then the second halves (reference common.py:64-77)."""

    cins: Tuple[int, ...]

    @property
    def cout(self):
        return sum(self.cins)

    def init(self, gen):
        return {}, {}

    def apply(self, params, state, xs, ctx):
        halves = [xi.shape[1] // 2 for xi in xs]
        firsts = [xi[:, :c] for xi, c in zip(xs, halves)]
        seconds = [xi[:, c:] for xi, c in zip(xs, halves)]
        return torch.cat(firsts + seconds, dim=1), state


@dataclasses.dataclass(frozen=True)
class Shortcut(Block):
    """Elementwise add of two routed inputs (reference common.py:80)."""

    cins: Tuple[int, ...]

    @property
    def cout(self):
        return self.cins[0]

    def init(self, gen):
        return {}, {}

    def apply(self, params, state, xs, ctx):
        return xs[0] + xs[1], state


@dataclasses.dataclass(frozen=True)
class Foldcut(Block):
    """The channels split in half and the halves added (reference
    common.py:89)."""

    c1: int

    @property
    def cout(self):
        return self.c1 // 2

    def init(self, gen):
        return {}, {}

    def apply(self, params, state, x, ctx):
        c = x.shape[1] // 2
        return x[:, :c] + x[:, c:], state


@dataclasses.dataclass(frozen=True)
class GhostConv(Composite):
    """Ghost convolution (reference common.py:152-162): cv1, then a 5 x 5
    depthwise cv2 of its output, concatenated."""

    c1: int
    c2: int
    k: int = 1
    s: int = 1
    g: int = 1
    act: Any = True

    @property
    def cout(self):
        return self.c2

    @property
    def stride_factor(self):
        return float(self.s)

    def children(self):
        c_ = self.c2 // 2
        return {
            "cv1": ConvBnAct(self.c1, c_, self.k, self.s, None, self.g, self.act),
            "cv2": ConvBnAct(c_, c_, 5, 1, None, c_, self.act),
        }

    def apply(self, params, state, x, ctx):
        call, new_state = self._call(params, state, ctx)
        y = call("cv1", x)
        return torch.cat([y, call("cv2", y)], dim=1), new_state


@dataclasses.dataclass(frozen=True)
class DownC(Composite):
    """Conv + max-pool downsample pair of the P6 backbones (reference
    common.py:181-192): cv2(cv1(x)) (1x1, then k3 stride k) beside cv3 of
    the k x k / stride-k max pool of x, concatenated. The pool is the
    non-overlapping one, so training takes `MaxPoolTiled`'s gradient."""

    c1: int
    c2: int
    n: int = 1
    k: int = 2

    @property
    def cout(self):
        return self.c2

    @property
    def stride_factor(self):
        return float(self.k)

    def children(self):
        return {
            "cv1": ConvBnAct(self.c1, self.c1, 1, 1),
            "cv2": ConvBnAct(self.c1, self.c2 // 2, 3, self.k),
            "cv3": ConvBnAct(self.c1, self.c2 // 2, 1, 1),
        }

    def apply(self, params, state, x, ctx):
        call, new_state = self._call(params, state, ctx)
        a = call("cv2", call("cv1", x))
        b = call("cv3", max_pool(x, self.k, self.k, 0))
        return torch.cat([a, b], dim=1), new_state


@dataclasses.dataclass(frozen=True)
class SPPCSPC(Composite):
    """The YOLOv7 neck block: CSP-wrapped SPP (reference common.py:260-280)."""

    c1: int
    c2: int
    n: int = 1
    shortcut: bool = False
    g: int = 1
    e: float = 0.5
    k: Tuple[int, ...] = (5, 9, 13)

    @property
    def cout(self):
        return self.c2

    def children(self):
        c_ = int(2 * self.c2 * self.e)
        return {
            "cv1": ConvBnAct(self.c1, c_, 1, 1),
            "cv2": ConvBnAct(self.c1, c_, 1, 1),
            "cv3": ConvBnAct(c_, c_, 3, 1),
            "cv4": ConvBnAct(c_, c_, 1, 1),
            "cv5": ConvBnAct(4 * c_, c_, 1, 1),
            "cv6": ConvBnAct(c_, c_, 3, 1),
            "cv7": ConvBnAct(2 * c_, self.c2, 1, 1),
        }

    def apply(self, params, state, x, ctx):
        call, new_state = self._call(params, state, ctx)
        x1 = call("cv4", call("cv3", call("cv1", x)))
        pools = max_pool_pyramid(x1, self.k)
        y1 = call("cv6", call("cv5", torch.cat([x1] + pools, dim=1)))
        y2 = call("cv2", x)
        return call("cv7", torch.cat([y1, y2], dim=1)), new_state


@dataclasses.dataclass(frozen=True)
class SPP(Composite):
    """Spatial pyramid pooling (reference common.py:195-206)."""

    c1: int
    c2: int
    k: Tuple[int, ...] = (5, 9, 13)

    @property
    def cout(self):
        return self.c2

    def children(self):
        c_ = self.c1 // 2
        return {
            "cv1": ConvBnAct(self.c1, c_, 1, 1),
            "cv2": ConvBnAct(c_ * (len(self.k) + 1), self.c2, 1, 1),
        }

    def apply(self, params, state, x, ctx):
        call, new_state = self._call(params, state, ctx)
        x = call("cv1", x)
        pools = max_pool_pyramid(x, self.k)
        return call("cv2", torch.cat([x] + pools, dim=1)), new_state


@dataclasses.dataclass(frozen=True)
class SPPF(Composite):
    """Fast SPP (reference common.py:808-821): three chained stride-1 k x k
    pools, whose gradient sends a tie to the first maximum of its window
    in both libraries (not `MaxPoolTiled`'s split)."""

    c1: int
    c2: int
    k: int = 5

    @property
    def cout(self):
        return self.c2

    def children(self):
        c_ = self.c1 // 2
        return {
            "cv1": ConvBnAct(self.c1, c_, 1, 1),
            "cv2": ConvBnAct(c_ * 4, self.c2, 1, 1),
        }

    def apply(self, params, state, x, ctx):
        call, new_state = self._call(params, state, ctx)
        x = call("cv1", x)
        y1 = max_pool(x, self.k, 1, self.k // 2)
        y2 = max_pool(y1, self.k, 1, self.k // 2)
        y3 = max_pool(y2, self.k, 1, self.k // 2)
        return call("cv2", torch.cat([x, y1, y2, y3], dim=1)), new_state


@dataclasses.dataclass(frozen=True)
class Stem(Composite):
    """4x-downsampling stem of r50/x50-csp (reference common.py:165-178):
    cv1 (k3/s2), then cv3(cv2(.)) beside a 2x2/2 max pool of cv1's output,
    concatenated, then cv4. The pool is the non-overlapping one, so
    training takes `MaxPoolTiled`'s gradient."""

    c1: int
    c2: int
    k: int = 1
    s: int = 1
    p: Optional[int] = None
    g: int = 1
    act: Any = True

    @property
    def cout(self):
        return self.c2

    stride_factor = 4.0

    def children(self):
        c_ = int(self.c2 / 2)
        return {
            "cv1": ConvBnAct(self.c1, c_, 3, 2),
            "cv2": ConvBnAct(c_, c_, 1, 1),
            "cv3": ConvBnAct(c_, c_, 3, 2),
            "cv4": ConvBnAct(2 * c_, self.c2, 1, 1),
        }

    def apply(self, params, state, x, ctx):
        call, new_state = self._call(params, state, ctx)
        x = call("cv1", x)
        pooled = max_pool(x, 2, 2, 0)
        return call("cv4", torch.cat([call("cv3", call("cv2", x)), pooled], dim=1)), new_state


@dataclasses.dataclass(frozen=True)
class Bottleneck(Composite):
    """Darknet bottleneck (reference common.py:209-219): a 1x1 then a 3x3
    (grouped by g), plus x when shortcut and c1 == c2."""

    c1: int
    c2: int
    shortcut: bool = True
    g: int = 1
    e: float = 0.5

    @property
    def cout(self):
        return self.c2

    def children(self):
        c_ = int(self.c2 * self.e)
        return {
            "cv1": ConvBnAct(self.c1, c_, 1, 1),
            "cv2": ConvBnAct(c_, self.c2, 3, 1, None, self.g),
        }

    def apply(self, params, state, x, ctx):
        call, new_state = self._call(params, state, ctx)
        y = call("cv2", call("cv1", x))
        if self.shortcut and self.c1 == self.c2:
            y = x + y
        return y, new_state


@dataclasses.dataclass(frozen=True)
class Res(Composite):
    """ResNet bottleneck (reference common.py:222-234): 1x1, 3x3 (grouped
    by g), 1x1, plus x when shortcut and c1 == c2."""

    c1: int
    c2: int
    shortcut: bool = True
    g: int = 1
    e: float = 0.5

    @property
    def cout(self):
        return self.c2

    def children(self):
        c_ = int(self.c2 * self.e)
        return {
            "cv1": ConvBnAct(self.c1, c_, 1, 1),
            "cv2": ConvBnAct(c_, c_, 3, 1, None, self.g),
            "cv3": ConvBnAct(c_, self.c2, 1, 1),
        }

    def apply(self, params, state, x, ctx):
        call, new_state = self._call(params, state, ctx)
        y = call("cv3", call("cv2", call("cv1", x)))
        if self.shortcut and self.c1 == self.c2:
            y = x + y
        return y, new_state


def ResX(c1, c2, shortcut=True, g=32, e=0.5):
    """ResNeXt bottleneck (reference common.py:237-241): a Res with 32
    groups."""
    return Res(c1, c2, shortcut, g, e)


@dataclasses.dataclass(frozen=True)
class Ghost(Composite):
    """Ghost bottleneck (reference common.py:244-255): two GhostConvs (a
    depthwise k x k between them at stride 2), plus x, or at stride 2 a
    depthwise-then-1x1 shortcut of x."""

    c1: int
    c2: int
    k: int = 3
    s: int = 1

    @property
    def cout(self):
        return self.c2

    @property
    def stride_factor(self):
        return float(self.s)

    def children(self):
        c_ = self.c2 // 2
        kids = {
            "conv0": GhostConv(self.c1, c_, 1, 1),
            "conv2": GhostConv(c_, self.c2, 1, 1, act=False),
        }
        if self.s == 2:
            kids["conv1"] = DWConv(c_, c_, self.k, self.s, act=False)
            kids["short_dw"] = DWConv(self.c1, self.c1, self.k, self.s, act=False)
            kids["short_pw"] = ConvBnAct(self.c1, self.c2, 1, 1, act=False)
        return kids

    def apply(self, params, state, x, ctx):
        call, new_state = self._call(params, state, ctx)
        y = call("conv0", x)
        if self.s == 2:
            y = call("conv1", y)
        y = call("conv2", y)
        sc = call("short_pw", call("short_dw", x)) if self.s == 2 else x
        return y + sc, new_state


# The CSP wrappers: the A/B/C variants differ in the stem and route
# topology (reference common.py:307-354), and the families in their inner
# block (ResCSP* common.py:357-398, ResXCSP* common.py:401-426). The inner
# blocks are children m0 .. m{n-1} (the reference's nn.Sequential `m`).


@dataclasses.dataclass(frozen=True)
class _CSPBase(Composite):
    c1: int
    c2: int
    n: int = 1
    shortcut: bool = True
    g: int = 1
    e: float = 0.5

    @property
    def cout(self):
        return self.c2

    def inner(self, c_) -> Sequence[Block]:
        raise NotImplementedError

    def _stems(self, c_) -> Dict[str, Block]:
        raise NotImplementedError

    def children(self):
        c_ = self._hidden()
        kids = self._stems(c_)
        kids.update({f"m{i}": b for i, b in enumerate(self.inner(c_))})
        return kids

    def _chain(self, call, y):
        for i in range(self.n):
            y = call(f"m{i}", y)
        return y


class _CSPA(_CSPBase):
    """Topology A: two parallel 1x1 stems on x, the inner chain on the
    first."""

    def _hidden(self):
        return int(self.c2 * self.e)

    def _stems(self, c_):
        return {"cv1": ConvBnAct(self.c1, c_, 1, 1), "cv2": ConvBnAct(self.c1, c_, 1, 1),
                "cv3": ConvBnAct(2 * c_, self.c2, 1, 1)}

    def apply(self, params, state, x, ctx):
        call, new_state = self._call(params, state, ctx)
        y1 = self._chain(call, call("cv1", x))
        y2 = call("cv2", x)
        return call("cv3", torch.cat([y1, y2], dim=1)), new_state


class _CSPB(_CSPBase):
    """Topology B: one 1x1 stem, split after it; the hidden width is c2,
    not c2 * e."""

    def _hidden(self):
        return int(self.c2)

    def _stems(self, c_):
        return {"cv1": ConvBnAct(self.c1, c_, 1, 1), "cv2": ConvBnAct(c_, c_, 1, 1),
                "cv3": ConvBnAct(2 * c_, self.c2, 1, 1)}

    def apply(self, params, state, x, ctx):
        call, new_state = self._call(params, state, ctx)
        x1 = call("cv1", x)
        y1 = self._chain(call, x1)
        y2 = call("cv2", x1)
        return call("cv3", torch.cat([y1, y2], dim=1)), new_state


class _CSPC(_CSPBase):
    """Topology C: as A, with a transition 1x1 (cv3) after the chain."""

    def _hidden(self):
        return int(self.c2 * self.e)

    def _stems(self, c_):
        return {"cv1": ConvBnAct(self.c1, c_, 1, 1), "cv2": ConvBnAct(self.c1, c_, 1, 1),
                "cv3": ConvBnAct(c_, c_, 1, 1), "cv4": ConvBnAct(2 * c_, self.c2, 1, 1)}

    def apply(self, params, state, x, ctx):
        call, new_state = self._call(params, state, ctx)
        y1 = call("cv3", self._chain(call, call("cv1", x)))
        y2 = call("cv2", x)
        return call("cv4", torch.cat([y1, y2], dim=1)), new_state


def _bottlenecks(b, c_):
    return [Bottleneck(c_, c_, b.shortcut, b.g, e=1.0) for _ in range(b.n)]


def _res(b, c_, e):
    return [Res(c_, c_, b.shortcut, b.g, e=e) for _ in range(b.n)]


class BottleneckCSPA(_CSPA):
    def inner(self, c_):
        return _bottlenecks(self, c_)


class BottleneckCSPB(_CSPB):
    def __init__(self, c1, c2, n=1, shortcut=False, g=1, e=0.5):
        super().__init__(c1, c2, n, shortcut, g, e)

    def inner(self, c_):
        return _bottlenecks(self, c_)


class BottleneckCSPC(_CSPC):
    def inner(self, c_):
        return _bottlenecks(self, c_)


class ResCSPA(_CSPA):
    def inner(self, c_):
        return _res(self, c_, 0.5)


class ResCSPB(_CSPB):
    def inner(self, c_):
        return _res(self, c_, 0.5)


class ResCSPC(_CSPC):
    def inner(self, c_):
        return _res(self, c_, 0.5)


class ResXCSPA(_CSPA):
    def __init__(self, c1, c2, n=1, shortcut=True, g=32, e=0.5):
        super().__init__(c1, c2, n, shortcut, g, e)

    def inner(self, c_):
        return _res(self, c_, 1.0)


class ResXCSPB(_CSPB):
    def __init__(self, c1, c2, n=1, shortcut=True, g=32, e=0.5):
        super().__init__(c1, c2, n, shortcut, g, e)

    def inner(self, c_):
        return _res(self, c_, 1.0)


class ResXCSPC(_CSPC):
    def __init__(self, c1, c2, n=1, shortcut=True, g=32, e=0.5):
        super().__init__(c1, c2, n, shortcut, g, e)

    def inner(self, c_):
        return _res(self, c_, 1.0)


def _ghosts(b, c_):
    return [Ghost(c_, c_) for _ in range(b.n)]


class GhostCSPA(_CSPA):
    def inner(self, c_):
        return _ghosts(self, c_)


class GhostCSPB(_CSPB):
    def inner(self, c_):
        return _ghosts(self, c_)


class GhostCSPC(_CSPC):
    def inner(self, c_):
        return _ghosts(self, c_)


@dataclasses.dataclass(frozen=True)
class RepConv(Composite):
    """RepVGG-style conv (reference common.py:463-507). Train form: 3x3+BN,
    1x1+BN, identity BN when c1 == c2 and s == 1; deploy form (after
    `reparam.fuse_repconv`): one 3x3 conv {w, b}."""

    c1: int
    c2: int
    k: int = 3
    s: int = 1
    p: Optional[int] = None
    g: int = 1
    act: Any = True

    def __post_init__(self):
        if self.k != 3 or autopad(self.k, self.p) != 1:
            raise ValueError("RepConv is 3x3 with padding 1")

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
        return {}

    def init(self, gen):
        bnd_p, bnd_s = bn_init(self.c2)
        bn1_p, bn1_s = bn_init(self.c2)
        params = {
            "dense": {"w": conv_kernel_init(gen, 3, 3, self.c1 // self.g,
                                            self.c2), "bn": bnd_p},
            "one": {"w": conv_kernel_init(gen, 1, 1, self.c1 // self.g,
                                          self.c2), "bn": bn1_p},
        }
        state = {"dense": {"bn": bnd_s}, "one": {"bn": bn1_s}}
        if self.has_identity:
            params["idbn"], state["idbn"] = bn_init(self.c1)
        return params, state

    def apply(self, params, state, x, ctx):
        _, fn = get_activation(self.act)
        if ctx.observer is not None:
            ctx.observer(ctx.path, x)
        if "wq" in params:  # int8 deploy form
            return fn(_int8_conv(params, x, self.s, 1, self.g)).to(x.dtype), state
        if "w" in params:  # fused deploy form
            return fn(conv2d(x, params["w"], params["b"], self.s, 1, self.g,
                             ctx.dtype)), state
        new_state = dict(state)
        yd = conv2d(x, params["dense"]["w"], None, self.s, 1, self.g, ctx.dtype)
        y, bns = batch_norm(params["dense"]["bn"], state["dense"]["bn"], yd, ctx)
        new_state["dense"] = {"bn": bns}
        y1 = conv2d(x, params["one"]["w"], None, self.s, 0, self.g, ctx.dtype)
        y1, bns = batch_norm(params["one"]["bn"], state["one"]["bn"], y1, ctx)
        new_state["one"] = {"bn": bns}
        y = y + y1
        if self.has_identity:
            yid, new_state["idbn"] = batch_norm(params["idbn"], state["idbn"],
                                                x.to(y.dtype), ctx)
            y = y + yid
        return fn(y), new_state


@dataclasses.dataclass(frozen=True)
class ImplicitA(Block):
    """Learned additive prior over NCHW channels, init N(0, 0.02)
    (reference common.py:433)."""

    c: int

    @property
    def cout(self):
        return self.c

    def init(self, gen):
        return {"v": 0.02 * torch.randn((self.c,), generator=gen)}, {}

    def apply(self, params, state, x, ctx):
        return x + params["v"].to(x.dtype)[:, None, None], state


@dataclasses.dataclass(frozen=True)
class ImplicitM(Block):
    """Learned multiplicative prior over NCHW channels, init N(1, 0.02)
    (reference common.py:446)."""

    c: int

    @property
    def cout(self):
        return self.c

    def init(self, gen):
        return {"v": 1.0 + 0.02 * torch.randn((self.c,), generator=gen)}, {}

    def apply(self, params, state, x, ctx):
        return x * params["v"].to(x.dtype)[:, None, None], state


@dataclasses.dataclass(frozen=True)
class BatchNorm2d(Block):
    """A standalone BN layer (the `nn.BatchNorm2d` rows of the DSL): params
    {scale, bias}, state {mean, var}."""

    c1: int

    @property
    def cout(self):
        return self.c1

    def init(self, gen):
        return bn_init(self.c1)

    def apply(self, params, state, x, ctx):
        return batch_norm(params, state, x, ctx)
