"""Attention blocks (counterpart of `yolo_series_tpu/models/attention.py`):
the ViT-lite TransformerBlock, Swin v1 / v2 window attention, and their
CSP hybrids STCSPA/B/C and ST2CSPA/B/C.

Reference: TransformerLayer / TransformerBlock (common.py:746-789),
WindowAttention, SwinTransformerLayer / Block and STCSP{A,B,C}
(common.py:1365-1656), the Swin v2 cosine-attention variants and
ST2CSP{A,B,C} (common.py:1662-2017).

The blocks take and return NCHW maps, as every block of the port does;
inside, a Swin layer and the TransformerBlock work on NHWC views of them,
as the JAX package's blocks do, so windows are plain reshapes. Linear
weights are (in, out) under the key `w`, as the JAX package keeps them,
so the bridges carry them across unchanged. The attention is plain
tensor arithmetic (`einsum`, `softmax`), as the JAX package computes it
outside any kernel: logits and softmax in fp32, the probabilities cast
back to the input's dtype before they weight the values. LayerNorm is
computed in fp32 with eps 1e-5; the MLP's activation is SiLU.

Swin specifics that the JAX package fixes and this port keeps: the pad
and the crop are at the bottom and right; the shift of the odd layers is
unconditional, so even one padded window is rolled and masked; v2 zeroes
the k third of the qkv bias at every call (the reference has no k bias),
clamps `logit_scale` at log(100), and takes its relative-position bias
from an MLP over log-spaced coordinates (16 sigmoid of it). drop_path is
identity, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from yolo_series_tpu_torch.models.layers import _CSPA, _CSPB, _CSPC, Block, Composite, ConvBnAct


def _linear_init(gen, cin, cout, bias=True):
    bound = 1.0 / math.sqrt(cin)
    p = {"w": (torch.rand((cin, cout), generator=gen) * 2 - 1) * bound}
    if bias:
        p["b"] = (torch.rand((cout,), generator=gen) * 2 - 1) * bound
    return p


def _linear(p, x):
    y = torch.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def _ln_init(c):
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def _layer_norm(p, x, eps=1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]).to(x.dtype)


def _window_partition(x, ws):
    """(B, H, W, C) -> (B * nW, ws * ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def _window_reverse(wins, ws, h, w):
    c = wins.shape[-1]
    b = wins.shape[0] // ((h // ws) * (w // ws))
    x = wins.reshape(b, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def _rel_pos_index(ws: int) -> np.ndarray:
    """(ws * ws, ws * ws) index into the (2 ws - 1)^2 bias table
    (reference common.py:1381-1393)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def _shift_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """The SW-MSA attention mask (nW, N, N) (reference create_mask,
    common.py:1499-1521)."""
    img = np.zeros((h, w))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wss in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wss] = cnt
            cnt += 1
    wins = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _cpb_grid(ws: int) -> np.ndarray:
    """Swin v2's log-spaced relative coordinates, ((2 ws - 1)^2, 2)."""
    rng = np.arange(-(ws - 1), ws, dtype=np.float32)
    grid = np.stack(np.meshgrid(rng, rng, indexing="ij"), -1)
    grid = grid / max(ws - 1, 1) * 8.0
    grid = np.sign(grid) * np.log2(np.abs(grid) + 1.0) / np.log2(8)
    return grid.reshape(-1, 2).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _on(table: str, device: torch.device, *args) -> torch.Tensor:
    """One of the fixed tables above on `device`, made at its first use: a
    forward copies nothing from the host, so a CUDA graph can capture it
    once an eager call has run. Made outside inference mode, so a training
    forward can use the table an inference forward made."""
    make = {"rel_index": lambda ws: _rel_pos_index(ws).reshape(-1),
            "shift_mask": _shift_mask, "cpb_grid": _cpb_grid}[table]
    with torch.inference_mode(False):
        return torch.from_numpy(make(*args)).to(device)


@dataclasses.dataclass(frozen=True)
class WindowAttention(Block):
    """Multi-head self-attention within windows: v1 with a learned
    relative-position bias table, v2 cosine attention with a learned
    temperature and the continuous position bias MLP."""

    dim: int
    window_size: int
    num_heads: int
    v2: bool = False

    @property
    def cout(self):
        return self.dim

    def init(self, gen):
        p = {"qkv": _linear_init(gen, self.dim, self.dim * 3),
             "proj": _linear_init(gen, self.dim, self.dim)}
        ws = self.window_size
        if self.v2:
            # the reference's q / v biases start at zero, its k bias is none
            p["qkv"]["b"] = torch.zeros(self.dim * 3)
            p["logit_scale"] = torch.full((self.num_heads, 1, 1), math.log(10.0))
            p["cpb1"] = _linear_init(gen, 2, 512)
            p["cpb2"] = _linear_init(gen, 512, self.num_heads, bias=False)
        else:
            p["rel_bias"] = 0.02 * torch.randn(((2 * ws - 1) ** 2, self.num_heads),
                                               generator=gen)
        return p, {}

    def _bias(self, params):
        """(heads, N, N) position bias in fp32."""
        ws = self.window_size
        dev = params["proj"]["w"].device
        idx = _on("rel_index", dev, ws)
        if self.v2:
            grid = _on("cpb_grid", dev, ws)
            table = _linear(params["cpb2"], F.relu(_linear(params["cpb1"], grid)))
            bias = 16.0 * torch.sigmoid(table)
        else:
            bias = params["rel_bias"]
        n = ws * ws
        return bias[idx].reshape(n, n, self.num_heads).permute(2, 0, 1)

    def apply(self, params, state, x, ctx, mask=None):
        """x: (B_, N, C) windows; mask: (nW, N, N) or None."""
        b_, n, c = x.shape
        nh = self.num_heads
        hd = c // nh
        qkv_p = params["qkv"]
        if self.v2:   # the k third of the bias is zero, whatever the param holds
            qb = qkv_p["b"]
            qkv_p = {"w": qkv_p["w"],
                     "b": torch.cat([qb[:c], torch.zeros_like(qb[c:2 * c]), qb[2 * c:]])}
        qkv = _linear(qkv_p, x).reshape(b_, n, 3, nh, hd)
        q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
        qf, kf = q.float(), k.float()
        if self.v2:   # cosine attention with a learned temperature
            qf = qf / (torch.linalg.vector_norm(qf, dim=-1, keepdim=True) + 1e-6)
            kf = kf / (torch.linalg.vector_norm(kf, dim=-1, keepdim=True) + 1e-6)
            scale = torch.exp(torch.clamp(params["logit_scale"], max=math.log(100.0)))
            attn = torch.einsum("bhnd,bhmd->bhnm", qf, kf) * scale
        else:
            attn = torch.einsum("bhnd,bhmd->bhnm", qf * (hd ** -0.5), kf)
        attn = attn + self._bias(params)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(b_ // nw, nw, nh, n, n) + mask[None, :, None]
            attn = attn.reshape(b_, nh, n, n)
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        y = torch.einsum("bhnm,bhmd->bhnd", attn, v)
        return _linear(params["proj"], y.permute(0, 2, 1, 3).reshape(b_, n, c)), state


@dataclasses.dataclass(frozen=True)
class SwinTransformerLayer(Block):
    """One W-MSA (shift 0) or SW-MSA layer (reference common.py:1472-1581;
    v2's res-post-norm form common.py:1830-1930)."""

    dim: int
    num_heads: int
    window_size: int = 8
    shift_size: int = 0
    mlp_ratio: float = 4.0
    v2: bool = False

    @property
    def cout(self):
        return self.dim

    def _attn(self):
        return WindowAttention(self.dim, self.window_size, self.num_heads, v2=self.v2)

    def init(self, gen):
        hidden = int(self.dim * self.mlp_ratio)
        return {"norm1": _ln_init(self.dim), "attn": self._attn().init(gen)[0],
                "norm2": _ln_init(self.dim), "fc1": _linear_init(gen, self.dim, hidden),
                "fc2": _linear_init(gen, hidden, self.dim)}, {}

    def apply(self, params, state, x, ctx):
        x = x.permute(0, 2, 3, 1)   # NHWC view
        _, h0, w0, _ = x.shape
        ws = self.window_size
        pad_b, pad_r = (ws - h0 % ws) % ws, (ws - w0 % ws) % ws
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        h, w = x.shape[1:3]
        shift = self.shift_size

        shortcut = x
        xs = x if self.v2 else _layer_norm(params["norm1"], x)
        if shift:
            xs = torch.roll(xs, (-shift, -shift), dims=(1, 2))
        mask = _on("shift_mask", x.device, h, w, ws, shift) if shift else None
        att, _ = self._attn().apply(params["attn"], {}, _window_partition(xs, ws), ctx,
                                    mask=mask)
        xs = _window_reverse(att, ws, h, w)
        if shift:
            xs = torch.roll(xs, (shift, shift), dims=(1, 2))
        if self.v2:   # res-post-norm
            xs = _layer_norm(params["norm1"], xs)
        x = shortcut + xs

        y = x if self.v2 else _layer_norm(params["norm2"], x)
        y = _linear(params["fc2"], F.silu(_linear(params["fc1"], y)))
        if self.v2:
            y = _layer_norm(params["norm2"], y)
        x = x + y
        if pad_b or pad_r:
            x = x[:, :h0, :w0]
        return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last), state


@dataclasses.dataclass(frozen=True)
class SwinTransformerBlock(Composite):
    """A 1x1 ConvBnAct when c1 != c2, then num_layers Swin layers, the odd
    ones shifted by half a window (reference common.py:1584-1599; v2
    common.py:1933-1948)."""

    c1: int
    c2: int
    num_heads: int
    num_layers: int
    window_size: int = 8
    v2: bool = False

    @property
    def cout(self):
        return self.c2

    def children(self):
        kids = {}
        if self.c1 != self.c2:
            kids["conv"] = ConvBnAct(self.c1, self.c2, 1, 1)
        for i in range(self.num_layers):
            kids[f"m{i}"] = SwinTransformerLayer(
                self.c2, self.num_heads, self.window_size,
                shift_size=0 if i % 2 == 0 else self.window_size // 2, v2=self.v2)
        return kids

    def apply(self, params, state, x, ctx):
        call, new_state = self._call(params, state, ctx)
        if self.c1 != self.c2:
            x = call("conv", x)
        for i in range(self.num_layers):
            x = call(f"m{i}", x)
        return x, new_state


def _stcsp(base, v2):
    class _ST(base):
        """A CSP wrapper whose inner chain is one SwinTransformerBlock of n
        layers (child `m0`), heads c_ // 32 (at least 1), window 8 (v1)
        or 7 (v2, common.py:1585, :1947)."""

        def inner(self, c_):
            return [SwinTransformerBlock(c_, c_, max(c_ // 32, 1), self.n,
                                         window_size=7 if v2 else 8, v2=v2)]

        def _chain(self, call, y):
            return call("m0", y)

    _ST.__name__ = f"{'ST2' if v2 else 'ST'}{base.__name__[-4:]}"
    return _ST


STCSPA = _stcsp(_CSPA, v2=False)
STCSPB = _stcsp(_CSPB, v2=False)
STCSPC = _stcsp(_CSPC, v2=False)
ST2CSPA = _stcsp(_CSPA, v2=True)
ST2CSPB = _stcsp(_CSPB, v2=True)
ST2CSPC = _stcsp(_CSPC, v2=True)


@dataclasses.dataclass(frozen=True)
class TransformerBlock(Composite):
    """The ViT-lite block over the flattened map (reference
    common.py:746-789): a 1x1 ConvBnAct when c1 != c2, a learned linear
    position term, then per layer the q / k / v linears, the packed
    `in_proj` and `out_proj` of `nn.MultiheadAttention` on top of them,
    and two bias-free linears, each with its residual; no LayerNorm."""

    c1: int
    c2: int
    num_heads: int
    num_layers: int

    @property
    def cout(self):
        return self.c2

    def children(self):
        return {"conv": ConvBnAct(self.c1, self.c2, 1, 1)} if self.c1 != self.c2 else {}

    def init(self, gen):
        params, state = Composite.init(self, gen)
        c = self.c2
        params["pos"] = _linear_init(gen, c, c)
        xav = math.sqrt(6.0 / (4 * c))   # nn.MultiheadAttention's xavier in_proj
        for i in range(self.num_layers):
            params[f"tr{i}"] = {
                "q": _linear_init(gen, c, c, bias=False),
                "k": _linear_init(gen, c, c, bias=False),
                "v": _linear_init(gen, c, c, bias=False),
                "in_proj": {"w": (torch.rand((c, 3 * c), generator=gen) * 2 - 1) * xav,
                            "b": torch.zeros(3 * c)},
                "out_proj": {"w": _linear_init(gen, c, c)["w"], "b": torch.zeros(c)},
                "fc1": _linear_init(gen, c, c, bias=False),
                "fc2": _linear_init(gen, c, c, bias=False),
            }
        return params, state

    def apply(self, params, state, x, ctx):
        call, new_state = self._call(params, state, ctx)
        if self.c1 != self.c2:
            x = call("conv", x)
        b, c, h, w = x.shape
        p = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        p = p + _linear(params["pos"], p)
        nh = self.num_heads
        hd = c // nh

        def heads(t):
            return t.reshape(b, -1, nh, hd).permute(0, 2, 1, 3)

        for i in range(self.num_layers):
            tp = params[f"tr{i}"]
            wq, wk, wv = torch.chunk(tp["in_proj"]["w"], 3, dim=1)
            bq, bk, bv = torch.chunk(tp["in_proj"]["b"], 3)
            q = heads(_linear({"w": wq, "b": bq}, _linear(tp["q"], p)))
            k = heads(_linear({"w": wk, "b": bk}, _linear(tp["k"], p)))
            v = heads(_linear({"w": wv, "b": bv}, _linear(tp["v"], p)))
            attn = torch.softmax(
                torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) / math.sqrt(hd), -1)
            y = torch.einsum("bhnm,bhmd->bhnd", attn.to(x.dtype), v)
            y = _linear(tp["out_proj"], y.permute(0, 2, 1, 3).reshape(b, -1, c))
            p = y + p
            p = _linear(tp["fc2"], _linear(tp["fc1"], p)) + p
        y = p.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return y.contiguous(memory_format=torch.channels_last), new_state
