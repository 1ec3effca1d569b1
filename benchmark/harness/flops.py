"""Operations, bytes and roofline bounds of a configuration, from the
shapes of its frozen cfg alone (the reference's `Net`), so that a change to
the program's plan cannot change them.

The arithmetic is that of the program's dense FLOP counter at the time
the benchmark was written (`utils/general.FlopCounter.dense`): two
operations a multiply-add over the taps that fall inside the input, window
- 1 compares a max-pooled output; biases, BN, activations, concats,
shortcut adds and resizes count nothing. The deploy form counts a repconv
as its fused 3x3 conv; the training form counts its 3x3 and 1x1 branches.

Peaks: one NVIDIA H100 SXM, dense bf16 989 TFLOP/s, HBM 3.35 TB/s
(NVIDIA's data sheet, at the 700 W power limit).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def _taps(n_in: int, n_out: int, k: int, s: int, p: int) -> int:
    """Kernel taps inside the input, summed over the outputs of one axis."""
    return sum(1 for o in range(n_out) for i in range(k) if 0 <= o * s - p + i < n_in)


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def convs(net, img: int, form: str = "deploy") -> List[dict]:
    """Every conv of one img x img image: {layer, name, cin, cout, k, s,
    hin, hout, ops}, and every max pool as {layer, name, k, hout, c, ops}."""
    hw: Dict[int, int] = {}
    out: List[dict] = []

    def conv(i, name, cin, cout, k, s, h):
        p = k // 2
        ho = _out(h, k, s, p)
        out.append({"layer": i, "name": name, "cin": cin, "cout": cout, "k": k, "s": s,
                    "hin": h, "hout": ho, "ops": 2 * cin * cout * _taps(h, ho, k, s, p) ** 2})
        return ho

    def pool(i, name, c, k, s, h):
        ho = _out(h, k, s, k // 2 if s == 1 else 0)
        out.append({"layer": i, "name": name, "k": k, "hout": ho, "c": c,
                    "ops": c * ho * ho * (k * k - 1)})
        return ho

    for L in net.layers:
        i, kind, c1, c2 = L["i"], L["kind"], L["c1"], L["c2"]
        h = img if L["frm"][0] < 0 else hw[L["frm"][0]]
        if kind == "conv":
            h = conv(i, "conv", c1, c2, L["k"], L["s"], h)
        elif kind == "repconv":
            ho = conv(i, "rbr_dense", c1, c2, L["k"], L["s"], h)
            if form == "training":
                conv(i, "rbr_1x1", c1, c2, 1, L["s"], h)
            h = ho
        elif kind == "mp":
            h = pool(i, "mp", c1, 2, 2, h)
        elif kind == "upsample":
            h = 2 * h
        elif kind == "reorg":
            h = h // 2
        elif kind == "sppcspc":
            conv(i, "cv1", c1, c2, 1, 1, h)
            conv(i, "cv2", c1, c2, 1, 1, h)
            conv(i, "cv3", c2, c2, 3, 1, h)
            conv(i, "cv4", c2, c2, 1, 1, h)
            for k in (5, 9, 13):
                pool(i, f"m{k}", c2, k, 1, h)
            conv(i, "cv5", 4 * c2, c2, 1, 1, h)
            conv(i, "cv6", c2, c2, 3, 1, h)
            conv(i, "cv7", 2 * c2, c2, 1, 1, h)
        elif kind == "downc":
            conv(i, "cv1", c1, c1, 1, 1, h)
            ho = conv(i, "cv2", c1, c2 // 2, L["k"], L["s"], h)
            conv(i, "cv3", c1, c2 // 2, 1, 1, pool(i, "mp", c1, L["s"], L["s"], h))
            h = ho
        elif kind in ("detect", "idetect"):
            for j, (f, c) in enumerate(zip(L["frm"], L["c_in"])):
                conv(i, f"m.{j}", c, net.na * net.no, 1, 1, hw[f])
        hw[i] = h
    return out


def gflops(net, img: int, form: str = "deploy") -> float:
    """Operations of one image's forward, in GFLOPs."""
    return sum(c["ops"] for c in convs(net, img, form)) / 1e9


def params_m(net, form: str = "deploy") -> float:
    """Parameters in millions: conv weights, and in the deploy form one bias
    a fused conv's output channel; in the training form BN's two vectors
    an output channel and the implicit layers."""
    n = 0
    for c in convs(net, 64, form):
        if "cin" in c:
            w = c["cin"] * c["cout"] * c["k"] ** 2
            n += w + (c["cout"] if form == "deploy" else 2 * c["cout"])
    if form == "training":
        for L in net.layers:
            if L["kind"] == "repconv" and L["c1"] == L["c2"] and L["s"] == 1:
                n += 2 * L["c2"]
            if L["kind"] == "idetect":
                n += sum(L["c_in"]) + net.nl * net.na * net.no
            if L["kind"] in ("detect", "idetect"):   # head convs: bias, not BN
                n -= net.nl * net.na * net.no
    return n / 1e6


def bound_ms(net, img: int, batch: int, layers) -> Tuple[float, float, float]:
    """(bound ms, operations, bytes) of the deploy convs of `layers` at
    `batch`: each conv's bound is the larger of its operations over the
    bf16 peak and its bytes (bf16 input read once, weights, output written
    once) over the HBM peak; the bounds add up."""
    keep = set(layers)
    total = ops_sum = bytes_sum = 0.0
    for c in convs(net, img, "deploy"):
        if c["layer"] not in keep or "cin" not in c:
            continue
        ops = batch * c["ops"]
        nbytes = 2 * (batch * c["cin"] * c["hin"] ** 2 + c["cin"] * c["cout"] * c["k"] ** 2
                      + batch * c["cout"] * c["hout"] ** 2)
        total += max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
        ops_sum += ops
        bytes_sum += nbytes
    return total * 1e3, ops_sum, bytes_sum
