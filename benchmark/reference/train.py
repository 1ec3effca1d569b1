"""Plain reference of the training step: the training form's forward with
train-mode BN (`yolo.Net.forward(mode="train")`), the OTA loss (`ota.py`),
the gradient by autograd, SGD with Nesterov momentum over upstream's three
parameter groups (conv weights with weight decay; BN gains and the
implicit layers; biases), and the EMA of the weights and BN statistics
(upstream utils/torch_utils.ModelEMA: decay 0.9999 (1 - exp(-updates /
2000))). fp32, TF32 off; `cast` runs every conv in a lower precision
(the control)."""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from benchmark.reference import ota
from benchmark.reference.yolo import Net, fp32_exact

STATS = ("running_mean", "running_var")


def init_training(net: Net, seed: int, device) -> Dict[str, torch.Tensor]:
    """A drawn state dict with upstream Detect's bias prior (yolo.py
    _initialize_biases): objectness log(8 / (640 / stride)^2), classes
    log(0.6 / (nc - 0.99))."""
    sd = net.draw(seed, device)
    p = f"model.{net.head['i']}"
    img = 640.0
    for j, c in enumerate(net.head["c_in"]):
        b = sd[f"{p}.m.{j}.bias"].view(net.na, net.no)
        stride = 8.0 * 2 ** j
        b[:, 4] += math.log(8.0 / (img / stride) ** 2)
        b[:, 5:] += math.log(0.6 / (net.nc - 0.99))
    return sd


def after_warmup(hyp: dict):
    """([lr] x 3 groups, momentum) of the first step past warm-up at epoch 0
    (upstream train.py: the one-cycle factor at epoch 0 is 1)."""
    epoch = 0.0
    f = ((1 - math.cos(epoch * math.pi / hyp["epochs"])) / 2) * (hyp["lrf"] - 1) + 1
    return [hyp["lr0"] * f] * 3, hyp["momentum"]


def is_param(key: str, t: torch.Tensor) -> bool:
    return t.is_floating_point() and not key.endswith(STATS)


def group(key: str, t: torch.Tensor) -> int:
    """Upstream's groups: 1 conv weights (decayed), 2 biases, 0 the rest."""
    if key.endswith(".bias"):
        return 2
    if key.endswith(".weight") and t.ndim >= 2:
        return 1
    return 0


class Trainer:
    """The reference's train state and step, on the state dict's device."""

    def __init__(self, net: Net, sd, hyp: dict, cast=None):
        self.net, self.hyp, self.cast = net, hyp, cast
        self.sd = {k: v.detach().clone() for k, v in sd.items()}
        self.keys = [k for k, v in self.sd.items() if is_param(k, v)]
        self.buf = {k: torch.zeros_like(self.sd[k]) for k in self.keys}
        self.ema = {k: v.detach().clone() for k, v in self.sd.items() if v.is_floating_point()}
        self.updates = 0
        anchors = net.anchors
        self.anchors_px = [[a[i:i + 2] for i in range(0, len(a), 2)] for a in anchors]

    def step(self, images, labels, mask, lr: List[float], momentum: float):
        """One step on (B, H, W, 3) uint8 images; returns the loss (x batch)."""
        net, sd, hyp = self.net, self.sd, self.hyp
        x = images.permute(0, 3, 1, 2).float() / 255.0
        params = {k: sd[k].detach().requires_grad_() for k in self.keys}
        new_state: Dict[str, torch.Tensor] = {}
        with fp32_exact():
            raws = net.forward({**sd, **params}, x, mode="train", cast=self.cast,
                               new_state=new_state)
            strides = [x.shape[2] / r.shape[2] for r in raws]
            total, _ = ota.loss(raws, labels, mask, self.anchors_px, strides)
            grads = torch.autograd.grad(total, [params[k] for k in self.keys],
                                        allow_unused=True)
        wd, mu = hyp["weight_decay"], momentum
        with torch.no_grad():
            for k, g in zip(self.keys, grads):
                p = sd[k]
                g = torch.zeros_like(p) if g is None else g
                gid = group(k, p)
                d = g + wd * p if gid == 1 else g
                self.buf[k] = mu * self.buf[k] + d
                sd[k] = p - lr[gid] * (d + mu * self.buf[k])
            sd.update(new_state)
            self.updates += 1
            dec = hyp["ema_decay"] * (1.0 - math.exp(-self.updates / 2000.0))
            for k in self.ema:
                self.ema[k] = self.ema[k] * dec + sd[k] * (1.0 - dec)
        return float(total.detach())
