"""A benchmark cell at a tiny size on the CPU, for the tests: the
configuration's channels cut by `div`, its image side `img`, the mix's
sizes small, and the harness's CUDA calls made no-ops; the harness's look
for a card is skipped. Used as a context manager."""

from __future__ import annotations

import contextlib
import copy

import torch

from benchmark.harness import common

SMALL_MIX = {"batch": 2, "pool": 8, "warmup_s": 0.2, "batches": 4, "label_pad": 32}


def tiny_cfg(cfg: dict, div: int = 8, img: int = 128) -> dict:
    """Each block's width cut by `div` and rounded up to a multiple of 8, as
    the program rounds a width (`make_divisible`) and the reference takes
    it as it stands: so both build the same shapes, a downc's halves stay
    whole, and the two inputs of a shortcut, cut alike, keep equal widths."""
    cfg = copy.deepcopy(cfg)
    for key in ("cfg_deploy", "cfg_training"):
        for row in cfg.get(key, {}).get("backbone", []) + cfg.get(key, {}).get("head", []):
            if row[2] in ("conv", "repconv", "sppcspc", "downc"):
                row[3][0] = 8 * max(1, -(-row[3][0] // (8 * div)))
    cfg["img"] = img
    return cfg


@contextlib.contextmanager
def tiny(monkeypatch, div: int = 8, img: int = 128):
    monkeypatch.setattr(common, "DEVICE", "cpu")
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a, **k: "cpu")
    monkeypatch.setattr(common, "check_device", lambda chips: None)
    cell = common.cell

    def small(name):
        wl, cfg, mix = cell(name)
        mix = {k: SMALL_MIX.get(k, v) if k in SMALL_MIX else v for k, v in mix.items()}
        return wl, tiny_cfg(cfg, div, img), mix

    monkeypatch.setattr(common, "cell", small)
    yield
