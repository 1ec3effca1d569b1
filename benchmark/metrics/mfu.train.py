"""The train step's share of the card's bf16 peak: 3 x the training form's
forward operations an image (the configuration's frozen count; a
recomputed operation counts nothing) times the images a second of the
traced run's untraced part, over 989 TFLOP/s, in percent (kind "train")."""

from benchmark.harness.flops import PEAK_BF16_FLOPS


def read(r):
    if r.get("kind") != "train" or not r.get("untraced_s"):
        return None
    rate = r["untraced_images"] / r["untraced_s"]
    return 100.0 * 3 * r["config"]["counted"]["gflops_training"] * 1e9 * rate / PEAK_BF16_FLOPS
