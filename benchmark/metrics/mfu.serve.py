"""The served forward's share of the card's bf16 peak: the deploy form's
operations an image (the configuration's frozen count) times the images
a second of the traced run's untraced part, over 989 TFLOP/s, in percent
(kind "batch")."""

from benchmark.harness.flops import PEAK_BF16_FLOPS


def read(r):
    if r.get("kind") != "batch" or not r.get("untraced_s"):
        return None
    rate = r["untraced_images"] / r["untraced_s"]
    return 100.0 * r["config"]["counted"]["gflops_deploy"] * 1e9 * rate / PEAK_BF16_FLOPS
