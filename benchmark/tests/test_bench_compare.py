"""The detection comparison on a small hand-made case: an exact greedy-NMS
answer reads 0, and each kind of wrong answer reads a gap."""

import numpy as np
import pytest
import torch

from benchmark.harness import compare

NMS = {"iou_thres": 0.45, "conf_thres": 0.25, "max_det": 100, "max_nms": 1024}


def _case():
    boxes = torch.tensor([[10, 10, 50, 50], [12, 12, 52, 52], [100, 100, 140, 160],
                          [200, 20, 230, 90], [300, 300, 301, 301]], dtype=torch.float64)
    scores = torch.zeros(5, 80, dtype=torch.float64)
    scores[0, 3], scores[1, 3], scores[2, 7], scores[3, 7], scores[4, 1] = 0.9, 0.8, 0.7, 0.6, 0.2
    return boxes, scores


def _served(rows):
    n = len(rows)
    out = {"num_dets": np.array([n], np.int32), "det_boxes": np.zeros((100, 4), np.float32),
           "det_scores": np.zeros(100, np.float32), "det_classes": np.zeros(100, np.int32)}
    for i, (b, s, c) in enumerate(rows):
        out["det_boxes"][i], out["det_scores"][i], out["det_classes"][i] = b, s, c
    return out


EXACT = [([10, 10, 50, 50], 0.9, 3), ([100, 100, 140, 160], 0.7, 7), ([200, 20, 230, 90], 0.6, 7)]


def test_greedy_nms_answer_reads_zero():
    g = compare.detection_gaps(_served(EXACT), *_case(), NMS)
    assert g["det"] < 1e-6 and g["overlap"] == 0 and g["unexplained"] == 0 and g["must"] == 4


@pytest.mark.parametrize("rows,kind", [
    ([(EXACT[0][0], EXACT[0][1], 4)] + EXACT[1:], "det"),               # another class
    ([([10, 10, 50, 58], 0.9, 3)] + EXACT[1:], "det"),                 # a moved box
    (EXACT + [([12, 12, 52, 52], 0.8, 3)], "overlap"),                 # not suppressed
    (EXACT[:2], "unexplained"),                                        # an answer missing
])
def test_wrong_answers_read_a_gap(rows, kind):
    g = compare.detection_gaps(_served(rows), *_case(), NMS)
    assert g[kind] > 0.1, g
    assert compare.widest([g], NMS["iou_thres"])["det_gap"] > 0.1


def test_a_non_finite_answer_fails_every_limit():
    rows = [([float("nan"), 10, 50, 50], 0.9, 3)] + EXACT[1:]
    g = compare.detection_gaps(_served(rows), *_case(), NMS)
    assert compare.widest([g], NMS["iou_thres"])["det_gap"] >= compare.NOT_FINITE
