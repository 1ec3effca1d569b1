"""Label-source parsers: COCO-YOLO txt, CrowdHuman .odgt, SHEL VOC xml
(counterpart of `yolo_series_tpu/data/parsers.py`, line for line).

The reference's three label sources
(utils/datasets.py:352-355 img2label_paths, 514-529 odgt, 531-546 xml,
599-803 cache build). Parsing uses json/ElementTree — no eval() of label
lines (the reference eval()s each odgt row, datasets.py:517).
"""

from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np


def img2label_paths(img_paths: Sequence[str]) -> List[str]:
    """/images/ -> /labels/, extension -> .txt (reference datasets.py:352)."""
    sa, sb = os.sep + "images" + os.sep, os.sep + "labels" + os.sep
    return ["txt".join(x.replace(sa, sb, 1).rsplit(x.split(".")[-1], 1))
            for x in img_paths]


def parse_yolo_txt(path: str):
    """One YOLO label file -> (labels (n, 5) [cls, x, y, w, h] normalized,
    segments list). Rows longer than 5 are polygon segments
    (reference datasets.py:612-621)."""
    segments = []
    if not os.path.isfile(path):
        return np.zeros((0, 5), np.float32), segments
    with open(path) as f:
        rows = [x.split() for x in f.read().strip().splitlines() if len(x)]
    if any(len(x) > 8 for x in rows):  # segment rows
        classes = np.array([x[0] for x in rows], np.float32)
        segments = [np.array(x[1:], np.float32).reshape(-1, 2) for x in rows]
        boxes = np.array([_segment2box(s) for s in segments], np.float32)
        labels = np.concatenate((classes.reshape(-1, 1), boxes), 1)
    else:
        labels = (np.array(rows, np.float32) if rows
                  else np.zeros((0, 5), np.float32))
    if len(labels):
        if labels.shape[1] != 5:
            raise ValueError(f"> 5 label columns: {path}")
        if not (labels >= 0).all():
            raise ValueError(f"negative labels: {path}")
        if not (labels[:, 1:] <= 1).all():
            raise ValueError(f"non-normalized coords: {path}")
        _, keep = np.unique(labels, axis=0, return_index=True)
        labels = labels[np.sort(keep)]
    return labels.astype(np.float32), segments


def _segment2box(seg):
    x, y = seg[:, 0], seg[:, 1]
    x1, y1, x2, y2 = x.min(), y.min(), x.max(), y.max()
    return [(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1]


def parse_crowdhuman_odgt(odgt_paths: Sequence[str]) -> Dict[str, list]:
    """CrowdHuman .odgt (JSON lines) -> {image_id: [(hbox, vbox), ...]}.

    Keeps instances with tag == 'person'; hbox = head box, vbox = visible
    person region, both [x, y, w, h] pixels (reference datasets.py:514-529).
    """
    out: Dict[str, list] = {}
    for path in odgt_paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                boxes = [(g["hbox"], g["vbox"]) for g in rec.get("gtboxes", [])
                         if g.get("tag") == "person"]
                out[rec["ID"]] = boxes
    return out


SHEL_CLASS_MAP = {  # reference datasets.py:707-724
    "person_no_helmet": 0,
    "person_with_helmet": 80,
    "head": 81,
    "head_with_helmet": 82,
}
CROWDHUMAN_PERSON_CLS = 0
CROWDHUMAN_HEAD_CLS = 81


def parse_shel_xml(xml_paths: Sequence[str]) -> Dict[str, list]:
    """SHEL VOC xml files -> {image_id: [[x1, y1, x2, y2, class_name], ...]}."""
    out: Dict[str, list] = {}
    for path in xml_paths:
        root = ET.parse(path).getroot()
        fname = None
        objs = []
        for child in root:
            if child.tag == "filename":
                fname = Path(child.text).stem
            elif child.tag == "object":
                name = child.find("name").text
                bb = child.find("bndbox")
                objs.append([float(bb.find("xmin").text),
                             float(bb.find("ymin").text),
                             float(bb.find("xmax").text),
                             float(bb.find("ymax").text), name])
        if fname is not None:
            out[fname] = objs
    return out


def shel_labels(objs, width, height) -> np.ndarray:
    """VOC objects -> (n, 5) [cls, x, y, w, h] normalized (reference
    datasets.py:707-742): unknown classes skipped, boxes clipped."""
    rows = []
    for x1, y1, x2, y2, name in objs:
        if name not in SHEL_CLASS_MAP:
            continue
        cls = SHEL_CLASS_MAP[name]
        x1, y1 = max(0.0, x1), max(0.0, y1)
        x2, y2 = min(width, x2), min(height, y2)
        rows.append([cls, (x1 + x2) / 2 / width, (y1 + y2) / 2 / height,
                     (x2 - x1) / width, (y2 - y1) / height])
    return (np.array(rows, np.float32) if rows
            else np.zeros((0, 5), np.float32))


def crowdhuman_labels(boxes, width, height) -> np.ndarray:
    """CrowdHuman instances -> person (cls 0) + head (cls 81) rows, matching
    the reference's center/size computation incl. its size clamping
    (datasets.py:744-783)."""
    rows = []
    for hbox, vbox in boxes:
        for cls, (bx, by, bw, bh) in ((CROWDHUMAN_PERSON_CLS, vbox),
                                      (CROWDHUMAN_HEAD_CLS, hbox)):
            w = min(width, bw)
            h = min(height, bh)
            cx = bx + bw / 2
            cy = by + bh / 2
            rows.append([cls, cx / width, cy / height, w / width, h / height])
    # reference appends person rows then head rows per instance in order
    # person, head — keep interleaved per instance (same set of rows)
    return (np.array(rows, np.float32) if rows
            else np.zeros((0, 5), np.float32))
