"""Inference input sources: files / dirs / globs, videos, webcam, RTSP
streams (counterpart of `yolo_series_tpu/infer/sources.py`; reference
utils/datasets.py LoadImages :133-210, LoadWebcam :213-268, LoadStreams
:271-349). Each iterates (path, letterboxed RGB array, original BGR image,
capture, ratio, (dw, dh)). Pure host code, with the port's own letterbox.

LoadStreams also counts each stream's retrieved frames and signals every
new one (`wait_frames`), so that a caller can wait for a frame with a
bounded wait instead of sleeping and polling.
"""

from __future__ import annotations

import glob
import os
import threading
import time
from pathlib import Path

import cv2
import numpy as np

from yolo_series_tpu_torch.data.augment import letterbox

IMG_FORMATS = ("bmp", "jpg", "jpeg", "png", "tif", "tiff", "dng", "webp", "mpo")
VID_FORMATS = ("mov", "avi", "mp4", "mpg", "mpeg", "m4v", "wmv", "mkv")


def _prep(img0, img_size, stride, auto=False):
    img, ratio, dwdh = letterbox(img0, img_size, stride=stride, auto=auto)
    img = img[:, :, ::-1]  # BGR -> RGB (HWC uint8)
    return np.ascontiguousarray(img), ratio, dwdh


class LoadImages:
    """Files / globs / dirs / videos iterator (reference datasets.py:133)."""

    def __init__(self, path: str, img_size=640, stride=32, auto=False):
        p = str(Path(path).absolute())
        if "*" in p:
            files = sorted(glob.glob(p, recursive=True))
        elif os.path.isdir(p):
            files = sorted(glob.glob(os.path.join(p, "*.*")))
        elif os.path.isfile(p):
            files = [p]
        else:
            raise FileNotFoundError(f"{p} does not exist")
        images = [x for x in files if x.split(".")[-1].lower() in IMG_FORMATS]
        videos = [x for x in files if x.split(".")[-1].lower() in VID_FORMATS]
        self.img_size = img_size
        self.stride = stride
        self.auto = auto
        self.files = images + videos
        self.nf = len(self.files)
        self.video_flag = [False] * len(images) + [True] * len(videos)
        self.mode = "image"
        self.cap = None
        if videos:
            self._new_video(videos[0])
        if self.nf == 0:
            raise FileNotFoundError(f"no images or videos found in {p}")

    def _new_video(self, path):
        self.frame = 0
        self.cap = cv2.VideoCapture(path)
        self.nframes = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))

    def __iter__(self):
        self.count = 0
        return self

    def __len__(self):
        return self.nf

    def __next__(self):
        if self.count == self.nf:
            raise StopIteration
        path = self.files[self.count]
        if self.video_flag[self.count]:
            self.mode = "video"
            ret, img0 = self.cap.read()
            if not ret:
                self.count += 1
                self.cap.release()
                if self.count == self.nf:
                    raise StopIteration
                self._new_video(self.files[self.count])
                ret, img0 = self.cap.read()
            self.frame += 1
        else:
            self.mode = "image"
            self.count += 1
            img0 = cv2.imread(path)
            if img0 is None:
                raise FileNotFoundError(f"image not found {path}")
        img, ratio, dwdh = _prep(img0, self.img_size, self.stride, self.auto)
        return path, img, img0, self.cap, ratio, dwdh


class LoadWebcam:
    """cv2 camera source (reference datasets.py:213)."""

    def __init__(self, pipe="0", img_size=640, stride=32):
        self.img_size = img_size
        self.stride = stride
        self.pipe = int(pipe) if str(pipe).isnumeric() else pipe
        self.cap = cv2.VideoCapture(self.pipe)
        self.cap.set(cv2.CAP_PROP_BUFFERSIZE, 3)
        self.mode = "webcam"

    def __iter__(self):
        self.count = -1
        return self

    def __len__(self):
        return 0

    def __next__(self):
        self.count += 1
        if cv2.waitKey(1) == ord("q"):
            self.cap.release()
            cv2.destroyAllWindows()
            raise StopIteration
        ret, img0 = self.cap.read()
        if not ret:
            raise RuntimeError(f"camera error {self.pipe}")
        img0 = cv2.flip(img0, 1)
        img, ratio, dwdh = _prep(img0, self.img_size, self.stride)
        return str(self.pipe), img, img0, None, ratio, dwdh


class LoadStreams:
    """Multi-RTSP/HTTP threaded grabber: one daemon thread per stream,
    keeping the latest frame (reference datasets.py:271-349 retrieves
    every 4th frame). `frames[i]` counts the frames stream i retrieved
    after the first read; `wait_frames(i, n, timeout)` waits for it to
    reach n."""

    def __init__(self, sources="streams.txt", img_size=640, stride=32):
        self.mode = "stream"
        self.img_size = img_size
        self.stride = stride
        if os.path.isfile(sources):
            with open(sources) as f:
                sources = [x.strip() for x in f.read().strip().splitlines() if x.strip()]
        else:
            sources = [sources]
        self.sources = sources
        self.imgs = [None] * len(sources)
        self.frames = [0] * len(sources)
        self._new_frame = threading.Condition()
        self.caps = []
        self.threads = []
        self._closed = False
        for i, s in enumerate(sources):
            cap = cv2.VideoCapture(int(s) if s.isnumeric() else s)
            if not cap.isOpened():
                raise RuntimeError(f"failed to open {s}")
            _, self.imgs[i] = cap.read()
            self.caps.append(cap)
            t = threading.Thread(target=self._update, args=(i, cap), daemon=True)
            t.start()
            self.threads.append(t)

    def _update(self, i, cap):
        n = 0
        while not self._closed and cap.isOpened():
            n += 1
            cap.grab()
            if n == 4:  # grab every 4th frame (reference datasets.py:318)
                ok, im = cap.retrieve()
                if ok:
                    with self._new_frame:
                        self.imgs[i] = im
                        self.frames[i] += 1
                        self._new_frame.notify_all()
                n = 0
            time.sleep(0.01)

    def wait_frames(self, i: int, n: int, timeout: float) -> bool:
        """Wait until stream i has retrieved n frames, at most `timeout`
        seconds; True when it has."""
        with self._new_frame:
            return self._new_frame.wait_for(lambda: self.frames[i] >= n, timeout)

    def close(self):
        """Stop the grabber threads and release the captures (the reference
        leaks its daemon threads, datasets.py:294-300)."""
        self._closed = True
        for t in self.threads:
            t.join(timeout=2.0)
        for cap in self.caps:
            cap.release()

    def __iter__(self):
        self.count = -1
        return self

    def __len__(self):
        return 0

    def __next__(self):
        self.count += 1
        with self._new_frame:
            img0 = [im.copy() for im in self.imgs]
        imgs, ratios, dwdhs = [], [], []
        for im in img0:
            img, ratio, dwdh = _prep(im, self.img_size, self.stride)
            imgs.append(img)
            ratios.append(ratio)
            dwdhs.append(dwdh)
        return self.sources, np.stack(imgs), img0, None, ratios, dwdhs
