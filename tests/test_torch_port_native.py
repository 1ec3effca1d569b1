"""The port's native loader (`data/native.py`, built from the port's own
`native/loader.cc` into build/native/) against the port's Python letterbox
(`data/augment.letterbox`, RGB) bit for bit, and against the JAX package's
native loader (`yolo_series_tpu/data/native.py`): images equal, metas
within 1e-5. Skips only where g++ or OpenCV's headers are missing."""

import shutil
from pathlib import Path

import cv2
import numpy as np
import pytest

from yolo_series_tpu_torch.data import native
from yolo_series_tpu_torch.data.augment import letterbox

SHAPES = ((480, 640), (720, 1280), (100, 150), (333, 250))
SIZE = 320


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """JPEGs and a PNG of noise at the shapes above (the 100 x 150 one is
    smaller than the letterbox: no resize, as scaleup is off), and a path
    that does not decode."""
    root = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate(SHAPES):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        img = cv2.GaussianBlur(img, (5, 5), 0)
        p = root / f"im{i}.{'png' if i == 3 else 'jpg'}"
        cv2.imwrite(str(p), img)
        paths.append(str(p))
    return paths + [str(root / "missing.jpg")]


def _need_toolchain():
    if shutil.which("g++") is None or not (native.OPENCV_INCLUDE / "opencv2").is_dir():
        pytest.skip("no g++ or no OpenCV headers: the native loader cannot be built")


@pytest.mark.parametrize("threads", [1, 4])
def test_native_batch_equals_python_letterbox(images, threads):
    """Each image bit-equal with the Python letterbox (auto off, scaleup
    off) in RGB; metas [ratio, dw, dh, h0, w0, ok] as it computes them; the
    missing file 114-grey with ok 0. The library is the port's own build
    under build/native/."""
    _need_toolchain()
    out, metas = native.load_letterbox_batch(images, SIZE, scaleup=False, n_threads=threads)
    assert native.native_available()
    so = native.library_path()
    assert so.exists() and so.parent == Path(native.BUILD_DIR)
    assert so.parent.parent.name == "build"
    assert "loaded build/native/" in native.native_status()
    assert out.shape == (len(images), SIZE, SIZE, 3) and out.dtype == np.uint8
    for i, p in enumerate(images[:-1]):
        img0 = cv2.imread(p)
        py, r, (dw, dh) = letterbox(img0, SIZE, auto=False, scaleup=False)
        np.testing.assert_array_equal(out[i], py[:, :, ::-1])
        np.testing.assert_allclose(metas[i], [r[0], dw, dh, *img0.shape[:2], 1.0], atol=1e-5)
    assert metas[-1, 5] == 0 and (out[-1] == 114).all()


def test_native_batch_equals_jax_native(images):
    """The port's batch equals the JAX package's native batch on the same
    files: images bit for bit, metas within 1e-5."""
    _need_toolchain()
    from yolo_series_tpu.data.native import load_letterbox_batch as jload
    from yolo_series_tpu.data.native import native_available as jnative_available

    if not jnative_available():
        pytest.skip("the JAX package's native loader did not build")
    got = native.load_letterbox_batch(images, SIZE, scaleup=False, n_threads=2)
    want = jload(images, SIZE, scaleup=False, n_threads=2)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=1e-5)
    up = native.load_letterbox_batch(images[2:3], SIZE, scaleup=True)
    np.testing.assert_array_equal(up[0], jload(images[2:3], SIZE, scaleup=True)[0])
    assert up[1][0, 0] > 1.0     # scaleup lets the small image grow
