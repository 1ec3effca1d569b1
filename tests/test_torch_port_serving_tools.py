"""The port's serving tools on the CPU: tools/torch_serve_http.py answering
tools/client.py (its answers equal to the engine's direct `infer` on the
same frames, letterboxed and scaled back by the same functions, bf16 and
`--int8`), tools/torch_bench_serving.py's closed-loop clients (each gets
its own frame's detections; a crossed mapping is caught), and
tools/torch_eval_int8.py (its mAPs equal to the port's `evaluate` on the
same int8 tree, and within a stated distance of the JAX package's).
Weights drawn by the port and livened (`chip_smoke.liven`), width 0.25,
128 px."""

import json
import sys
import threading
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import liven
from tests._torch_port_util import deploy_cfg, port_drawn_model
from yolo_series_tpu.data.datasets import DetectionDataset as JDataset
from yolo_series_tpu.data.datasets import create_loader as jcreate_loader
from yolo_series_tpu.eval.evaluator import evaluate as jevaluate
from yolo_series_tpu.infer import quant as jquant
from yolo_series_tpu.models import reparam as jreparam
from yolo_series_tpu_torch.data.augment import letterbox
from yolo_series_tpu_torch.eval.evaluator import scale_coords_np
from yolo_series_tpu_torch.infer import quant as tquant
from yolo_series_tpu_torch.infer.serving import ServingEngine
from yolo_series_tpu_torch.models.convert import to_jax_tree
from yolo_series_tpu_torch.models.model import apply_model
from yolo_series_tpu_torch.models.reparam import fuse_model
from yolo_series_tpu_torch.ops import nms as tnms
from yolo_series_tpu_torch.train.checkpoints import FORMAT, _dump, load_checkpoint_any

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import client  # noqa: E402  tools/client.py
import torch_bench_serving  # noqa: E402
import torch_eval_int8  # noqa: E402
import torch_serve_http  # noqa: E402

torch.set_num_threads(2)

SIZE, NC, WIDTH = 128, 3, 0.25
# mAP of the int8 eval tool against the JAX package's int8 evaluation of
# the same checkpoint: a value on a rounding boundary of x / sx rounds one
# way in one package and the other way in the other, and meets more
# boundaries downstream (tests/test_torch_port_int8.py), which moves a few
# detections' scores; on 2 val images that moves the mAPs by up to
# INT8_MAP_ATOL (measured 0.016 on map50, 0.038 on map). The fp row is held
# at the eval tests' 1e-3 (measured equal).
INT8_MAP_ATOL, FP_MAP_ATOL = 0.05, 1e-3


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A livened width-0.25 yolov7 deploy checkpoint (NC classes) in the
    JAX format, and a data root with train/ and val/ images whose val
    labels are the model's own detections, jittered (mAP neither 0 nor 1)."""
    root = tmp_path_factory.mktemp("serving_tools")
    cfg = deploy_cfg(WIDTH, nc=NC)
    # drawn by the port (`port_drawn_model`: the JAX package's eager init
    # takes ~20 s), livened as `jax_model` livens
    plan, _, state, lplan, lp, ls = port_drawn_model(cfg, seed=2)
    noise = np.random.default_rng(2).integers(0, 256, (2, SIZE, SIZE, 3))
    liven(lplan, lp, ls, torch.from_numpy(noise / 255.0).float(), candidates=40)
    params = to_jax_tree(lp)
    ckpt = root / "w.ckpt"
    _dump({"format": FORMAT, "epoch": -1, "best_fitness": 0, "results": None, "hyp": None,
           "cfg": cfg, "step": 0, "params": params, "state": state, "ema_params": None,
           "ema_state": None, "opt_state": None}, ckpt)
    tplan, tp, ts = load_checkpoint_any(str(ckpt))
    fp, fs = fuse_model(tplan, tp, ts)
    rng = np.random.default_rng(3)
    for split, n in (("train", 2), ("val", 2)):
        (root / split / "images").mkdir(parents=True)
        (root / split / "labels").mkdir()
        for i in range(n):
            h, w = 96, SIZE   # one rect batch shape: one JAX compile a model
            f = root / split / "images" / f"im{i}.jpg"
            cv2.imwrite(str(f), rng.integers(0, 256, (h, w, 3), np.uint8))
            img = cv2.imread(str(f))[:, :, ::-1]
            with torch.inference_mode():
                x = torch.from_numpy(letterbox(img, SIZE, auto=False)[0].copy())[None]
                out, _ = apply_model(tplan, fp, fs, x.float() / 255.0)
                det = tnms.nms_output_to_dets(tnms.batched_nms(out["pred"], max_det=6))[0]
            boxes = scale_coords_np((SIZE, SIZE), det[:, :4].copy(), (h, w),
                                    ((SIZE / max(h, w),) * 2, ((SIZE - w * SIZE / max(h, w)) / 2,
                                                              (SIZE - h * SIZE / max(h, w)) / 2)))
            boxes = np.clip(boxes + rng.normal(0, 1.5, boxes.shape), 0, [w, h, w, h])
            rows = [f"{int(c)} {(b[0] + b[2]) / 2 / w:.6f} {(b[1] + b[3]) / 2 / h:.6f} "
                    f"{(b[2] - b[0]) / w:.6f} {(b[3] - b[1]) / h:.6f}"
                    for b, c in zip(boxes, det[:, 5])]
            rows.append(f"{i % NC} 0.5 0.5 0.2 0.3")
            (root / split / "labels" / f"im{i}.txt").write_text("\n".join(rows))
    return root, str(ckpt), plan, params, state


def _serve(opt_args):
    opt = torch_serve_http.make_parser().parse_args(opt_args)
    plan, engine, batcher = torch_serve_http.build_engine(opt)
    server = torch_serve_http.make_server(batcher, opt.img_size, plan.names,
                                          host="127.0.0.1", port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return plan, engine, batcher, server


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_http_server_answers_as_the_engine(setup, int8):
    """Five JPEGs of other sizes through tools/client.py's `post`: each
    answer equals the engine's direct `infer` on the decoded frame,
    letterboxed and scaled back by the same functions; the JSON contract's
    keys; an undecodable body gets 400. conf 0.05: the livened model
    passes a few anchors on noise frames."""
    root, ckpt, *_ = setup
    plan, engine, batcher, server = _serve(
        ["--weights", ckpt, "--img-size", str(SIZE), "--batch-size", "2", "--device", "cpu",
         "--conf-thres", "0.05"] + (["--int8"] if int8 else []))
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        rng = np.random.default_rng(5)
        n_dets = 0
        for i, (h, w) in enumerate(((100, 140), (128, 128), (200, 90), (64, 64), (150, 170))):
            ok, buf = cv2.imencode(".jpg", rng.integers(0, 256, (h, w, 3), np.uint8))
            res = client.post(url, buf.tobytes())
            img0 = cv2.imdecode(buf, cv2.IMREAD_COLOR)
            img, ratio, dwdh = letterbox(img0, SIZE, auto=False)
            want = engine.infer(np.ascontiguousarray(img[:, :, ::-1])[None])
            n = int(want["num_dets"][0, 0])
            boxes = scale_coords_np((SIZE, SIZE), want["det_boxes"][0, :n].copy(),
                                    img0.shape[:2], ((ratio[1], ratio[0]), dwdh))
            assert res["num_dets"] == n
            assert res["det_boxes"] == json.loads(json.dumps(boxes.tolist()))
            assert res["det_scores"] == want["det_scores"][0, :n].tolist()
            assert res["det_classes"] == want["det_classes"][0, :n].tolist()
            assert res["names"] == [plan.names[int(c)] for c in res["det_classes"]]
            n_dets += n
        assert n_dets > 0
        if int8:
            assert any("wq" in str(k) for k in _keys(engine._params))
        import urllib.error
        with pytest.raises(urllib.error.HTTPError, match="400"):
            client.post(url, b"not an image")
    finally:
        server.shutdown()
        batcher.close()


def _keys(tree, prefix=""):
    if isinstance(tree, dict):
        return [k for key, v in tree.items() for k in _keys(v, f"{prefix}/{key}")] + \
            [f"{prefix}/{key}" for key in tree]
    if isinstance(tree, (list, tuple)):
        return [k for i, v in enumerate(tree) for k in _keys(v, f"{prefix}[{i}]")]
    return []


def test_http_server_dummy(setup, capsys):
    """`--dummy`: one ones-buffer through the engine, the output shapes."""
    _, ckpt, *_ = setup
    torch_serve_http.main(["--weights", ckpt, "--img-size", str(SIZE), "--batch-size", "2",
                           "--device", "cpu", "--dummy", "--low-latency"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "dummy inference OK"
    assert json.loads(out[-2])["det_boxes"] == [2, 100, 4]


def test_load_bench_maps_each_client_to_its_frame(setup):
    """Both modes on CPU engines (batch 2 and 1): every answer is checked
    against its client's frame, numbers are reported; a front end that
    hands a client another client's answer is caught."""
    _, ckpt, *_ = setup
    plan, params, state = load_checkpoint_any(ckpt)
    params, state = fuse_model(plan, params, state)
    kw = dict(img_size=SIZE, max_det=100, max_nms=256, pack_output=True, device="cpu",
              dtype=torch.float32)
    eng = ServingEngine(plan, params, state, batch_size=2, **kw)
    eng1 = ServingEngine(plan, params, state, batch_size=1, **kw)
    out = torch_bench_serving.bench(eng, eng1, clients=4, seconds=1.0, max_delay_ms=5.0)
    for mode in ("dynamic_batching_on", "dynamic_batching_off"):
        r = out[mode]
        assert r["requests"] > 0 and r["checked"] and r["p99_ms"] >= r["p50_ms"] > 0
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 255, (SIZE, SIZE, 3), np.uint8) for _ in range(2)]
    expected = [eng.infer(f[None]) for f in frames]
    assert any(int(e["num_dets"][0, 0]) for e in expected)
    crossed = {id(frames[0]): expected[1], id(frames[1]): expected[0]}
    wrong = torch_bench_serving.run_clients(
        2, 0.2, lambda f: {k: v[0] for k, v in crossed[id(f)].items()}, frames, expected)[4]
    assert wrong > 0


def _jax_metrics(plan, params, state, val_images):
    ds = JDataset(val_images, img_size=SIZE, batch_size=2, augment=False, rect=True,
                  stride=32, pad=0.5)
    loader = jcreate_loader(ds, batch_size=2, shuffle=False, max_labels=64, drop_last=False)
    r = jevaluate(plan, params, state, loader, names=torch_eval_int8.CLASS_NAMES)
    return {k: float(r[k]) for k in ("mp", "mr", "map50", "map")}


def test_eval_int8_tool_matches_evaluate_and_jax(setup):
    """The tool's int8 row equals the port's `evaluate` on the same int8
    tree (fused, calibrated on the tool's letterboxed frames, quantized);
    both rows within the stated distance of the JAX package's on the same
    checkpoint and frames."""
    root, ckpt, jplan, params, state = setup
    out = torch_eval_int8.main(["--ckpt", ckpt, "--data", str(root), "--img-size",
                                str(SIZE), "--batch-size", "2", "--calib-imgs", "2",
                                "--device", "cpu"])
    plan, tp, ts = load_checkpoint_any(ckpt)
    fp, fs = fuse_model(plan, tp, ts)
    cal = torch_eval_int8.calibration_frames(root / "train" / "images", SIZE, 2)
    q, qs = tquant.quantize_model(plan, fp, fs, tquant.calibrate(plan, fp, fs, cal))
    val = str(root / "val" / "images")
    assert out["int8"] == torch_eval_int8.metrics(plan, q, qs, val, SIZE, 2, "cpu")
    assert 0.05 < out["fp"]["map50"] < 0.999, out
    jp, js = jreparam.fuse_model(jplan, jax.tree_util.tree_map(jnp.asarray, params),
                                 jax.tree_util.tree_map(jnp.asarray, state))
    jq, jqs = jquant.quantize_model(jplan, jp, js, jquant.calibrate(jplan, jp, js, cal))
    want = {"fp": _jax_metrics(jplan, jp, js, val), "int8": _jax_metrics(jplan, jq, jqs, val)}
    for row, atol in (("fp", FP_MAP_ATOL), ("int8", INT8_MAP_ATOL)):
        for k in ("map50", "map"):
            assert abs(out[row][k] - want[row][k]) <= atol, (row, k, out[row], want[row])
