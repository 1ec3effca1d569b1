"""Hyperparameter evolution of the port (`yolo_series_tpu_torch/train/
evolve.py`) against the JAX package's (`yolo_series_tpu/train/evolve.py`)
on the CPU: the meta-table, `mutate` under equal seeds (the port's explicit
generators against JAX's global `random` and `np.random`) with and without
an evolve.txt and with both parent selections, `append_result`'s rows, and
`cli/train.py --evolve --evolve-gens 2` end to end on a tiny set."""

import random
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from tests._torch_port_util import training_cfg
from tests.test_torch_port_trainer import _write_set
from yolo_series_tpu.train import evolve as jevolve
from yolo_series_tpu_torch.cli import train as cli_train
from yolo_series_tpu_torch.train import evolve
from yolo_series_tpu_torch.train.trainer import DEFAULT_TRAIN_HYP

torch.set_num_threads(2)

KEYS = list(evolve.EVOLVE_META)


def test_meta_table_matches_jax():
    """The same keys in the same order (evolve.txt's columns), gains and
    bounds, every bound ordered."""
    assert list(jevolve.EVOLVE_META) == KEYS
    assert evolve.EVOLVE_META == jevolve.EVOLVE_META
    assert all(lo <= hi for _, lo, hi in evolve.EVOLVE_META.values())


def _evolve_txt(path, rows, seed):
    """`rows` rows of 4 metrics in [0, 1] and a hyp value a key, drawn in
    its bounds."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.uniform(0, 1, (rows, 4)),
                        np.stack([rng.uniform(lo, hi, rows) for _, lo, hi in
                                  evolve.EVOLVE_META.values()], 1)], 1)
    np.savetxt(path, x)
    return path


def _method(seed):
    """The parent selection `mutate` draws first from a generator seeded
    with `seed`."""
    return random.Random(seed).choice(["single", "weighted"])


SEEDS = range(6)


def test_seeds_cover_both_selections():
    assert {_method(s) for s in SEEDS} == {"single", "weighted"}


@pytest.mark.parametrize("rows", [0, 1, 6])
@pytest.mark.parametrize("seed", SEEDS)
def test_mutate_matches_jax(tmp_path, rows, seed):
    """With no evolve.txt (the hyp clipped to the bounds), one row (the
    single parent, whatever the draw) and six (the top five; the single
    or the weighted parent as the seed draws it): the port's hyp equals
    JAX's exactly, and every value lies in its bounds."""
    txt = (_evolve_txt(tmp_path / "evolve.txt", rows, seed) if rows
           else tmp_path / "evolve.txt")
    hyp = dict(DEFAULT_TRAIN_HYP, lr0=0.5, momentum=0.1)   # two values out of bounds
    random.seed(seed)
    np.random.seed(seed)
    want = jevolve.mutate(hyp, txt)
    got = evolve.mutate(hyp, txt, random.Random(seed), np.random.RandomState(seed))
    assert got == want
    for k, (_, lo, hi) in evolve.EVOLVE_META.items():
        assert lo <= got[k] <= hi, k
    assert got["loss_ota"] == hyp["loss_ota"]   # a key outside the table stays
    if rows:
        assert got != evolve.mutate(hyp, Path(tmp_path / "none.txt"), random.Random(seed),
                                    np.random.RandomState(seed))


def test_append_result_rows_are_text_equal(tmp_path):
    hyp = dict(DEFAULT_TRAIN_HYP, lr0=0.0123456789, box=0.05)
    del hyp["fl_gamma"]   # a key the hyp lacks is written as 0
    for mod, name in ((evolve, "port.txt"), (jevolve, "jax.txt")):
        mod.append_result(tmp_path / name, [0.5, 0.25, 0.125, 1 / 3], hyp)
        mod.append_result(tmp_path / name, [1e-7, 0, 1, 0.1], dict(hyp, box=2e-5))
    text = (tmp_path / "port.txt").read_text()
    assert text == (tmp_path / "jax.txt").read_text()
    assert [len(r.split()) for r in text.splitlines()] == [4 + len(KEYS)] * 2


def test_evolve_cli_two_generations(tmp_path):
    """`cli/train.py --evolve --evolve-gens 2` (1 epoch a generation, on
    the CPU): evolve.txt holds one row a generation of the 4 metrics and
    the 29 meta keys, every value finite and within its bounds, the second
    generation mutated from the first; hyp_evolved.yaml is the best
    generation's hyp."""
    root = tmp_path / "set"
    _write_set(root / "train", 2, 7, ((96, 128), (128, 112)))
    _write_set(root / "val", 2, 8, ((120, 160), (128, 128)))
    (root / "data.yaml").write_text(yaml.dump({
        "train": str(root / "train" / "images"), "val": str(root / "val" / "images"),
        "nc": 3, "names": ["a", "b", "c"]}))
    (root / "model.yaml").write_text(yaml.dump(training_cfg(0.25, nc=3)))
    best = cli_train.main([
        "--cfg", str(root / "model.yaml"), "--data", str(root / "data.yaml"),
        "--epochs", "1", "--batch-size", "2", "--nbs", "2", "--img-size", "128",
        "--max-labels", "16", "--device", "cpu", "--evolve", "--evolve-gens", "2",
        "--project", str(tmp_path / "runs"), "--name", "evo"])
    d = tmp_path / "runs" / "evo"
    x = np.loadtxt(d / "evolve.txt", ndmin=2)
    assert x.shape == (2, 4 + len(KEYS)) and np.all(np.isfinite(x))
    for i, (_, lo, hi) in enumerate(evolve.EVOLVE_META.values()):
        assert np.all((lo - 1e-9 <= x[:, 4 + i]) & (x[:, 4 + i] <= hi + 1e-9)), KEYS[i]
    assert not np.allclose(x[0, 4:], x[1, 4:])
    fit = 0.1 * x[:, 2] + 0.9 * x[:, 3]
    evolved = yaml.safe_load((d / "hyp_evolved.yaml").read_text())
    np.testing.assert_allclose([evolved[k] for k in KEYS], x[int(np.argmax(fit)), 4:],
                               rtol=1e-4)
    assert best[1] == evolved and sorted(p.name for p in d.glob("gen*")) == ["gen000", "gen001"]
