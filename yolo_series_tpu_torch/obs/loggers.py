"""Experiment logging facade (counterpart of `yolo_series_tpu/obs/loggers.py`):
console + results.jsonl + optional TensorBoard / Weights & Biases
(reference utils/wandb_logging/ + train.py:447-453 TB scalars + results.txt
append, train.py:441-442).

The jsonl record is always written. TensorBoard and W&B are optional, as in
the JAX package: a missing package disables its sink, and
`log_dataset_artifact` is a no-op without wandb.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, Optional


def setup_logging(rank: int = 0, verbose: bool = True):
    """Root logging config by process rank (reference general.py:34-37)."""
    logging.basicConfig(
        format="%(message)s",
        level=logging.INFO if (verbose and rank in (-1, 0)) else logging.WARNING)


class ExperimentLogger:
    """Unified scalar/image logging to console, results.jsonl, TB, W&B."""

    def __init__(self, save_dir, use_tb: bool = True, use_wandb: bool = False,
                 wandb_project: str = "yolo-series-tpu", run_name: Optional[str] = None,
                 config: Optional[dict] = None, resume_id: Optional[str] = None,
                 entity: Optional[str] = None):
        self.save_dir = Path(save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.results_file = self.save_dir / "results.jsonl"
        self.tb = None
        self.wandb_run = None

        if use_tb:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.tb = SummaryWriter(log_dir=str(self.save_dir / "tb"))
            except Exception as e:  # noqa: BLE001
                logging.info(f"tensorboard disabled: {e}")
        if use_wandb:
            try:
                import wandb
                self.wandb_run = wandb.init(
                    project=wandb_project, name=run_name, config=config,
                    id=resume_id, resume="allow", entity=entity)
            except Exception as e:  # noqa: BLE001
                logging.info(f"wandb disabled: {e}")

    @property
    def wandb_id(self):
        return self.wandb_run.id if self.wandb_run else None

    def log_scalars(self, scalars: Dict[str, float], step: int):
        with open(self.results_file, "a") as f:
            f.write(json.dumps({"step": step, **scalars}) + "\n")
        if self.tb:
            for k, v in scalars.items():
                if isinstance(v, (int, float)):
                    self.tb.add_scalar(k, v, step)
        if self.wandb_run:
            self.wandb_run.log(scalars, step=step)

    def log_image(self, tag: str, path, step: int = 0):
        if self.wandb_run:
            import wandb
            self.wandb_run.log({tag: wandb.Image(str(path))}, step=step)

    def log_model_artifact(self, ckpt_path, name="model", metadata=None,
                           aliases=("latest",)):
        """Model artifact (reference wandb_utils.py:179-191): always stored
        in the LOCAL versioned store (obs/artifacts.py — works with zero
        egress, supports artifact:// resume), mirrored to W&B if live."""
        from yolo_series_tpu_torch.obs.artifacts import ArtifactStore
        store = ArtifactStore(self.save_dir / "artifacts")
        vdir = store.log(name, [ckpt_path], metadata=metadata,
                         aliases=aliases, type="model")
        if self.wandb_run:
            import wandb
            art = wandb.Artifact(name=name, type="model", metadata=metadata or {})
            art.add_file(str(ckpt_path))
            self.wandb_run.log_artifact(art, aliases=list(aliases))
        return vdir

    def finish(self):
        if self.tb:
            self.tb.close()
        if self.wandb_run:
            self.wandb_run.finish()


def log_dataset_artifact(data_yaml: str, project: str = "yolo-series-tpu"):
    """Upload a dataset as a W&B artifact (reference log_dataset.py +
    wandb_utils.py:193-261). No-op, returning None, when wandb is
    unavailable."""
    try:
        import wandb
        import yaml
    except Exception as e:  # noqa: BLE001
        logging.info(f"log_dataset skipped: {e}")
        return None
    with open(data_yaml) as f:
        data = yaml.safe_load(f)
    run = wandb.init(project=project, job_type="dataset")
    art = wandb.Artifact(name=Path(data_yaml).stem, type="dataset", metadata=data)
    for split in ("train", "val"):
        p = data.get(split)
        if p and Path(p).exists():
            (art.add_dir if Path(p).is_dir() else art.add_file)(str(p))
    run.log_artifact(art)
    run.finish()
    return art
