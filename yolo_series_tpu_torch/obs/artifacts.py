"""Local, versioned artifact store (counterpart of
`yolo_series_tpu/obs/artifacts.py`, the same layout, so either package
reads the other's store) — the offline half of the reference's W&B
artifact pipeline (wandb_utils.py:159-261: model up/download with resume
metadata, dataset artifacts with rewritten data yamls).

Layout: <root>/<name>/v<N>/files..., metadata.json; alias files
<root>/<name>/<alias> containing the version dir name. References use the
reference's prefix scheme (`WANDB_ARTIFACT_PREFIX`):

    artifact://<name>[:<alias-or-vN>]    (default alias: latest)
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

ARTIFACT_PREFIX = "artifact://"


class ArtifactStore:
    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    # -- write --------------------------------------------------------------

    def log(self, name: str, files: Sequence[str | Path],
            metadata: Optional[dict] = None,
            aliases: Sequence[str] = ("latest",),
            type: str = "model") -> Path:
        """Store files as a new version of `name`; returns the version dir."""
        base = self.root / name
        base.mkdir(parents=True, exist_ok=True)
        n = 1 + max((int(d.name[1:]) for d in base.glob("v*")
                     if d.name[1:].isdigit()), default=-1)
        vdir = base / f"v{n}"
        vdir.mkdir()
        for f in files:
            f = Path(f)
            if f.is_dir():
                shutil.copytree(f, vdir / f.name)
            else:
                shutil.copyfile(f, vdir / f.name)
        meta = dict(metadata or {})
        meta.setdefault("type", type)
        (vdir / "metadata.json").write_text(json.dumps(meta, indent=1))
        for a in aliases:
            if a:
                (base / a).write_text(vdir.name)
        return vdir

    # -- read ---------------------------------------------------------------

    def resolve(self, ref: str) -> Tuple[Path, Dict]:
        """artifact://name[:alias] -> (version dir, metadata)."""
        if not ref.startswith(ARTIFACT_PREFIX):
            raise ValueError(f"not an {ARTIFACT_PREFIX} reference: {ref}")
        spec = ref[len(ARTIFACT_PREFIX):]
        name, _, alias = spec.partition(":")
        alias = alias or "latest"
        base = self.root / name
        if (base / alias).is_dir():  # direct version ref like :v3
            vdir = base / alias
        else:
            ptr = base / alias
            if not ptr.is_file():
                raise FileNotFoundError(f"no artifact {ref} under {self.root}")
            vdir = base / ptr.read_text().strip()
        meta = {}
        mf = vdir / "metadata.json"
        if mf.exists():
            meta = json.loads(mf.read_text())
        return vdir, meta


def log_model_artifact(store: ArtifactStore, ckpt_path, run_id: str,
                       epoch: int, total_epochs: int, fitness_score: float,
                       best: bool = False) -> Path:
    """Model artifact with resume metadata (wandb_utils.py log_model,
    :179-191)."""
    aliases = ["latest", f"epoch{epoch}"] + (["best"] if best else [])
    return store.log(
        f"run_{run_id}_model", [ckpt_path],
        metadata={"epochs_trained": epoch + 1, "total_epochs": total_epochs,
                  "fitness_score": fitness_score,
                  "original_path": str(ckpt_path)},
        aliases=aliases, type="model")


def download_model_artifact(store: ArtifactStore, ref: str):
    """Resolve an artifact resume ref -> (ckpt path, metadata); enforces the
    reference's finished-run guard (wandb_utils.py:168-177)."""
    vdir, meta = store.resolve(ref)
    trained = meta.get("epochs_trained")
    total = meta.get("total_epochs")
    if trained is not None and total is not None and trained >= total:
        raise RuntimeError(
            f"training to {total} epochs is finished, nothing to resume")
    ckpts = sorted(vdir.glob("*.ckpt")) + sorted(vdir.glob("*.pt"))
    if not ckpts:
        raise FileNotFoundError(f"no checkpoint in artifact {ref}")
    return ckpts[0], meta


def log_dataset_artifact(store: ArtifactStore, data_yaml: str | Path,
                         name: Optional[str] = None) -> Path:
    """Dataset artifact: images + labels + a REWRITTEN data yaml whose
    train/val entries point into the artifact (the reference's
    `_wandb.yaml` flow, wandb_utils.py:193-218)."""
    import yaml

    from yolo_series_tpu_torch.data.parsers import img2label_paths

    data_yaml = Path(data_yaml)
    with open(data_yaml) as f:
        data = yaml.safe_load(f)
    name = name or data_yaml.stem
    base = store.root / name
    base.mkdir(parents=True, exist_ok=True)
    n = 1 + max((int(d.name[1:]) for d in base.glob("v*")
                 if d.name[1:].isdigit()), default=-1)
    vdir = base / f"v{n}"
    (vdir / "data" / "images").mkdir(parents=True)
    (vdir / "data" / "labels").mkdir(parents=True)
    new_data = dict(data)
    for split in ("train", "val", "test"):
        src = data.get(split)
        if not src:
            continue
        if Path(src).is_dir():
            imgs = sorted(str(p) for p in Path(src).rglob("*")
                          if p.suffix.lower().lstrip(".") in
                          ("jpg", "jpeg", "png", "bmp", "webp"))
        else:
            imgs = [l.strip() for l in Path(src).read_text().splitlines()
                    if l.strip()]
        rel_list = []
        for im in imgs:
            dst = vdir / "data" / "images" / Path(im).name
            if not dst.exists():
                shutil.copyfile(im, dst)
            lb = Path(img2label_paths([im])[0])
            if lb.exists():
                shutil.copyfile(lb, vdir / "data" / "labels" / lb.name)
            rel_list.append(str(dst))
        lst = vdir / f"{split}.txt"
        lst.write_text("\n".join(rel_list))
        new_data[split] = str(lst)
    with open(vdir / "data.yaml", "w") as f:
        yaml.safe_dump(new_data, f)
    (vdir / "metadata.json").write_text(json.dumps(
        {"type": "dataset", "source": str(data_yaml),
         "nc": data.get("nc"), "names": data.get("names")}, indent=1))
    (base / "latest").write_text(vdir.name)
    return vdir


def download_dataset_artifact(store: ArtifactStore, ref: str) -> Path:
    """Resolve a dataset artifact ref -> path of its rewritten data.yaml
    (wandb_utils.py:159-166)."""
    vdir, _ = store.resolve(ref)
    y = vdir / "data.yaml"
    if not y.exists():
        raise FileNotFoundError(f"artifact {ref} has no data.yaml")
    return y
