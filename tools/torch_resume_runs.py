#!/usr/bin/env python
"""Relaunch interrupted training runs of the port (the counterpart of
`tools/resume_runs.py`; reference utils/aws/resume.py:13-37): find every
`last.ckpt` whose run has no `DONE` marker, and relaunch
`python -m yolo_series_tpu_torch.cli.train --resume <last.ckpt>`, which
reloads the run's options from its saved opt.yaml.

Usage: python tools/torch_resume_runs.py [--root runs/train] [--dry-run]
"""

import argparse
import pickle
import subprocess
import sys
from pathlib import Path


def find_interrupted(root: Path):
    """(last.ckpt, run dir) of each run under `root` with no DONE marker."""
    for last in sorted(Path(root).rglob("last.ckpt")):
        run_dir = last.parent.parent
        if (run_dir / "DONE").exists():
            continue
        yield last, run_dir


def resume_command(last: Path):
    """The command that resumes the run of `last`."""
    return [sys.executable, "-m", "yolo_series_tpu_torch.cli.train", "--resume", str(last)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="runs/train")
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)

    cmds = []
    for last, run_dir in find_interrupted(Path(args.root)):
        with open(last, "rb") as f:
            epoch = pickle.load(f).get("epoch", -1)
        cmd = resume_command(last)
        print(f"resuming {run_dir} from epoch {epoch}: {' '.join(cmd)}")
        cmds.append(cmd)
        if not args.dry_run:
            subprocess.run(cmd, check=False)
    return cmds


if __name__ == "__main__":
    main()
