#!/usr/bin/env python
"""Convert a reference-format model cfg YAML into the canonical cfg format
of the port (lowercase module names, plain activation strings, flow-style
rows); the counterpart of `tools/convert_cfg.py`, through the port's own
`models/graph._REF_NAMES` and `models/layers.get_activation`. The graph's
topology is kept exactly; only its encoding changes.

Usage: python tools/torch_convert_cfg.py <src.yaml> <dst.yaml>
       python tools/torch_convert_cfg.py --all <src_dir> <dst_dir>
"""

import sys
from pathlib import Path

import yaml

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from yolo_series_tpu_torch.models.graph import _REF_NAMES  # noqa: E402
from yolo_series_tpu_torch.models.layers import get_activation  # noqa: E402


def _norm_arg(a):
    if isinstance(a, str):
        if a.startswith("nn."):
            return get_activation(a)[0]
        if a == "None":  # the reference relies on eval('None') at parse time
            return None
        if a in ("True", "False"):
            return a == "True"
    return a


def convert(src) -> dict:
    """A reference-format cfg (a path, or the loaded dict) -> the canonical
    dict: nc, depth_multiple, width_multiple, anchors, and each backbone and
    head row [from, n, module, args] with its module name and arguments
    normalized."""
    if isinstance(src, (str, Path)):
        with open(src) as f:
            d = yaml.safe_load(f)
    else:
        d = src
    out = {}
    for k in ("nc", "depth_multiple", "width_multiple", "anchors"):
        if k in d:
            out[k] = d[k]
    for section in ("backbone", "head"):
        out[section] = [[f, n, _REF_NAMES.get(m, str(m).lower()), [_norm_arg(a) for a in args]]
                        for f, n, m, args in d[section]]
    return out


class _FlowRow(list):
    pass


def _flow_row_representer(dumper, data):
    return dumper.represent_sequence("tag:yaml.org,2002:seq", data, flow_style=True)


yaml.add_representer(_FlowRow, _flow_row_representer)


def dump(cfg: dict, dst):
    """Write `cfg` with one flow-style row a layer and an anchor level."""
    cfg = dict(cfg)
    for section in ("backbone", "head"):
        cfg[section] = [_FlowRow(r) for r in cfg[section]]
    cfg["anchors"] = [_FlowRow(a) for a in cfg["anchors"]]
    with open(dst, "w") as f:
        yaml.dump(cfg, f, sort_keys=False, width=120)


def main(argv=None):
    args = sys.argv[1:] if argv is None else argv
    if args and args[0] == "--all":
        src_dir, dst_dir = Path(args[1]), Path(args[2])
        dst_dir.mkdir(parents=True, exist_ok=True)
        for p in sorted(src_dir.rglob("*.yaml")):
            dst = dst_dir / p.relative_to(src_dir)
            dst.parent.mkdir(parents=True, exist_ok=True)
            try:
                dump(convert(p), dst)
                print(f"converted {p} -> {dst}")
            except Exception as e:  # noqa: BLE001 — one bad file skips, the rest convert
                print(f"SKIP {p}: {e}")
    else:
        dump(convert(args[0]), args[1])


if __name__ == "__main__":
    main()
