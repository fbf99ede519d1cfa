"""Collect the concept-count sweep's results into a markdown table (a copy
of scripts/science_table.py).

    python -m multimodal_concept_learning_tpu_torch.scripts.science_table [SWEEP_ROOT]

Walks a sweep root (``<root>/<name>/{train,gen,gen_int8,gen_int4,
analysis}.log`` beside ``<root>/<name>/mm.yaml``) and prints one row a
sweep point: classes, data volume, best val loss, the generation-based
yes/no accuracy (and its int8 / int4 spot checks when present) and the
RGB-vs-embedding Pearson r.  Unlike the original it reads a point's
``dataset.yaml`` with ``miniyaml`` (no PyYAML), counts each point's classes
once, and prints "—" for classes it cannot read (a missing or malformed
``dataset.yaml``), as for every other missing value.
"""

from __future__ import annotations

import os
import re
import sys

from multimodal_concept_learning_tpu_torch import miniyaml


def _grep(path, pattern):
    try:
        with open(path) as f:
            hits = re.findall(pattern, f.read())
        return hits[-1] if hits else None
    except OSError:
        return None


def _classes(root: str, name: str):
    """The point's class count: from its name (``<N>_colors...``), else the
    colors of its prepared ``dataset.yaml``; None when neither is readable."""
    m = re.match(r"(\d+)_colors", name)
    if m:
        return int(m.group(1))
    try:
        with open(os.path.join(root, name, "dataset.yaml")) as f:
            return len(miniyaml.safe_load(f)["colors"])
    except (OSError, ValueError, KeyError, TypeError):
        return None


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    root = argv[0] if argv else "/tmp/sweep"
    names = [n for n in os.listdir(root)
             if os.path.isdir(os.path.join(root, n))
             and os.path.exists(os.path.join(root, n, "mm.yaml"))]
    classes = {n: _classes(root, n) for n in names}
    names.sort(key=lambda n: classes[n] or 0)
    rows = []
    for n in names:
        d = os.path.join(root, n)
        imgs = _grep(os.path.join(d, "train.log"), r"(\d+) train samples")
        best = _grep(os.path.join(d, "train.log"), r"Best val loss: ([\d.]+)")
        acc = _grep(os.path.join(d, "gen.log"), r"Yes/No Accuracy: ([\d.]+)%")
        acc8 = _grep(os.path.join(d, "gen_int8.log"), r"Yes/No Accuracy: ([\d.]+)%")
        acc4 = _grep(os.path.join(d, "gen_int4.log"), r"Yes/No Accuracy: ([\d.]+)%")
        r = _grep(os.path.join(d, "analysis.log"),
                  r"Pearson correlation coefficient: (-?[\d.]+)")
        rows.append((classes[n], imgs, best, acc, acc8, acc4, r))

    print("| classes | imgs/class split | best val loss | yes/no acc "
          "(generate) | int8 | int4 | Pearson r |")
    print("|---|---|---|---|---|---|---|")
    for classes_n, imgs, best, acc, acc8, acc4, r in rows:
        fmt = lambda v, suf="": f"{v}{suf}" if v is not None else "—"  # noqa: E731
        print(f"| {fmt(classes_n)} | {fmt(imgs)} | {fmt(best)} | {fmt(acc, '%')} "
              f"| {fmt(acc8, '%')} | {fmt(acc4, '%')} | {fmt(r)} |")
    return rows


if __name__ == "__main__":
    main()
