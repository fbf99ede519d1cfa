"""Multi-token color-name embedding exploration (a copy of
multimodal_concept_learning_tpu/analysis/multi_token_embedding.py, the
script form of the reference's
random_experiments/multi_token_embedding/multi_token.ipynb).

    python -m multimodal_concept_learning_tpu_torch.analysis.multi_token_embedding \
        [--model_path models/] [--colors_path colors.txt] [--output_dir D]

The notebook loads a pretrained LM's embedding matrix, parses ~950
XKCD-style ``name\\thex`` color entries, computes the mean of subword-token
embeddings per color name, unit-normalizes, and renders PCA-3D / UMAP-3D
interactive scatters colored by the true RGB (SURVEY.md C15).

Offline adaptation: the color list comes from matplotlib's built-in
XKCD survey palette (954 named colors) — or a user-supplied ``colors.txt``
with the same ``name\\thex`` format — and the embedding matrix comes from a
framework checkpoint (``--model_path`` pointing at a results ``models/`` dir
or a .pt file) or a freshly initialized LM when none is given.

The port's copy runs on numpy alone: PCA from ``analysis/projection.py``,
checkpoints through the port's ``checkpoint.load_state_dict``.  matplotlib
supplies the XKCD table and draws the figures; without it ``--colors_path``
is required, and the figures are skipped with one printed line.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Tuple

import numpy as np

from multimodal_concept_learning_tpu_torch.analysis.projection import Projector, pca
from multimodal_concept_learning_tpu_torch.analysis.token_embedding_analysis import (
    FIGURES_SKIPPED,
    pyplot,
)
from multimodal_concept_learning_tpu_torch.tokenizer import ConceptTokenizer, load_tokenizer

EMBED_KEY = "language_model.model.embed_tokens.weight"


def load_color_table(colors_path: str | None) -> List[Tuple[str, str]]:
    """(name, '#rrggbb') pairs from a colors.txt file or matplotlib's XKCD set."""
    if colors_path:
        pairs = []
        with open(colors_path) as f:
            for line in f:
                if "\t" in line:
                    name, hex_code = line.strip().split("\t")
                    pairs.append((name, hex_code))
        return pairs
    try:
        from matplotlib.colors import XKCD_COLORS
    except ImportError:
        raise ValueError("matplotlib is not installed, so its XKCD color table is not "
                         "available: pass --colors_path (name\\thex lines)") from None
    return [(name.removeprefix("xkcd:"), hex_code) for name, hex_code in XKCD_COLORS.items()]


def hex_to_rgb(hex_code: str) -> Tuple[float, float, float]:
    h = hex_code.lstrip("#")
    return tuple(int(h[i : i + 2], 16) / 255.0 for i in (0, 2, 4))


def load_embedding_matrix(model_path: str | None, tokenizer) -> np.ndarray:
    if model_path:
        from multimodal_concept_learning_tpu_torch.checkpoint import load_state_dict

        if os.path.isdir(model_path):
            model_path = os.path.join(model_path, "initial_model.pt")
        return load_state_dict(model_path)[EMBED_KEY].numpy()
    # fall back to a freshly initialized Gemma-geometry embedding
    rng = np.random.default_rng(0)
    return rng.normal(0, 0.02, size=(len(tokenizer), 256)).astype(np.float32)


def mean_subword_embeddings(
    tokenizer, matrix: np.ndarray, names: List[str]
) -> np.ndarray:
    """Mean-of-subword-token embeddings per name, unit-normalized (C15)."""
    vecs = np.zeros((len(names), matrix.shape[1]), dtype=np.float32)
    for i, name in enumerate(names):
        ids = tokenizer.encode(name, add_special_tokens=False)
        ids = [t for t in ids if 0 <= t < matrix.shape[0]]
        if ids:
            vecs[i] = matrix[ids].mean(axis=0)
    norms = np.maximum(np.linalg.norm(vecs, axis=1, keepdims=True), 1e-12)
    return vecs / norms


def scatter3d(points: np.ndarray, rgbs: List[Tuple[float, float, float]], title: str, path: str):
    plt = pyplot()
    if plt is None:
        return
    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(points[:, 0], points[:, 1], points[:, 2], c=rgbs, s=12, depthshade=False)
    ax.set_title(title)
    plt.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    print(f"Saved {path}")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Multi-token color-name embedding exploration")
    parser.add_argument("--model_path", type=str, default=None,
                        help="models/ dir or .pt checkpoint supplying the embedding matrix")
    parser.add_argument("--tokenizer_path", type=str, default=None,
                        help="saved tokenizer dir (defaults to the built-in tokenizer)")
    parser.add_argument("--colors_path", type=str, default=None,
                        help="name\\thex color table (defaults to matplotlib XKCD colors)")
    parser.add_argument("--output_dir", type=str, default="multi_token_plots")
    parser.add_argument("--max_colors", type=int, default=None)
    args = parser.parse_args(argv)

    tokenizer = (
        load_tokenizer(args.tokenizer_path) if args.tokenizer_path else ConceptTokenizer()
    )
    color_table = load_color_table(args.colors_path)
    if args.max_colors:
        color_table = color_table[: args.max_colors]
    print(f"Loaded {len(color_table)} color names")

    matrix = load_embedding_matrix(args.model_path, tokenizer)
    print(f"Embedding matrix: {matrix.shape}")

    names = [name for name, _ in color_table]
    rgbs = [hex_to_rgb(h) for _, h in color_table]
    vecs = mean_subword_embeddings(tokenizer, matrix, names)

    os.makedirs(args.output_dir, exist_ok=True)
    if pyplot() is None:
        print(FIGURES_SKIPPED)

    pca_points = pca(vecs.astype(np.float64), 3)
    scatter3d(pca_points, rgbs, "PCA-3D of mean-subword color-name embeddings",
              os.path.join(args.output_dir, "color_names_pca_3d.png"))

    proj = Projector(n_components=3, random_state=42, n_neighbors=min(15, len(names) - 1))
    umap_points = proj.fit_transform(vecs)
    scatter3d(umap_points, rgbs, f"{proj.backend.upper()}-3D of mean-subword color-name embeddings",
              os.path.join(args.output_dir, "color_names_umap_3d.png"))

    print("Done")


if __name__ == "__main__":
    main()
