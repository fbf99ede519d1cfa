"""Token-embedding analysis CLI, color experiments (a copy of
multimodal_concept_learning_tpu/analysis/token_embedding_analysis.py).

    python -m multimodal_concept_learning_tpu_torch.analysis.token_embedding_analysis \
        --results_dir R [--output_dir D]

Parity surface with the reference
(src/multimodal/token_embedding_analysis.py): flags ``--results_dir``
``--output_dir`` (:607-613), checkpoint discovery ``initial_model.pt`` +
``epoch_*_model.pt`` sorted by epoch (:97-121), regular/OOD token split from
the labels mapping (:127-168), RGB parsing from ``r{R}g{G}b{B}`` keys
(:171-180), 2D multi-epoch projection figure ``token_embeddings_umap.png``
fit on the initial epoch (:263-373), 3D last-epoch interactive
``token_embeddings_3d_umap.html`` (:376-516), regular-tokens-only figure
``regular_tokens_umap.png`` with printed pairwise 2D distances (:519-602),
and the Pearson correlation between pairwise L1 RGB distance and 1−cosine
embedding distance (:183-260).

TPU re-designs:
- checkpoints are read directly for the embedding tensor
  (``language_model.model.embed_tokens.weight``) instead of reconstructing
  the full MLLM per epoch — the reference's dominant cost;
- all pairwise distances come from one vectorized pass (normalized matmul
  for cosine, broadcast abs-diff for RGB) instead of an O(n²) Python loop.

The port's copy runs on numpy alone: checkpoints through the port's
``checkpoint.load_state_dict``, the config and tokenizer through its own
copies, projections through ``analysis/projection.py`` (no scikit-learn).
matplotlib (and plotly, for the 3D page) are imported only to draw; without
matplotlib the CLI prints one line saying the figures were skipped and
still prints every distance and the Pearson r.
"""

from __future__ import annotations

import argparse
import json
import os
import re
from typing import Dict, List, Tuple

import numpy as np

from multimodal_concept_learning_tpu_torch.analysis.projection import Projector
from multimodal_concept_learning_tpu_torch.checkpoint import load_state_dict
from multimodal_concept_learning_tpu_torch.configs import MultimodalTrainingConfig
from multimodal_concept_learning_tpu_torch.tokenizer import load_tokenizer

EMBED_KEY = "language_model.model.embed_tokens.weight"
FIGURES_SKIPPED = "matplotlib is not installed: figures skipped (every number is still printed)"


def pyplot():
    """matplotlib's pyplot on the Agg backend, or None when not installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _embedding(path: str) -> np.ndarray:
    return load_state_dict(path)[EMBED_KEY].numpy()


def load_token_embeddings(results_dir: str):
    """Load the embedding matrix of every saved epoch.

    Returns (embeddings_by_epoch {name: [V,H] np.ndarray}, tokenizer, config).
    """
    models_dir = os.path.join(results_dir, "models")

    config_path = os.path.join(models_dir, "training_config.json")
    if not os.path.exists(config_path):
        raise FileNotFoundError(f"Training config not found at {config_path}")
    with open(config_path) as f:
        config = MultimodalTrainingConfig.from_params(json.load(f))

    tokenizer_path = os.path.join(models_dir, "tokenizer")
    if not os.path.exists(tokenizer_path):
        raise FileNotFoundError(f"Saved tokenizer not found at {tokenizer_path}")
    tokenizer = load_tokenizer(tokenizer_path)
    print(f"Loaded saved tokenizer with vocabulary size: {len(tokenizer)}")

    embeddings_by_epoch: Dict[str, np.ndarray] = {}

    initial_path = os.path.join(models_dir, "initial_model.pt")
    if os.path.exists(initial_path):
        embeddings_by_epoch["initial"] = _embedding(initial_path)
        print(f"Loaded initial model embeddings: {embeddings_by_epoch['initial'].shape}")

    epoch_files = [
        f for f in os.listdir(models_dir) if f.startswith("epoch_") and f.endswith("_model.pt")
    ]
    epoch_files.sort(key=lambda x: int(x.split("_")[1]))
    for epoch_file in epoch_files:
        epoch_num = epoch_file.split("_")[1]
        embeddings_by_epoch[f"epoch_{epoch_num}"] = _embedding(
            os.path.join(models_dir, epoch_file))
        print(f"Loaded epoch {epoch_num} embeddings: {embeddings_by_epoch[f'epoch_{epoch_num}'].shape}")

    print(f"Total loaded {len(embeddings_by_epoch)} embedding matrices")
    return embeddings_by_epoch, tokenizer, config


def extract_tokens_from_saved_tokenizer(tokenizer, config):
    """Split vocab into regular vs OOD concept tokens via the labels mapping
    (parity :127-168)."""
    labels_mapping = None
    ood_tokens: List[str] = []
    regular_tokens: List[str] = []

    if config.labels_mapping_path and os.path.exists(config.labels_mapping_path):
        with open(config.labels_mapping_path) as f:
            labels_mapping = json.load(f)
        ood_tokens = [v for v in labels_mapping.values() if v.startswith("<ood")]
        regular_tokens = [v for v in labels_mapping.values() if not v.startswith("<ood")]
        print(
            f"Found {len(ood_tokens)} OOD tokens and {len(regular_tokens)} regular "
            "tokens in labels mapping"
        )
    else:
        print("No labels mapping found, will extract tokens from tokenizer vocabulary")
        vocab = tokenizer.get_vocab()
        ood_tokens = [t for t in vocab if t.startswith("<ood")]
        regular_tokens = [
            t for t in vocab if not t.startswith("<ood") and not t.startswith("<") and len(t) > 1
        ]

    print(f"Tokenizer vocabulary size: {len(tokenizer)}")
    print(f"Regular tokens: {len(regular_tokens)}")
    print(f"OOD tokens: {len(ood_tokens)}")
    return labels_mapping, ood_tokens, regular_tokens


def extract_rgb_from_mapping(labels_mapping, token) -> Tuple[float, float, float]:
    """RGB for a token from its ``r{R}g{G}b{B}`` mapping key (parity :171-180)."""
    for rgb_key, token_value in (labels_mapping or {}).items():
        if token_value == token:
            match = re.match(r"r(\d+)g(\d+)b(\d+)", rgb_key)
            if match:
                r, g, b = map(int, match.groups())
                return (r / 255.0, g / 255.0, b / 255.0)
    return (0.5, 0.5, 0.5)


def _last_epoch_name(embeddings_by_epoch) -> str:
    epoch_names = [n for n in embeddings_by_epoch if n.startswith("epoch_")]
    if not epoch_names:
        print("No epoch data found, using initial embeddings")
        return "initial"
    return f"epoch_{max(int(n.split('_')[1]) for n in epoch_names)}"


def pairwise_color_and_embedding_distances(
    rgb_colors: np.ndarray, token_embeddings: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """All-pairs L1 RGB distance and 1−cosine embedding distance in one
    vectorized pass (replaces the reference's O(n²) Python loop :237-246)."""
    color_d = np.abs(rgb_colors[:, None, :] - rgb_colors[None, :, :]).sum(-1)
    x = token_embeddings.astype(np.float64)
    x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    embed_d = 1.0 - x @ x.T
    iu = np.triu_indices(len(rgb_colors), k=1)
    return color_d[iu], embed_d[iu]


def calculate_color_embedding_correlation(
    embeddings_by_epoch, ood_tokens, regular_tokens, ood_token_ids, regular_token_ids,
    labels_mapping,
) -> float:
    """Pearson correlation of L1-RGB vs 1−cosine over all token pairs (:183-260)."""
    last_epoch_name = _last_epoch_name(embeddings_by_epoch)
    print(f"\n=== Color-Embedding Distance Correlation Analysis ({last_epoch_name}) ===")

    embedding_matrix = embeddings_by_epoch[last_epoch_name]
    all_token_ids = list(ood_token_ids) + list(regular_token_ids)
    all_token_names = list(ood_tokens) + list(regular_tokens)

    token_embeddings = np.asarray(embedding_matrix)[all_token_ids].astype(np.float32)
    rgb_colors = np.array([extract_rgb_from_mapping(labels_mapping, t) for t in all_token_names])

    print(f"Calculating pairwise distances for {len(all_token_names)} tokens (regular + OOD)...")
    color_distances, embedding_distances = pairwise_color_and_embedding_distances(
        rgb_colors, token_embeddings
    )

    correlation = float(np.corrcoef(color_distances, embedding_distances)[0, 1])

    print(f"Number of token pairs: {len(color_distances)}")
    print(f"Color distance range: [{color_distances.min():.4f}, {color_distances.max():.4f}]")
    print(
        f"Embedding distance range: [{embedding_distances.min():.4f}, "
        f"{embedding_distances.max():.4f}]"
    )
    print(f"Pearson correlation coefficient: {correlation:.4f}")
    return correlation


def create_umap_visualization(
    embeddings_by_epoch, ood_tokens, regular_tokens, labels_mapping,
    ood_token_ids, regular_token_ids, output_dir=None,
):
    """Multi-epoch 2D projection figure, fit on the initial epoch (:263-373)."""
    all_token_ids = list(ood_token_ids) + list(regular_token_ids)
    all_token_names = list(ood_tokens) + list(regular_tokens)
    token_types = ["OOD"] * len(ood_tokens) + ["Regular"] * len(regular_tokens)

    print(f"Analyzing {len(all_token_ids)} tokens across {len(embeddings_by_epoch)} epochs")

    epoch_embeddings = {
        name: np.asarray(matrix)[all_token_ids].astype(np.float32)
        for name, matrix in embeddings_by_epoch.items()
    }

    print("\nFitting projection on initial embeddings...")
    reducer = Projector(n_components=2, random_state=42, n_neighbors=min(15, len(all_token_ids) - 1))
    reducer.fit(epoch_embeddings["initial"])
    epoch_projections = {name: reducer.transform(emb) for name, emb in epoch_embeddings.items()}

    token_colors = [extract_rgb_from_mapping(labels_mapping, t) for t in all_token_names]

    plt = pyplot()
    if plt is None:
        return
    epochs = list(epoch_projections.keys())
    n_epochs = len(epochs)
    fig, axes = plt.subplots(1, n_epochs, figsize=(6 * n_epochs, 6))
    if n_epochs == 1:
        axes = [axes]

    for ax, epoch_name in zip(axes, epochs):
        projections = epoch_projections[epoch_name]
        for j, (x, y) in enumerate(projections):
            marker, size = ("o", 60) if token_types[j] == "OOD" else ("x", 80)
            ax.scatter(
                x, y, c=[token_colors[j]], marker=marker, s=size, alpha=0.8,
                edgecolors="black" if marker == "o" else None, linewidth=0.5,
            )
        ax.set_title(epoch_name, fontsize=14)
        ax.set_xlabel("UMAP 1", fontsize=12)
        ax.set_ylabel("UMAP 2", fontsize=12)
        ax.grid(True, alpha=0.3)
        ax.scatter([], [], c="black", marker="x", s=80, label="Regular")
        ax.scatter([], [], c="black", marker="o", s=60, label="OOD", edgecolors="black")
        ax.legend()

    plt.tight_layout()
    plt.suptitle("Token Embeddings Colored by RGB Values (x=Regular, o=OOD)", y=1.02, fontsize=16)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        out = os.path.join(output_dir, "token_embeddings_umap.png")
        plt.savefig(out, dpi=150, bbox_inches="tight")
        print(f"Saved UMAP plot to {out}")
    plt.close()


def create_3d_umap_visualization(
    embeddings_by_epoch, ood_tokens, regular_tokens, labels_mapping,
    ood_token_ids, regular_token_ids, output_dir=None,
):
    """3D last-epoch visualization → token_embeddings_3d_umap.html (:376-516).

    Uses plotly when importable; otherwise embeds a matplotlib 3D render in a
    minimal self-contained HTML so the output filename contract holds.
    """
    print("=== Creating 3D UMAP Visualization ===")
    last_epoch_name = _last_epoch_name(embeddings_by_epoch)
    print(f"Using {last_epoch_name} for 3D visualization")

    all_token_ids = list(ood_token_ids) + list(regular_token_ids)
    all_token_names = list(ood_tokens) + list(regular_tokens)
    token_types = ["OOD"] * len(ood_tokens) + ["Regular"] * len(regular_tokens)

    token_embeddings = np.asarray(embeddings_by_epoch[last_epoch_name])[all_token_ids].astype(
        np.float32
    )
    reducer = Projector(n_components=3, random_state=42, n_neighbors=min(15, len(all_token_ids) - 1))
    projections_3d = reducer.fit_transform(token_embeddings)

    token_colors = [extract_rgb_from_mapping(labels_mapping, t) for t in all_token_names]

    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
    html_path = os.path.join(output_dir, "token_embeddings_3d_umap.html") if output_dir else None

    try:  # pragma: no cover - plotly not installed in CI image
        import plotly.graph_objects as go

        fig = go.Figure()
        for type_name, symbol, size in (("OOD", "circle", 6), ("Regular", "x", 4)):
            mask = [t == type_name for t in token_types]
            if not any(mask):
                continue
            idx = [i for i, m in enumerate(mask) if m]
            fig.add_trace(
                go.Scatter3d(
                    x=projections_3d[idx, 0], y=projections_3d[idx, 1], z=projections_3d[idx, 2],
                    mode="markers",
                    marker=dict(
                        size=size,
                        color=[
                            f"#{int(r*255):02x}{int(g*255):02x}{int(b*255):02x}"
                            for r, g, b in (token_colors[i] for i in idx)
                        ],
                        symbol=symbol,
                        line=dict(width=1, color="black"),
                    ),
                    text=[all_token_names[i] for i in idx],
                    name=f"{type_name} Tokens",
                )
            )
        fig.update_layout(
            title=f"3D UMAP Visualization - {last_epoch_name}",
            scene=dict(xaxis_title="UMAP 1", yaxis_title="UMAP 2", zaxis_title="UMAP 3"),
            width=1000, height=800,
        )
        if html_path:
            fig.write_html(html_path)
            print(f"Saved 3D UMAP plot to {html_path}")
    except ImportError:
        plt = pyplot()
        if plt is None:
            print("3D UMAP visualization complete!")
            return
        fig = plt.figure(figsize=(10, 8))
        ax = fig.add_subplot(111, projection="3d")
        for j in range(len(all_token_names)):
            marker = "o" if token_types[j] == "OOD" else "x"
            ax.scatter(*projections_3d[j], c=[token_colors[j]], marker=marker, s=40)
        ax.set_title(f"3D Projection - {last_epoch_name}")
        if html_path:
            import base64
            import io

            buf = io.BytesIO()
            plt.savefig(buf, format="png", dpi=120, bbox_inches="tight")
            b64 = base64.b64encode(buf.getvalue()).decode()
            with open(html_path, "w") as f:
                f.write(
                    "<html><body><h2>3D Token Embedding Projection "
                    f"({last_epoch_name}; static fallback, plotly unavailable)</h2>"
                    f'<img src="data:image/png;base64,{b64}"/></body></html>'
                )
            print(f"Saved 3D UMAP plot to {html_path}")
        plt.close()

    print("3D UMAP visualization complete!")


def create_regular_tokens_analysis(
    embeddings_by_epoch, regular_tokens, regular_token_ids, labels_mapping, output_dir=None
):
    """Regular-tokens-only projection + printed pairwise 2D distances (:519-602)."""
    print("=== Regular Tokens UMAP Analysis ===")
    if len(regular_tokens) < 2:
        print("Not enough regular tokens for analysis")
        return

    regular_epoch_embeddings = {
        name: np.asarray(matrix)[list(regular_token_ids)].astype(np.float32)
        for name, matrix in embeddings_by_epoch.items()
    }

    print("\nFitting projection on regular tokens from initial epoch...")
    reducer = Projector(n_components=2, random_state=42, n_neighbors=min(5, len(regular_tokens) - 1))
    reducer.fit(regular_epoch_embeddings["initial"])
    projections_by_epoch = {
        name: reducer.transform(emb) for name, emb in regular_epoch_embeddings.items()
    }

    epochs = list(projections_by_epoch.keys())
    plt = pyplot()
    for ax, epoch_name in zip(_axes(plt, len(epochs)), epochs):
        projections = projections_by_epoch[epoch_name]
        for j, (x, y) in enumerate(projections):
            rgb = extract_rgb_from_mapping(labels_mapping, regular_tokens[j])
            ax.scatter(x, y, c=[rgb], marker="o", s=100, alpha=0.8, edgecolors="black", linewidth=1.5)
            ax.annotate(
                regular_tokens[j], (x, y), xytext=(5, 5), textcoords="offset points",
                fontsize=10, alpha=0.8, fontweight="bold",
            )
        ax.set_title(f"{epoch_name} - Regular Tokens Only", fontsize=14)
        ax.set_xlabel("UMAP 1", fontsize=12)
        ax.set_ylabel("UMAP 2", fontsize=12)
        ax.grid(True, alpha=0.3)

    if plt is not None:
        plt.tight_layout()
        plt.suptitle("Regular Token Embeddings Evolution (RGB Colored)", y=1.02, fontsize=16)
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            out = os.path.join(output_dir, "regular_tokens_umap.png")
            plt.savefig(out, dpi=150, bbox_inches="tight")
            print(f"Saved regular tokens UMAP plot to {out}")
        plt.close()

    print("\n=== Regular Token Distance Analysis ===")
    for epoch_name in epochs:
        projections = projections_by_epoch[epoch_name]
        print(f"\n{epoch_name}:")
        diffs = projections[:, None, :] - projections[None, :, :]
        dists = np.linalg.norm(diffs, axis=-1)
        for i, token1 in enumerate(regular_tokens):
            for j, token2 in enumerate(regular_tokens):
                if i < j:
                    print(f"  {token1} <-> {token2}: {dists[i, j]:.3f}")


def _axes(plt, n: int) -> list:
    """n subplot axes side by side, or none when there is no matplotlib."""
    if plt is None:
        return []
    _, axes = plt.subplots(1, n, figsize=(5 * n, 5))
    return [axes] if n == 1 else list(axes)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Token Embedding Analysis")
    parser.add_argument("--results_dir", type=str, required=True,
                        help="Path to results directory containing trained model")
    parser.add_argument("--output_dir", type=str, default=None,
                        help="Directory to save output plots (defaults to results_dir)")
    args = parser.parse_args(argv)

    if args.output_dir is None:
        args.output_dir = args.results_dir

    print(f"Loading embeddings from: {args.results_dir}")
    print(f"Saving plots to: {args.output_dir}")
    if pyplot() is None:
        print(FIGURES_SKIPPED)

    embeddings_by_epoch, tokenizer, config = load_token_embeddings(args.results_dir)
    labels_mapping, ood_tokens, regular_tokens = extract_tokens_from_saved_tokenizer(
        tokenizer, config
    )

    print("\n=== Token Analysis ===")
    print(f"Total vocabulary size: {len(tokenizer)}")
    print(f"Regular tokens: {len(regular_tokens)}")
    print(f"OOD tokens: {len(ood_tokens)}")

    ood_token_ids = [tokenizer.convert_tokens_to_ids(t) for t in ood_tokens]
    regular_token_ids = [tokenizer.convert_tokens_to_ids(t) for t in regular_tokens]

    create_umap_visualization(
        embeddings_by_epoch, ood_tokens, regular_tokens, labels_mapping,
        ood_token_ids, regular_token_ids, args.output_dir,
    )
    create_3d_umap_visualization(
        embeddings_by_epoch, ood_tokens, regular_tokens, labels_mapping,
        ood_token_ids, regular_token_ids, args.output_dir,
    )
    create_regular_tokens_analysis(
        embeddings_by_epoch, regular_tokens, regular_token_ids, labels_mapping, args.output_dir
    )
    correlation = calculate_color_embedding_correlation(
        embeddings_by_epoch, ood_tokens, regular_tokens, ood_token_ids, regular_token_ids,
        labels_mapping,
    )

    print("\n=== FINAL CORRELATION RESULT ===")
    print(f"Color-Embedding Distance Correlation: {correlation:.4f}")
    print("\nAnalysis complete!")
    return correlation


if __name__ == "__main__":
    main()
