"""Token-embedding analysis CLI for ImageNet models (a copy of
multimodal_concept_learning_tpu/analysis/token_embedding_analysis_imagenet.py).

    python -m multimodal_concept_learning_tpu_torch.analysis.token_embedding_analysis_imagenet \\
        --results_dir R --data_dir data/imagenet [--parent_level 4] [--epoch epoch_10]

The WordNet is-a graph of the ILSVRC2012 devkit over interned ids
(:class:`WordNetHierarchy`: roots, depth frontiers, the nearest claimed
ancestor of every token by one vectorized lifting fixpoint), tokens
coloured by their ancestor at ``--parent_level`` from the tab20 / tab20b /
tab20c / Set3 palette (its colours written out here, so no matplotlib is
needed to assign them), checkpoints discovered as ``initial`` then
``epoch_N`` (``--max_epochs``), multi-token concepts embedded as the mean of
their subword rows, and the 2D and 3D projections of the all / regular /
OOD token sets at one epoch (``{epoch}_{label}_umap_{2d,3d}.png``).

It runs on numpy alone: checkpoints through the port's
``checkpoint.load_state_dict``, projections through
``analysis/projection.py``.  matplotlib is imported only to draw; without it
the CLI prints one line saying the figures were skipped and prints every
other line (the token counts, the loaded epochs, the target epoch) as the
JAX CLI does.
"""

from __future__ import annotations

import argparse
import json
import os
import re
from collections import Counter
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from multimodal_concept_learning_tpu_torch.analysis.projection import Projector
from multimodal_concept_learning_tpu_torch.analysis.token_embedding_analysis import (
    EMBED_KEY,
    FIGURES_SKIPPED,
    extract_tokens_from_saved_tokenizer,
    pyplot,
)
from multimodal_concept_learning_tpu_torch.checkpoint import load_state_dict
from multimodal_concept_learning_tpu_torch.configs import MultimodalTrainingConfig
from multimodal_concept_learning_tpu_torch.tokenizer import load_tokenizer

FALLBACK_COLOR = "#636363"
DEFAULT_LEGEND_MAX = 12
# matplotlib's tab20, tab20b, tab20c and Set3 colours, in that order, as
# its ``to_hex`` writes them (the JAX module reads them from matplotlib)
PALETTE = (
    "#1f77b4", "#aec7e8", "#ff7f0e", "#ffbb78", "#2ca02c", "#98df8a", "#d62728", "#ff9896",
    "#9467bd", "#c5b0d5", "#8c564b", "#c49c94", "#e377c2", "#f7b6d2", "#7f7f7f", "#c7c7c7",
    "#bcbd22", "#dbdb8d", "#17becf", "#9edae5", "#393b79", "#5254a3", "#6b6ecf", "#9c9ede",
    "#637939", "#8ca252", "#b5cf6b", "#cedb9c", "#8c6d31", "#bd9e39", "#e7ba52", "#e7cb94",
    "#843c39", "#ad494a", "#d6616b", "#e7969c", "#7b4173", "#a55194", "#ce6dbd", "#de9ed6",
    "#3182bd", "#6baed6", "#9ecae1", "#c6dbef", "#e6550d", "#fd8d3c", "#fdae6b", "#fdd0a2",
    "#31a354", "#74c476", "#a1d99b", "#c7e9c0", "#756bb1", "#9e9ac8", "#bcbddc", "#dadaeb",
    "#636363", "#969696", "#bdbdbd", "#d9d9d9", "#8dd3c7", "#ffffb3", "#bebada", "#fb8072",
    "#80b1d3", "#fdb462", "#b3de69", "#fccde5", "#d9d9d9", "#bc80bd", "#ccebc5", "#ffed6f",
)


# -- WordNet hierarchy --------------------------------------------------------


class WordNetHierarchy:
    """ILSVRC2012-devkit WordNet is-a graph over interned integer ids.

    The devkit ships ``wordnet.is_a.txt`` (parent child pairs) and
    ``words.txt`` (wnid<TAB>gloss).  Interning the wnids once lets every
    graph question below be answered with array ops: roots are a boolean
    mask, depth frontiers are repeated edge selections, and
    nearest-claimed-ancestor for a whole token batch is a lifting fixpoint
    on the ``primary_parent`` array (first-listed parent, matching the
    reference's choice of ``child_to_parents[c][0]``).
    """

    def __init__(self, data_dir: str):
        devkit = os.path.join(data_dir, "ILSVRC2012_devkit_t12", "data")
        raw = np.loadtxt(os.path.join(devkit, "wordnet.is_a.txt"), dtype=str)
        pairs = raw.reshape(-1, 2)

        self.wnids: List[str] = list(dict.fromkeys(pairs.ravel().tolist()))
        self._index = {w: i for i, w in enumerate(self.wnids)}
        n = len(self.wnids)
        e_parent = np.fromiter((self._index[p] for p in pairs[:, 0]), np.int64, len(pairs))
        e_child = np.fromiter((self._index[c] for c in pairs[:, 1]), np.int64, len(pairs))
        self._edges = (e_parent, e_child)

        # primary parent = FIRST listed parent of each child; write edges in
        # reverse so earlier lines win the slot.
        primary = np.full(n, -1, np.int64)
        primary[e_child[::-1]] = e_parent[::-1]
        self.primary_parent = primary

        appears_as_parent = np.zeros(n, bool)
        appears_as_parent[e_parent] = True
        self._root_ids = np.flatnonzero(appears_as_parent & (primary < 0))

        self.names: Dict[str, str] = {}
        with open(os.path.join(devkit, "words.txt")) as f:
            for line in f:
                cols = line.strip().split("\t")
                if cols and cols[0]:
                    self.names[cols[0]] = " ".join(cols[1:]) or cols[0]

    @property
    def roots(self) -> List[str]:
        return [self.wnids[i] for i in self._root_ids]

    def frontier(self, depth: int) -> List[str]:
        """Wnids exactly ``depth`` is-a steps below the roots.

        ``depth <= 0`` (or walking past the deepest leaves) yields the
        roots themselves, mirroring the reference's fallback.
        """
        e_parent, e_child = self._edges
        level = self._root_ids
        for _ in range(max(depth, 0)):
            below = e_child[np.isin(e_parent, level)]
            if below.size == 0:
                break
            level = below
        if depth > 0 and np.array_equal(level, self._root_ids):
            return self.roots
        return [self.wnids[i] for i in level]

    def nearest_claimed_ancestor(
        self, wnids: Sequence[Optional[str]], claimed: Set[str]
    ) -> List[Optional[str]]:
        """For each wnid, the closest node (inclusive) on its primary-parent
        chain that belongs to ``claimed``; None when the chain tops out
        without a hit or the wnid is unknown.

        Vectorized: all chains are lifted one level per iteration, frozen as
        soon as they land on a claimed node, until nothing can move.
        """
        claimed_mask = np.zeros(len(self.wnids) + 1, bool)
        for w in claimed:
            i = self._index.get(w)
            if i is not None:
                claimed_mask[i] = True

        cur = np.fromiter((self._index.get(w, -1) for w in wnids), np.int64, len(wnids))
        settled = claimed_mask[cur] | (cur < 0)
        while True:
            lifted = np.where(cur >= 0, self.primary_parent[cur], -1)
            movable = ~settled & (lifted >= 0)
            if not movable.any():
                break
            cur = np.where(movable, lifted, cur)
            settled |= claimed_mask[cur] | ~movable
        hit = claimed_mask[cur] & (cur >= 0)
        return [self.wnids[i] if ok else None for i, ok in zip(cur, hit)]


def build_palette() -> List[str]:
    return list(PALETTE)


def color_tokens_by_ancestor(
    hierarchy: WordNetHierarchy,
    token_names: Sequence[str],
    token_to_wnid: Dict[str, str],
    depth: int,
):
    """Color each token by its WordNet ancestor at ``depth``.

    Returns ``(token_to_color, token_to_parent, parent_to_color)``.  Tokens
    whose chain misses the frontier anchor to their own wnid (or, lacking
    one, to the token string itself); palette slots go to frontier nodes
    first, then to the remaining anchors in token order.
    """
    frontier = hierarchy.frontier(depth)
    wnids = [token_to_wnid.get(t) for t in token_names]
    ancestors = hierarchy.nearest_claimed_ancestor(wnids, set(frontier))

    token_to_parent = {
        t: anc or wnid or t for t, wnid, anc in zip(token_names, wnids, ancestors)
    }
    palette = build_palette()
    ordered = dict.fromkeys([*frontier, *token_to_parent.values()])
    parent_to_color = {p: palette[i % len(palette)] for i, p in enumerate(ordered)}
    token_to_color = {t: parent_to_color[p] for t, p in token_to_parent.items()}
    return token_to_color, token_to_parent, parent_to_color


# -- embeddings --------------------------------------------------------------

_EPOCH_FILE = re.compile(r"epoch_(\d+)_model\.pt$")


def _epoch_sort_key(name: str):
    if name == "initial":
        return (-1, 0)
    m = re.match(r"epoch_(\d+)", name)
    return (0, int(m.group(1)) if m else 0)


def discover_checkpoints(models_dir: str, max_epochs: Optional[int]):
    """Ordered ``(epoch_name, path)`` pairs: 'initial' first when present,
    then numbered epochs ascending, capped at ``max_epochs``."""
    found = []
    initial = os.path.join(models_dir, "initial_model.pt")
    if os.path.exists(initial):
        found.append(("initial", initial))

    numbered = sorted(
        (int(m.group(1)), f)
        for f in os.listdir(models_dir)
        if (m := _EPOCH_FILE.fullmatch(f))
    )
    if max_epochs is not None:
        numbered = numbered[:max_epochs]
        print(f"Limiting to {len(numbered)} epoch checkpoints")
    found.extend(
        (f"epoch_{num}", os.path.join(models_dir, f)) for num, f in numbered
    )
    return found


def load_token_embeddings(results_dir: str, max_epochs: Optional[int] = None):
    """Read the embedding matrix straight out of each saved checkpoint
    (reference :180-232 rebuilds the whole MLLM per epoch instead)."""
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
    print(f"Loaded tokenizer with vocabulary size {len(tokenizer)}")

    embeddings_by_epoch: Dict[str, np.ndarray] = {}
    for epoch_name, path in discover_checkpoints(models_dir, max_epochs):
        matrix = load_state_dict(path)[EMBED_KEY].numpy()
        embeddings_by_epoch[epoch_name] = matrix
        shown = "initial" if epoch_name == "initial" else f"epoch {epoch_name.split('_')[1]}"
        print(f"Loaded {shown} embeddings {matrix.shape}")

    return embeddings_by_epoch, tokenizer, config


def average_embeddings_for_tokens(
    tokenizer, embeddings_by_epoch: Dict[str, np.ndarray], token_names: List[str]
) -> Dict[str, np.ndarray]:
    """Mean of subword-token rows per concept (parity :261-286), vectorized:
    one padded gather + segment mean instead of a per-token Python loop."""
    averaged: Dict[str, np.ndarray] = {}
    if not embeddings_by_epoch:
        return averaged
    dim = next(iter(embeddings_by_epoch.values())).shape[1]

    id_lists = [tokenizer.encode(t, add_special_tokens=False) for t in token_names]
    max_len = max((len(ids) for ids in id_lists), default=1) or 1
    ids = np.zeros((len(token_names), max_len), dtype=np.int64)
    mask = np.zeros((len(token_names), max_len), dtype=np.float32)
    for i, id_list in enumerate(id_lists):
        ids[i, : len(id_list)] = id_list
        mask[i, : len(id_list)] = 1.0
    denom = np.maximum(mask.sum(axis=1, keepdims=True), 1.0)

    for epoch_name, matrix in embeddings_by_epoch.items():
        if not token_names:
            averaged[epoch_name] = np.empty((0, dim), dtype=np.float32)
            continue
        gathered = np.asarray(matrix)[ids]  # [N, L, H]
        averaged[epoch_name] = (gathered * mask[:, :, None]).sum(axis=1) / denom
    return averaged


def select_epoch(embeddings_by_epoch, requested_epoch: Optional[str]) -> str:
    if requested_epoch in embeddings_by_epoch:
        return requested_epoch
    ordered = sorted(embeddings_by_epoch, key=_epoch_sort_key)
    if not ordered:
        raise ValueError("No embedding checkpoints were loaded.")
    if requested_epoch:
        print(f"Requested epoch '{requested_epoch}' not found; falling back to final epoch")
    return ordered[-1]


# -- figures ------------------------------------------------------------------


def _project(embeddings: np.ndarray, n_components: int) -> np.ndarray:
    if embeddings.shape[0] < max(3, n_components + 1):
        raise ValueError("Need more tokens to run the projection for the requested dimensionality.")
    reducer = Projector(
        n_components=n_components, random_state=42,
        n_neighbors=max(2, min(15, embeddings.shape[0] - 1)),
    )
    return reducer.fit_transform(embeddings)


def add_parent_legend(ax, parents, parent_to_color, wnid_to_name):
    from matplotlib.lines import Line2D

    top = Counter(parents).most_common(DEFAULT_LEGEND_MAX)
    if not top:
        return
    swatches = [
        Line2D([0], [0], marker="o", color="none", markersize=6,
               markerfacecolor=parent_to_color.get(p, FALLBACK_COLOR))
        for p, _ in top
    ]
    ax.legend(swatches, [wnid_to_name.get(p, p) for p, _ in top],
              title="WordNet parent", loc="best", fontsize=8)


def save_umap_figures(
    label, epoch_name, embeddings, token_names, token_to_color, token_to_parent,
    parent_to_color, wnid_to_name, output_dir,
):
    if embeddings.shape[0] < 3:
        print(f"Not enough tokens to build {label} projections (need at least 3)")
        return
    plt = pyplot()
    if plt is None:
        return

    colors = [token_to_color.get(t, FALLBACK_COLOR) for t in token_names]
    parents = [token_to_parent.get(t, t) for t in token_names]

    for n_components, suffix in ((2, "2d"), (3, "3d")):
        try:
            points = _project(embeddings, n_components)
        except ValueError as err:
            print(f"  Skipping {suffix.upper()} projection for {label}: {err}")
            continue
        path = os.path.join(output_dir, f"{epoch_name}_{label}_umap_{suffix}.png")
        if n_components == 2:
            fig, ax = plt.subplots(figsize=(6, 5))
            ax.scatter(points[:, 0], points[:, 1], c=colors, s=16, alpha=0.9)
        else:
            fig = plt.figure(figsize=(6, 5))
            ax = fig.add_subplot(111, projection="3d")
            ax.scatter(points[:, 0], points[:, 1], points[:, 2], c=colors, s=16, depthshade=False)
            ax.set_zlabel("UMAP 3")
        ax.set_title(f"UMAP {suffix.upper()} ({label}, {epoch_name})")
        ax.set_xlabel("UMAP 1")
        ax.set_ylabel("UMAP 2")
        add_parent_legend(ax, parents, parent_to_color, wnid_to_name)
        plt.tight_layout()
        fig.savefig(path, dpi=150)
        plt.close(fig)
        print(f"  Saved {path}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Token Embedding Analysis for ImageNet Models")
    parser.add_argument("--results_dir", type=str, required=True,
                        help="Path to results directory containing the trained model")
    parser.add_argument("--output_dir", type=str, default=None,
                        help="Directory to save output plots (defaults to results_dir/plots)")
    parser.add_argument("--max_epochs", type=int, default=None,
                        help="Maximum number of epochs to analyze (None for all epochs)")
    parser.add_argument("--parent_level", type=int, default=4,
                        help="WordNet hierarchy level to use for coloring (1=parent, ...)")
    parser.add_argument("--data_dir", type=str, required=True,
                        help="Path to ImageNet data directory containing WordNet hierarchy files")
    parser.add_argument("--epoch", type=str, default=None,
                        help="Specific epoch to visualise (e.g. 'initial' or 'epoch_10')")
    args = parser.parse_args(argv)

    if args.output_dir is None:
        args.output_dir = os.path.join(args.results_dir, "plots")
    os.makedirs(args.output_dir, exist_ok=True)

    print(f"Loading embeddings from {args.results_dir}")
    print(f"Saving plots to {args.output_dir}")
    if pyplot() is None:
        print(FIGURES_SKIPPED)

    hierarchy = WordNetHierarchy(args.data_dir)
    embeddings_by_epoch, tokenizer, config = load_token_embeddings(
        args.results_dir, args.max_epochs
    )
    labels_mapping, ood_tokens, regular_tokens = extract_tokens_from_saved_tokenizer(
        tokenizer, config
    )

    print("\n=== Token Overview ===")
    print(f"Total vocabulary size: {len(tokenizer)}")
    print(f"Regular tokens selected: {len(regular_tokens)}")
    print(f"OOD tokens selected: {len(ood_tokens)}")

    ood_embeddings = average_embeddings_for_tokens(tokenizer, embeddings_by_epoch, ood_tokens)
    regular_embeddings = average_embeddings_for_tokens(
        tokenizer, embeddings_by_epoch, regular_tokens
    )

    token_to_wnid = (
        {token_name: wnid for wnid, token_name in labels_mapping.items()} if labels_mapping else {}
    )

    print(f"\nAssigning colors using WordNet hierarchy level {args.parent_level}")
    all_tokens = ood_tokens + regular_tokens
    token_to_color, token_to_parent, parent_to_color = color_tokens_by_ancestor(
        hierarchy, all_tokens, token_to_wnid, args.parent_level
    )

    if not all_tokens:
        print("No tokens available to visualise; exiting.")
        return

    target_epoch = select_epoch(embeddings_by_epoch, args.epoch)
    print(f"\nTarget epoch for plots: {target_epoch}")

    if ood_tokens and regular_tokens:
        combined = np.concatenate(
            [ood_embeddings[target_epoch], regular_embeddings[target_epoch]], axis=0
        )
    elif ood_tokens:
        combined = ood_embeddings[target_epoch]
    else:
        combined = regular_embeddings[target_epoch]

    print("\nGenerating projection figures...")
    common = dict(
        token_to_color=token_to_color, token_to_parent=token_to_parent,
        parent_to_color=parent_to_color, wnid_to_name=hierarchy.names,
        output_dir=args.output_dir, epoch_name=target_epoch,
    )
    if combined is not None and combined.shape[0] >= 3:
        save_umap_figures(label="all_tokens", embeddings=combined, token_names=all_tokens, **common)
    if regular_tokens and target_epoch in regular_embeddings:
        save_umap_figures(
            label="regular_tokens", embeddings=regular_embeddings[target_epoch],
            token_names=regular_tokens, **common,
        )
    if ood_tokens and target_epoch in ood_embeddings:
        save_umap_figures(
            label="ood_tokens", embeddings=ood_embeddings[target_epoch],
            token_names=ood_tokens, **common,
        )

    print("\nAnalysis complete.")


if __name__ == "__main__":
    main()
