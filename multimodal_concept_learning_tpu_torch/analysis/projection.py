"""2D/3D embedding projection (a copy of
multimodal_concept_learning_tpu/analysis/projection.py in numpy alone).

:class:`Projector` prefers umap-learn when importable and otherwise runs
:class:`NeighborEmbedding`, a self-contained UMAP-equivalent (k-NN fuzzy
graph, adaptive bandwidths, cross-entropy attract/repulse SGD layout,
out-of-sample transform); the backend used is printed.  Where the JAX module
calls scikit-learn, this copy has its own numpy versions: ``pca`` is an SVD
of the centred data with scikit-learn's sign rule (``svd_flip`` on the
components: each one's largest |entry| positive), and ``nearest_neighbors``
an exact Euclidean k-NN (rows sorted by distance, ties by index), so the
analysis runs where scikit-learn is not installed.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

_ATTRACT_CLIP = 4.0  # per-step coordinate update clip, as in UMAP


def _fit_curve_params(min_dist: float, spread: float = 1.0):
    """Least-squares fit of the low-dim similarity curve 1/(1 + a d^{2b})
    to the target exp(-(d - min_dist)/spread) piecewise template."""
    d = np.linspace(0.0, 3.0 * spread, 300)
    target = np.where(d < min_dist, 1.0, np.exp(-(d - min_dist) / spread))
    try:
        from scipy.optimize import curve_fit

        (a, b), _ = curve_fit(
            lambda x, a, b: 1.0 / (1.0 + a * x ** (2.0 * b)), d, target,
            p0=(1.0, 1.0), maxfev=5000,
        )
        return float(a), float(b)
    except Exception:
        return 1.577, 0.8951  # the standard values for min_dist=0.1, spread=1


def pca(x: np.ndarray, n_components: int) -> np.ndarray:
    """scikit-learn's ``PCA(n_components).fit_transform(x)``: the centred
    data projected on its first right singular vectors, each signed so that
    its largest |entry| is positive."""
    x = np.asarray(x, dtype=np.float64)
    centred = x - x.mean(axis=0)
    u, s, vt = np.linalg.svd(centred, full_matrices=False)
    signs = np.sign(vt[np.arange(len(vt)), np.argmax(np.abs(vt), axis=1)])
    return (u * s * signs)[:, :n_components]


def nearest_neighbors(train: np.ndarray, query: np.ndarray, k: int):
    """(distances, indices) [Q, k] of the k rows of ``train`` nearest to
    each row of ``query`` (Euclidean, ascending; ties by index)."""
    train = np.asarray(train, dtype=np.float64)
    query = np.asarray(query, dtype=np.float64)
    dist = np.sqrt(((query[:, None, :] - train[None, :, :]) ** 2).sum(axis=-1))
    idx = np.argsort(dist, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(dist, idx, axis=1), idx


def _knn(matrix: np.ndarray, k: int):
    """(distances, indices) of the k nearest OTHER rows for each row."""
    dist, idx = nearest_neighbors(matrix, matrix, min(k + 1, len(matrix)))
    return dist[:, 1:], idx[:, 1:]  # drop self


def _membership_strengths(dist: np.ndarray):
    """Per-row adaptive fuzzy membership of each neighbor, UMAP-style.

    rho_i is the distance to the nearest neighbor; sigma_i is binary-searched
    (vectorized over all rows at once) so that the smoothed neighbor count
    sums to log2(k).
    """
    n, k = dist.shape
    rho = dist[:, 0:1]
    target = np.log2(max(k, 2))
    lo = np.full((n, 1), 1e-8)
    hi = np.full((n, 1), 1e4)
    sigma = np.ones((n, 1))
    shifted = np.maximum(dist - rho, 0.0)
    for _ in range(64):
        total = np.exp(-shifted / sigma).sum(axis=1, keepdims=True)
        hi = np.where(total > target, sigma, hi)
        lo = np.where(total > target, lo, sigma)
        sigma = 0.5 * (lo + hi)
    return np.exp(-shifted / sigma)


def _symmetrized_edges(idx: np.ndarray, strengths: np.ndarray):
    """Fuzzy-union symmetrization W = P + P^T - P∘P^T as an edge list.

    Returns (heads, tails, weights) with each undirected pair listed once.
    """
    n, k = idx.shape
    heads = np.repeat(np.arange(n), k)
    tails = idx.ravel()
    p = np.zeros((n, n))
    p[heads, tails] = strengths.ravel()
    w = p + p.T - p * p.T
    hh, tt = np.nonzero(np.triu(w, 1))
    return hh, tt, w[hh, tt]


@dataclass
class NeighborEmbedding:
    """From-scratch UMAP-equivalent: fuzzy k-NN graph + SGD force layout.

    fit(): build the symmetrized fuzzy graph over the training rows, start
    from a scaled PCA layout, and run ``n_epochs`` of vectorized
    cross-entropy gradient steps — every edge attracts with its membership
    weight, and ``negative_rate`` uniform non-edges per edge repulse.

    transform(): place new rows at the membership-weighted mean of their
    k-NN anchors' embeddings, then refine them for ``n_epochs // 3`` steps
    against the FROZEN training layout.
    """

    n_components: int = 2
    n_neighbors: int = 15
    min_dist: float = 0.1
    n_epochs: int = 300
    learning_rate: float = 1.0
    negative_rate: int = 5
    random_state: int = 42
    _train_x: Optional[np.ndarray] = field(default=None, repr=False)
    _train_y: Optional[np.ndarray] = field(default=None, repr=False)

    def _layout_step(self, y, heads, tails, weights, alpha, rng, movable_tails):
        a, b = self._curve
        diff = y[heads] - y[tails]
        d2 = np.maximum((diff ** 2).sum(axis=1, keepdims=True), 1e-12)
        # attractive CE gradient through Phi(d) = 1/(1 + a d^{2b})
        att = (-2.0 * a * b * d2 ** (b - 1.0)) / (1.0 + a * d2 ** b)
        pull = np.clip(att * weights[:, None] * diff, -_ATTRACT_CLIP, _ATTRACT_CLIP)
        np.add.at(y, heads, alpha * pull)
        if movable_tails:
            np.add.at(y, tails, -alpha * pull)

        neg = rng.integers(0, len(self._train_y), size=(len(heads), self.negative_rate))
        for col in range(self.negative_rate):
            rdiff = y[heads] - self._train_y[neg[:, col]]
            rd2 = np.maximum((rdiff ** 2).sum(axis=1, keepdims=True), 1e-12)
            rep = (2.0 * b) / ((0.001 + rd2) * (1.0 + a * rd2 ** b))
            push = np.clip(rep * rdiff, -_ATTRACT_CLIP, _ATTRACT_CLIP)
            np.add.at(y, heads, alpha * push)

    def fit(self, x: np.ndarray) -> "NeighborEmbedding":
        x = np.asarray(x, dtype=np.float64)
        rng = np.random.default_rng(self.random_state)
        self._curve = _fit_curve_params(self.min_dist)
        k = max(2, min(self.n_neighbors, len(x) - 1))
        dist, idx = _knn(x, k)
        heads, tails, weights = _symmetrized_edges(idx, _membership_strengths(dist))

        dims = min(self.n_components, len(x), x.shape[1])
        init = pca(x, dims)
        if dims < self.n_components:
            init = np.pad(init, ((0, 0), (0, self.n_components - dims)))
        span = np.abs(init).max() or 1.0
        y = (init / span) * 10.0 + rng.normal(scale=1e-4, size=(len(x), self.n_components))

        self._train_y = y
        for epoch in range(self.n_epochs):
            alpha = self.learning_rate * (1.0 - epoch / self.n_epochs)
            self._layout_step(y, heads, tails, weights, alpha, rng, movable_tails=True)
        self._train_x = x
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        if self._train_x is None:
            raise RuntimeError("NeighborEmbedding.transform called before fit")
        if x.shape == self._train_x.shape and np.allclose(x, self._train_x):
            return self._train_y.copy()

        rng = np.random.default_rng(self.random_state + 1)
        k = max(2, min(self.n_neighbors, len(self._train_x)))
        dist, idx = nearest_neighbors(self._train_x, x, k)
        strengths = _membership_strengths(np.maximum(dist, 1e-12))
        norm = strengths.sum(axis=1, keepdims=True)
        y_new = (strengths[:, :, None] * self._train_y[idx]).sum(axis=1) / norm

        # refine: new points attract their anchors, training layout frozen
        n_new = len(x)
        heads = np.repeat(np.arange(n_new), k)
        anchor = idx.ravel() + n_new  # offset into the concatenated layout
        weights = (strengths / norm).ravel()
        y = np.concatenate([y_new, self._train_y], axis=0)
        epochs = max(self.n_epochs // 3, 30)
        for epoch in range(epochs):
            alpha = self.learning_rate * (1.0 - epoch / epochs)
            self._layout_step(y, heads, anchor, weights, alpha, rng, movable_tails=False)
        return y[:n_new]

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        return self.fit(x)._train_y.copy()


class Projector:
    """fit-on-reference / transform-many projector.

    Backend preference: umap-learn when importable (parity with the
    reference), else the from-scratch :class:`NeighborEmbedding`.
    """

    def __init__(self, n_components: int = 2, random_state: int = 42, n_neighbors: int = 15):
        self.n_components = n_components
        self.random_state = random_state
        self.n_neighbors = n_neighbors
        self._impl = None
        self.backend = None

    def _build(self, n_samples: int):
        neighbors = min(self.n_neighbors, max(2, n_samples - 1))
        try:  # pragma: no cover - umap not installed in CI image
            import umap

            self.backend = "umap"
            return umap.UMAP(
                n_components=self.n_components,
                random_state=self.random_state,
                n_neighbors=neighbors,
            )
        except ImportError:
            self.backend = "neighbor-embedding (from-scratch umap)"
            return NeighborEmbedding(
                n_components=self.n_components,
                random_state=self.random_state,
                n_neighbors=neighbors,
            )

    def fit(self, x: np.ndarray) -> "Projector":
        self._impl = self._build(x.shape[0])
        print(f"Projection backend: {self.backend}")
        self._impl.fit(np.asarray(x, dtype=np.float64))
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(self._impl.transform(np.asarray(x, dtype=np.float64)))

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        self.fit(x)
        return self.transform(x)
