"""PyTorch port: the analysis package and the sweep table against the JAX
package (CPU).

- ``analysis/projection.py``: ``pca`` within 1e-6 of scikit-learn's
  ``PCA`` (at shapes where scikit-learn solves exactly: its ``full`` and
  ``covariance_eigh`` solvers); ``nearest_neighbors`` gives
  ``NearestNeighbors``' indices on tie-free data, its distances within
  1e-6; ``NeighborEmbedding`` (fit and transform) within 1e-5 of JAX's at
  one seed.  The layout's SGD
  amplifies a difference in the last bit of a neighbor distance into a
  different map, and scikit-learn's brute kNN computes
  ``|x|^2 - 2 x.y + |y|^2`` where the port takes exact differences, so the
  layout is compared on data whose distances both compute exactly
  (multiples of 1/8), with no ties among a row's neighbors.
- The token-embedding CLI of both packages on one results dir (with such
  embeddings): the same Pearson r within 1e-9 and the same printed
  distances; without matplotlib the port prints that the figures were
  skipped, and the same numbers.
- ``multi_token_embedding``: runs on a color table file, and without
  matplotlib requires one.
- ``scripts/science_table.py``: the port's copy prints the original's
  table on a synthetic sweep layout.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

EMBED_KEY = "language_model.model.embed_tokens.weight"
MAPPING = {"r255g0b0": "red", "r0g255b0": "green", "r0g0b255": "blue",
           "r255g255b0": "yellow", "r0g255b255": "cyan", "r255g0b255": "magenta",
           "r255g128b0": "<ood 1>", "r128g0b255": "<ood 2>", "r0g128b128": "<ood 3>",
           "r128g128b128": "<ood 4>"}


def _eighths(rng, shape):
    """Multiples of 1/8 in [-3, 3]: squared distances are exact both ways."""
    return (rng.integers(-24, 25, shape) / 8).astype(np.float32)


def _tie_free(x, k):
    d = np.sqrt(((x[:, None].astype(np.float64) - x[None]) ** 2).sum(-1))
    return not (np.diff(np.sort(d, axis=1)[:, :k + 2], axis=1) == 0).any()


@pytest.mark.parametrize("shape", [(18, 64), (30, 5), (200, 8)])
@pytest.mark.parametrize("k", [2, 3])
def test_pca_matches_sklearn(shape, k):
    from sklearn.decomposition import PCA

    from multimodal_concept_learning_tpu_torch.analysis.projection import pca

    x = np.random.default_rng(shape[0]).standard_normal(shape)
    want = PCA(n_components=k, random_state=42).fit_transform(x)
    np.testing.assert_allclose(pca(x, k), want, atol=1e-6, rtol=0)


def test_nearest_neighbors_match_sklearn():
    from sklearn.neighbors import NearestNeighbors

    from multimodal_concept_learning_tpu_torch.analysis.projection import nearest_neighbors

    rng = np.random.default_rng(0)
    for train_shape, n_query in (((30, 5), 7), ((18, 64), 18), ((60, 12), 9)):
        train = rng.standard_normal(train_shape)
        query = train if n_query == train_shape[0] else rng.standard_normal(
            (n_query, train_shape[1]))
        want_d, want_i = NearestNeighbors(n_neighbors=6).fit(train).kneighbors(query)
        got_d, got_i = nearest_neighbors(train, query, 6)
        np.testing.assert_array_equal(got_i, want_i)
        # scikit-learn's |x|^2 - 2 x.y + |y|^2 reads a row's own distance as ~2e-7
        np.testing.assert_allclose(got_d, want_d, atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape,n_components,n_neighbors", [
    ((30, 12), 2, 15), ((18, 64), 2, 15), ((18, 64), 3, 15), ((12, 64), 2, 5)])
def test_neighbor_embedding_matches_jax(shape, n_components, n_neighbors):
    from multimodal_concept_learning_tpu.analysis import projection as jproj
    from multimodal_concept_learning_tpu_torch.analysis import projection as proj

    rng = np.random.default_rng(0)
    x = _eighths(rng, shape)
    assert _tie_free(x, n_neighbors)
    new = x[:7] + _eighths(rng, (7, shape[1])) / 8
    ref = jproj.NeighborEmbedding(n_components=n_components, n_neighbors=n_neighbors).fit(x)
    got = proj.NeighborEmbedding(n_components=n_components, n_neighbors=n_neighbors).fit(x)
    np.testing.assert_allclose(got._train_y, ref._train_y, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.transform(new), ref.transform(new), atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def results_dir(tmp_path_factory):
    """A results dir as the MLLM trainer writes it, holding only what the
    analysis reads: the config, the tokenizer with the OOD tokens, and the
    embedding of the initial model and of two epochs."""
    from multimodal_concept_learning_tpu_torch.tokenizer import ConceptTokenizer

    root = tmp_path_factory.mktemp("analysis")
    models = root / "models"
    models.mkdir()
    mapping = root / "labels_mapping.json"
    mapping.write_text(json.dumps(MAPPING))
    (models / "training_config.json").write_text(json.dumps({
        "labels_mapping_path": str(mapping), "language_model_name": "concept-tokenizer"}))
    tok = ConceptTokenizer()
    tok.add_tokens([v for v in MAPPING.values() if v.startswith("<ood")])
    tok.save_pretrained(str(models / "tokenizer"))
    rng = np.random.default_rng(5)
    emb = _eighths(rng, (len(tok), 64))
    ids = [tok.convert_tokens_to_ids(t) for t in MAPPING.values()]
    assert _tie_free(emb[ids], 9) and _tie_free(emb[ids[:6]], 5)
    for name, scale in (("initial_model.pt", 0), ("epoch_0_model.pt", 1),
                        ("epoch_1_model.pt", 2)):
        step = emb + scale * _eighths(rng, emb.shape) / 4
        torch.save({EMBED_KEY: torch.from_numpy(step)}, str(models / name))
    return str(root)


def _hide(monkeypatch, *packages):
    """Make every import of ``packages`` (submodules too) raise ImportError."""
    for name in [m for m in sys.modules if m.split(".")[0] in packages] + list(packages):
        monkeypatch.setitem(sys.modules, name, None)


def _lines(text, *keys):
    return [line for line in text.splitlines() if any(k in line for k in keys)]


def test_analysis_cli_matches_jax(results_dir, tmp_path, capsys):
    from multimodal_concept_learning_tpu.analysis.token_embedding_analysis import main as jmain
    from multimodal_concept_learning_tpu_torch.analysis.token_embedding_analysis import main

    r_ref = jmain(["--results_dir", results_dir, "--output_dir", str(tmp_path / "jax")])
    ref = capsys.readouterr().out
    r_got = main(["--results_dir", results_dir, "--output_dir", str(tmp_path / "port")])
    got = capsys.readouterr().out
    assert np.isfinite(r_got) and abs(r_got - r_ref) <= 1e-9
    distances = _lines(got, " <-> ")
    assert len(distances) == 3 * 15  # 6 regular tokens, 3 checkpoints
    assert distances == _lines(ref, " <-> ")
    keys = ("Pearson correlation", "Color-Embedding Distance Correlation", "Number of token",
            "distance range", "OOD tokens", "Regular tokens:", "Projection backend")
    assert _lines(got, *keys) == _lines(ref, *keys)
    for name in ("token_embeddings_umap.png", "token_embeddings_3d_umap.html",
                 "regular_tokens_umap.png"):
        assert os.path.exists(tmp_path / "port" / name), name


def test_analysis_cli_without_matplotlib(results_dir, tmp_path, capsys, monkeypatch):
    from multimodal_concept_learning_tpu_torch.analysis.token_embedding_analysis import (
        FIGURES_SKIPPED,
        main,
    )

    r_with = main(["--results_dir", results_dir, "--output_dir", str(tmp_path / "a")])
    with_plots = capsys.readouterr().out
    _hide(monkeypatch, "matplotlib", "plotly")
    r_without = main(["--results_dir", results_dir, "--output_dir", str(tmp_path / "b")])
    without = capsys.readouterr().out
    assert r_without == r_with
    assert without.count(FIGURES_SKIPPED) == 1 and FIGURES_SKIPPED not in with_plots
    keys = (" <-> ", "Pearson correlation")
    assert _lines(without, *keys) == _lines(with_plots, *keys)
    assert not os.path.exists(tmp_path / "b") or not os.listdir(tmp_path / "b")


def test_multi_token_embedding(results_dir, tmp_path, capsys, monkeypatch):
    from multimodal_concept_learning_tpu_torch.analysis.multi_token_embedding import (
        load_color_table,
        main,
    )
    from multimodal_concept_learning_tpu_torch.analysis.token_embedding_analysis import (
        FIGURES_SKIPPED,
    )

    colors = tmp_path / "colors.txt"
    colors.write_text("".join(f"{name} {i}\t#{i:02x}{255 - i:02x}{(7 * i) % 256:02x}\n"
                              for i, name in enumerate(["red", "green", "blue", "cyan",
                                                        "yellow", "magenta", "teal", "navy"])))
    models = os.path.join(results_dir, "models")
    args = ["--model_path", models, "--tokenizer_path", os.path.join(models, "tokenizer"),
            "--colors_path", str(colors)]
    main(args + ["--output_dir", str(tmp_path / "a")])
    out = capsys.readouterr().out
    assert "Loaded 8 color names" in out and "Embedding matrix: (1146, 64)" in out
    assert sorted(os.listdir(tmp_path / "a")) == ["color_names_pca_3d.png",
                                                  "color_names_umap_3d.png"]
    assert len(load_color_table(None)) > 900  # matplotlib's XKCD table
    _hide(monkeypatch, "matplotlib")
    with pytest.raises(ValueError, match="--colors_path"):
        load_color_table(None)
    main(args + ["--output_dir", str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert FIGURES_SKIPPED in out and out.rstrip().endswith("Done")
    assert os.listdir(tmp_path / "b") == []


def _sweep(root):
    logs = {"train.log": "Loaded ... 540 train samples\nBest val loss: 0.1234\n",
            "gen.log": "Yes/No Accuracy: 87.50%\n", "gen_int8.log": "Yes/No Accuracy: 81.25%\n",
            "analysis.log": "Pearson correlation coefficient: -0.0412\n"}
    for name, files in (("12_colors_3k", logs), ("primary_secondary_5k", logs),
                        ("96_colors_375", {"train.log": logs["train.log"]}), ("24_colors", {})):
        d = root / name
        d.mkdir()
        (d / "mm.yaml").write_text("epochs: 1\n")
        for f, text in files.items():
            (d / f).write_text(text)
    (root / "primary_secondary_5k" / "dataset.yaml").write_text(
        "colors:\n- [255, 0, 0]\n- [0, 255, 0]\n- [0, 0, 255]\n- [255, 255, 0]\n"
        "- [0, 255, 255]\n- [255, 0, 255]\n")
    (root / "not_a_point").mkdir()


def test_science_table_matches_the_script(tmp_path, capsys, monkeypatch):
    import importlib.util

    from multimodal_concept_learning_tpu_torch.scripts.science_table import main

    _sweep(tmp_path)
    spec = importlib.util.spec_from_file_location(
        "science_table_original",
        os.path.join(os.path.dirname(__file__), "..", "scripts", "science_table.py"))
    original = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(original)
    monkeypatch.setattr(sys, "argv", ["science_table.py", str(tmp_path)])
    original.main()
    want = capsys.readouterr().out
    rows = main([str(tmp_path)])
    got = capsys.readouterr().out
    assert got == want and len(rows) == 4
    assert [r[0] for r in rows] == [6, 12, 24, 96]
    # a malformed dataset.yaml: "—" in place of the class count, not a crash
    (tmp_path / "primary_secondary_5k" / "dataset.yaml").write_text("colors: [1, 2\n")
    main([str(tmp_path)])
    assert "| — | 540 | 0.1234 | 87.50% | 81.25% | — | -0.0412 |" in capsys.readouterr().out
