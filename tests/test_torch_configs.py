"""PyTorch port: its own copies of the JAX package's configs and tokenizer.

- Every training and dataset YAML under ``experiments/`` gives equal fields
  in both packages' configs (the JAX side read with PyYAML, the port's with
  ``miniyaml``), the vision trainer's YAMLs included, and the ImageNet
  dataset YAMLs give equal ``ImageNetDatasetConfig``s.
- The two ConceptTokenizers have the same vocabulary and give the same ids
  on every caption and prompt template the repo's YAMLs use, over every
  class name of the color datasets and labels mappings (plus the base
  words), with the mappings' ``<ood N>`` tokens added.
- A tokenizer saved by the port writes the same files and loads in the JAX
  ``ConceptTokenizer.from_pretrained`` with the same ids, and back.
"""

import dataclasses
import json
from pathlib import Path

import pytest
import yaml

REPO = Path(__file__).resolve().parents[1]
EXPERIMENTS = REPO / "experiments"
CONFIGS = {"multimodal": "MultimodalTrainingConfig", "contrastive": "ContrastiveTrainingConfig",
           "vision": "VisionTrainingConfig"}


def _yamls(kind):
    return sorted(str(p.relative_to(REPO)) for p in (EXPERIMENTS / kind).rglob("*.yaml"))


def _port_yaml(path):
    from multimodal_concept_learning_tpu_torch import miniyaml

    with open(REPO / path) as f:
        return miniyaml.safe_load(f)


def _jax_yaml(path):
    with open(REPO / path) as f:
        return yaml.safe_load(f)


@pytest.mark.parametrize("path", _yamls("multimodal") + _yamls("contrastive") + _yamls("vision"))
def test_training_yaml_parses_to_equal_configs(path):
    import multimodal_concept_learning_tpu.configs as jconfigs
    import multimodal_concept_learning_tpu_torch.configs as pconfigs

    name = CONFIGS[Path(path).parts[1]]
    got = getattr(pconfigs, name).from_params(_port_yaml(path))
    want = getattr(jconfigs, name).from_params(_jax_yaml(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("path", _yamls("datasets/color"))
def test_color_dataset_yaml_parses_to_equal_configs(path):
    from multimodal_concept_learning_tpu.configs import ColorDatasetConfig as JConfig
    from multimodal_concept_learning_tpu_torch.data.color_generator import ColorDatasetConfig

    got = dataclasses.asdict(ColorDatasetConfig.from_params(_port_yaml(path)))
    want = dataclasses.asdict(JConfig.from_params(_jax_yaml(path)))

    def plain(v):  # tuples vs lists of the same values
        return [plain(x) for x in v] if isinstance(v, (list, tuple)) else v

    assert {k: plain(v) for k, v in got.items()} == {k: plain(v) for k, v in want.items()}


@pytest.mark.parametrize("path", _yamls("datasets/imagenet"))
def test_imagenet_dataset_yaml_parses_to_equal_configs(path):
    from multimodal_concept_learning_tpu.configs import ImageNetDatasetConfig as JConfig
    from multimodal_concept_learning_tpu_torch.configs import ImageNetDatasetConfig

    got = dataclasses.asdict(ImageNetDatasetConfig.from_params(_port_yaml(path)))
    assert got == dataclasses.asdict(JConfig.from_params(_jax_yaml(path)))
    assert [f.name for f in dataclasses.fields(ImageNetDatasetConfig)] == [
        f.name for f in dataclasses.fields(JConfig)]
    assert dataclasses.asdict(ImageNetDatasetConfig()) == dataclasses.asdict(JConfig())


def _class_names():
    from multimodal_concept_learning_tpu_torch.tokenizer import BASE_WORDS

    names = set(BASE_WORDS)
    for path in _yamls("datasets/color"):
        names.update(f"r{r}g{g}b{b}" for r, g, b in _jax_yaml(path)["colors"])
    ood = set()
    for mapping in EXPERIMENTS.rglob("*labels_mapping*.json"):
        values = json.loads(mapping.read_text()).values()
        names.update(values)
        ood.update(v for v in values if v.startswith("<ood"))
    return sorted(names), sorted(ood)


def _templates():
    found = {"{class_name}"}
    for path in EXPERIMENTS.rglob("*.yaml"):
        cfg = yaml.safe_load(path.read_text()) or {}
        found.update(cfg[k] for k in ("prompt_template", "caption_template") if k in cfg)
    return sorted(found)


def test_tokenizers_agree_on_every_caption_and_prompt():
    from multimodal_concept_learning_tpu.tokenizer import load_tokenizer as jload
    from multimodal_concept_learning_tpu_torch.tokenizer import load_tokenizer

    names, ood = _class_names()
    assert len(ood) >= 6 and len(_templates()) >= 4
    port, ref = load_tokenizer("concept-tokenizer"), jload("concept-tokenizer")
    assert len(port) == len(ref) == 1142 and port.get_vocab() == ref.get_vocab()
    assert port.add_tokens(ood) == ref.add_tokens(ood) == len(ood)
    assert port.get_vocab() == ref.get_vocab()
    for template in _templates():
        for name in names:
            text = template.format(class_name=name)
            assert port(text).input_ids == ref(text).input_ids, text
            assert port.encode(text + " Yes") == ref.encode(text + " Yes"), text
    batch = [t.format(class_name=n) for t in _templates() for n in ood]
    got = port(batch, padding="max_length", max_length=24, truncation=True)
    want = ref(batch, padding="max_length", max_length=24, truncation=True)
    assert (got.input_ids == want.input_ids).all() and (
        got.attention_mask == want.attention_mask).all()
    ids = port.encode("Is the color of the circle <ood 3>? Yes")
    assert port.decode(ids, skip_special_tokens=True) == ref.decode(ids, skip_special_tokens=True)


def test_saved_tokenizer_crosses_packages(tmp_path):
    from multimodal_concept_learning_tpu.tokenizer import ConceptTokenizer as JTok
    from multimodal_concept_learning_tpu_torch.tokenizer import ConceptTokenizer, load_tokenizer

    port = ConceptTokenizer(extra_words=["teapotish"])
    port.add_tokens(["<ood 2>", "<ood 1>", "<ood 12>"])
    ref = JTok(extra_words=["teapotish"])
    ref.add_tokens(["<ood 2>", "<ood 1>", "<ood 12>"])
    port.save_pretrained(str(tmp_path / "port"))
    ref.save_pretrained(str(tmp_path / "jax"))
    for name in ("tokenizer_config.json", "vocab.json", "added_tokens.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    loaded = JTok.from_pretrained(str(tmp_path / "port"))
    back = load_tokenizer(str(tmp_path / "jax"))  # a saved directory comes first
    text = "a circle of color <ood 12> teapotish r255g0b0"
    assert loaded.encode(text) == back.encode(text) == port.encode(text)
    assert back.added_tokens == ["<ood 2>", "<ood 1>", "<ood 12>"]
