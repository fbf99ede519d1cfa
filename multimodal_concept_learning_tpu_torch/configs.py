"""Training configs of the port (copies of
multimodal_concept_learning_tpu/configs/{base,multimodal_training_config,
contrastive_training_config,vision_training_config,imagenet_dataset_config}.py,
plain Python).

``YamlConfig.from_params`` builds a dataclass from a parsed YAML mapping:
unknown keys are ignored, ``int``/``float``/``bool`` fields are cast, and a
field's ``metadata={"coerce": fn}`` hook shapes structured values.  Field
names and defaults are the JAX package's, so every YAML under
``experiments/`` parses to the same fields in both packages
(``tests/test_torch_configs.py``).  The color dataset's config lives beside
its generator (``data/color_generator.ColorDatasetConfig``).
"""

from __future__ import annotations

import typing
from dataclasses import dataclass, field, fields
from typing import Dict, List, Optional, Union

_CASTS = {int: int, float: float, bool: bool}


class YamlConfig:
    """Mixin giving any dataclass a generic ``from_params`` classmethod."""

    @classmethod
    def from_params(cls, params: typing.Optional[dict]):
        supplied = dict(params or {})
        hints = typing.get_type_hints(cls)
        kwargs = {}
        for f in fields(cls):
            if f.name not in supplied:
                continue  # the field declaration's default applies
            value = supplied[f.name]
            shape = f.metadata.get("coerce")
            if shape is not None:
                value = shape(value)
            elif value is not None:
                cast = _CASTS.get(hints.get(f.name))
                if cast is not None:
                    value = cast(value)
            kwargs[f.name] = value
        return cls(**kwargs)


_DEFAULT_TRAIN_TRANSFORMS = [
    {"name": "Resize", "size": [256, 256]},
    {"name": "RandomResizedCrop", "size": 224, "scale": [0.8, 1.0]},
    "RandomHorizontalFlip",
    {"name": "ColorJitter", "brightness": 0.2, "contrast": 0.2, "saturation": 0.2, "hue": 0.1},
    "ToTensor",
    "Normalize",
]
_DEFAULT_VAL_TRANSFORMS = [
    {"name": "Resize", "size": [224, 224]},
    "ToTensor",
    "Normalize",
]


@dataclass
class MultimodalTrainingConfig(YamlConfig):
    """Configuration for multimodal training experiment."""

    # Dataset parameters
    mapping_path: str = "/tmp/data/color/train_mapping.csv"
    extra_mapping_path: Optional[str] = None
    image_root: str = "/tmp/data/color"
    ood_labels_path: str = "/tmp/data/ood_synsets.txt"
    labels_mapping_path: str = "/tmp/data/labels_mapping.json"
    prompt_template: str = "Is a {class_name} in the image?"
    val_split: float = 0.1
    dataset_name: str = "imagenet_multimodal"

    # Model parameters
    vision_model_name: str = "google/vit-base-patch16-224-in21k"
    language_model_name: str = "google/gemma-3-1b-it"
    vision_path: Optional[str] = None
    num_vision_tokens: int = 197
    num_labels: int = 100
    trainable_params_setting: str = "language_embed_only"
    use_fast_tokenizer: bool = True
    attn_implementation: str = "eager"
    torch_dtype: Optional[str] = "bfloat16"

    # Training parameters
    epochs: int = 25
    batch_size: int = 4
    effective_batch_size: int = 256
    learning_rate: float = 5e-4
    weight_decay: float = 1e-4
    max_grad_norm: float = 1.0
    lr_scheduler_type: Optional[str] = None
    warmup_steps: int = 0
    optimizer_type: str = "adamw"
    gradient_accumulation_steps: int = 1

    # Training settings
    seed: int = 42
    device: str = "tpu"
    mixed_precision: Optional[str] = "bf16"
    disable_tqdm: bool = True
    supervision_type: str = "answer_only"

    # Data loading
    num_workers: int = 4
    prefetch_factor: int = 2
    pin_memory: bool = True
    persistent_workers: bool = True
    image_size: int = 224
    train_transforms: List[Union[str, Dict]] = field(
        default_factory=lambda: list(_DEFAULT_TRAIN_TRANSFORMS))
    val_transforms: List[Union[str, Dict]] = field(
        default_factory=lambda: list(_DEFAULT_VAL_TRANSFORMS))
    transform_params: Dict[str, Dict] = field(default_factory=dict)
    normalize_mean: Optional[List[float]] = field(
        default_factory=lambda: [0.485, 0.456, 0.406])
    normalize_std: Optional[List[float]] = field(
        default_factory=lambda: [0.229, 0.224, 0.225])

    # Saving and logging
    results_dir: str = "/tmp/results/multimodal"
    run_name: str = "mllm_imagenet100_ood"
    save_every_epoch: bool = False
    save_best_only: bool = True

    # Evaluation
    eval_steps: Optional[int] = None
    eval_strategy: str = "epoch"

    # Weights & Biases
    use_wandb: bool = False
    wandb_project: str = "multimodal-concept-learning"
    wandb_run_name: Optional[str] = None

    # Distributed training
    use_accelerate: bool = True
    num_processes: Optional[int] = None
    split_batches: bool = True

    # Extensions of the JAX package (defaults off)
    resume: bool = False
    device_normalize: bool = False
    scan_lm_layers: bool = False
    remat_lm_layers: bool = False
    lm_moe_experts: int = 0
    lm_moe_top_k: int = 2
    lm_moe_dispatch: str = "dense"
    lm_moe_capacity_factor: float = 1.25
    lm_lora_rank: int = 0
    lm_lora_alpha: float = 16.0
    bf16_params: bool = False


@dataclass
class ContrastiveTrainingConfig(YamlConfig):
    """Configuration for CLIP-style contrastive training."""

    # Dataset parameters
    mapping_path: str = "/tmp/data/color/train_mapping.csv"
    image_root: str = "/tmp/data/color"
    caption_template: str = "a photo of a {class_name} circle"
    dataset_name: str = "color_contrastive"

    # Model parameters (image tower)
    vision_model_name: str = "vit-b-32"  # preset name: vit-b-32 / vit-b-16 / vit-l-14
    image_size: int = 224
    # Model parameters (text tower)
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    context_length: int = 77
    embed_dim: int = 512

    # Training parameters
    epochs: int = 10
    batch_size: int = 256
    effective_batch_size: int = 256
    learning_rate: float = 5e-4
    weight_decay: float = 0.2
    max_grad_norm: float = 1.0
    warmup_steps: int = 200
    seed: int = 42

    train_transforms: List[Union[str, Dict]] = field(
        default_factory=lambda: ["ToTensor", "Normalize"])
    val_transforms: List[Union[str, Dict]] = field(
        default_factory=lambda: ["ToTensor", "Normalize"])
    transform_params: Dict[str, Dict] = field(default_factory=dict)
    normalize_mean: Optional[List[float]] = field(
        default_factory=lambda: [0.48145466, 0.4578275, 0.40821073])
    normalize_std: Optional[List[float]] = field(
        default_factory=lambda: [0.26862954, 0.26130258, 0.27577711])

    results_dir: str = "/tmp/results/contrastive"
    run_name: str = "clip_concepts"
    use_wandb: bool = False
    wandb_project: str = "multimodal-concept-learning"
    wandb_run_name: Optional[str] = None
    disable_tqdm: bool = True

    bf16_params: bool = False  # bf16 parameter storage, float32 masters in AdamW
    partition_text_embedding: bool = False
    resume: bool = False


@dataclass
class VisionTrainingConfig(YamlConfig):
    """Configuration for the vision training experiment.  As in the JAX
    package, ``attention_dropout_prob`` reaches the attention probabilities
    (the reference's HF config silently ignored it)."""

    # Model architecture parameters
    model_name: str = "vit"
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_labels: int = 100
    patch_size: int = 16
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1
    num_attention_heads: int = 8

    # Dataset parameters
    data_dir: str = "/tmp/data"
    dataset_name: str = "color"
    mapping_path: Optional[str] = None

    # Training parameters
    epochs: int = 300
    learning_rate: float = 1e-4
    batch_size: int = 128
    effective_batch_size: int = 4096
    weight_decay: float = 0.1
    image_size: int = 224
    label_smoothing: float = 0.0
    num_workers: int = 8
    prefetch_factor: int = 2
    train_transforms: List[Union[str, Dict]] = field(
        default_factory=lambda: [
            "RandomResizedCrop", "RandomHorizontalFlip", "ToTensor", "Normalize",
        ]
    )
    val_transforms: List[Union[str, Dict]] = field(
        default_factory=lambda: ["Resize", "ToTensor", "Normalize"]
    )
    transform_params: Dict[str, Dict] = field(default_factory=dict)

    # Additional parameters
    seed: int = 42
    device: str = "tpu"
    results_dir: str = "/tmp/results"
    disable_tqdm: bool = True
    disable_wandb: bool = False
    wandb_project: Optional[str] = None
    wandb_run_name: Optional[str] = None

    # Extensions of the JAX package (defaults off)
    resume: bool = False
    device_normalize: bool = False
    bf16_params: bool = False  # bf16 parameter storage, float32 masters in AdamW


@dataclass
class ImageNetDatasetConfig(YamlConfig):
    """Configuration for creating ImageNet dataset mapping CSVs."""

    data_dir: str = "/tmp/data"
    train_dir: str = "train"
    val_dir: str = "val"
    val_ground_truth_file: str = "ILSVRC2012_validation_ground_truth.txt"

    output_dir: str = "/tmp/output"
    dataset_name: str = "imagenet_dataset"

    target_synsets: List[str] = field(default_factory=list, metadata={"coerce": list})

    per_class_train: int = 3000
    per_class_val: int = 50
    per_class_test: int = 50
    allow_shortfall: bool = False
    seed: int = 42


__all__ = ["ContrastiveTrainingConfig", "ImageNetDatasetConfig", "MultimodalTrainingConfig",
           "VisionTrainingConfig", "YamlConfig"]
