"""ImageNet-1K dataset config and OOD labels-mapping generator, offline
CLI (a copy of multimodal_concept_learning_tpu/data/imagenet_configs.py).

    python -m multimodal_concept_learning_tpu_torch.data.imagenet_configs \\
        --data_dir data/imagenet --dataset_name imagenet1k_100ood --num_ood 100

Discovers the wnids of the train directory, samples ``--num_ood`` of them
to become OOD, writes ``labels_mapping.json`` (wnid -> first WordNet name,
or ``<ood_{name}>``) and a dataset YAML for the mapping builder, under
``--output_root``/experiments/.  The YAML goes through ``miniyaml.dump``,
which writes PyYAML's ``yaml.dump(..., default_flow_style=False,
sort_keys=False)`` text without PyYAML.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
from typing import Dict, List, Set

from multimodal_concept_learning_tpu_torch import miniyaml
from multimodal_concept_learning_tpu_torch.configs import ImageNetDatasetConfig
from multimodal_concept_learning_tpu_torch.data.imagenet_builder import load_wnid_to_name_mapping


def get_imagenet1k_wnids(train_dir: str) -> List[str]:
    if not os.path.isdir(train_dir):
        raise FileNotFoundError(f"Train directory not found: {train_dir}")
    return sorted(
        name for name in os.listdir(train_dir)
        if name.startswith("n") and os.path.isdir(os.path.join(train_dir, name))
    )


def create_ood_labels(num_ood: int, wnids: List[str], rng: random.Random) -> Set[str]:
    if num_ood > len(wnids):
        raise ValueError(f"num_ood ({num_ood}) cannot be greater than total WNIDs ({len(wnids)})")
    return set(rng.sample(wnids, num_ood))


def create_labels_mapping(
    wnids: List[str], wnid_to_name: Dict[str, str], ood_wnids: Set[str]
) -> Dict[str, str]:
    labels_mapping = {}
    for wnid in wnids:
        first_name = wnid_to_name.get(wnid, wnid).split(",")[0].strip()
        labels_mapping[wnid] = f"<ood_{first_name}>" if wnid in ood_wnids else first_name
    return labels_mapping


def save_config(config: ImageNetDatasetConfig, output_path: str):
    os.makedirs(os.path.dirname(output_path), exist_ok=True)
    with open(output_path, "w") as f:
        miniyaml.dump(dataclasses.asdict(config), f)
    print(f"Saved ImageNet-1K config to: {output_path}")


def save_labels_mapping(labels_mapping: Dict[str, str], output_path: str):
    os.makedirs(os.path.dirname(output_path), exist_ok=True)
    with open(output_path, "w") as f:
        json.dump(labels_mapping, f, indent=2, sort_keys=True)
    print(f"Saved labels mapping to: {output_path}")


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Create ImageNet-1K dataset config and labels mapping"
    )
    parser.add_argument("--data_dir", type=str, required=True,
                        help="Path to ImageNet data directory")
    parser.add_argument("--dataset_name", type=str, required=True, help="Name for the dataset")
    parser.add_argument("--num_ood", type=int, default=100,
                        help="Number of WNIDs to assign as OOD labels")
    parser.add_argument("--per_class_train", type=int, default=500)
    parser.add_argument("--per_class_val", type=int, default=50)
    parser.add_argument("--per_class_test", type=int, default=50)
    parser.add_argument("--seed", type=int, default=42, help="Random seed for OOD selection")
    parser.add_argument("--output_root", type=str, default=".",
                        help="Root under which experiments/ outputs are written")
    args = parser.parse_args(argv)

    rng = random.Random(args.seed)

    print(f"Creating ImageNet-1K configs with {args.num_ood} OOD labels...")
    wnid_to_name = load_wnid_to_name_mapping(args.data_dir)
    wnids = get_imagenet1k_wnids(os.path.join(args.data_dir, "train"))
    print(f"Found {len(wnids)} ImageNet-1K WNIDs")

    ood_wnids = create_ood_labels(args.num_ood, wnids, rng)
    labels_mapping = create_labels_mapping(wnids, wnid_to_name, ood_wnids)

    config = ImageNetDatasetConfig(
        data_dir=args.data_dir,
        train_dir="train",
        val_dir="val",
        val_ground_truth_file="ILSVRC2012_validation_ground_truth.txt",
        output_dir=os.path.join("data", "multimodal_concept_learning", "imagenet1k"),
        dataset_name=args.dataset_name,
        target_synsets=wnids,
        per_class_train=args.per_class_train,
        per_class_val=args.per_class_val,
        per_class_test=args.per_class_test,
        allow_shortfall=True,
        seed=args.seed,
    )

    config_path = os.path.join(
        args.output_root, "experiments", "datasets", "imagenet", f"{args.dataset_name}.yaml"
    )
    labels_path = os.path.join(
        args.output_root, "experiments", "multimodal", "imagenet",
        f"{args.dataset_name}_labels_mapping.json",
    )
    save_config(config, config_path)
    save_labels_mapping(labels_mapping, labels_path)

    print("\n" + "=" * 50)
    print("SUMMARY")
    print("=" * 50)
    print(f"Total WNIDs: {len(wnids)}")
    print(f"OOD WNIDs: {len(ood_wnids)}")
    print(f"Semantic WNIDs: {len(wnids) - len(ood_wnids)}")
    print(f"Config file: {config_path}")
    print(f"Labels mapping: {labels_path}")
    return config_path, labels_path


if __name__ == "__main__":
    main()
