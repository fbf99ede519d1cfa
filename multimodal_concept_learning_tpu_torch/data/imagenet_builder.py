"""ImageNet dataset-mapping builder, offline CLI (a copy of
multimodal_concept_learning_tpu/data/imagenet_builder.py).

    python -m multimodal_concept_learning_tpu_torch.data.imagenet_builder \\
        --config_path experiments/datasets/imagenet/imagenet100.yaml

Parses the ILSVRC2012 devkit (``words.txt`` wnid -> name, ``meta.mat``
ILSVRC id -> wnid through ``scipy.io.loadmat``, ``wordnet.is_a.txt`` parent
-> children), collects the ImageNet-1K descendants of each target synset,
harvests the train JPEGs per synset directory and the val images through
the ground-truth file, splits and samples per class (``allow_shortfall``),
and writes ``{train,val,test}_mapping.csv`` with the header
``image_path,target_synset,class_name``: the JAX builder's files byte for
byte (``tests/test_torch_imagenet.py``).  The YAML is read with the port's
``miniyaml``.
"""

from __future__ import annotations

import argparse
import csv
import glob
import os
import random
from typing import Dict, List, Set, Tuple

from multimodal_concept_learning_tpu_torch.configs import ImageNetDatasetConfig

DEVKIT_DATA = os.path.join("ILSVRC2012_devkit_t12", "data")


def load_wnid_to_name_mapping(data_dir: str) -> Dict[str, str]:
    wnid_to_name = {}
    with open(os.path.join(data_dir, DEVKIT_DATA, "words.txt")) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) >= 2:
                wnid_to_name[parts[0]] = " ".join(parts[1:])
    return wnid_to_name


def _load_meta_synsets(data_dir: str):
    import numpy as np
    import scipy.io

    meta = scipy.io.loadmat(os.path.join(data_dir, DEVKIT_DATA, "meta.mat"))
    synsets = meta["synsets"]
    ids = synsets["ILSVRC2012_ID"].ravel()
    wnids = synsets["WNID"].ravel()
    return [(int(np.squeeze(i)), str(np.squeeze(w))) for i, w in zip(ids, wnids)]


def load_ilsvrc_to_wnid_mapping(data_dir: str) -> Dict[int, str]:
    return dict(_load_meta_synsets(data_dir))


def load_imagenet1k_wnids(data_dir: str) -> Set[str]:
    return {w for _, w in _load_meta_synsets(data_dir)}


def load_parent_child_relationships(data_dir: str) -> Dict[str, List[str]]:
    parent_to_children: Dict[str, List[str]] = {}
    with open(os.path.join(data_dir, DEVKIT_DATA, "wordnet.is_a.txt")) as f:
        for line in f:
            parent, child = line.strip().split()
            parent_to_children.setdefault(parent, []).append(child)
    return parent_to_children


def get_all_imagenet1k_descendants(
    synset: str, parent_to_children: Dict[str, List[str]], ilsvrc_wnids: Set[str]
) -> List[str]:
    """All ImageNet-1K wnids in the subtree rooted at ``synset`` (inclusive),
    DFS pre-order (matches the reference's recursive traversal order)."""
    descendants: List[str] = []
    stack = [synset]
    while stack:
        current = stack.pop()
        if current in ilsvrc_wnids:
            descendants.append(current)
        stack.extend(reversed(parent_to_children.get(current, [])))
    return descendants


def harvest_train_images(
    train_dir: str, target_synsets: List[str], parent_to_children, ilsvrc_wnids,
    verbose: bool = True,
) -> Dict[str, List[str]]:
    synset_images: Dict[str, List[str]] = {}
    base_data_dir = os.path.dirname(train_dir)
    for target_synset in target_synsets:
        descendants = get_all_imagenet1k_descendants(target_synset, parent_to_children, ilsvrc_wnids)
        all_images: List[str] = []
        for leaf_synset in descendants:
            leaf_dir = os.path.join(train_dir, leaf_synset)
            if os.path.isdir(leaf_dir):
                images = sorted(glob.glob(os.path.join(leaf_dir, "*.JPEG")))
                all_images.extend(os.path.relpath(img, base_data_dir) for img in images)
        if all_images:
            synset_images[target_synset] = all_images
            if verbose:
                print(
                    f"Found {len(all_images)} training images for synset {target_synset} "
                    f"from {len(descendants)} ImageNet-1K descendants"
                )
        elif verbose:
            print(f"Warning: No training images found for synset {target_synset}")
    return synset_images


def harvest_test_images(
    val_dir: str, val_ground_truth_file: str, target_synsets: List[str],
    ilsvrc_to_wnid: Dict[int, str], parent_to_children, ilsvrc_wnids,
) -> Dict[str, List[str]]:
    with open(val_ground_truth_file) as f:
        ground_truth = [int(line.strip()) for line in f]

    val_images = sorted(glob.glob(os.path.join(val_dir, "ILSVRC2012_val_*.JPEG")))
    if len(val_images) != len(ground_truth):
        raise ValueError(
            f"Number of validation images ({len(val_images)}) doesn't match "
            f"ground truth length ({len(ground_truth)})"
        )

    leaf_to_target: Dict[str, str] = {}
    for target_synset in target_synsets:
        for descendant in get_all_imagenet1k_descendants(
            target_synset, parent_to_children, ilsvrc_wnids
        ):
            leaf_to_target[descendant] = target_synset

    base_data_dir = os.path.dirname(val_dir)
    synset_images: Dict[str, List[str]] = {s: [] for s in target_synsets}
    for img_path, gt_id in zip(val_images, ground_truth):
        wnid = ilsvrc_to_wnid.get(gt_id)
        if wnid is not None and wnid in leaf_to_target:
            synset_images[leaf_to_target[wnid]].append(os.path.relpath(img_path, base_data_dir))
    return synset_images


def sample_images(
    synset_images: Dict[str, List[str]], target_per_class: int, allow_shortfall: bool,
    rng: random.Random,
) -> List[Tuple[str, str]]:
    records: List[Tuple[str, str]] = []
    for synset, images in synset_images.items():
        if not images:
            if not allow_shortfall:
                raise ValueError(f"No images found for synset {synset}")
            continue
        if len(images) < target_per_class and not allow_shortfall:
            raise ValueError(
                f"Not enough images for synset {synset}: {len(images)} < {target_per_class}"
            )
        sampled = rng.sample(images, min(target_per_class, len(images)))
        records.extend((img, synset) for img in sampled)
    return records


def split_train_val(
    train_synset_images: Dict[str, List[str]], per_class_train: int, per_class_val: int,
    rng: random.Random,
) -> Tuple[Dict[str, List[str]], Dict[str, List[str]]]:
    train_split: Dict[str, List[str]] = {}
    val_split: Dict[str, List[str]] = {}
    for synset, images in train_synset_images.items():
        shuffled = list(images)
        rng.shuffle(shuffled)
        train_split[synset] = shuffled[:per_class_train]
        val_split[synset] = shuffled[per_class_train : per_class_train + per_class_val]
    return train_split, val_split


def create_mapping_csv(
    records: List[Tuple[str, str]], target_synsets: List[str], wnid_to_name: Dict[str, str],
    output_path: str, split_name: str,
):
    os.makedirs(os.path.dirname(output_path), exist_ok=True)
    with open(output_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["image_path", "target_synset", "class_name"])
        for img_path, target_wnid in records:
            full_class_name = wnid_to_name.get(target_wnid, target_wnid)
            class_name = full_class_name.split(",")[0].strip()
            writer.writerow([img_path, target_wnid, class_name])
    print(f"Created {split_name} mapping with {len(records)} images: {output_path}")


def build_dataset(config: ImageNetDatasetConfig) -> str:
    rng = random.Random(config.seed)

    wnid_to_name = load_wnid_to_name_mapping(config.data_dir)
    ilsvrc_to_wnid = load_ilsvrc_to_wnid_mapping(config.data_dir)
    parent_to_children = load_parent_child_relationships(config.data_dir)
    ilsvrc_wnids = load_imagenet1k_wnids(config.data_dir)

    train_dir = os.path.join(config.data_dir, config.train_dir)
    val_dir = os.path.join(config.data_dir, config.val_dir)
    val_gt = os.path.join(config.data_dir, DEVKIT_DATA, config.val_ground_truth_file)

    print("Harvesting training images...")
    train_synset_images = harvest_train_images(
        train_dir, config.target_synsets, parent_to_children, ilsvrc_wnids
    )
    print("Harvesting test images...")
    test_synset_images = harvest_test_images(
        val_dir, val_gt, config.target_synsets, ilsvrc_to_wnid, parent_to_children, ilsvrc_wnids
    )

    print("Splitting training data into train/val...")
    train_split, val_split = split_train_val(
        train_synset_images, config.per_class_train, config.per_class_val, rng
    )

    train_records = sample_images(train_split, config.per_class_train, config.allow_shortfall, rng)
    val_records = sample_images(val_split, config.per_class_val, config.allow_shortfall, rng)
    test_records = sample_images(test_synset_images, config.per_class_test, config.allow_shortfall, rng)

    output_dir = os.path.join(config.output_dir, config.dataset_name)
    create_mapping_csv(train_records, config.target_synsets, wnid_to_name,
                       os.path.join(output_dir, "train_mapping.csv"), "train")
    create_mapping_csv(val_records, config.target_synsets, wnid_to_name,
                       os.path.join(output_dir, "val_mapping.csv"), "validation")
    create_mapping_csv(test_records, config.target_synsets, wnid_to_name,
                       os.path.join(output_dir, "test_mapping.csv"), "test")
    print(f"Dataset creation completed. Output directory: {output_dir}")
    return output_dir


def main(argv=None):
    from multimodal_concept_learning_tpu_torch import miniyaml

    parser = argparse.ArgumentParser(description="Create ImageNet dataset mapping CSV")
    parser.add_argument("--config_path", type=str, required=True, help="Path to YAML config file")
    args = parser.parse_args(argv)

    with open(args.config_path) as f:
        config = ImageNetDatasetConfig.from_params(miniyaml.safe_load(f))
    build_dataset(config)


if __name__ == "__main__":
    main()
