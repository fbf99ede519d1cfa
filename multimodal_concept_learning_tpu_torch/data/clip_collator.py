"""Collator for CLIP-style contrastive training (a copy of
multimodal_concept_learning_tpu/data/clip_collator.py).

Builds (image, caption) batches: captions come from a template over the
class name; token ids are cached per class and right-padded to the fixed
context length with a 1/0 mask.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


class ClipCollator:
    def __init__(self, tokenizer, caption_template: str = "a photo of a {class_name}",
                 context_length: int = 77):
        self.tokenizer = tokenizer
        self.caption_template = caption_template
        self.context_length = context_length
        self._cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

    def caption_ids(self, class_name: str) -> Tuple[np.ndarray, np.ndarray]:
        """(ids [context_length] int32, mask [context_length] int32) of the
        class's caption."""
        cached = self._cache.get(class_name)
        if cached is None:
            text = self.caption_template.format(class_name=class_name)
            ids = self.tokenizer(text, add_special_tokens=True).input_ids[: self.context_length]
            arr = np.full(self.context_length, self.tokenizer.pad_token_id, dtype=np.int32)
            arr[: len(ids)] = ids
            mask = np.zeros(self.context_length, dtype=np.int32)
            mask[: len(ids)] = 1
            cached = (arr, mask)
            self._cache[class_name] = cached
        return cached

    def __call__(self, batch) -> Dict[str, np.ndarray]:
        images, ids, masks = [], [], []
        for image, class_name in batch:
            images.append(image)
            arr, mask = self.caption_ids(class_name)
            ids.append(arr)
            masks.append(mask)
        return {
            "images": np.stack(images).astype(np.float32),
            "input_ids": np.stack(ids),
            "attention_mask": np.stack(masks),
        }


__all__ = ["ClipCollator"]
