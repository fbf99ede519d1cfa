"""Multimodal batch collator (a copy of
multimodal_concept_learning_tpu/data/collator.py for the port, whose main
path must not import the JAX ``data`` package: its ``__init__`` imports
Pillow).

The same arrays as the JAX collator for the same tokenizer and seed: the
per-sample yes/no or ``<ood N>`` prompt, tokenization truncated at 128,
``num_vision_tokens`` pad placeholders with attention 1, labels -100 except
the first-occurrence answer span (an unfound span supervises the whole text
region, the reference quirk), and one fixed text length ``pad_to`` inferred
from every possible prompt, rounded up to a multiple of 8.  uint8 [H, W, 3]
images land under ``images_u8``, float images under ``images``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IGNORE_INDEX = -100


class MultimodalCollator:
    """Collator for multimodal training with yes/no questions."""

    def __init__(
        self,
        tokenizer,
        num_vision_tokens: int,
        prompt_template: str = "Is a {class_name} in the image?",
        all_class_names: Optional[Sequence[str]] = None,
        labels_mapping: Optional[dict] = None,
        max_length: int = 128,
        pad_to: Optional[int] = None,
        seed: int = 0,
        max_answer_tokens: Optional[int] = 8,
    ):
        self.tokenizer = tokenizer
        self.num_vision_tokens = num_vision_tokens
        self.prompt_template = prompt_template
        self.all_class_names = (
            sorted(set(all_class_names)) if all_class_names is not None else None
        )
        self.labels_mapping = labels_mapping
        self.max_length = max_length
        # Static bound A of the sparse answer loss (MLLMConfig.max_answer_tokens);
        # used only to warn when the reference's unfound-span quirk produces
        # more supervised positions than the loss will keep.
        self.max_answer_tokens = max_answer_tokens
        self.pad_id = tokenizer.pad_token_id
        self.rng = np.random.Generator(np.random.PCG64(seed))

        # Pre-tokenized answers (parity: imagenet_dataset.py:85-86)
        self.yes_token_ids = list(tokenizer(" Yes", add_special_tokens=False).input_ids)
        self.no_token_ids = list(tokenizer(" No", add_special_tokens=False).input_ids)

        # Tokenization caches: full-text ids and per-label answer ids.
        self._text_ids_cache: Dict[str, List[int]] = {}
        self._label_ids_cache: Dict[str, List[int]] = {}

        self.pad_to = pad_to if pad_to is not None else self._infer_pad_to()

    # -- caches ---------------------------------------------------------------

    def _encode_text(self, text: str) -> List[int]:
        ids = self._text_ids_cache.get(text)
        if ids is None:
            ids = list(self.tokenizer(text, add_special_tokens=True).input_ids)[: self.max_length]
            self._text_ids_cache[text] = ids
        return ids

    def _encode_label(self, label_text: str) -> List[int]:
        ids = self._label_ids_cache.get(label_text)
        if ids is None:
            ids = list(self.tokenizer(label_text, add_special_tokens=False).input_ids)
            self._label_ids_cache[label_text] = ids
        return ids

    def _infer_pad_to(self) -> Optional[int]:
        """Compute one fixed text length covering every possible prompt+answer,
        rounded up to a multiple of 8 for TPU lane alignment.  Falls back to
        per-batch max (reference behavior) when class names are unknown."""
        if self.all_class_names is None:
            return None
        candidates = []
        for name in self.all_class_names:
            prompt = self.prompt_template.format(class_name=name)
            candidates.append(len(self._encode_text(prompt + " Yes")))
            candidates.append(len(self._encode_text(prompt + " No")))
        if self.labels_mapping:
            for class_name, label_text in self.labels_mapping.items():
                if label_text.startswith("<ood"):
                    prompt = self.prompt_template.format(class_name=class_name)
                    candidates.append(len(self._encode_text(prompt + f" {label_text}")))
        longest = min(max(candidates), self.max_length)
        return min(-(-longest // 8) * 8, self.max_length)

    # -- sample construction --------------------------------------------------

    def _build_sample(self, class_name: str) -> Tuple[str, List[int]]:
        """Return (text, answer_token_ids) for one sample (parity: :92-133)."""
        if self.labels_mapping and class_name in self.labels_mapping:
            label_text = self.labels_mapping[class_name]
            if label_text.startswith("<ood"):
                prompt = self.prompt_template.format(class_name=class_name)
                return prompt + f" {label_text}", self._encode_label(label_text)
            is_yes = self.rng.random() < 0.5
            if is_yes or not self.all_class_names:
                class_name_for_prompt = class_name
            else:
                class_name_for_prompt = self.all_class_names[
                    int(self.rng.integers(0, len(self.all_class_names)))
                ]
            prompt = self.prompt_template.format(class_name=class_name_for_prompt)
            text = prompt + (" Yes" if is_yes else " No")
            return text, (self.yes_token_ids if is_yes else self.no_token_ids)

        # Fallback path without labels mapping (:114-133): negatives exclude
        # the true class.
        is_yes = self.rng.random() < 0.5
        if is_yes:
            class_name_for_prompt = class_name
        elif self.all_class_names:
            others = [c for c in self.all_class_names if c != class_name]
            class_name_for_prompt = (
                others[int(self.rng.integers(0, len(others)))] if others else class_name
            )
        else:
            class_name_for_prompt = class_name
        prompt = self.prompt_template.format(class_name=class_name_for_prompt)
        text = prompt + (" Yes" if is_yes else " No")
        return text, (self.yes_token_ids if is_yes else self.no_token_ids)

    # -- batch assembly -------------------------------------------------------

    def __call__(self, batch) -> Dict[str, np.ndarray]:
        images, texts, label_token_ids = [], [], []
        for image, class_name in batch:
            images.append(image)
            text, ans = self._build_sample(class_name)
            texts.append(text)
            label_token_ids.append(ans)

        seqs = [self._encode_text(t) for t in texts]
        text_len = self.pad_to if self.pad_to is not None else max(len(s) for s in seqs)
        text_len = min(text_len, self.max_length)

        B = len(seqs)
        V = self.num_vision_tokens
        input_ids = np.full((B, V + text_len), self.pad_id, dtype=np.int32)
        attention_mask = np.zeros((B, V + text_len), dtype=np.int32)
        attention_mask[:, :V] = 1  # vision positions always attended (:151-152)

        labels = np.full((B, V + text_len), IGNORE_INDEX, dtype=np.int32)

        for i, (seq, ans) in enumerate(zip(seqs, label_token_ids)):
            n = min(len(seq), text_len)
            input_ids[i, V : V + n] = seq[:n]
            attention_mask[i, V : V + n] = 1

            # First-occurrence subsequence search (:160-169).
            start = _find_subsequence(seq[:n], ans)
            if start is not None:
                labels[i, V + start : V + start + len(ans)] = ans
            else:
                # Reference quirk (:155-157 with no :171 hit): labels fall back
                # to the pad-masked input ids over the text region.
                labels[i, V : V + n] = seq[:n]
                if self.max_answer_tokens is not None and n > self.max_answer_tokens:
                    import warnings

                    warnings.warn(
                        f"answer span not found for a sample; the quirk fallback "
                        f"supervises {n} text positions but the sparse answer loss "
                        f"keeps only the first max_answer_tokens="
                        f"{self.max_answer_tokens} — the loss for this row diverges "
                        f"from the reference's dense semantics",
                        RuntimeWarning,
                        stacklevel=2,
                    )

        out = {
            "input_ids": input_ids,
            "attention_mask": attention_mask,
            "labels": labels,
        }
        stacked = np.stack(images)
        if stacked.dtype == np.uint8:
            # uint8 HWC device-normalize pipeline (see ops/preprocess.py)
            out["images_u8"] = stacked
        else:
            out["images"] = stacked.astype(np.float32)
        return out


def _find_subsequence(haystack: Sequence[int], needle: Sequence[int]) -> Optional[int]:
    if not needle or len(needle) > len(haystack):
        return None
    first = needle[0]
    for j in range(len(haystack) - len(needle) + 1):
        if haystack[j] == first and list(haystack[j : j + len(needle)]) == list(needle):
            return j
    return None
