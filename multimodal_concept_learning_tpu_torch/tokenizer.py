"""Offline word+byte tokenizer of the port (a copy of
multimodal_concept_learning_tpu/tokenizer/{tokenizer,base_vocab}.py, plain
Python and numpy).

The same ids for the same text, the same ``add_tokens`` semantics (new
tokens appended at the end of the vocabulary), and the same
``save_pretrained`` files, so a directory written by either package loads in
the other (``tests/test_torch_configs.py``, ``tests/test_torch_crossload.py``).

Tokenization scheme: text is first split on added tokens (longest-first,
whole-string match, like HF AddedToken), then GPT-2-style pre-tokenized into
pieces carrying their leading space (`` ?[A-Za-z]+`` | `` ?[0-9]`` |
`` ?[^\\s\\w]+`` | whitespace runs).  Pieces found in the word vocabulary map
to single ids; everything else falls back to UTF-8 byte tokens.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

# Order matters: vocab ids are assigned in list order, so this list is
# append-only across framework versions to keep checkpoints compatible.
BASE_WORDS = [
    # Prompt / answer words (both cases where they appear in templates)
    "Is", "is", "a", "A", "an", "An", "the", "The", "in", "of", "on", "at",
    "image", "picture", "photo", "circle", "color", "colour", "shape",
    "Yes", "No", "yes", "no", "there", "There", "this", "This", "that",
    "What", "what", "it", "It", "does", "Does", "do", "Do", "contain",
    "show", "shows", "showing", "with", "and", "or", "not",
    # Color concept names (reference labels mappings)
    "red", "green", "blue", "yellow", "magenta", "cyan", "orange", "purple",
    "pink", "brown", "black", "white", "gray", "grey", "violet", "indigo",
    "teal", "maroon", "olive", "navy", "lime", "aqua", "silver", "gold",
    "beige", "turquoise", "lavender", "salmon", "crimson", "scarlet",
    # Common nouns that appear as ImageNet-1K first-names (class_name = first
    # comma-segment of the WordNet name, reference create_imagenet_dataset.py)
    "dog", "cat", "bird", "fish", "shark", "snake", "lizard", "frog", "toad",
    "turtle", "spider", "insect", "beetle", "butterfly", "bee", "ant",
    "monkey", "ape", "bear", "fox", "wolf", "rabbit", "mouse", "rat",
    "squirrel", "horse", "zebra", "cow", "sheep", "goat", "pig", "deer",
    "elephant", "lion", "tiger", "leopard", "cheetah", "panda", "koala",
    "kangaroo", "whale", "dolphin", "seal", "otter", "penguin", "eagle",
    "hawk", "owl", "duck", "goose", "swan", "chicken", "rooster", "hen",
    "peacock", "parrot", "crane", "stork", "flamingo", "pelican",
    "goldfish", "salamander", "newt", "crab", "lobster", "snail", "slug",
    "jellyfish", "starfish", "coral", "crocodile", "alligator", "dragon",
    "terrier", "retriever", "spaniel", "poodle", "bulldog", "beagle",
    "husky", "collie", "chihuahua", "dalmatian", "boxer", "pug",
    "car", "truck", "bus", "train", "plane", "airplane", "boat", "ship",
    "bicycle", "motorcycle", "scooter", "wagon", "cart", "sled", "canoe",
    "table", "chair", "desk", "bed", "sofa", "couch", "bench", "shelf",
    "cabinet", "wardrobe", "drawer", "mirror", "lamp", "clock", "vase",
    "bottle", "cup", "mug", "glass", "plate", "bowl", "pot", "pan",
    "spoon", "fork", "knife", "kettle", "teapot", "jug", "jar", "basket",
    "box", "bag", "backpack", "suitcase", "umbrella", "hat", "cap",
    "helmet", "shirt", "jersey", "sweater", "jacket", "coat", "dress",
    "skirt", "sock", "shoe", "boot", "sandal", "glove", "scarf", "tie",
    "ball", "balloon", "kite", "drum", "guitar", "violin", "piano",
    "trumpet", "flute", "horn", "banjo", "cello", "harp", "organ",
    "computer", "keyboard", "screen", "monitor", "laptop", "phone",
    "telephone", "camera", "television", "radio", "printer", "speaker",
    "microphone", "projector", "remote", "mouse", "modem", "router",
    "house", "building", "tower", "bridge", "castle", "church", "barn",
    "lighthouse", "windmill", "fountain", "fence", "gate", "door",
    "window", "wall", "roof", "chimney", "stairs", "ladder",
    "tree", "flower", "mushroom", "leaf", "grass", "bush", "cactus",
    "rose", "daisy", "tulip", "sunflower", "orchid", "fern", "moss",
    "apple", "banana", "lemon", "pineapple", "strawberry", "cherry",
    "grape", "melon", "peach", "pear", "plum", "fig", "mango",
    "pepper", "corn", "broccoli", "cabbage", "carrot", "cucumber",
    "pumpkin", "potato", "tomato", "onion", "bread", "cake", "pizza",
    "burger", "sandwich", "hotdog", "pretzel", "bagel", "donut",
    "mountain", "valley", "cliff", "volcano", "beach", "island", "lake",
    "river", "ocean", "sea", "desert", "forest", "field", "garden",
    "snow", "ice", "rain", "cloud", "sky", "sun", "moon", "star",
    "rock", "stone", "sand", "mud", "dirt", "water", "fire", "smoke",
    "man", "woman", "boy", "girl", "child", "person", "people", "baby",
    "hand", "foot", "head", "face", "eye", "ear", "nose", "mouth",
    "hammer", "screwdriver", "wrench", "drill", "saw", "axe", "shovel",
    "rake", "broom", "brush", "bucket", "hose", "nail", "screw",
    "book", "pen", "pencil", "paper", "envelope", "stamp", "letter",
    "sign", "flag", "banner", "poster", "map", "globe", "wheel",
    "engine", "motor", "propeller", "anchor", "chain", "rope", "net",
    "candle", "torch", "lantern", "match", "lighter", "stove", "oven",
    "refrigerator", "freezer", "washer", "dryer", "toaster", "blender",
    "small", "large", "big", "little", "tall", "short", "long", "wide",
    "round", "square", "flat", "new", "old", "young", "good", "bad",
    "hot", "cold", "warm", "cool", "bright", "dark", "light", "heavy",
]

_PRETOK_RE = re.compile(r" ?[A-Za-z]+| ?[0-9]| ?[^\sA-Za-z0-9]+|\s")

PAD, EOS, BOS, UNK = "<pad>", "<eos>", "<bos>", "<unk>"
_SPECIALS = [PAD, EOS, BOS, UNK]
_NUM_BYTE_TOKENS = 256


class _Encoding(dict):
    """dict with attribute access, standing in for HF BatchEncoding."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:  # pragma: no cover
            raise AttributeError(name) from e


class ConceptTokenizer:
    """Offline word+byte tokenizer with Gemma-tokenizer-compatible API surface."""

    def __init__(
        self,
        extra_words: Optional[Sequence[str]] = None,
        added_tokens: Optional[Sequence[str]] = None,
        padding_side: str = "right",
    ):
        self.padding_side = padding_side

        # id layout: specials | bytes | base words (each as "w" and " w") | extras | added
        self._id_to_token: List[str] = []
        self._token_to_id: Dict[str, int] = {}

        for tok in _SPECIALS:
            self._push(tok)
        self._byte_offset = len(self._id_to_token)
        for b in range(_NUM_BYTE_TOKENS):
            self._push(f"<0x{b:02X}>")
        for w in BASE_WORDS:
            self._push_word(w)
        for w in extra_words or []:
            self._push_word(w)
        self._base_size = len(self._id_to_token)

        self._added_tokens: List[str] = []
        self._added_re: Optional[re.Pattern] = None
        if added_tokens:
            self.add_tokens(list(added_tokens))

        self._extra_words = list(extra_words or [])

    # -- vocab construction -------------------------------------------------

    def _push(self, token: str) -> bool:
        if token in self._token_to_id:
            return False
        self._token_to_id[token] = len(self._id_to_token)
        self._id_to_token.append(token)
        return True

    def _push_word(self, word: str):
        # Store both the bare and the leading-space variant so words tokenize
        # to one id regardless of position (mirrors GPT-2/SentencePiece "▁w").
        self._push(word)
        self._push(" " + word)

    def add_tokens(self, tokens: Union[str, Sequence[str]]) -> int:
        """Append new whole-string tokens at the end of the vocab (HF semantics)."""
        if isinstance(tokens, str):
            tokens = [tokens]
        added = 0
        for tok in tokens:
            if tok in self._token_to_id:
                continue
            self._push(tok)
            self._added_tokens.append(tok)
            added += 1
        if self._added_tokens:
            # Longest-first alternation so "<ood 12>" wins over "<ood 1>".
            pattern = "|".join(
                re.escape(t) for t in sorted(self._added_tokens, key=len, reverse=True)
            )
            self._added_re = re.compile(f"({pattern})")
        return added

    # -- special token properties -------------------------------------------

    pad_token = PAD
    eos_token = EOS
    bos_token = BOS
    unk_token = UNK

    @property
    def pad_token_id(self) -> int:
        return self._token_to_id[PAD]

    @property
    def eos_token_id(self) -> int:
        return self._token_to_id[EOS]

    @property
    def bos_token_id(self) -> int:
        return self._token_to_id[BOS]

    def __len__(self) -> int:
        return len(self._id_to_token)

    @property
    def vocab_size(self) -> int:
        return len(self._id_to_token)

    def get_vocab(self) -> Dict[str, int]:
        return dict(self._token_to_id)

    @property
    def added_tokens(self) -> List[str]:
        return list(self._added_tokens)

    # -- encoding ------------------------------------------------------------

    def _encode_piece(self, piece: str) -> List[int]:
        tid = self._token_to_id.get(piece)
        if tid is not None:
            return [tid]
        return [self._byte_offset + b for b in piece.encode("utf-8")]

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids: List[int] = []
        segments = self._added_re.split(text) if self._added_re else [text]
        for seg in segments:
            if not seg:
                continue
            if self._added_re and seg in self._token_to_id and seg in self._added_tokens:
                ids.append(self._token_to_id[seg])
                continue
            for m in _PRETOK_RE.finditer(seg):
                ids.extend(self._encode_piece(m.group(0)))
        if add_special_tokens:
            ids = [self.bos_token_id] + ids
        return ids

    def __call__(
        self,
        text: Union[str, Sequence[str]],
        padding: Union[bool, str] = False,
        truncation: bool = False,
        max_length: Optional[int] = None,
        add_special_tokens: bool = True,
        return_tensors: Optional[str] = None,
    ) -> _Encoding:
        single = isinstance(text, str)
        texts = [text] if single else list(text)
        seqs = [self.encode(t, add_special_tokens=add_special_tokens) for t in texts]
        if truncation and max_length is not None:
            seqs = [s[:max_length] for s in seqs]

        if padding:
            target = max_length if padding == "max_length" else max(len(s) for s in seqs)
            input_ids = np.full((len(seqs), target), self.pad_token_id, dtype=np.int32)
            attention_mask = np.zeros((len(seqs), target), dtype=np.int32)
            for i, s in enumerate(seqs):
                if self.padding_side == "right":
                    input_ids[i, : len(s)] = s
                    attention_mask[i, : len(s)] = 1
                else:
                    input_ids[i, target - len(s) :] = s
                    attention_mask[i, target - len(s) :] = 1
        else:
            if single:
                input_ids = seqs[0]
                attention_mask = [1] * len(seqs[0])
            else:
                input_ids = seqs
                attention_mask = [[1] * len(s) for s in seqs]

        if return_tensors == "np" and not padding:
            input_ids = np.asarray(input_ids, dtype=np.int32)
            attention_mask = np.asarray(attention_mask, dtype=np.int32)
        return _Encoding(input_ids=input_ids, attention_mask=attention_mask)

    # -- decoding ------------------------------------------------------------

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        special_ids = {self._token_to_id[t] for t in _SPECIALS}
        out: List[str] = []
        byte_buf = bytearray()

        def flush():
            if byte_buf:
                out.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            i = int(i)
            if i < 0 or i >= len(self._id_to_token):
                continue
            if i in special_ids:
                if not skip_special_tokens:
                    flush()
                    out.append(self._id_to_token[i])
                continue
            if self._byte_offset <= i < self._byte_offset + _NUM_BYTE_TOKENS:
                byte_buf.append(i - self._byte_offset)
                continue
            flush()
            out.append(self._id_to_token[i])
        flush()
        return "".join(out)

    def convert_tokens_to_ids(self, token: Union[str, Sequence[str]]):
        if not isinstance(token, str):
            return [self.convert_tokens_to_ids(t) for t in token]
        tid = self._token_to_id.get(token)
        if tid is None:
            tid = self._token_to_id.get(" " + token)
        if tid is None:
            return self._token_to_id[UNK]
        return tid

    def convert_ids_to_tokens(self, ids: Union[int, Sequence[int]]):
        if isinstance(ids, (int, np.integer)):
            return self._id_to_token[int(ids)]
        return [self._id_to_token[int(i)] for i in ids]

    # -- persistence ----------------------------------------------------------

    def save_pretrained(self, save_directory: str):
        """Write vocab + added tokens as JSON (layout: tokenizer_config.json,
        vocab.json, added_tokens.json — shape-compatible with the reference's
        saved-tokenizer directory usage in token_embedding_analysis.py:76-81)."""
        os.makedirs(save_directory, exist_ok=True)
        with open(os.path.join(save_directory, "tokenizer_config.json"), "w") as f:
            json.dump(
                {
                    "tokenizer_class": "ConceptTokenizer",
                    "padding_side": self.padding_side,
                    "extra_words": self._extra_words,
                },
                f,
                indent=2,
            )
        with open(os.path.join(save_directory, "vocab.json"), "w") as f:
            json.dump(self._token_to_id, f)
        with open(os.path.join(save_directory, "added_tokens.json"), "w") as f:
            json.dump({t: self._token_to_id[t] for t in self._added_tokens}, f, indent=2)

    @classmethod
    def from_pretrained(cls, directory: str) -> "ConceptTokenizer":
        with open(os.path.join(directory, "tokenizer_config.json")) as f:
            cfg = json.load(f)
        with open(os.path.join(directory, "added_tokens.json")) as f:
            added = json.load(f)
        tok = cls(
            extra_words=cfg.get("extra_words") or [],
            padding_side=cfg.get("padding_side", "right"),
        )
        # Re-add in saved-id order so ids round-trip exactly.
        for t, _ in sorted(added.items(), key=lambda kv: kv[1]):
            tok.add_tokens(t)
        with open(os.path.join(directory, "vocab.json")) as f:
            saved_vocab = json.load(f)
        if saved_vocab != tok._token_to_id:
            raise ValueError(
                f"Saved vocab in {directory} does not match this framework version's "
                "base vocabulary (base_vocab.py is append-only; check versions)."
            )
        return tok


def load_tokenizer(name_or_path: str, extra_words: Optional[Sequence[str]] = None):
    """Resolve a tokenizer: a saved ConceptTokenizer dir, a locally cached HF
    tokenizer, or (default) a fresh ConceptTokenizer.

    ``name_or_path`` keeps YAML compatibility with the reference's
    ``language_model_name`` field (e.g. "google/gemma-3-1b-it"): if the HF
    tokenizer is locally cached it is used; otherwise the offline
    ConceptTokenizer stands in with the identical downstream API.
    """
    if os.path.isdir(name_or_path) and os.path.exists(
        os.path.join(name_or_path, "tokenizer_config.json")
    ):
        try:
            return ConceptTokenizer.from_pretrained(name_or_path)
        except Exception:  # noqa: BLE001 - may be an HF-format directory
            pass
    try:  # pragma: no cover - only hit when an HF cache exists
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(name_or_path, local_files_only=True, use_fast=True)
    except Exception:  # noqa: BLE001
        return ConceptTokenizer(extra_words=extra_words)


__all__ = ["BASE_WORDS", "ConceptTokenizer", "load_tokenizer"]
