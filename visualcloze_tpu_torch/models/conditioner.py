"""Text conditioning: tokenizer + encoder facade (counterpart of
visualcloze_tpu/models/conditioner.py).

Pad-to-max tokenization, no attention mask to either encoder; T5 returns its
last hidden state and CLIP its pooled output. A local HF tokenizer directory
is read with `transformers` (imported only inside load_hf_tokenizer: the
port needs it for nothing else); without one, the deterministic
FallbackTokenizer (a copy of the JAX package's) stands in. No tokenizer
files are in the repository.
"""

from __future__ import annotations

import itertools
import os
from typing import Sequence

import numpy as np
import torch


class FallbackTokenizer:
    """Deterministic hash tokenizer for offline/test use — NOT a parity
    tokenizer; real deployments need the HF tokenizer files."""

    def __init__(self, vocab_size: int, pad_id: int = 0, eos_id: int = 1, bos_id: int | None = None):
        self.vocab_size = vocab_size
        self.pad_id = pad_id
        self.eos_id = eos_id
        self.bos_id = bos_id

    def __call__(self, texts: Sequence[str], max_length: int) -> np.ndarray:
        out = np.full((len(texts), max_length), self.pad_id, dtype=np.int32)
        for i, text in enumerate(texts):
            ids = []
            if self.bos_id is not None:
                ids.append(self.bos_id)
            for w in text.split():
                h = 0
                for ch in w:
                    h = (h * 131 + ord(ch)) % (self.vocab_size - 16)
                ids.append(h + 8)
            ids.append(self.eos_id)
            if len(ids) > max_length:
                # truncate the content and keep EOS last, as HF tokenizers do
                ids = ids[: max_length - 1] + [self.eos_id]
            out[i, : len(ids)] = ids
        return out


def load_hf_tokenizer(path: str):
    """A transformers tokenizer from a local directory (no network)."""
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(path, local_files_only=True)


class HFTokenizerAdapter:
    """A transformers tokenizer called as FallbackTokenizer is: pad to
    max_length, truncate, int32 ids."""

    def __init__(self, tok):
        self.tok = tok

    def __call__(self, texts: Sequence[str], max_length: int) -> np.ndarray:
        enc = self.tok(
            list(texts),
            truncation=True,
            max_length=max_length,
            return_length=False,
            return_overflowing_tokens=False,
            padding="max_length",
            return_tensors="np",
        )
        return enc["input_ids"].astype(np.int32)


# a file any HF tokenizer directory holds (fast, sentencepiece or BPE)
_TOKENIZER_FILES = ("tokenizer_config.json", "tokenizer.json", "spiece.model", "vocab.json")


def is_tokenizer_dir(path: str | None) -> bool:
    return bool(path) and os.path.isdir(path) and any(
        os.path.exists(os.path.join(path, f)) for f in _TOKENIZER_FILES)


def default_tokenizer(kind: str, local_path: str | None = None):
    """The HF tokenizer of `local_path` (or of $T5_TOKENIZER_PATH /
    $CLIP_TOKENIZER_PATH) when that directory holds tokenizer files, else the
    full-vocabulary FallbackTokenizer. A directory of weights alone (a T5_PATH
    of safetensors shards) falls back too, where the JAX package hands it to
    transformers and fails."""
    env = {"t5": "T5_TOKENIZER_PATH", "clip": "CLIP_TOKENIZER_PATH"}[kind]
    path = local_path or os.environ.get(env)
    if is_tokenizer_dir(path):
        return HFTokenizerAdapter(load_hf_tokenizer(path))
    if kind == "t5":
        return FallbackTokenizer(vocab_size=32100, pad_id=0, eos_id=1)
    return FallbackTokenizer(vocab_size=49408, pad_id=49407, eos_id=49407, bos_id=49406)


class TextEncoder:
    """encoder(prompts) -> T5 features (B, L, d) or CLIP pooled vectors (B, d)."""

    def __init__(self, kind: str, model: torch.nn.Module, tokenizer, max_length: int | None = None):
        assert kind in ("t5", "clip")
        self.kind = kind
        self.model = model
        self.cfg = model.cfg
        self.tokenizer = tokenizer
        self.max_length = max_length or model.cfg.max_length

    @property
    def device(self) -> torch.device:
        return next(itertools.chain(self.model.parameters(), self.model.buffers())).device

    def __call__(self, prompts: str | Sequence[str]) -> torch.Tensor:
        if isinstance(prompts, str):
            prompts = [prompts]
        ids = torch.from_numpy(self.tokenizer(list(prompts), self.max_length).astype(np.int64))
        ids = ids.to(self.device)
        if self.kind == "t5":
            return self.model(ids)
        return self.model(ids)[1]
