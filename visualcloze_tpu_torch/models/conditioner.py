"""Text conditioning: tokenizer + encoder facade (counterpart of
visualcloze_tpu/models/conditioner.py).

Pad-to-max tokenization, no attention mask to either encoder; T5 returns its
last hidden state and CLIP its pooled output. No tokenizer files are in the
repository, so the deterministic FallbackTokenizer (a copy of the JAX
package's) stands in for the HF tokenizers.
"""

from __future__ import annotations

import itertools
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


def default_tokenizer(kind: str) -> FallbackTokenizer:
    """The full-vocabulary stand-ins for the T5 and CLIP tokenizers."""
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
