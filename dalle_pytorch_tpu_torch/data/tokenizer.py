"""Host-side text tokenizer: the dependency-free byte tokenizer.

A copy of the JAX package's `data/tokenizer.py:_TokenizerBase` and
`ByteTokenizer` (the port imports nothing of that package). Contract:
`tokenize(texts, context_length, truncate_text) -> int32 [B, ctx]`,
zero-padded; id 0 is reserved (DALLE turns it into a per-position unique
padding id). The BPE tokenizers need the `regex` module and vocabulary
files and are not ported yet.
"""

from __future__ import annotations

import html
from typing import List, Sequence, Union

import numpy as np


def _clean_text(text: str) -> str:
    try:
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        pass
    text = html.unescape(html.unescape(text))
    return " ".join(text.split()).strip()


def _pack(
    token_lists: Sequence[List[int]],
    context_length: int,
    truncate_text: bool,
    texts: Sequence[str],
) -> np.ndarray:
    out = np.zeros((len(token_lists), context_length), dtype=np.int32)
    for i, toks in enumerate(token_lists):
        if len(toks) > context_length:
            if not truncate_text:
                raise RuntimeError(
                    f"Input {texts[i]!r} is too long for context length "
                    f"{context_length}"
                )
            toks = toks[:context_length]
        out[i, : len(toks)] = toks
    return out


class _TokenizerBase:
    vocab_size: int

    def encode(self, text: str) -> List[int]:
        raise NotImplementedError

    def decode(self, tokens, pad_tokens: set = frozenset()) -> str:
        raise NotImplementedError

    def tokenize(
        self,
        texts: Union[str, Sequence[str]],
        context_length: int = 256,
        truncate_text: bool = False,
    ) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        return _pack([self.encode(t) for t in texts], context_length, truncate_text, texts)

    @staticmethod
    def _to_list(tokens) -> List[int]:
        if hasattr(tokens, "tolist"):
            return [int(t) for t in np.asarray(tokens).reshape(-1)]
        return list(tokens)


class ByteTokenizer(_TokenizerBase):
    """Byte-level tokenizer: ids = utf-8 bytes + 1 (0 stays padding)."""

    def __init__(self):
        self.vocab_size = 257

    def encode(self, text: str) -> List[int]:
        return [b + 1 for b in _clean_text(text).lower().encode("utf-8")]

    def decode(self, tokens, pad_tokens: set = frozenset()) -> str:
        toks = [t for t in self._to_list(tokens) if t > 0 and t not in pad_tokens]
        return bytes(t - 1 for t in toks).decode("utf-8", errors="replace")
