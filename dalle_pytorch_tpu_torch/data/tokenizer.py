"""Host-side text tokenizers.

A copy of the JAX package's `data/tokenizer.py` (the port imports nothing
of that package): `ByteTokenizer`, the CLIP-format `SimpleTokenizer`, the
native C++ BPE `NativeBPETokenizer` over `data/native_bpe.py`, the thin
`HugTokenizer`, `ChineseTokenizer` and `YttmTokenizer` bridges (their
packages are optional: constructing one without its package raises
`ImportError`, as in the reference) and `get_tokenizer`, whose default
with no flags is the largest shipped native vocabulary,
`default_bpe_32k.model` (byte-identical copies of the JAX package's
`default_bpe_{8k,32k}.model` live beside this file). Contract:
`tokenize(texts, context_length, truncate_text) -> int32 [B, ctx]`,
zero-padded; id 0 is reserved (DALLE turns it into a per-position unique
padding id); `decode(ids)`.

`SimpleTokenizer` splits words with the `regex` module's pattern
`[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+` when `regex` is installed, else
with the standard library's `re` and an equivalent pattern: letters are
`[^\\W\\d_]` less the characters of Unicode categories Nl and No (listed
from `unicodedata` once), numbers `\\d` plus those, the rest runs of
characters outside `\\s`, `\\w` and those, plus `_`, but not U+0345 (a
combining mark whose case variants are letters: under IGNORECASE `regex`
leaves it out of both its letter class and the negated one, so it is in
no word). Checked character by character over every codepoint
the standard library's database assigns, the two split alike; they differ
only where the two modules' Unicode versions do (codepoints assigned
after it), and `\\s` differs on U+001C-U+001F, which `_clean_text` has
already turned into spaces.
"""

from __future__ import annotations

import html
import re as _stdlib_re
import sys
import unicodedata
import warnings
from functools import lru_cache
from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np

try:
    import regex as _regex
except ImportError:  # the card's machine has no `regex`
    _regex = None


# ---------------------------------------------------------------- helpers


@lru_cache()
def _byte_unicode_table() -> dict:
    """Reversible byte -> printable-unicode mapping (GPT-2/CLIP scheme),
    iterating in CLIP vocabulary order: the printable bytes first in
    codepoint order, then the remapped non-printables."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    mapping = {b: chr(b) for b in printable}
    extra = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + extra)
            extra += 1
    return mapping


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


# ---------------------------------------------------------- byte fallback


class ByteTokenizer(_TokenizerBase):
    """Byte-level tokenizer: ids = utf-8 bytes + 1 (0 stays padding)."""

    def __init__(self):
        self.vocab_size = 257

    def encode(self, text: str) -> List[int]:
        return [b + 1 for b in _clean_text(text).lower().encode("utf-8")]

    def decode(self, tokens, pad_tokens: set = frozenset()) -> str:
        toks = [t for t in self._to_list(tokens) if t > 0 and t not in pad_tokens]
        return bytes(t - 1 for t in toks).decode("utf-8", errors="replace")


# ------------------------------------------------------------- CLIP BPE

_CONTROL_AND_CONTRACTIONS = r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"


@lru_cache()
def _other_numbers() -> str:
    """The characters of Unicode categories Nl and No, escaped for a
    character class: `\\p{N}` beyond the decimal digits `\\d`."""
    chars = (chr(c) for c in range(sys.maxunicode + 1))
    return "".join(_stdlib_re.escape(ch) for ch in chars if unicodedata.category(ch) in ("Nl", "No"))


def word_pattern(use_regex: Optional[bool] = None):
    """SimpleTokenizer's compiled word splitter: the `regex` module's
    Unicode-property pattern when it is installed (or `use_regex`), else
    the standard library equivalent (module docstring)."""
    if use_regex is None:
        use_regex = _regex is not None
    if use_regex:
        return _regex.compile(
            _CONTROL_AND_CONTRACTIONS + r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+", _regex.IGNORECASE
        )
    nl_no = _other_numbers()
    return _stdlib_re.compile(
        _CONTROL_AND_CONTRACTIONS
        + rf"|[^\W\d_{nl_no}]+|[\d{nl_no}]|(?:[^\s\w{nl_no}\u0345]|_)+",
        _stdlib_re.IGNORECASE,
    )


class SimpleTokenizer(_TokenizerBase):
    """Byte-level BPE in the OpenAI-CLIP vocabulary format: a CLIP
    `bpe_simple_vocab_16e6.txt`-style merges file (a header line, then
    space-separated pairs); vocabulary = 256 byte symbols, 256 end-of-word
    symbols, one id per merge, then <|startoftext|>/<|endoftext|>.
    `use_regex` None takes the `regex` module where installed."""

    MAX_MERGES = 49152 - 256 - 2

    def __init__(self, bpe_path: Union[str, Path], use_regex: Optional[bool] = None):
        bpe_path = Path(bpe_path)
        if not bpe_path.exists():
            raise FileNotFoundError(f"BPE merges file {bpe_path} does not exist")
        self.byte_to_unicode = _byte_unicode_table()
        self.unicode_to_byte = {v: k for k, v in self.byte_to_unicode.items()}

        lines = bpe_path.read_text(encoding="utf8").split("\n")
        merges = [tuple(m.split()) for m in lines[1 : self.MAX_MERGES + 1] if m]

        symbols = list(self.byte_to_unicode.values())
        vocab = symbols + [s + "</w>" for s in symbols]
        vocab += ["".join(pair) for pair in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]

        self.token_to_id = {tok: i for i, tok in enumerate(vocab)}
        self.id_to_token = {i: tok for tok, i in self.token_to_id.items()}
        self.merge_rank = {pair: i for i, pair in enumerate(merges)}
        self.vocab_size = len(vocab)
        self._cache: dict = {}
        self.pattern = word_pattern(use_regex)
        self.sot = self.token_to_id["<|startoftext|>"]
        self.eot = self.token_to_id["<|endoftext|>"]

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        parts = list(token[:-1]) + [token[-1] + "</w>"]
        while len(parts) > 1:
            pairs = [(parts[i], parts[i + 1]) for i in range(len(parts) - 1)]
            ranked = min(pairs, key=lambda p: self.merge_rank.get(p, float("inf")))
            if ranked not in self.merge_rank:
                break
            merged: List[str] = []
            i = 0
            while i < len(parts):
                if i < len(parts) - 1 and (parts[i], parts[i + 1]) == ranked:
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        self._cache[token] = parts
        return parts

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in self.pattern.findall(_clean_text(text).lower()):
            if word in ("<|startoftext|>", "<|endoftext|>"):
                ids.append(self.token_to_id[word])  # control tokens pass through whole
                continue
            mapped = "".join(self.byte_to_unicode[b] for b in word.encode("utf-8"))
            ids.extend(self.token_to_id[p] for p in self._bpe(mapped))
        return ids

    def decode(self, tokens, pad_tokens: set = frozenset()) -> str:
        skip = set(pad_tokens) | {0, self.sot, self.eot}
        toks = [t for t in self._to_list(tokens) if t not in skip]
        text = "".join(self.id_to_token.get(t, "") for t in toks)
        raw = bytes(self.unicode_to_byte[c] for c in text if c in self.unicode_to_byte)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()


# --------------------------------------------------- HuggingFace bridges


class HugTokenizer(_TokenizerBase):
    """tokenizers-json bridge (needs `transformers`)."""

    def __init__(self, bpe_path: Union[str, Path]):
        from transformers import PreTrainedTokenizerFast

        bpe_path = Path(bpe_path)
        if not bpe_path.exists():
            raise FileNotFoundError(f"BPE json path {bpe_path} does not exist")
        self.tokenizer = PreTrainedTokenizerFast(tokenizer_file=str(bpe_path))
        self.vocab_size = self.tokenizer.vocab_size

    def encode(self, text: str) -> List[int]:
        return self.tokenizer.encode(text, add_special_tokens=False)

    def decode(self, tokens, pad_tokens: set = frozenset()) -> str:
        toks = [t for t in self._to_list(tokens) if t not in set(pad_tokens) | {0}]
        return self.tokenizer.decode(toks, skip_special_tokens=True)


class ChineseTokenizer(_TokenizerBase):
    """bert-base-chinese wordpiece (needs `transformers` and the model
    files locally)."""

    def __init__(self, model_name: str = "bert-base-chinese"):
        from transformers import BertTokenizerFast

        self.tokenizer = BertTokenizerFast.from_pretrained(model_name)
        self.vocab_size = self.tokenizer.vocab_size

    def encode(self, text: str) -> List[int]:
        return self.tokenizer.encode(text, add_special_tokens=False)

    def decode(self, tokens, pad_tokens: set = frozenset()) -> str:
        toks = [t for t in self._to_list(tokens) if t not in set(pad_tokens) | {0}]
        return self.tokenizer.decode(toks)


class YttmTokenizer(_TokenizerBase):
    """youtokentome-model bridge (needs `youtokentome`)."""

    def __init__(self, bpe_path: Union[str, Path]):
        try:
            import youtokentome as yttm
        except ImportError as e:
            raise ImportError(
                "youtokentome is not installed; use SimpleTokenizer/"
                "HugTokenizer, or convert the yttm model to a tokenizers json"
            ) from e
        self.tokenizer = yttm.BPE(model=str(bpe_path))
        self.vocab_size = self.tokenizer.vocab_size()

    def encode(self, text: str) -> List[int]:
        import youtokentome as yttm

        return self.tokenizer.encode([text], output_type=yttm.OutputType.ID)[0]

    def decode(self, tokens, pad_tokens: set = frozenset()) -> str:
        return self.tokenizer.decode(
            [self._to_list(tokens)], ignore_ids=list(set(pad_tokens) | {0})
        )[0]


class NativeBPETokenizer(_TokenizerBase):
    """The native C++ BPE (`native/bpe.cpp` via ctypes): the same
    tokenize/decode contract, batch encode threaded in native code."""

    def __init__(self, bpe_path: Union[str, Path]):
        from dalle_pytorch_tpu_torch.data.native_bpe import NativeBPE

        self.bpe = NativeBPE.load(bpe_path)
        self.vocab_size = self.bpe.vocab_size

    def encode(self, text: str) -> List[int]:
        return self.bpe.encode(_clean_text(text))

    def tokenize(
        self,
        texts: Union[str, Sequence[str]],
        context_length: int = 256,
        truncate_text: bool = False,
    ) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        return self.bpe.encode_batch(
            [_clean_text(t) for t in texts], context_length, truncate=truncate_text
        )

    def decode(self, tokens, pad_tokens: set = frozenset()) -> str:
        return self.bpe.decode([t for t in self._to_list(tokens) if t not in pad_tokens])


def default_vocabularies() -> List[Path]:
    """The shipped `default_bpe_<N>k.model` files, largest vocabulary first."""

    def vocab_k(p: Path) -> int:
        try:
            return int(p.stem[len("default_bpe_"):].rstrip("k"))
        except ValueError:
            return 0

    return sorted(Path(__file__).parent.glob("default_bpe_*.model"), key=vocab_k, reverse=True)


# The default vocabulary once a probe succeeded (only success is cached:
# the byte fallback re-probes silently, so a vocabulary that becomes usable
# later is picked up; its warning fires once per process).
_default_decision: Optional[Path] = None
_warned_default_probe = False


def get_tokenizer(
    bpe_path: Optional[str] = None,
    hug: bool = False,
    chinese: bool = False,
    yttm: bool = False,
    native: bool = False,
) -> _TokenizerBase:
    """Tokenizer selection by the trainer's flags; with none, the largest
    shipped native vocabulary, falling back to the `ByteTokenizer` with
    one warning when none can be loaded (no C++ toolchain, say)."""
    if chinese:
        return ChineseTokenizer()
    for flag, name in ((native, "native BPE"), (yttm, "yttm"), (hug, "huggingface")):
        if flag and not bpe_path:
            raise ValueError(f"--bpe_path required for {name} tokenizer")
    if native:
        return NativeBPETokenizer(bpe_path)
    if yttm:
        return YttmTokenizer(bpe_path)
    if hug:
        return HugTokenizer(bpe_path)
    if bpe_path:
        return SimpleTokenizer(bpe_path)
    global _default_decision, _warned_default_probe
    if _default_decision is not None:
        try:
            return NativeBPETokenizer(_default_decision)
        except Exception:
            _default_decision = None  # stale decision: re-probe (and re-warn)
            _warned_default_probe = False
    existing = default_vocabularies()
    for default_model in existing:
        try:
            tok = NativeBPETokenizer(default_model)
            _default_decision = default_model
            return tok
        except Exception as e:  # no C++ toolchain, corrupt model file
            if _warned_default_probe:
                continue
            next_step = (
                "trying the next candidate" if default_model != existing[-1]
                else "falling back to the 257-symbol ByteTokenizer"
            )
            warnings.warn(
                f"default BPE vocabulary {default_model.name} unusable ({e}); {next_step}",
                stacklevel=2,
            )
    if not existing and not _warned_default_probe:
        warnings.warn(
            f"no default BPE vocabulary (no {Path(__file__).parent}/default_bpe_*.model); "
            "falling back to the 257-symbol ByteTokenizer, which trains byte-level models only",
            stacklevel=2,
        )
    _warned_default_probe = True
    return ByteTokenizer()
