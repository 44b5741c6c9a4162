"""The port's tokenizers vs the JAX package's (CPU, host-only code).

Ids are compared exactly: the native BPE over both shipped vocabularies
(`encode`, `tokenize` with truncation on and off, `decode`), the default
vocabulary `get_tokenizer()` picks, and the CLIP-format `SimpleTokenizer`
with the standard library's `re` forced on the port's side against the
JAX package's `regex` pattern, on a merges file written here.
"""

import warnings
from pathlib import Path

import numpy as np
import pytest

from dalle_pytorch_tpu.data import tokenizer as jtok
from dalle_pytorch_tpu_torch.data import native_bpe
from dalle_pytorch_tpu_torch.data import tokenizer as ptok

REPO = Path(__file__).resolve().parent.parent
PROMPTS = [
    "a red cube on a blue table",
    "ünïcödé ☃ 日本語のテキスト, émojis 😀👍🏽 and x² ½ Ⅻ ①",
    "",
    "  spaces\tand\nnewlines  &amp; html ",
    "snake_case__var it's we're they'll 1234567 ٣٤٥",
]
LONG = "a very long prompt that repeats " * 80


@pytest.mark.parametrize("vocab", ["default_bpe_8k.model", "default_bpe_32k.model"])
def test_native_bpe_ids_match_the_reference(vocab):
    """encode, tokenize (ragged, truncated and not) and decode of both
    shipped vocabularies give the JAX package's ids and text."""
    port = ptok.NativeBPETokenizer(Path(ptok.__file__).parent / vocab)
    ref = jtok.NativeBPETokenizer(Path(jtok.__file__).parent / vocab)
    assert port.vocab_size == ref.vocab_size
    for text in PROMPTS + [LONG]:
        assert port.encode(text) == ref.encode(text)
    for ctx in (8, 64, 256):
        for truncate in (True, False):
            texts = PROMPTS if not truncate else PROMPTS + [LONG]
            try:
                expect = ref.tokenize(texts, ctx, truncate_text=truncate)
            except RuntimeError as exc:
                with pytest.raises(RuntimeError, match="too long"):
                    port.tokenize(texts, ctx, truncate_text=truncate)
                assert "too long" in str(exc)
                continue
            got = port.tokenize(texts, ctx, truncate_text=truncate)
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, expect)
            for row_p, row_r in zip(got, expect):
                assert port.decode(row_p) == ref.decode(row_r)
    with pytest.raises(RuntimeError, match="too long"):
        port.tokenize(LONG, 16, truncate_text=False)


def test_shipped_vocabularies_are_byte_identical_copies():
    for name in ("default_bpe_8k.model", "default_bpe_32k.model"):
        port = Path(ptok.__file__).parent / name
        ref = Path(jtok.__file__).parent / name
        assert port.read_bytes() == ref.read_bytes(), name


def test_default_tokenizer_is_the_32k_vocabulary():
    tok = ptok.get_tokenizer()
    assert isinstance(tok, ptok.NativeBPETokenizer) and tok.vocab_size == 32768
    assert tok.vocab_size == jtok.get_tokenizer().vocab_size
    ids = tok.tokenize("a red cube", 16, truncate_text=True)
    np.testing.assert_array_equal(ids, jtok.get_tokenizer().tokenize("a red cube", 16, True))


def test_native_library_builds_into_the_port_build_dir():
    native_bpe._load_library()
    lib = native_bpe._library_path()
    assert lib.exists() and lib.parent == REPO / "build" / "native"
    assert native_bpe._SRC == REPO / "native" / "bpe.cpp"


def test_default_probe_falls_back_to_bytes_with_one_warning(monkeypatch):
    monkeypatch.setattr(ptok, "default_vocabularies", lambda: [REPO / "no" / "default_bpe_9k.model"])
    monkeypatch.setattr(ptok, "_default_decision", None)
    monkeypatch.setattr(ptok, "_warned_default_probe", False)
    with pytest.warns(UserWarning, match="ByteTokenizer"):
        assert isinstance(ptok.get_tokenizer(), ptok.ByteTokenizer)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the second probe is silent
        assert isinstance(ptok.get_tokenizer(), ptok.ByteTokenizer)
    assert ptok._default_decision is None  # the fallback is not cached


def test_flags_pick_their_tokenizers(tmp_path):
    model = Path(ptok.__file__).parent / "default_bpe_8k.model"
    assert ptok.get_tokenizer(bpe_path=str(model), native=True).vocab_size == 8192
    with pytest.raises(ValueError, match="bpe_path"):
        ptok.get_tokenizer(native=True)
    with pytest.raises(ImportError, match="youtokentome"):
        ptok.get_tokenizer(bpe_path=str(model), yttm=True)
    merges = _merges_file(tmp_path)
    assert isinstance(ptok.get_tokenizer(bpe_path=str(merges)), ptok.SimpleTokenizer)


def _merges_file(tmp_path):
    """A small CLIP-format merges file: a header line, then pairs."""
    pairs = [
        "r e", "re d</w>", "c u", "cu b", "cub e</w>", "b l", "bl u", "blu e</w>", "t h",
        "th e</w>", "a n", "an d</w>", "Ã ¼", "Ã¼ n", "i t", "' s</w>", "_ _", "1 2", "12 3",
    ]
    path = tmp_path / "merges.txt"
    path.write_text("#version: 0.2\n" + "\n".join(pairs) + "\n", encoding="utf8")
    return path


@pytest.mark.parametrize("text", PROMPTS + ["<|startoftext|>the red cube<|endoftext|>", LONG[:300]])
def test_simple_tokenizer_stdlib_split_matches_the_reference(tmp_path, text):
    """The port's `SimpleTokenizer` with the standard library's `re` (the
    card's machine has no `regex`) gives the JAX package's ids, which it
    computes with `regex`; decode gives its text."""
    merges = _merges_file(tmp_path)
    port = ptok.SimpleTokenizer(merges, use_regex=False)
    ref = jtok.SimpleTokenizer(merges)
    assert port.vocab_size == ref.vocab_size
    assert port.encode(text) == ref.encode(text)
    np.testing.assert_array_equal(port.tokenize(text, 64, True), ref.tokenize(text, 64, True))
    assert port.decode(port.encode(text)) == ref.decode(ref.encode(text))


def test_stdlib_word_pattern_splits_as_the_unicode_property_one():
    """Every codepoint of the Basic Multilingual Plane that the standard
    library's Unicode database assigns takes the same class under both
    patterns (between letters, digits, symbols and underscores, alone and
    doubled), U+0345 included; and random strings over all planes split
    alike."""
    import unicodedata

    stdlib, reference = ptok.word_pattern(False), ptok.word_pattern(True)
    for cp in range(0x10000):
        c = chr(cp)
        if unicodedata.category(c) in ("Cn", "Cs"):
            continue
        for text in ("a" + c + "a", "1" + c + "1", "!" + c + "!", c + c, "_" + c + "_"):
            text = " ".join(text.split()).lower()
            assert stdlib.findall(text) == reference.findall(text), hex(cp)
    rng = np.random.RandomState(0)
    checked = 0
    while checked < 500:
        chars = [chr(rng.randint(32, 0x30000)) for _ in range(rng.randint(1, 12))]
        if any(unicodedata.category(c) in ("Cn", "Cs") for c in chars):
            continue
        text = " ".join("".join(chars).split()).lower()
        assert stdlib.findall(text) == reference.findall(text), repr(text)
        checked += 1
