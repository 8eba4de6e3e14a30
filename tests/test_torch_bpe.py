"""The port's byte-level BPE (`hyperion_tpu_torch/data/bpe.py`) against
the JAX package's (`hyperion_tpu/data/bpe.py`).

The reference pre-tokenizes with the GPT-2 pattern through the `regex`
package; the port scans `unicodedata` categories instead (the card's
machine has no `regex`). Every case holds the two to exact equality:
the pre-tokens, the learned merges, the ids, the decoded text and the
files each package writes.
"""

from __future__ import annotations

import unicodedata

import numpy as np
import pytest

from hyperion_tpu.data import bpe as jb
from hyperion_tpu_torch.data import bpe as tb

# one case a script or trap: the GPT-2 pattern's letter and number
# classes are \p{L} and \p{N}; `²`, `½` and `Ⅻ` are numbers there (No,
# No, Nl) although `str.isalnum` admits them, and `٣` is an Arabic-Indic
# digit (Nd)
CASES = {
    "ascii_prose": "The quick brown fox jumps over the lazy dog. It was 1999!",
    "contractions": "I'm sure they'll say it's fine, we've seen what you'd do"
                    " and can't. 'S 'T 'RE ''s '",
    "space_runs": "a  b   c\n\nd \n e\t\t f   \n",
    "trailing_space": "ends with spaces   ",
    "leading_space": "   starts with spaces",
    "composed_accents": "café naïve résumé Ångström",
    "decomposed_accents": unicodedata.normalize("NFD", "café naïve résumé"),
    "cjk": "中文分词 日本語のテキスト 한국어 텍스트",
    "emoji": "ok 😀👍🏽 family 👨‍👩‍👧 flags 🇫🇷!",
    "superscript_two": "x² + y² = z²",
    "vulgar_half": "½ cup and 1½ spoons",
    "roman_twelve": "Chapter Ⅻ and Ⅻth",
    "arabic_indic_three": "العدد ٣ و٣٣",
    "punctuation": "--- ... !!! ??? (a) [b] {c} @#$%^&*",
    "mixed_digits": "abc123def 456 7.89 0x1F",
    "control_separators": "a\x1cb\x1dc\x1e d\x1f e\xa0f　g",
}

_ALPHABET = list("ab Z'sdtlmrve\n\t\r!?.,-_²½Ⅻ٣5é́中文😀\x1c\xa0　") \
    + ["'ll", "'re", " '", "  "]


def _corpus(seed: int, n_lines: int = 300) -> list[str]:
    """Seeded prose: words from a small vocabulary (so pairs repeat and
    merges are learned), with the cases' scripts mixed in."""
    rng = np.random.default_rng(seed)
    words = ["the", "model", "serves", "tokens", "it's", "we'll", "data",
             "café", "中文", "²", "½", "٣", "😀", "  ", "\n", "12", "345"]
    lines = []
    for _ in range(n_lines):
        k = int(rng.integers(3, 12))
        lines.append(" ".join(words[int(i)]
                              for i in rng.integers(0, len(words), k)))
    return lines + list(CASES.values())


@pytest.fixture(scope="module")
def pair():
    lines = _corpus(0)
    return (jb.train_bpe(lines, vocab_size=256 + 1 + 120),
            tb.train_bpe(lines, vocab_size=256 + 1 + 120))


@pytest.mark.parametrize("name", sorted(CASES))
def test_pretokens_equal_the_gpt2_pattern(name):
    text = CASES[name]
    assert tb.pretokenize(text) == jb._PRETOKEN.findall(text)


def test_pretokens_equal_on_seeded_random_strings():
    rng = np.random.default_rng(7)
    for _ in range(3000):
        n = int(rng.integers(0, 24))
        text = "".join(_ALPHABET[int(i)]
                       for i in rng.integers(0, len(_ALPHABET), n))
        assert tb.pretokenize(text) == jb._PRETOKEN.findall(text), repr(text)


def test_train_gives_the_same_merges_and_vocab(pair):
    ref, port = pair
    assert port.merges == ref.merges
    assert len(port.merges) > 50  # training stops where pairs run out
    assert port.vocab == ref.vocab and port.eos_id == ref.eos_id
    assert tb.bytes_to_unicode() == jb.bytes_to_unicode()


@pytest.mark.parametrize("name", sorted(CASES))
def test_encode_ids_equal(pair, name):
    ref, port = pair
    assert port.encode(CASES[name]) == ref.encode(CASES[name])


@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_round_trips(pair, name):
    ref, port = pair
    ids = port.encode(CASES[name])
    assert port.decode(ids) == CASES[name] == ref.decode(ids)


def test_decode_skips_eos_and_unknown_ids(pair):
    ref, port = pair
    ids = port.encode("hello") + [port.eos_id, 10 ** 6]
    assert port.decode(ids) == ref.decode(ids) == "hello"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_saved_files_load_in_the_other_package(pair, tmp_path, writer):
    ref, port = pair
    (ref if writer == "jax" else port).save(tmp_path)
    back_ref, back_port = jb.ByteBPE.load(tmp_path), tb.ByteBPE.load(tmp_path)
    assert back_port.merges == back_ref.merges == port.merges
    assert back_port.vocab == back_ref.vocab
    text = " ".join(CASES.values())
    assert back_port.encode(text) == back_ref.encode(text) == ref.encode(text)


def test_merges_starting_with_hash_survive_a_round_trip(tmp_path):
    lines = ["## heading ## again ##"] * 4
    tok = tb.train_bpe(lines, vocab_size=256 + 1 + 8)
    assert any(a.startswith("#") for a, _ in tok.merges)
    tok.save(tmp_path)
    assert tb.ByteBPE.load(tmp_path).merges == tok.merges
    assert jb.ByteBPE.load(tmp_path).merges == tok.merges
