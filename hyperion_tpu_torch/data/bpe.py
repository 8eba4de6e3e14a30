"""In-tree byte-level BPE tokenizer — `hyperion_tpu/data/bpe.py` in the
port, without the `regex` package.

`ByteBPE.load` reads GPT-2-format `vocab.json` + `merges.txt`,
`train_bpe` learns merges from a corpus with incremental pair counts,
and every byte is representable, so encode/decode round-trips any text.
Files written by either package load in the other.

Pre-tokenization is the public GPT-2 pattern

    's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+

which the reference runs through `regex`. The card's machine has no
`regex`, and Python's `re` has no `\\p` classes (`[^\\W\\d_]` is no
substitute: `str.isalnum` also admits `²`, `½` and `Ⅻ`, which `\\p{L}`
does not), so `pretokenize` is a scanner over `unicodedata.category`:
letters are `L*`, numbers `N*`, whitespace is `str.isspace` less
U+001C-U+001F (the `regex` module's `\\s`). It gives the pattern's
tokens wherever both sides' Unicode tables agree; code points assigned
after this interpreter's `unicodedata` version are not letters here.
"""

from __future__ import annotations

import functools
import json
import unicodedata
from collections import Counter, defaultdict
from pathlib import Path

_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
_NOT_SPACE = frozenset("\x1c\x1d\x1e\x1f")


def _cls(c: str) -> str:
    """'L' letter, 'N' number, 'S' whitespace, 'P' anything else."""
    if c.isspace() and c not in _NOT_SPACE:
        return "S"
    cat = unicodedata.category(c)[0]
    return cat if cat in "LN" else "P"


def pretokenize(text: str) -> list[str]:
    """The GPT-2 pattern's `findall`: alternatives tried in order at
    each position, the first that matches wins."""
    out: list[str] = []
    n = len(text)
    i = 0
    while i < n:
        c = text[i]
        if c == "'":
            hit = next((s for s in _CONTRACTIONS if text.startswith(s, i)),
                       None)
            if hit is not None:
                out.append(hit)
                i += len(hit)
                continue
        # ` ?\\p{L}+`, ` ?\\p{N}+`, ` ?[^\\s\\p{L}\\p{N}]+`: an optional
        # literal space, then a run of one class
        j = i + 1 if c == " " and i + 1 < n else i
        k = _cls(text[j])
        if k != "S":
            e = j + 1
            while e < n and _cls(text[e]) == k:
                e += 1
            out.append(text[i:e])
            i = e
            continue
        # whitespace: `\\s+(?!\\S)` leaves the run's last character for
        # the token after it; `\\s+` takes a lone one
        e = i + 1
        while e < n and _cls(text[e]) == "S":
            e += 1
        if e < n and e - i >= 2:
            e -= 1
        out.append(text[i:e])
        i = e
    return out


EOS_TOKEN = "<|endoftext|>"


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """Invertible byte → printable-unicode-char map (the byte-level BPE
    alphabet trick: merges operate on strings, so every byte needs a
    visible, json-safe character)."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    mapping = {}
    extra = 0
    for b in range(256):
        if b in printable:
            mapping[b] = chr(b)
        else:
            mapping[b] = chr(256 + extra)
            extra += 1
    return mapping


@functools.lru_cache(maxsize=1)
def unicode_to_bytes() -> dict[str, int]:
    return {c: b for b, c in bytes_to_unicode().items()}


def _to_symbols(pretoken: str) -> tuple[str, ...]:
    b2u = bytes_to_unicode()
    return tuple(b2u[b] for b in pretoken.encode("utf-8"))


class ByteBPE:
    """Encoder/decoder over a vocab + ranked merge list."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 eos_token: str = EOS_TOKEN):
        self.vocab = dict(vocab)
        self.merges = list(merges)
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self.eos_token = eos_token
        if eos_token not in self.vocab:
            self.vocab[eos_token] = len(self.vocab)
        self.eos_id = self.vocab[eos_token]
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self._cache: dict[str, list[int]] = {}

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def _bpe(self, symbols: tuple[str, ...]) -> list[str]:
        """Merge the lowest-rank adjacent pair until no ranked pair
        remains — the standard BPE apply loop."""
        word = list(symbols)
        while len(word) > 1:
            pairs = [(self.ranks.get((a, b), None), i)
                     for i, (a, b) in enumerate(zip(word, word[1:]))]
            ranked = [(r, i) for r, i in pairs if r is not None]
            if not ranked:
                break
            _, i = min(ranked)
            word[i: i + 2] = [word[i] + word[i + 1]]
        return word

    def encode_pretoken(self, pretoken: str) -> list[int]:
        ids = self._cache.get(pretoken)
        if ids is None:
            pieces = self._bpe(_to_symbols(pretoken))
            # byte-level base alphabet means every piece decomposes to
            # in-vocab symbols even if a merged piece is missing
            ids = []
            for p in pieces:
                if p in self.vocab:
                    ids.append(self.vocab[p])
                else:
                    ids.extend(self.vocab[c] for c in p)
            self._cache[pretoken] = ids
        return ids

    def encode(self, text: str) -> list[int]:
        out: list[int] = []
        for tok in pretokenize(text):
            out.extend(self.encode_pretoken(tok))
        return out

    def decode(self, ids) -> str:
        u2b = unicode_to_bytes()
        chars = "".join(
            self.id_to_token[int(i)] for i in ids
            if int(i) != self.eos_id and int(i) in self.id_to_token
        )
        data = bytes(u2b[c] for c in chars if c in u2b)
        return data.decode("utf-8", errors="replace")

    # --- GPT-2-format interchange ---------------------------------

    def save(self, tokenizer_dir: str | Path) -> None:
        d = Path(tokenizer_dir)
        d.mkdir(parents=True, exist_ok=True)
        (d / "vocab.json").write_text(
            json.dumps(self.vocab, ensure_ascii=False)
        )
        lines = ["#version: hyperion_tpu bpe"]
        lines += [f"{a} {b}" for a, b in self.merges]
        (d / "merges.txt").write_text("\n".join(lines) + "\n")
        # merge symbols may themselves start with '#' (any corpus with
        # markdown/code), so loaders must only skip the version header,
        # never bare '#'-prefixed lines — see load()

    @classmethod
    def load(cls, tokenizer_dir: str | Path,
             eos_token: str = EOS_TOKEN) -> "ByteBPE":
        d = Path(tokenizer_dir)
        vocab = json.loads((d / "vocab.json").read_text())
        merges = []
        for i, line in enumerate(
            (d / "merges.txt").read_text().splitlines()
        ):
            # only the first line may be a '#version' header; '#' is a
            # legitimate merge symbol ('##' appears in any markdown
            # corpus) and must not be treated as a comment
            if i == 0 and line.startswith("#version"):
                continue
            if not line.strip():
                continue
            a, _, b = line.partition(" ")
            merges.append((a, b))
        return cls(vocab, merges, eos_token)


def train_bpe(
    lines, vocab_size: int = 8192, eos_token: str = EOS_TOKEN,
    verbose: bool = False,
) -> ByteBPE:
    """Learn a byte-level BPE vocabulary from an iterable of text lines.

    Classic frequency-greedy merge training with incremental pair-count
    maintenance: after each merge only the words containing the merged
    pair are rewritten, and the global pair counter is adjusted by the
    local deltas, so each step costs O(words containing the pair), not
    O(corpus)."""
    base = list(bytes_to_unicode().values())
    n_merges = max(0, vocab_size - len(base) - 1)  # reserve eos

    word_freq: Counter = Counter()
    for line in lines:
        for tok in pretokenize(line):
            word_freq[_to_symbols(tok)] += 1

    words = [list(w) for w in word_freq]
    freqs = [word_freq[w] for w in word_freq]

    pair_counts: Counter = Counter()
    pair_words: defaultdict[tuple, set] = defaultdict(set)
    for wi, w in enumerate(words):
        f = freqs[wi]
        for pair in zip(w, w[1:]):
            pair_counts[pair] += f
            pair_words[pair].add(wi)

    merges: list[tuple[str, str]] = []
    for step in range(n_merges):
        if not pair_counts:
            break
        # deterministic: max count, then lexicographically smallest pair
        best = max(pair_counts.items(), key=lambda kv: (kv[1], kv[0][0], kv[0][1]))
        (a, b), count = best
        if count < 2:
            break  # merging singletons only memorizes the corpus
        merges.append((a, b))
        merged = a + b
        for wi in list(pair_words[(a, b)]):
            w, f = words[wi], freqs[wi]
            # remove old pair contributions for this word
            for pair in zip(w, w[1:]):
                pair_counts[pair] -= f
                if pair_counts[pair] <= 0:
                    del pair_counts[pair]
                pair_words[pair].discard(wi)
            # apply the merge within the word
            j, new_w = 0, []
            while j < len(w):
                if j < len(w) - 1 and w[j] == a and w[j + 1] == b:
                    new_w.append(merged)
                    j += 2
                else:
                    new_w.append(w[j])
                    j += 1
            words[wi] = new_w
            for pair in zip(new_w, new_w[1:]):
                pair_counts[pair] += f
                pair_words[pair].add(wi)
        if verbose and (step + 1) % 500 == 0:
            print(f"[bpe] {step + 1}/{n_merges} merges")

    vocab = {c: i for i, c in enumerate(base)}
    for a, b in merges:
        vocab[a + b] = len(vocab)
    return ByteBPE(vocab, merges, eos_token)
