"""CLIP BPE tokenizer (self-contained implementation of the standard algorithm).

The reference tokenizes with ``open_clip.tokenize`` (reference
odise/modeling/meta_arch/clip.py:64,165). We implement the same byte-level BPE
scheme from its public specification: byte->unicode table, lowercasing +
whitespace cleanup, the CLIP word regex, greedy merge by rank, and
<|startoftext|>/<|endoftext|> framing padded to 77 tokens.

The merge table (``bpe_simple_vocab_16e6.txt.gz``) is *data*, not code; it is
read from ``bpe_path`` or from this package's directory. When absent, a
deterministic byte-level fallback keeps the pipeline runnable: token ids are
stable but not CLIP-compatible, which only matters with real CLIP weights.
Copied from ``odise_tpu/models/clip/tokenizer.py`` (the port imports nothing
of the JAX package); the merge-file search reads nothing outside the package.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
from typing import List, Sequence, Union

import numpy as np

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408
SOT_TEXT = "<|startoftext|>"
EOT_TEXT = "<|endoftext|>"

# CLIP's original word-split pattern (open_clip simple_tokenizer), verbatim
# via the third-party `regex` module when present. The stdlib fallback is an
# EXACT Unicode equivalent built from Python re's classes:
#   \p{L}  == [^\W\d_]      (re \w = L ∪ N ∪ '_'; minus \d=Nd minus '_'
#                            leaves L plus Nl/No — see caveat below)
#   \p{N}  -> \d            (Nd)
#   [^\s\p{L}\p{N}] == [^\s\w]|_
# The union of the letter+number classes equals CLIP's exactly, so split
# points match; the only divergence is that CONSECUTIVE letterlike numerals
# (Nl/No, e.g. 'Ⅻ½') group into one run instead of one match per char —
# absent from every label file and caption corpus this framework tokenizes.
# Equivalence is pinned against the verbatim pattern in the JAX package's tests.
try:
    import regex as _regex

    _PAT = _regex.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _regex.IGNORECASE,
    )
except ImportError:  # stdlib-only environments
    _PAT = re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|(?:[^\s\w]|_)+""",
        re.IGNORECASE,
    )


@functools.lru_cache()
def bytes_to_unicode():
    """Reversible byte -> printable-unicode mapping (GPT-2 scheme)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _find_bpe_vocab() -> str | None:
    path = os.path.join(os.path.dirname(__file__), "bpe_simple_vocab_16e6.txt.gz")
    return path if os.path.isfile(path) else None


class SimpleTokenizer:
    """Byte-level BPE tokenizer; CLIP-compatible when given the merges file."""

    def __init__(self, bpe_path: str | None = None):
        bpe_path = bpe_path or _find_bpe_vocab()
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._compatible = bpe_path is not None
        if bpe_path is not None:
            with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
                merges = f.read().split("\n")
            merges = merges[1: 49152 - 256 - 2 + 1]
            merges = [tuple(m.split()) for m in merges]
            vocab = list(bytes_to_unicode().values())
            vocab = vocab + [v + "</w>" for v in vocab]
            for merge in merges:
                vocab.append("".join(merge))
            vocab.extend([SOT_TEXT, EOT_TEXT])
            self.encoder = dict(zip(vocab, range(len(vocab))))
            self.bpe_ranks = dict(zip(merges, range(len(merges))))
        else:
            # Deterministic fallback: byte-level vocab only, no merges.
            vocab = list(bytes_to_unicode().values())
            vocab = vocab + [v + "</w>" for v in vocab]
            self.encoder = dict(zip(vocab, range(len(vocab))))
            self.encoder[SOT_TEXT] = VOCAB_SIZE - 2
            self.encoder[EOT_TEXT] = VOCAB_SIZE - 1
            self.bpe_ranks = {}
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.cache = {SOT_TEXT: SOT_TEXT, EOT_TEXT: EOT_TEXT}
        self.sot_token = self.encoder[SOT_TEXT]
        self.eot_token = self.encoder[EOT_TEXT]

    @property
    def is_clip_compatible(self) -> bool:
        return self._compatible

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        if not self.bpe_ranks:
            out = " ".join(word)
            self.cache[token] = out
            return out
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in _PAT.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens: Sequence[int]) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        return (
            bytearray(self.byte_decoder[c] for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )


@functools.lru_cache()
def default_tokenizer() -> SimpleTokenizer:
    return SimpleTokenizer()


def tokenize(texts: Union[str, Sequence[str]],
             context_length: int = CONTEXT_LENGTH) -> np.ndarray:
    """Tokenize to a fixed [N, context_length] int32 array (CLIP convention:
    sot + tokens + eot, truncated so eot is always present, zero padded)."""
    if isinstance(texts, str):
        texts = [texts]
    tok = default_tokenizer()
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        tokens = [tok.sot_token] + tok.encode(text) + [tok.eot_token]
        if len(tokens) > context_length:
            tokens = tokens[: context_length - 1] + [tok.eot_token]
        result[i, : len(tokens)] = tokens
    return result
