"""WordPiece tokenizer (BERT-style), pure Python.

The port's own copy of the JAX package's ``data/wordpiece.py``: HF
``BertTokenizer`` semantics (``do_lower_case=True`` by default, as the
published STonKGs preprocessing builds it from the cased BioBERT vocab),
with ``encode_plus(padding="max_length", truncation=True)`` output.  The
C++ batch tokenizer of ``data/fast_tokenizer.py`` behaves identically;
this module defines the semantics and is its test oracle.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PAD_ID = 0
UNK_TOKEN = "[UNK]"
CLS_TOKEN = "[CLS]"
SEP_TOKEN = "[SEP]"
PAD_TOKEN = "[PAD]"
MASK_TOKEN = "[MASK]"


def load_vocab(vocab_file: str) -> Dict[str, int]:
    """Read a BERT vocab.txt into an ordered token->id dict."""
    vocab: Dict[str, int] = {}
    with open(vocab_file, encoding="utf-8") as f:
        for i, line in enumerate(f):
            token = line.rstrip("\n")
            vocab[token] = i
    return vocab


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII non-alphanumeric ranges count as punctuation (BERT convention)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_chinese_char(cp: int) -> bool:
    return (
        (0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
        or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
        or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
        or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F)
    )


class BasicTokenizer:
    """BERT basic tokenizer: cleanup, CJK spacing, lowercase/strip accents,
    punctuation splitting."""

    def __init__(self, do_lower_case: bool = True, strip_accents: Optional[bool] = None):
        self.do_lower_case = do_lower_case
        self.strip_accents = strip_accents

    def tokenize(self, text: str) -> List[str]:
        """Whitespace/punctuation split (+ optional lowercase/accent strip)."""
        text = self._clean_text(text)
        text = self._tokenize_chinese_chars(text)
        text = unicodedata.normalize("NFC", text)
        tokens: List[str] = []
        for token in text.split():
            if self.do_lower_case:
                token = token.lower()
                if self.strip_accents is not False:
                    token = self._strip_accents(token)
            elif self.strip_accents:
                token = self._strip_accents(token)
            tokens.extend(self._split_on_punc(token))
        return tokens

    @staticmethod
    def _clean_text(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _tokenize_chinese_chars(text: str) -> str:
        out = []
        for ch in text:
            if _is_chinese_char(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(token: str) -> str:
        return "".join(
            ch for ch in unicodedata.normalize("NFD", token)
            if unicodedata.category(ch) != "Mn"
        )

    @staticmethod
    def _split_on_punc(token: str) -> List[str]:
        if not token:
            return []
        out: List[List[str]] = []
        start_new = True
        for ch in token:
            if _is_punctuation(ch):
                out.append([ch])
                start_new = True
            else:
                if start_new:
                    out.append([])
                    start_new = False
                out[-1].append(ch)
        return ["".join(x) for x in out]


class WordPieceTokenizer:
    """Greedy longest-match-first subword tokenizer."""

    def __init__(self, vocab: Dict[str, int], unk_token: str = UNK_TOKEN,
                 max_input_chars_per_word: int = 100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_input_chars_per_word = max_input_chars_per_word

    def tokenize(self, word: str) -> List[str]:
        """Greedy longest-match-first WordPiece split of one token."""
        if len(word) > self.max_input_chars_per_word:
            return [self.unk_token]
        tokens: List[str] = []
        start = 0
        n = len(word)
        while start < n:
            end = n
            cur = None
            while start < end:
                substr = word[start:end]
                if start > 0:
                    substr = "##" + substr
                if substr in self.vocab:
                    cur = substr
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            tokens.append(cur)
            start = end
        return tokens


class BertTokenizer:
    """End-to-end BERT tokenizer with ``encode_plus``-style output.

    Matches HF ``BertTokenizer(vocab_file, do_lower_case=True)`` /
    ``encode_plus(padding="max_length", truncation=True, max_length=L)``
    as used by all reference preprocessors."""

    def __init__(self, vocab_file: str, do_lower_case: bool = True):
        self.vocab = load_vocab(vocab_file)
        self.basic = BasicTokenizer(do_lower_case=do_lower_case)
        self.wordpiece = WordPieceTokenizer(self.vocab)
        self.unk_id = self.vocab[UNK_TOKEN]
        self.cls_id = self.vocab[CLS_TOKEN]
        self.sep_id = self.vocab[SEP_TOKEN]
        self.pad_id = self.vocab[PAD_TOKEN]
        self.mask_id = self.vocab.get(MASK_TOKEN)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    SPECIAL_TOKENS = (PAD_TOKEN, UNK_TOKEN, CLS_TOKEN, SEP_TOKEN, MASK_TOKEN)

    def _split_on_specials(self, text: str) -> List[str]:
        """Split so literal special tokens survive intact (HF treats them
        as added tokens matched before basic tokenization)."""
        parts = [text]
        for tok in self.SPECIAL_TOKENS:
            nxt: List[str] = []
            for part in parts:
                if part in self.SPECIAL_TOKENS:
                    nxt.append(part)
                    continue
                pieces = part.split(tok)
                for i, piece in enumerate(pieces):
                    if i:
                        nxt.append(tok)
                    if piece:
                        nxt.append(piece)
            parts = nxt
        return parts

    def tokenize(self, text: str) -> List[str]:
        """Full BERT tokenization: basic split then WordPiece."""
        out: List[str] = []
        for segment in self._split_on_specials(text):
            if segment in self.SPECIAL_TOKENS:
                out.append(segment)
                continue
            for word in self.basic.tokenize(segment):
                out.extend(self.wordpiece.tokenize(word))
        return out

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        return [self.vocab.get(t, self.unk_id) for t in tokens]

    def encode(self, text: str, max_length: int) -> Tuple[List[int], List[int]]:
        """CLS + tokens (truncated to max_length-2) + SEP, padded.

        Returns (input_ids, attention_mask), each of length max_length."""
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        ids = ids[: max_length - 2]
        ids = [self.cls_id] + ids + [self.sep_id]
        mask = [1] * len(ids)
        pad = max_length - len(ids)
        return ids + [self.pad_id] * pad, mask + [0] * pad

    def encode_batch(self, texts: Iterable[str], max_length: int):
        """Batch encode -> (ids (N, L) int32, mask (N, L) int32) numpy arrays."""
        import numpy as np

        texts = list(texts)
        ids = np.zeros((len(texts), max_length), np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)
        for i, t in enumerate(texts):
            row_ids, row_mask = self.encode(t, max_length)
            ids[i] = row_ids
            mask[i] = row_mask
        return ids, mask
