"""Tokenizer "fetchers": recover the original substring each token covers.

Each fetcher walks a pointer through the original text while consuming the
characters of each (de-prefixed) token, emitting the exact original substring
per token; trailing unconsumed text is appended to the last token. These are
pure functions of ``(orig_text, tokens)`` — no tokenizer object needed.

Behavioral parity targets (reference: model/backbone_mapping.py):
- ``fetch_xlm``        :35-75   (SentencePiece '▁', full/half-width-tolerant)
- ``fetch_wordpiece``  :78-137  (WordPiece '##', '[UNK]', accent folding)
- ``fetch_roberta``    :140-194 (BPE 'Ġ', '<unk>')
- ``fetch_layoutlmv3`` :197-253 (BPE with 'ĠÂ' mojibake handling)
"""

from __future__ import annotations

from typing import List

from .box_utils import string_f2h

_ACCENT_FOLD = str.maketrans({"á": "a", "é": "e", "í": "i", "ó": "o", "ú": "u", "ü": "u"})


def fetch_xlm(orig_text: str, tokens: List[str]) -> List[str]:
    """SentencePiece (XLM-R / LayoutXLM) fetcher.

    Matches token characters against the original text modulo full-width/
    half-width equivalence; double spaces in the original are consumed when the
    tokenizer collapsed them.
    """
    out = []
    ptr = 0
    n = len(orig_text)
    for i, tok in enumerate(tokens):
        piece = tok.replace("▁", " ")
        sub = ""
        for ch in piece:
            if ptr >= n:
                break
            cur = orig_text[ptr]
            if ch != cur and string_f2h(ch) != string_f2h(cur):
                continue  # tokenizer-inserted char with no original counterpart
            sub += cur
            ptr += 1
            if cur == " " and ptr < n and orig_text[ptr] == " ":
                ptr += 1
                sub += " "
        if i == len(tokens) - 1 and ptr < n:
            sub += orig_text[ptr:]
            ptr = n
        out.append(sub)
    return out


def _walk_chars(token_chars: str, orig_text: str, ptr: int) -> (str, int):
    """Consume ``token_chars`` from ``orig_text[ptr:]``, carrying along any
    original characters the tokenizer skipped (case-folded match allowed)."""
    sub = ""
    n = len(orig_text)
    for c in token_chars:
        while ptr < n and c != orig_text[ptr] and c.upper() != orig_text[ptr]:
            sub += orig_text[ptr]
            ptr += 1
        if ptr < n:
            sub += orig_text[ptr]
            ptr += 1
    return sub, ptr


def _consume_unk(orig_text: str, ptr: int) -> (str, int):
    """[UNK]/<unk> consumes any leading spaces plus one original character."""
    sub = ""
    n = len(orig_text)
    while ptr < n and orig_text[ptr] == " ":
        sub += orig_text[ptr]
        ptr += 1
    if ptr < n:
        sub += orig_text[ptr]
        ptr += 1
    return sub, ptr


def fetch_wordpiece(orig_text: str, tokens: List[str]) -> List[str]:
    """WordPiece (LayoutLMv2 / BERT-uncased) fetcher with accent folding."""
    if len(orig_text) == 0 or orig_text.isspace():
        return []
    orig_text = orig_text.translate(_ACCENT_FOLD)
    out = []
    ptr = 0
    for tok in tokens:
        if tok == "[UNK]":
            sub, ptr = _consume_unk(orig_text, ptr)
        else:
            body = tok[2:] if tok.startswith("##") else tok
            sub, ptr = _walk_chars(body, orig_text, ptr)
        out.append(sub)
    if ptr < len(orig_text) and out:
        out[-1] += orig_text[ptr:]
    return out


def _fold_bpe_mojibake(tok: str) -> str:
    return tok.replace("Â°", "°").replace("Î¿", "o")


def fetch_roberta(orig_text: str, tokens: List[str]) -> List[str]:
    """Byte-level BPE (RoBERTa) fetcher: 'Ġ' marks a leading space."""
    if len(orig_text) == 0 or orig_text.isspace():
        return []
    out = []
    ptr = 0
    for tok in tokens:
        tok = _fold_bpe_mojibake(tok)
        if tok == "<unk>":
            sub, ptr = _consume_unk(orig_text, ptr)
        else:
            body = tok.replace("Ġ", " ") if tok.startswith("Ġ") else tok
            sub, ptr = _walk_chars(body, orig_text, ptr)
        out.append(sub)
    if ptr < len(orig_text) and out:
        out[-1] += orig_text[ptr:]
    return out


def fetch_layoutlmv3(orig_text: str, tokens: List[str]) -> List[str]:
    """LayoutLMv3 BPE fetcher: like RoBERTa but the first token's leading-space
    marker maps to the empty string, and 'ĠÂ' mojibake is folded."""
    if len(orig_text) == 0 or orig_text.isspace():
        return []
    out = []
    ptr = 0
    for i, tok in enumerate(tokens):
        tok = _fold_bpe_mojibake(tok)
        if tok == "<unk>":
            sub, ptr = _consume_unk(orig_text, ptr)
        else:
            body = tok
            if body.startswith("ĠÂ"):
                body = body.replace("ĠÂ", " " if i > 0 else "")
            if body.startswith("Ġ"):
                body = body.replace("Ġ", " " if i > 0 else "")
            sub, ptr = _walk_chars(body, orig_text, ptr)
        out.append(sub)
    if ptr < len(orig_text) and out:
        out[-1] += orig_text[ptr:]
    return out
