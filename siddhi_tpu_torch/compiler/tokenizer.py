"""SiddhiQL tokenizer.

Covers the lexer rules of the reference grammar
(``siddhi-query-compiler/src/main/antlr4/.../SiddhiQL.g4:720-918``):
case-insensitive keywords, quoted identifiers, numeric literals with
L/F/D suffixes, single/double/triple-quoted strings, ``--`` and ``/* */``
comments, ``{ ... }`` script bodies, and the operator/symbol set.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional


class TokenizeError(Exception):
    def __init__(self, msg: str, line: int, col: int):
        super().__init__(f"{msg} at line {line}:{col}")
        self.line = line
        self.col = col


# token kinds
ID = "ID"
INT = "INT"
LONG = "LONG"
FLOAT = "FLOAT"
DOUBLE = "DOUBLE"
STRING = "STRING"
SCRIPT = "SCRIPT"
SYM = "SYM"
KW = "KW"
EOF = "EOF"

KEYWORDS = {
    "define", "stream", "table", "app", "from", "partition", "window", "select",
    "group", "by", "order", "asc", "desc", "limit", "offset", "having", "insert",
    "delete", "update", "return", "events", "into", "output", "expired", "current",
    "snapshot", "for", "raw", "of", "as", "at", "or", "and", "in", "is", "not", "on",
    "within", "with", "begin", "end", "null", "every", "last", "all", "first",
    "join", "inner", "outer", "right", "left", "full", "unidirectional", "aggregation",
    "aggregate", "per", "set", "trigger", "function", "string", "int", "long",
    "float", "double", "bool", "object", "true", "false",
}

# time-unit lexemes -> milliseconds multiplier (grammar SiddhiQL.g4:829-836;
# month = 30 days, year = 365 days as in the reference TimeConstant builders)
TIME_UNITS = {}
for _names, _ms in [
    (("millisecond", "milliseconds", "millisec", "ms"), 1),
    (("sec", "second", "seconds"), 1000),
    (("min", "minute", "minutes"), 60_000),
    (("hour", "hours"), 3_600_000),
    (("day", "days"), 86_400_000),
    (("week", "weeks"), 604_800_000),
    (("month", "months"), 2_592_000_000),
    (("year", "years"), 31_536_000_000),
]:
    for _n in _names:
        TIME_UNITS[_n] = _ms

MULTI_SYMS = ["...", "->", "==", "!=", "<=", ">="]
SINGLE_SYMS = set("@()[]{}:;,.#!=<>+-*/%?")


@dataclass
class Token:
    kind: str
    text: str  # for KW: lowercased; for ID/STRING: literal text
    line: int
    col: int
    value: object = None  # parsed numeric value

    def __repr__(self):
        return f"{self.kind}({self.text!r})"


def tokenize(src: str, script_mode_hint: bool = True) -> List[Token]:
    """Tokenize SiddhiQL source.

    ``{ ... }`` blocks are lexed as single SCRIPT tokens (function bodies),
    matching the reference lexer's SCRIPT rule.
    """
    toks: List[Token] = []
    i, n = 0, len(src)
    line, col = 1, 1

    def advance(k: int):
        nonlocal i, line, col
        for _ in range(k):
            if i < n and src[i] == "\n":
                line += 1
                col = 1
            else:
                col += 1
            i += 1

    while i < n:
        c = src[i]
        # whitespace
        if c in " \t\r\n\x0b":
            advance(1)
            continue
        # comments
        if src.startswith("--", i):
            j = src.find("\n", i)
            advance((j - i) if j != -1 else (n - i))
            continue
        if src.startswith("/*", i):
            j = src.find("*/", i + 2)
            advance(((j + 2) - i) if j != -1 else (n - i))
            continue
        tl, tc = line, col
        # script block { ... } with nesting
        if c == "{":
            depth = 0
            j = i
            while j < n:
                if src[j] == "{":
                    depth += 1
                elif src[j] == "}":
                    depth -= 1
                    if depth == 0:
                        break
                elif src[j] in "\"'":
                    quote = src[j]
                    j += 1
                    while j < n and src[j] != quote:
                        j += 1
                elif src.startswith("//", j):
                    # script-internal line comment: braces inside don't count
                    # (reference SCRIPT_ATOM rule, SiddhiQL.g4:883-887)
                    while j < n and src[j] != "\n":
                        j += 1
                j += 1
            if j >= n:
                raise TokenizeError("unterminated '{' script block", tl, tc)
            text = src[i : j + 1]
            toks.append(Token(SCRIPT, text, tl, tc, value=text[1:-1]))
            advance(j + 1 - i)
            continue
        # strings
        if src.startswith('"""', i):
            j = src.find('"""', i + 3)
            if j == -1:
                raise TokenizeError("unterminated triple-quoted string", tl, tc)
            toks.append(Token(STRING, src[i + 3 : j], tl, tc, value=src[i + 3 : j]))
            advance(j + 3 - i)
            continue
        if c in "'\"":
            j = i + 1
            while j < n and src[j] != c:
                if src[j] == "\n":
                    raise TokenizeError("unterminated string literal", tl, tc)
                j += 1
            if j >= n:
                raise TokenizeError("unterminated string literal", tl, tc)
            toks.append(Token(STRING, src[i + 1 : j], tl, tc, value=src[i + 1 : j]))
            advance(j + 1 - i)
            continue
        # quoted identifier
        if c == "`":
            j = src.find("`", i + 1)
            if j == -1:
                raise TokenizeError("unterminated quoted identifier", tl, tc)
            toks.append(Token(ID, src[i + 1 : j], tl, tc))
            advance(j + 1 - i)
            continue
        # numbers
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            j = i
            seen_dot = False
            seen_exp = False
            while j < n:
                ch = src[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp and j + 1 < n and src[j + 1].isdigit():
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp and j + 1 < n and (
                    src[j + 1].isdigit() or (src[j + 1] in "+-" and j + 2 < n and src[j + 2].isdigit())
                ):
                    seen_exp = True
                    j += 1
                    if src[j] in "+-":
                        j += 1
                else:
                    break
            text = src[i:j]
            kind = None
            if j < n and src[j] in "lL" and not seen_dot and not seen_exp:
                kind, j = LONG, j + 1
                val = int(text)
            elif j < n and src[j] in "fF":
                kind, j = FLOAT, j + 1
                val = float(text)
            elif j < n and src[j] in "dD":
                kind, j = DOUBLE, j + 1
                val = float(text)
            elif seen_dot or seen_exp:
                kind, val = DOUBLE, float(text)
            else:
                kind, val = INT, int(text)
            toks.append(Token(kind, text, tl, tc, value=val))
            advance(j - i)
            continue
        # identifiers / keywords
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            text = src[i:j]
            low = text.lower()
            if low in KEYWORDS or low in TIME_UNITS:
                toks.append(Token(KW, low, tl, tc, value=text))
            else:
                toks.append(Token(ID, text, tl, tc))
            advance(j - i)
            continue
        # symbols
        matched = False
        for ms in MULTI_SYMS:
            if src.startswith(ms, i):
                toks.append(Token(SYM, ms, tl, tc))
                advance(len(ms))
                matched = True
                break
        if matched:
            continue
        if c in SINGLE_SYMS:
            toks.append(Token(SYM, c, tl, tc))
            advance(1)
            continue
        raise TokenizeError(f"unexpected character {c!r}", tl, tc)

    toks.append(Token(EOF, "", line, col))
    return toks
