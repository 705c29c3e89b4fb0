"""Tokenizer for the Stan modeling language."""

from __future__ import annotations

import dataclasses

from .errors import StanCompileError

# multi-char operators, longest first
_OPERATORS = [
    "<-", "+=", "-=", "*=", "/=", ".*=", "./=",
    "==", "!=", "<=", ">=", "&&", "||",
    ".*", "./", ".^",
    "+", "-", "*", "/", "%", "^", "'", "!", "=", "<", ">",
    "~", "?", ":", "|",
]
_PUNCT = ["{", "}", "[", "]", "(", ")", ",", ";"]

KEYWORDS = {
    "functions", "data", "transformed", "parameters", "model", "generated",
    "quantities", "int", "real", "complex", "vector", "row_vector", "matrix",
    "complex_vector", "complex_row_vector", "complex_matrix",
    "array", "simplex", "unit_vector", "ordered", "positive_ordered",
    "cholesky_factor_corr", "cholesky_factor_cov", "corr_matrix", "cov_matrix",
    "sum_to_zero_vector", "tuple",
    "lower", "upper", "offset", "multiplier",
    "for", "in", "while", "if", "else", "break", "continue",
    "return", "print", "reject", "fatal_error", "target", "profile", "void",
}


@dataclasses.dataclass
class Token:
    kind: str   # IDENT, INT, REAL, STRING, OP, PUNCT, KEYWORD, EOF
    value: str
    line: int
    col: int

    def __repr__(self):
        return f"Token({self.kind}, {self.value!r}, {self.line}:{self.col})"


def tokenize(src: str) -> list[Token]:
    tokens: list[Token] = []
    i = 0
    line = 1
    col = 1
    n = len(src)

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
        if c in " \t\r\n":
            advance(1)
            continue
        # comments
        if src.startswith("//", i) or c == "#":
            while i < n and src[i] != "\n":
                advance(1)
            continue
        if src.startswith("/*", i):
            end = src.find("*/", i + 2)
            if end < 0:
                raise StanCompileError("unterminated block comment", line, col)
            advance(end + 2 - i)
            continue
        tl, tc = line, col
        # member-access dot: `pair.1`, `arr[2].3`, `z.real` -- a '.' right
        # after a value-ending token that is NOT an elementwise operator
        # (.* ./ .^) and NOT the start of a bare decimal like `.5` at the
        # beginning of an expression
        if (
            c == "."
            and tokens
            and (
                tokens[-1].kind in ("IDENT", "KEYWORD", "INT", "REAL")
                or (tokens[-1].kind == "PUNCT" and tokens[-1].value in (")", "]"))
            )
            # a number token is complete when emitted, so a '.' right
            # after INT/REAL can only continue a member chain (`x.2.2.real`)
            and i + 1 < n
            and (src[i + 1].isdigit() or src[i + 1].isalpha() or src[i + 1] == "_")
        ):
            tokens.append(Token("OP", ".", tl, tc))
            advance(1)
            continue
        # string literal
        if c == '"':
            j = src.find('"', i + 1)
            if j < 0:
                raise StanCompileError("unterminated string", line, col)
            tokens.append(Token("STRING", src[i + 1 : j], tl, tc))
            advance(j + 1 - i)
            continue
        # number
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            j = i
            is_real = False
            while j < n and src[j].isdigit():
                j += 1
            if j < n and src[j] == ".":
                # distinguish "1.5" from range-ish constructs; Stan has no
                # ".." operator so a dot after digits is always a decimal
                # point unless followed by an operator char like '*'
                if j + 1 < n and src[j + 1] in "*/^":
                    pass  # elementwise op like 2 .* x
                else:
                    is_real = True
                    j += 1
                    while j < n and src[j].isdigit():
                        j += 1
            if j < n and src[j] in "eE":
                k = j + 1
                if k < n and src[k] in "+-":
                    k += 1
                if k < n and src[k].isdigit():
                    is_real = True
                    j = k
                    while j < n and src[j].isdigit():
                        j += 1
            # imaginary literal: number immediately suffixed with `i`
            # (4.0i, 2i) that is not the start of a longer identifier
            if (
                j < n
                and src[j] == "i"
                and (j + 1 >= n or not (src[j + 1].isalnum() or src[j + 1] == "_"))
            ):
                tokens.append(Token("IMAG", src[i:j], tl, tc))
                advance(j + 1 - i)
                continue
            tokens.append(
                Token("REAL" if is_real else "INT", src[i:j], tl, tc)
            )
            advance(j - i)
            continue
        # identifier / keyword
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            word = src[i:j]
            kind = "KEYWORD" if word in KEYWORDS else "IDENT"
            tokens.append(Token(kind, word, tl, tc))
            advance(j - i)
            continue
        # operators / punctuation
        matched = False
        for op in _OPERATORS:
            if src.startswith(op, i):
                tokens.append(Token("OP", "=" if op == "<-" else op, tl, tc))
                advance(len(op))
                matched = True
                break
        if matched:
            continue
        if c in _PUNCT:
            tokens.append(Token("PUNCT", c, tl, tc))
            advance(1)
            continue
        raise StanCompileError(f"unexpected character {c!r}", line, col)
    tokens.append(Token("EOF", "", line, col))
    return tokens
