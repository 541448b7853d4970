"""ECMAScript lexer + structural checks for the SPA's inline JS.

Copy of ``archi_tpu/web/js_lint.py``.

This image has no JS engine or browser (verified: no node/deno/quickjs/
jsc/chromium and no embeddable engine packages), so the reference's
Playwright tier (``/root/reference/tests/ui/``) cannot execute here.
This module is the strongest browser-free substitute: a real ES lexer
(string/template/regex/comment-aware, including nested ``${}`` template
expressions and regex-vs-division disambiguation) that tokenizes the
SPA's JavaScript and verifies it *parses at the lexical+bracket level* —
catching the bug classes source-level greps cannot (unterminated
literals, unbalanced braces from a bad edit, comments swallowing code).

``scripts/ui_browser_smoke.py`` holds the real-browser workflow smoke,
gated on a driver existing; CI runs this lexer tier unconditionally.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

_PUNCT = (
    ">>>=", "===", "!==", "**=", "<<=", ">>=", ">>>", "...", "=>",
    "==", "!=", "<=", ">=", "&&", "||", "??", "?.", "++", "--", "+=",
    "-=", "*=", "/=", "%=", "&=", "|=", "^=", "**", "<<", ">>",
    "{", "}", "(", ")", "[", "]", ";", ",", "<", ">", "+", "-", "*",
    "/", "%", "&", "|", "^", "!", "~", "?", ":", "=", ".",
)
_ID_RE = re.compile(r"[A-Za-z_$][A-Za-z0-9_$]*")
_NUM_RE = re.compile(
    r"0[xX][0-9a-fA-F]+|0[bB][01]+|0[oO][0-7]+|"
    r"(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?")
_KEYWORDS = frozenset(
    "var let const function return if else for while do switch case "
    "default break continue new delete typeof instanceof in of void this "
    "null true false undefined try catch finally throw class extends "
    "super import export yield async await static get set".split())
# previous token kinds/values after which '/' must be a REGEX, not division
_REGEX_PRECEDERS = frozenset(
    "( [ { , ; : ! ? = < > + - * / % & | ^ ~ => == != === !== <= >= && "
    "|| ?? += -= *= /= %= return typeof instanceof in of new delete void "
    "throw case do else yield await".split())


@dataclass
class Token:
    kind: str      # id | num | str | template | regex | punct | keyword
    value: str
    line: int


class JsLexError(ValueError):
    def __init__(self, msg: str, line: int):
        super().__init__(f"line {line}: {msg}")
        self.line = line


def lex(src: str) -> list[Token]:
    """Tokenize ES2017-flavored JS; raises JsLexError on malformed input."""
    toks: list[Token] = []
    i, n, line = 0, len(src), 1
    # template-literal nesting: each entry is the brace depth at which a
    # ${ expression will close back into its template
    tmpl_stack: list[int] = []
    brace_depth = 0

    def prev_significant() -> Token | None:
        return toks[-1] if toks else None

    while i < n:
        c = src[i]
        if c == "\n":
            line += 1
            i += 1
            continue
        if c in " \t\r":
            i += 1
            continue
        if src.startswith("//", i):
            j = src.find("\n", i)
            i = n if j < 0 else j
            continue
        if src.startswith("/*", i):
            j = src.find("*/", i + 2)
            if j < 0:
                raise JsLexError("unterminated block comment", line)
            line += src.count("\n", i, j)
            i = j + 2
            continue
        if c in "'\"":
            j = i + 1
            while j < n:
                if src[j] == "\\":
                    j += 2
                    continue
                if src[j] == c:
                    break
                if src[j] == "\n":
                    raise JsLexError("newline in string literal", line)
                j += 1
            else:
                raise JsLexError("unterminated string literal", line)
            toks.append(Token("str", src[i:j + 1], line))
            i = j + 1
            continue
        if c == "`":
            # scan to the next ${ or closing backtick
            j = i + 1
            while j < n:
                if src[j] == "\\":
                    j += 2
                    continue
                if src[j] == "\n":
                    line += 1
                    j += 1
                    continue
                if src.startswith("${", j):
                    toks.append(Token("template", src[i:j + 2], line))
                    tmpl_stack.append(brace_depth)
                    i = j + 2
                    break
                if src[j] == "`":
                    toks.append(Token("template", src[i:j + 1], line))
                    i = j + 1
                    break
                j += 1
            else:
                raise JsLexError("unterminated template literal", line)
            continue
        if c == "}":
            if tmpl_stack and brace_depth == tmpl_stack[-1]:
                # closing a ${ expression — resume the template literal
                tmpl_stack.pop()
                j = i + 1
                while j < n:
                    if src[j] == "\\":
                        j += 2
                        continue
                    if src[j] == "\n":
                        line += 1
                        j += 1
                        continue
                    if src.startswith("${", j):
                        toks.append(Token("template", src[i:j + 2], line))
                        tmpl_stack.append(brace_depth)
                        i = j + 2
                        break
                    if src[j] == "`":
                        toks.append(Token("template", src[i:j + 1], line))
                        i = j + 1
                        break
                    j += 1
                else:
                    raise JsLexError("unterminated template literal", line)
                continue
            brace_depth -= 1
            toks.append(Token("punct", "}", line))
            i += 1
            continue
        if c == "{":
            brace_depth += 1
            toks.append(Token("punct", "{", line))
            i += 1
            continue
        if c == "/":
            prev = prev_significant()
            is_regex = prev is None or (
                prev.kind in ("punct", "keyword")
                and prev.value in _REGEX_PRECEDERS)
            if is_regex:
                j, in_class = i + 1, False
                while j < n:
                    ch = src[j]
                    if ch == "\\":
                        j += 2
                        continue
                    if ch == "\n":
                        raise JsLexError("newline in regex literal", line)
                    if ch == "[":
                        in_class = True
                    elif ch == "]":
                        in_class = False
                    elif ch == "/" and not in_class:
                        break
                    j += 1
                else:
                    raise JsLexError("unterminated regex literal", line)
                j += 1
                while j < n and src[j] in "gimsuyd":
                    j += 1
                toks.append(Token("regex", src[i:j], line))
                i = j
                continue
        m = _ID_RE.match(src, i)
        if m:
            v = m.group(0)
            toks.append(Token(
                "keyword" if v in _KEYWORDS else "id", v, line))
            i = m.end()
            continue
        m = _NUM_RE.match(src, i)
        if m:
            toks.append(Token("num", m.group(0), line))
            i = m.end()
            continue
        for p in _PUNCT:
            if src.startswith(p, i):
                toks.append(Token("punct", p, line))
                i += len(p)
                break
        else:
            raise JsLexError(f"unexpected character {c!r}", line)
    if tmpl_stack:
        raise JsLexError("unterminated template expression", line)
    return toks


def check_balance(toks: list[Token]) -> None:
    """Brackets must nest properly across the whole program."""
    pairs = {")": "(", "]": "[", "}": "{"}
    stack: list[Token] = []
    for t in toks:
        if t.kind != "punct":
            continue
        if t.value in "([{":
            stack.append(t)
        elif t.value in ")]}":
            if not stack or stack[-1].value != pairs[t.value]:
                raise JsLexError(
                    f"unbalanced {t.value!r}", t.line)
            stack.pop()
    if stack:
        raise JsLexError(f"unclosed {stack[-1].value!r}", stack[-1].line)


def extract_scripts(html: str) -> list[str]:
    """Inline <script> bodies from an HTML document."""
    return re.findall(r"<script[^>]*>(.*?)</script>", html, re.S)


def lint_html(html: str) -> dict:
    """Lex + balance-check every inline script; → summary stats."""
    stats = {"scripts": 0, "tokens": 0, "functions": 0, "listeners": 0,
             "dom_ids": set(), "api_paths": set()}
    for body in extract_scripts(html):
        toks = lex(body)
        check_balance(toks)
        stats["scripts"] += 1
        stats["tokens"] += len(toks)
        for a, b in zip(toks, toks[1:]):
            if a.kind == "keyword" and a.value == "function":
                stats["functions"] += 1
            if a.value == "=>":
                stats["functions"] += 1
            if a.kind == "id" and a.value == "addEventListener":
                stats["listeners"] += 1
            if a.kind == "id" and a.value == "getElementById" \
                    and b.value == "(":
                pass
        for t in toks:
            if t.kind == "str":
                v = t.value[1:-1]
                if v.startswith("/api/"):
                    stats["api_paths"].add(v)
        ids = re.findall(r"getElementById\(\s*['\"]([^'\"]+)", body)
        stats["dom_ids"].update(ids)
    return stats
