"""yacs-style YAML config tree (counterpart of `hosnerf_tpu/config/
yamlcfg.py`): `CfgNode` (a dict with attribute access and deep merge),
`load_yaml` and `make_cfg` (default.yaml <- per-scene yaml <- overrides).

The files are read by `parse_yaml`, this module's reader of the YAML subset
that configs use, in place of PyYAML: block mappings, block sequences
(`- x`, nested or compact `- key: value`), one-line flow sequences
(`[a, b]`), comments, and plain, single- and double-quoted scalars. Plain
scalars resolve as PyYAML's `safe_load` (YAML 1.1) resolves them: `1e-3`
stays a string while `1.0e-3` and `.5` are floats, yes/no/on/off are
booleans, `~`/null/empty are None, `0x1F` and `017` are ints. Anything
outside the subset (anchors, aliases, tags, block scalars, flow mappings,
nested flow sequences, multi-line scalars, several documents, timestamps,
binary and ':'-separated numbers, backslash escapes) raises ValueError with
its line number: the reader never guesses.
"""

from __future__ import annotations

import copy
import re
from typing import Any, Dict, List, Optional, Tuple


class CfgNode(dict):
    """dict with attribute access, recursive over nested dicts."""

    def __init__(self, d: Optional[Dict[str, Any]] = None):
        super().__init__()
        for k, v in (d or {}).items():
            self[k] = CfgNode(v) if isinstance(v, dict) else v

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = CfgNode(value) if isinstance(value, dict) else value

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def merge_from(self, other: Dict[str, Any]) -> "CfgNode":
        for k, v in other.items():
            if (k in self and isinstance(self[k], CfgNode)
                    and isinstance(v, dict)):
                self[k].merge_from(v)
            else:
                self[k] = CfgNode(v) if isinstance(v, dict) else v
        return self


def load_yaml(path: str) -> CfgNode:
    with open(path) as f:
        return CfgNode(parse_yaml(f.read()) or {})


def make_cfg(scene_cfg_path: Optional[str] = None,
             default_cfg_path: Optional[str] = None,
             overrides: Optional[Dict[str, Any]] = None) -> CfgNode:
    """default.yaml <- per-scene yaml <- overrides (yacs merge order)."""
    cfg = CfgNode()
    if default_cfg_path:
        cfg.merge_from(load_yaml(default_cfg_path))
    if scene_cfg_path:
        cfg.merge_from(load_yaml(scene_cfg_path))
    if overrides:
        cfg.merge_from(overrides)
    return cfg


# ---------------------------------------------------------------------------
# scalars: PyYAML's YAML 1.1 implicit resolvers and constructors
# ---------------------------------------------------------------------------

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0[0-7_]+
                  |[-+]?(?:0|[1-9][0-9_]*)
                  |[-+]?0x[0-9a-fA-F_]+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                        |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                        (?:[Tt]|[\ \t]+)[0-9][0-9]?
                        :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                        (?:[\ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                        re.X)
# numbers PyYAML reads and configs do not use: binary and base 60
_UNREAD_NUMBER = re.compile(r"""^[-+]?(?:0b[0-1_]+
                            |[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?)$""",
                            re.X)


def resolve_plain(text: str, lineno: int = 0):
    """The value PyYAML's safe_load gives the plain scalar `text`."""
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _NULL.match(text):
        return None
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        return sign * float(v)
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if (_TIMESTAMP.match(text) or _UNREAD_NUMBER.match(text)
            or text in ("=", "<<")):
        raise ValueError(f"line {lineno}: {text!r} is a timestamp, a binary "
                         "or base-60 number, a value or a merge key, outside "
                         "the YAML subset read here")
    return text


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------

_NOT_PLAIN_START = set(",[]{}#&*!|>'\"%@`")


class _Text:
    """One logical line's content and a cursor over it."""

    def __init__(self, text: str, lineno: int):
        self.s, self.i, self.n = text, 0, lineno

    def fail(self, what: str):
        raise ValueError(f"line {self.n}: {what}: {self.s!r}")

    def peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ""

    def skip_space(self):
        while self.peek() in (" ", "\t") and self.peek():
            self.i += 1

    def at_end(self) -> bool:
        """Only spaces and a comment left."""
        j = self.i
        while j < len(self.s) and self.s[j] in " \t":
            j += 1
        return j == len(self.s) or (self.s[j] == "#" and (
            j == 0 or self.s[j - 1] in " \t"))

    def quoted(self) -> str:
        q = self.peek()
        self.i += 1
        out = []
        while True:
            if self.i >= len(self.s):
                self.fail("quoted scalar not closed on its line (multi-line "
                          "scalars are not read)")
            ch = self.s[self.i]
            if q == "'" and ch == "'":
                if self.s[self.i + 1:self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if q == '"' and ch == '"':
                self.i += 1
                return "".join(out)
            if q == '"' and ch == "\\":
                self.fail("backslash escapes are not read")
            out.append(ch)
            self.i += 1

    def plain(self, flow: bool) -> str:
        """A plain scalar up to a comment, the line's end, or (in a flow
        sequence) ',' or ']'."""
        start = self.i
        ch = self.peek()
        if not ch or ch in _NOT_PLAIN_START or (ch in "-?:" and self.s[
                self.i + 1:self.i + 2] in ("", " ", "\t")):
            self.fail(f"{ch!r} starts no scalar of the subset (anchors, "
                      "aliases, tags, block scalars and flow mappings are "
                      "not read)")
        while self.i < len(self.s):
            ch = self.s[self.i]
            if ch == "#" and self.s[self.i - 1] in " \t":
                break
            if ch == ":" and self.s[self.i + 1:self.i + 2] in ("", " ", "\t"):
                self.fail("a ': ' inside a value")
            if flow and ch in ",[]{}":
                break
            self.i += 1
        return self.s[start:self.i].rstrip(" \t")

    def scalar(self, flow: bool = False):
        if self.peek() in ("'", '"'):
            return self.quoted()
        return resolve_plain(self.plain(flow), self.n)

    def flow_seq(self) -> list:
        self.i += 1                       # '['
        out = []
        while True:
            self.skip_space()
            ch = self.peek()
            if ch == "":
                self.fail("flow sequence not closed on its line")
            if ch == "]":
                self.i += 1
                return out
            if ch == "[":
                self.fail("nested flow sequences are not read")
            if ch == ",":
                self.fail("empty entry in a flow sequence")
            else:
                out.append(self.scalar(flow=True))
            self.skip_space()
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "]":
                self.fail("expected ',' or ']' in a flow sequence")

    def value(self):
        """An inline value: a flow sequence or a scalar, then nothing but
        a comment."""
        self.skip_space()
        v = self.flow_seq() if self.peek() == "[" else self.scalar()
        if not self.at_end():
            self.fail("text after a value")
        return v


def _lines(text: str) -> List[Tuple[int, int, str]]:
    """(line number, indent, content) of each line that holds more than a
    comment."""
    out = []
    for n, raw in enumerate(text.splitlines(), 1):
        body = raw.lstrip(" ")
        indent = len(raw) - len(body)
        if body.startswith("\t"):
            raise ValueError(f"line {n}: tab in indentation")
        t = _Text(body, n)
        if t.at_end():
            continue
        if body.startswith("%") or (body[:3] in ("---", "...")
                                     and body[3:4] in ("", " ", "\t")):
            raise ValueError(f"line {n}: document markers and directives "
                             "are not read (one document per file)")
        if body.startswith(("? ", "?\t")) or body == "?":
            raise ValueError(f"line {n}: complex mapping keys are not read")
        out.append((n, indent, body))
    return out


def _is_item(body: str) -> bool:
    return body == "-" or body.startswith(("- ", "-\t"))


class _Reader:
    def __init__(self, text: str):
        self.lines = _lines(text)
        self.k = 0

    def block(self, indent: int):
        n, _, body = self.lines[self.k]
        return (self.seq(indent) if _is_item(body) else self.mapping(indent))

    def nested(self, indent: int, lineno: int, seq_ok: bool):
        """The block under a 'key:' or '-' with nothing after it: deeper
        lines, a sequence at the key's own indent (`seq_ok`), or None."""
        if self.k < len(self.lines):
            n, ind, body = self.lines[self.k]
            if ind > indent:
                return self.block(ind)
            if seq_ok and ind == indent and _is_item(body):
                return self.seq(indent)
        return None

    def mapping(self, indent: int) -> dict:
        out = {}
        while self.k < len(self.lines):
            n, ind, body = self.lines[self.k]
            if ind < indent:
                break
            if ind > indent:
                raise ValueError(f"line {n}: unexpected indentation")
            if _is_item(body):
                break
            t = _Text(body, n)
            if t.peek() in ("'", '"'):
                key = t.quoted()
            else:
                start = t.i
                while t.i < len(t.s) and not (
                        t.s[t.i] == ":" and t.s[t.i + 1:t.i + 2] in (
                            "", " ", "\t")):
                    if t.s[t.i] == "#" and t.i > 0 and t.s[t.i - 1] in " \t":
                        break
                    t.i += 1
                key = _Text(t.s[start:t.i].rstrip(), n).scalar()
            t.skip_space()
            if t.peek() != ":":
                t.fail("expected 'key: value' (a bare scalar at block "
                       "level is not read)")
            t.i += 1
            if isinstance(key, list):
                t.fail("a sequence as a mapping key")
            self.k += 1
            out[key] = (self.nested(indent, n, seq_ok=True) if t.at_end()
                        else t.value())
        return out

    def seq(self, indent: int) -> list:
        out = []
        while self.k < len(self.lines):
            n, ind, body = self.lines[self.k]
            if ind != indent or not _is_item(body):
                if ind > indent:
                    raise ValueError(f"line {n}: unexpected indentation")
                break
            rest = body[1:].lstrip(" \t")
            t = _Text(rest, n)
            if t.at_end():
                self.k += 1
                out.append(self.nested(indent, n, seq_ok=False))
                continue
            col = indent + len(body) - len(rest)
            if _is_item(rest) or _has_key(rest, n):
                # a compact nested block: its first line starts at `col`
                self.lines[self.k] = (n, col, rest)
                out.append(self.block(col))
            else:
                self.k += 1
                out.append(t.value())
        return out


def _has_key(body: str, lineno: int) -> bool:
    """Whether a line's content is a 'key: value' entry."""
    t = _Text(body, lineno)
    if t.peek() in ("'", '"'):
        t.quoted()
    elif t.peek() == "[":
        return False
    while t.i < len(t.s):
        ch = t.s[t.i]
        if ch == "#" and t.i > 0 and t.s[t.i - 1] in " \t":
            return False
        if ch == ":" and t.s[t.i + 1:t.i + 2] in ("", " ", "\t"):
            return True
        t.i += 1
    return False


def parse_yaml(text: str):
    """The value of a YAML document in the subset this module reads (see
    the module's docstring); None for an empty one."""
    r = _Reader(text)
    if not r.lines:
        return None
    n, indent, _ = r.lines[0]
    v = r.block(indent)
    if r.k < len(r.lines):
        raise ValueError(f"line {r.lines[r.k][0]}: unexpected indentation")
    return v
