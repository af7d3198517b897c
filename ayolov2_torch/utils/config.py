"""Config files: data, model and train configs as dicts, and run dirs.

The counterpart of ``ayolov2_tpu/utils/config.py``. A file that holds JSON
is read with ``json``; any other is read by :func:`parse_yaml`, a reader of
the YAML subset the repository's configs use, so no PyYAML is needed:

- block mappings and block sequences (``- item``, compact ``- key: value``),
- flow sequences ``[...]`` and flow mappings ``{...}``, across lines, with
  trailing commas,
- anchors ``&name`` and aliases ``*name``,
- comments, single- and double-quoted scalars, and plain scalars resolved
  by ``yaml.safe_load``'s YAML 1.1 rules exactly: ``yes``/``off`` are
  booleans, ``0o``-less octal and ``1_000`` are ints, a float needs a dot
  (``5e-4`` stays a string, ``5.0e-4`` does not), ``~``/``null``/empty are
  None.

Anything else (block scalars ``|``/``>``, tags, multi-line plain scalars,
several documents, timestamps, merge keys) raises ``ValueError`` naming the
file and the line.

``snapshot_configs`` writes the merged config as ``args.json`` (the JAX
package writes ``args.yaml`` with PyYAML).
"""

from __future__ import annotations

import datetime
import glob
import json
import math
import re
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

# yaml.resolver.Resolver's implicit resolvers (YAML 1.1), verbatim
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]?-[0-9][0-9]?
                    (?:[Tt]|[ \t]+)[0-9][0-9]?
                    :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                    (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_FLOW_END = ",[]{}"
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}


def _sexagesimal(value: str, cast) -> Any:
    total = cast(0)
    for part in value.split(":"):
        total = total * 60 + cast(part)
    return total


def resolve_scalar(value: str) -> Any:
    """A plain scalar as ``yaml.safe_load`` constructs it."""
    if _BOOL.match(value):
        return value.lower() in ("yes", "true", "on")
    if _NULL.match(value):
        return None
    if _INT.match(value):
        v = value.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        if v[0] in "+-":
            v = v[1:]
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            return sign * _sexagesimal(v, int)
        return sign * int(v)
    if _FLOAT.match(value):
        v = value.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        if v[0] in "+-":
            v = v[1:]
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    if _TIMESTAMP.match(value) or value in ("<<", "="):
        raise ValueError(f"the plain scalar {value!r} (a timestamp, merge key or value key)")
    return value


class _YamlParser:
    """Recursive descent over the text; ``i`` is the read position."""

    def __init__(self, text: str, name: str) -> None:
        if "\t" in text:
            line = text[: text.index("\t")].count("\n") + 1
            raise ValueError(f"{name}:{line}: a tab character (this reader takes spaces only)")
        self.s = text.replace("\r\n", "\n")
        self.name = name
        self.i = 0
        self.anchors: Dict[str, Any] = {}

    # -- positions -----------------------------------------------------------
    def fail(self, what: str, at: Optional[int] = None) -> None:
        at = self.i if at is None else at
        line = self.s.count("\n", 0, at) + 1
        raise ValueError(f"{self.name}:{line}: {what} (outside the YAML subset this reader takes)")

    def peek(self, k: int = 0) -> str:
        j = self.i + k
        return self.s[j] if j < len(self.s) else ""

    def col(self) -> int:
        return self.i - (self.s.rfind("\n", 0, self.i) + 1)

    def eof(self) -> bool:
        return self.i >= len(self.s)

    def skip_spaces(self) -> None:
        while self.peek() == " ":
            self.i += 1

    def at_line_end(self) -> bool:
        """After spaces: at a newline, the end, or a comment."""
        self.skip_spaces()
        c = self.peek()
        return c in ("\n", "", "#")

    def end_line(self) -> None:
        """Past the rest of this line, which must be blank or a comment."""
        if not self.at_line_end():
            self.fail(f"unexpected {self.peek()!r}")
        nl = self.s.find("\n", self.i)
        self.i = len(self.s) if nl < 0 else nl + 1

    def next_content(self) -> int:
        """Skip blank and comment lines from a line start; return the next
        line's indentation (-1 at the end), leaving ``i`` at its content."""
        while not self.eof():
            start = self.i
            self.skip_spaces()
            if self.peek() in ("\n", "#", ""):
                nl = self.s.find("\n", self.i)
                self.i = len(self.s) if nl < 0 else nl + 1
                continue
            return self.i - start
        return -1

    def skip_flow_space(self) -> None:
        """Spaces, newlines and comments inside a flow collection."""
        while True:
            c = self.peek()
            if c in (" ", "\n"):
                self.i += 1
            elif c == "#" and (self.i == 0 or self.s[self.i - 1] in " \n"):
                nl = self.s.find("\n", self.i)
                self.i = len(self.s) if nl < 0 else nl
            else:
                return

    # -- documents and block nodes ---------------------------------------------
    def document(self) -> Any:
        if self.s.lstrip().startswith("%") or re.search(r"^(---|\.\.\.)(\s|$)", self.s, re.M):
            self.fail("a directive or document marker", self.s.find("-"))
        ind = self.next_content()
        if ind < 0:
            return None
        node = self.block_node(ind)
        if self.next_content() >= 0:
            self.fail("content after the document's root node")
        return node

    def is_key(self) -> bool:
        """Whether the content at ``i`` is ``key:`` (plain or quoted key)."""
        j = self.i
        c = self.peek()
        if c in ('"', "'"):
            end = self.s.find(c, j + 1)
            while c == "'" and end >= 0 and self.s[end + 1: end + 2] == "'":
                end = self.s.find(c, end + 2)
            if end < 0:
                return False
            k = end + 1
            while k < len(self.s) and self.s[k] == " ":
                k += 1
            return self.s[k: k + 1] == ":"
        if c in "[{&*!|>%@`" or (c in "-?" and self.peek(1) in (" ", "\n", "")):
            return False
        line_end = self.s.find("\n", j)
        line = self.s[j: len(self.s) if line_end < 0 else line_end]
        m = re.search(r"(?<=\s)#", line)
        if m:
            line = line[: m.start()]
        return re.search(r":(\s|$)", line) is not None

    def block_node(self, ind: int) -> Any:
        """The node whose first line's content is at ``i`` (column ``ind``)."""
        if self.peek() == "-" and self.peek(1) in (" ", "\n", ""):
            return self.block_seq(ind)
        if self.is_key():
            return self.block_map(ind)
        node = self.inline(flow=False)
        self.end_line()
        return node

    def block_value(self, ind: int, seq_at_same: bool) -> Any:
        """The value of a key or item whose line ended after the indicator:
        a more indented block node (or a sequence at the key's column)."""
        nxt = self.next_content()
        if nxt > ind or (seq_at_same and nxt == ind and self.peek() == "-"
                         and self.peek(1) in (" ", "\n", "")):
            return self.block_node(nxt)
        # an empty value: back to the start of that line
        if nxt >= 0:
            self.i -= nxt
        return None

    def block_map(self, ind: int) -> Dict[Any, Any]:
        out: Dict[Any, Any] = {}
        while True:
            key = self.scalar_key()
            self.skip_spaces()
            if self.peek() != ":":
                self.fail("a mapping key without ':'")
            self.i += 1
            anchor = self.anchor()
            if self.at_line_end():
                self.end_line()
                value = self.block_value(ind, seq_at_same=True)
            else:
                value = self.inline(flow=False)
                self.end_line()
            if anchor:
                self.anchors[anchor] = value
            out[key] = value
            nxt = self.next_content()
            if nxt < 0 or nxt < ind:
                if nxt >= 0:
                    self.i -= nxt
                return out
            if nxt > ind:
                self.fail("unexpected indentation")
            if not self.is_key():
                if self.peek() == "-":  # a sequence at the parent's column ends the map
                    self.i -= nxt
                    return out
                self.fail("a line that is not 'key: value' inside a mapping")

    def block_seq(self, ind: int) -> List[Any]:
        out: List[Any] = []
        while True:
            self.i += 1  # the '-'
            anchor = self.anchor()
            if self.at_line_end():
                self.end_line()
                item = self.block_value(ind, seq_at_same=False)
            else:
                self.skip_spaces()
                c = self.col()
                if self.peek() == "-" and self.peek(1) in (" ", "\n", ""):
                    item = self.block_seq(c)
                elif self.is_key():
                    item = self.block_map(c)
                else:
                    item = self.inline(flow=False)
                    self.end_line()
            if anchor:
                self.anchors[anchor] = item
            out.append(item)
            nxt = self.next_content()
            if nxt < 0 or nxt < ind or (nxt == ind and self.peek() != "-"):
                if nxt >= 0:
                    self.i -= nxt
                return out
            if nxt > ind:
                self.fail("unexpected indentation")
            if self.peek(1) not in (" ", "\n", ""):
                self.fail("a plain scalar starting with '-' inside a sequence")

    # -- inline nodes ------------------------------------------------------------
    def anchor(self) -> Optional[str]:
        self.skip_spaces()
        if self.peek() != "&":
            return None
        m = re.compile(r"&([^\s,\[\]{}]+)").match(self.s, self.i)
        self.i = m.end()
        return m.group(1)

    def scalar_key(self) -> Any:
        c = self.peek()
        if c in ('"', "'"):
            return self.quoted()
        m = re.compile(r"(.*?)(?=:(\s|$)| #)").match(self.s, self.i)
        if not m:
            self.fail("a mapping key")
        self.i = m.end()
        return self.resolve(m.group(1).strip(), m.start())

    def inline(self, flow: bool) -> Any:
        """A flow collection, alias, quoted or plain scalar starting at ``i``."""
        if flow:
            self.skip_flow_space()
        else:
            self.skip_spaces()
        anchor = self.anchor()
        if anchor:
            self.skip_flow_space() if flow else self.skip_spaces()
        c = self.peek()
        if c == "[":
            node = self.flow_seq()
        elif c == "{":
            node = self.flow_map()
        elif c == "*":
            m = re.compile(r"\*([^\s,\[\]{}]+)").match(self.s, self.i)
            if m.group(1) not in self.anchors:
                self.fail(f"the alias *{m.group(1)} names no anchor")
            self.i = m.end()
            return self.anchors[m.group(1)]
        elif c in ('"', "'"):
            node = self.quoted()
        elif c in "!|>%@`" or (c in "?-" and self.peek(1) in (" ", "\n", "")):
            self.fail(f"the indicator {c!r}")
        else:
            node = self.plain(flow)
        if anchor:
            self.anchors[anchor] = node
        return node

    def plain(self, flow: bool) -> Any:
        start = self.i
        while not self.eof():
            c = self.peek()
            if c == "\n":
                break
            if c == "#" and self.s[self.i - 1] == " ":
                break
            if c == ":" and (self.peek(1) in (" ", "\n", "") or (flow and self.peek(1) in _FLOW_END)):
                if not flow:
                    self.fail("a nested mapping on the line of a value")
                break
            if flow and c in _FLOW_END:
                break
            self.i += 1
        return self.resolve(self.s[start: self.i].strip(), start)

    def resolve(self, text: str, at: int) -> Any:
        try:
            return resolve_scalar(text)
        except ValueError as e:
            self.fail(str(e), at)

    def quoted(self) -> str:
        q = self.peek()
        self.i += 1
        out = []
        while True:
            c = self.peek()
            if c == "":
                self.fail("an unterminated quoted scalar")
            if c == "\n":
                self.fail("a quoted scalar across lines")
            if q == "'":
                if c == "'":
                    if self.peek(1) == "'":
                        out.append("'")
                        self.i += 2
                        continue
                    self.i += 1
                    return "".join(out)
                out.append(c)
                self.i += 1
                continue
            if c == '"':
                self.i += 1
                return "".join(out)
            if c == "\\":
                e = self.peek(1)
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    self.i += 2
                elif e in "xuU":
                    n = {"x": 2, "u": 4, "U": 8}[e]
                    out.append(chr(int(self.s[self.i + 2: self.i + 2 + n], 16)))
                    self.i += 2 + n
                else:
                    self.fail(f"the escape \\{e}")
                continue
            out.append(c)
            self.i += 1

    def flow_seq(self) -> List[Any]:
        self.i += 1
        out: List[Any] = []
        while True:
            self.skip_flow_space()
            if self.peek() == "]":
                self.i += 1
                return out
            item = self.inline(flow=True)
            self.skip_flow_space()
            if self.peek() == ":":
                self.fail("a single-pair mapping inside a flow sequence")
            out.append(item)
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "]":
                self.fail("a flow sequence without ',' or ']'")

    def flow_map(self) -> Dict[Any, Any]:
        self.i += 1
        out: Dict[Any, Any] = {}
        while True:
            self.skip_flow_space()
            if self.peek() == "}":
                self.i += 1
                return out
            key = self.quoted() if self.peek() in ('"', "'") else self.plain(flow=True)
            self.skip_flow_space()
            value = None
            if self.peek() == ":":
                self.i += 1
                self.skip_flow_space()
                if self.peek() not in (",", "}"):
                    value = self.inline(flow=True)
                    self.skip_flow_space()
            out[key] = value
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "}":
                self.fail("a flow mapping without ',' or '}'")


def parse_yaml(text: str, name: str = "<string>") -> Any:
    """The document ``text`` holds, as ``yaml.safe_load`` gives it (the
    subset in the module docstring; anything else raises)."""
    return _YamlParser(text, name).document()


def load_yaml(path: Union[str, Path]) -> Dict[str, Any]:
    text = Path(path).read_text(encoding="utf-8")
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    return parse_yaml(text, str(path))


def increment_path(path: Union[str, Path], exist_ok: bool = False, sep: str = "") -> str:
    """Auto-increment a run path: runs/exp -> runs/exp{sep}2, exp3, ..."""
    path = Path(path)
    if (path.exists() and exist_ok) or (not path.exists()):
        return str(path)
    dirs = glob.glob(f"{path}{sep}*")
    matches = [re.search(rf"%s{sep}(\d+)" % re.escape(path.stem), d) for d in dirs]
    i = [int(m.groups()[0]) for m in matches if m]
    n = max(i) + 1 if i else 2
    return f"{path}{sep}{n}"


def make_run_dir(root: Union[str, Path], mode: str = "train") -> Path:
    """Create an auto-incremented run dir ``{root}/{mode}/{DATE}_runs{N}``."""
    date = datetime.datetime.now().strftime("%Y_%m%d")
    path = Path(increment_path(Path(root) / mode / f"{date}_runs"))
    path.mkdir(parents=True, exist_ok=True)
    return path


def snapshot_configs(run_dir: Union[str, Path], merged: Dict[str, Any],
                     files: Optional[Dict[str, Union[str, Path]]] = None) -> None:
    """Write the merged config as ``args.json`` and copies of the input files."""
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    (run_dir / "args.json").write_text(json.dumps(merged, indent=2, default=str))
    for name, src in (files or {}).items():
        src = Path(src)
        if src.exists():
            shutil.copy(src, run_dir / f"{name}{src.suffix}")
