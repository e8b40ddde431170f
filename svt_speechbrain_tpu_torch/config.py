"""Experiment configuration: a small YAML-with-references loader (a copy of
``svt_speechbrain_tpu/config.py``; tags resolve against any importable
module, so the port's yaml files name the port's classes).

Reproduces the HyperPyYAML contract the reference's recipes rely on
(SURVEY.md §5.6; e.g. ``MIR_ST500/hparams/train_audio_ssl.yaml``):

- ``!ref <key>``            — reference another top-level key; ``<key>``
  tokens inside strings interpolate; pure-arithmetic results are evaluated
  (``!ref <lr> * 2``);
- ``!new:module.Class``     — instantiate with mapping/sequence arguments;
- ``!name:module.func``     — ``functools.partial`` factory;
- ``!apply:module.func``    — call at load time (e.g. seeding);
- ``!PLACEHOLDER``          — must be overridden (e.g. ``data_folder``);
- ``!tuple (a, b)``         — literal tuple.

``load_hyperyaml(stream, overrides)`` returns a dict of resolved values /
live objects. Overrides are a dict or YAML string merged before resolution —
the CLI layer (``core.parse_arguments``) converts ``--key value`` leftovers.

The file is read by this module's own reader (``_Reader``), never by PyYAML,
so that it reads the same on a machine without PyYAML: it gives the
structures PyYAML's ``SafeLoader`` gives for the YAML the repository's files
and command lines use, and raises ``LoadError`` with the line number for any
construct it does not read (anchors, block scalars, multi-line scalars, more
than one document, ...).
"""
from __future__ import annotations

import ast
import datetime
import functools
import importlib
import math
import re


class _Ref:
    def __init__(self, expr):
        self.expr = expr


class _Tagged:
    def __init__(self, kind, path, args):
        self.kind = kind  # "new" | "name" | "apply"
        self.path = path
        self.args = args  # mapping dict, sequence list, or None


class _Placeholder:
    pass


class LoadError(ValueError):
    pass


# ------------------------------------------------------------------ reader
# PyYAML's YAML 1.1 implicit resolvers (``yaml/resolver.py``), tried in its
# order among those listed for the scalar's first character.
_RESOLVERS = (
    ("bool", re.compile(r"""^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$""", re.X), "yYnNtTfFoO"),
    ("float", re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X), "-+0123456789."),
    ("int", re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X),
     "-+0123456789"),
    ("merge", re.compile(r"^(?:<<)$"), "<"),
    ("null", re.compile(r"^(?:~|null|Null|NULL)$"), "~nN"),
    ("timestamp", re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                             re.X), "0123456789"),
    ("value", re.compile(r"^(?:=)$"), "="),
)
_TIMESTAMP_PARTS = re.compile(
    r"""^(?P<year>[0-9][0-9][0-9][0-9])
        -(?P<month>[0-9][0-9]?)
        -(?P<day>[0-9][0-9]?)
        (?:(?:[Tt]|[ \t]+)
        (?P<hour>[0-9][0-9]?)
        :(?P<minute>[0-9][0-9])
        :(?P<second>[0-9][0-9])
        (?:\.(?P<fraction>[0-9]*))?
        (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)
        (?::(?P<tz_minute>[0-9][0-9]))?))?)?$""", re.X)
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\x09", "\t": "\x09",
            "n": "\x0a", "v": "\x0b", "f": "\x0c", "r": "\x0d", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(value, cast):
    total = cast(0)
    for part in value.split(":"):
        total = total * 60 + cast(part)
    return total


def _yaml_int(value):
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    value = value[1:] if value[0] in "+-" else value
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _yaml_float(value):
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    value = value[1:] if value[0] in "+-" else value
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def _yaml_timestamp(value):
    parts = _TIMESTAMP_PARTS.match(value).groupdict()
    year, month, day = (int(parts[k]) for k in ("year", "month", "day"))
    if not parts["hour"]:
        return datetime.date(year, month, day)
    fraction = int((parts["fraction"] or "")[:6].ljust(6, "0"))
    tzinfo = None
    if parts["tz_sign"]:
        delta = datetime.timedelta(hours=int(parts["tz_hour"]),
                                   minutes=int(parts["tz_minute"] or 0))
        tzinfo = datetime.timezone(-delta if parts["tz_sign"] == "-"
                                   else delta)
    elif parts["tz"]:
        tzinfo = datetime.timezone.utc
    return datetime.datetime(year, month, day, int(parts["hour"]),
                             int(parts["minute"]), int(parts["second"]),
                             fraction, tzinfo=tzinfo)


_CONSTRUCTORS = {
    "bool": lambda v: v.lower() in ("yes", "true", "on"),
    "float": _yaml_float, "int": _yaml_int, "null": lambda v: None,
    "timestamp": _yaml_timestamp}


class _Node:
    """A parsed node: ``kind`` "scalar" (``value`` the text, ``plain``
    whether unquoted), "seq" (a list of nodes) or "map" (a list of node
    pairs); ``tag`` the tag written before it, or None."""

    __slots__ = ("kind", "value", "line", "plain", "tag")

    def __init__(self, kind, value, line, plain=True):
        self.kind, self.value, self.line = kind, value, line
        self.plain, self.tag = plain, None


def _is_item(content):
    return content == "-" or content.startswith(("- ", "-\t"))


class _Reader:
    """A reader for the YAML the repository's files and command lines
    use, resolving scalars as PyYAML's ``SafeLoader`` (YAML 1.1) does:
    block mappings and sequences (also a sequence at its key's
    indentation), flow sequences and mappings on one line, plain,
    single- and double-quoted scalars on one line, comments, and the
    tags ``!ref``, ``!new:``, ``!name:``, ``!apply:``, ``!PLACEHOLDER``
    and ``!tuple``. Anchors, aliases, block scalars (``|``, ``>``), scalars
    or flow collections across lines, complex keys, merge keys, other
    tags, directives and more than one document raise ``LoadError`` with
    the line number."""

    def __init__(self, text, custom_tags=True):
        self.custom_tags = custom_tags
        self.lines = []
        for lineno, raw in enumerate(text.splitlines(), 1):
            body = raw.lstrip(" ")
            if not body.strip() or body.lstrip().startswith("#"):
                continue
            if body[0] == "\t":
                raise LoadError(f"line {lineno}: a tab in the indentation")
            indent = len(raw) - len(body)
            if indent == 0 and body[:3] in ("---", "...") and \
                    body[3:4] in ("", " ", "\t"):
                if self.lines or body[:3] == "..." or \
                        body[3:].strip() and \
                        not body[3:].strip().startswith("#"):
                    raise LoadError(f"line {lineno}: only one document, "
                                    f"starting at most with a bare '---', "
                                    f"is read")
                continue
            if indent == 0 and body[0] == "%":
                raise LoadError(f"line {lineno}: directives are not read")
            self.lines.append([lineno, indent, body.rstrip()])
        self.pos = 0

    def error(self, line, message):
        raise LoadError(f"line {line}: {message}")

    # ------------------------------------------------------------ blocks
    def read(self):
        if not self.lines:
            return None
        node = self.block(self.lines[0][1])
        if self.pos < len(self.lines):
            self.error(self.lines[self.pos][0],
                       "unexpected indentation or content")
        return self.construct(node)

    def block(self, indent):
        """The node whose first line is the next line, at ``indent``."""
        lineno, _, content = self.lines[self.pos]
        if _is_item(content):
            return self.sequence(indent)
        if self.split_key(content, lineno) is not None:
            return self.mapping(indent)
        self.pos += 1
        return self.value(content, lineno, indent, False)

    def sequence(self, indent):
        items = []
        line = self.lines[self.pos][0]
        while self.pos < len(self.lines):
            lineno, ind, content = self.lines[self.pos]
            if ind != indent or not _is_item(content):
                break
            body = content[1:].lstrip(" \t")
            if body and not body.startswith("#") and (
                    _is_item(body) or self.split_key(body, lineno)):
                # "- key: value" or "- - x": the item is a block node
                # starting at the column after the dash
                inner = indent + len(content) - len(body)
                self.lines[self.pos] = [lineno, inner, body]
                items.append(self.block(inner))
            else:
                self.pos += 1
                items.append(self.value(content[1:], lineno, indent, False))
        return _Node("seq", items, line)

    def mapping(self, indent):
        pairs = []
        line = self.lines[self.pos][0]
        while self.pos < len(self.lines):
            lineno, ind, content = self.lines[self.pos]
            if ind < indent or (ind == indent and _is_item(content)):
                break
            if ind > indent:
                self.error(lineno, "unexpected indentation")
            split = self.split_key(content, lineno)
            if split is None:
                self.error(lineno, "expected 'key: value'")
            key, rest = split
            self.pos += 1
            pairs.append((key, self.value(rest, lineno, indent, True)))
        return _Node("map", pairs, line)

    def value(self, text, lineno, indent, indentless):
        """The node after ``key:`` or ``-`` (``text``, the rest of the
        line): a tag, then a scalar or flow collection on this line, or a
        block node on the lines below (at ``indent`` too when ``indentless``
        and it is a sequence)."""
        scan = _Scan(self, text, lineno, flow=False)
        tag = scan.tag()
        if scan.at_end():
            nxt = self.lines[self.pos] if self.pos < len(self.lines) else None
            if nxt is not None and (nxt[1] > indent or (
                    indentless and nxt[1] == indent and _is_item(nxt[2]))):
                node = self.block(nxt[1])
            else:
                node = _Node("scalar", "", lineno)
        else:
            node = scan.node()
            if not scan.at_end():
                self.error(lineno, f"unexpected text {scan.rest()!r}")
            if self.pos < len(self.lines) and self.lines[self.pos][1] > indent:
                self.error(self.lines[self.pos][0],
                           "a value continued on the next line is not read")
        if tag is not None:
            if node.tag is not None:
                self.error(lineno, "two tags on one node")
            node.tag = tag
        return node

    def split_key(self, content, lineno):
        """(key node, rest) when ``content`` is a block mapping's
        ``key: value`` line, else None."""
        first = content[0]
        if first == "?" and content[1:2] in ("", " ", "\t"):
            self.error(lineno, "complex keys ('? ') are not read")
        if first in "\"'":
            scan = _Scan(self, content, lineno, flow=False)
            key = scan.quoted()
            scan.spaces()
            if scan.peek() == ":" and scan.peek(1) in ("", " ", "\t"):
                return key, scan.text[scan.i + 1:]
            return None
        if first in "[{!&*|>%@`#":
            return None
        i = 0
        while True:
            i = content.find(":", i)
            if i < 0:
                return None
            hash_at = content.find(" #")
            if 0 <= hash_at < i:
                return None
            if content[i + 1:i + 2] in ("", " ", "\t"):
                return (_Node("scalar", content[:i].rstrip(), lineno),
                        content[i + 1:])
            i += 1

    # ------------------------------------------------------ construction
    def construct(self, node):
        if node.tag is not None:
            return self.construct_tagged(node)
        if node.kind == "map":
            out = {}
            for key_node, value_node in node.value:
                key = self.construct(key_node)
                if isinstance(key, (dict, list)):
                    self.error(key_node.line, "a key that is a collection")
                out[key] = self.construct(value_node)
            return out
        if node.kind == "seq":
            return [self.construct(item) for item in node.value]
        if not node.plain:
            return node.value
        value = node.value
        if value == "":
            return None
        for kind, regex, first in _RESOLVERS:
            if value[0] in first and regex.match(value):
                if kind not in _CONSTRUCTORS:
                    self.error(node.line, f"the {kind} key {value!r} is not "
                                          f"read")
                return _CONSTRUCTORS[kind](value)
        return value

    def construct_tagged(self, node):
        tag = node.tag
        if not self.custom_tags:
            self.error(node.line, f"tag {tag} inside a tagged scalar")
        if tag == "!PLACEHOLDER":
            return _Placeholder()
        if tag in ("!ref", "!tuple"):
            if node.kind != "scalar":
                self.error(node.line, f"{tag} takes a scalar")
            if tag == "!ref":
                return _Ref(node.value)
            return tuple(_Reader(node.value.replace("(", "[").replace(
                ")", "]"), custom_tags=False).read())
        for kind in ("new", "name", "apply"):
            if tag.startswith(f"!{kind}:"):
                if node.kind == "scalar":
                    args = None if node.value == "" else [
                        _Reader(node.value, custom_tags=False).read()]
                else:
                    node.tag = None
                    args = self.construct(node)
                return _Tagged(kind, tag[len(kind) + 2:], args)
        self.error(node.line, f"tag {tag} is not read")


class _Scan:
    """One line's inline text: tags, scalars, flow collections."""

    def __init__(self, reader, text, line, flow):
        self.reader, self.text, self.line = reader, text, line
        self.i, self.flow = 0, flow

    def error(self, message):
        self.reader.error(self.line, message)

    def peek(self, k=0):
        return self.text[self.i + k:self.i + k + 1]

    def rest(self):
        return self.text[self.i:]

    def spaces(self):
        while self.peek() in (" ", "\t") and self.peek():
            self.i += 1

    def at_end(self):
        """Skip spaces; True at the end of the text or at a comment."""
        start = self.i
        self.spaces()
        return self.peek() == "" or (
            self.peek() == "#" and (self.i > start or self.i == 0))

    def tag(self):
        self.spaces()
        if self.peek() != "!":
            return None
        start = self.i
        while self.peek() not in ("", " ", "\t"):
            self.i += 1
        return self.text[start:self.i]

    def node(self):
        """A scalar, quoted scalar or flow collection at the cursor."""
        self.spaces()
        ch, nxt = self.peek(), self.peek(1)
        if ch == "[":
            return self.flow_seq()
        if ch == "{":
            return self.flow_map()
        if ch in "\"'":
            return self.quoted()
        if ch in "&*":
            self.error("anchors and aliases are not read")
        if ch in "|>":
            self.error("block scalars ('|', '>') are not read")
        if ch == "!":
            self.error("two tags on one node")
        if ch in "%@`" or (ch in ",]}" and self.flow) or ch == "#" or (
                ch in "-?:" and nxt in ("", " ", "\t") + (
                    tuple(",[]{}") if self.flow else ())):
            self.error(f"a plain scalar cannot start with {ch!r}")
        return self.plain()

    def plain(self):
        start, end = self.i, self.i
        stops = ",?[]{}" if self.flow else ""
        while True:
            ch = self.peek()
            if ch == "" or ch in stops:
                break
            if ch in " \t":
                self.spaces()
                if self.peek() in ("", "#"):
                    break
                continue
            if ch == ":" and self.peek(1) in ("", " ", "\t") + (
                    tuple(",[]{}") if self.flow else ()):
                if not self.flow:
                    self.error("a ': ' inside a value (a mapping on one "
                               "line) is not read")
                break
            self.i += 1
            end = self.i
        self.i = end
        return _Node("scalar", self.text[start:end], self.line)

    def quoted(self):
        quote = self.peek()
        self.i += 1
        out = []
        while True:
            ch = self.peek()
            if ch == "":
                self.error("a quoted scalar across lines is not read")
            self.i += 1
            if ch == quote:
                if quote == "'" and self.peek() == "'":
                    out.append("'")
                    self.i += 1
                    continue
                return _Node("scalar", "".join(out), self.line, plain=False)
            if ch == "\\" and quote == '"':
                code = self.peek()
                self.i += 1
                if code in _ESCAPES:
                    out.append(_ESCAPES[code])
                elif code in _HEX_ESCAPES:
                    digits = self.text[self.i:self.i + _HEX_ESCAPES[code]]
                    if len(digits) != _HEX_ESCAPES[code] or not all(
                            c in "0123456789abcdefABCDEF" for c in digits):
                        self.error(f"bad escape \\{code}{digits}")
                    out.append(chr(int(digits, 16)))
                    self.i += len(digits)
                else:
                    self.error(f"bad escape \\{code}")
                continue
            out.append(ch)

    def flow_node(self):
        tag = self.tag()
        self.spaces()
        if tag is not None and self.peek() in ("", ",", "]", "}"):
            node = _Node("scalar", "", self.line)
        else:
            node = self.node()
        if tag is not None:
            node.tag = tag
        return node

    def flow_seq(self):
        line, items = self.line, []
        self.i += 1
        outer, self.flow = self.flow, True
        while True:
            if self.at_end():
                self.error("a flow sequence across lines is not read")
            if self.peek() == "]":
                break
            items.append(self.flow_node())
            self.spaces()
            if self.peek() == ":":
                self.error("a mapping inside a flow sequence is not read")
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "]":
                self.error(f"expected ',' or ']' at {self.rest()!r}")
        self.i += 1
        self.flow = outer
        return _Node("seq", items, line)

    def flow_map(self):
        line, pairs = self.line, []
        self.i += 1
        outer, self.flow = self.flow, True
        while True:
            if self.at_end():
                self.error("a flow mapping across lines is not read")
            if self.peek() == "}":
                break
            if self.peek() == "?" and self.peek(1) in (" ", "\t"):
                self.error("complex keys ('? ') are not read")
            key = self.flow_node()
            self.spaces()
            if self.peek() == ":":
                self.i += 1
                self.spaces()
                value = (_Node("scalar", "", self.line)
                         if self.peek() in (",", "}") else self.flow_node())
            else:
                value = _Node("scalar", "", self.line)
            pairs.append((key, value))
            self.spaces()
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "}":
                self.error(f"expected ',' or '}}' at {self.rest()!r}")
        self.i += 1
        self.flow = outer
        return _Node("map", pairs, line)


def _import_obj(path):
    module_name, _, obj_name = path.rpartition(".")
    if not module_name:
        raise LoadError(f"Cannot import bare name {path!r}")
    mod = importlib.import_module(module_name)
    try:
        return getattr(mod, obj_name)
    except AttributeError as e:
        raise LoadError(f"{module_name} has no attribute {obj_name}") from e


_ARITH_RE = re.compile(r"^[\d\s\.\+\-\*/\(\)eE_%]+$")
_TOKEN_RE = re.compile(r"<([^<>]*)>")


class _Resolver:
    def __init__(self, root):
        self.root = root
        self._resolving = set()
        # memoize tagged-node instantiation so `!ref <wav2vec2>` aliases the
        # same live object (the reference's modules blocks depend on this)
        self._instances = {}

    def lookup(self, dotted):
        node = self.root
        for part in dotted.split("."):
            if isinstance(node, dict) and part in node:
                node = node[part]
            else:
                raise LoadError(f"!ref to unknown key: <{dotted}>")
        return self.resolve(node, key=dotted)

    def resolve_ref(self, expr):
        tokens = _TOKEN_RE.findall(expr)
        stripped = expr.strip()
        # whole-expression single token → return the referenced value as-is
        if len(tokens) == 1 and stripped == f"<{tokens[0]}>":
            return self.lookup(tokens[0])
        # substitute tokens into the string
        out = expr
        for tok in tokens:
            val = self.lookup(tok)
            out = out.replace(f"<{tok}>", str(val))
        # arithmetic evaluation when purely numeric
        if tokens and _ARITH_RE.match(out):
            try:
                return _safe_eval(out)
            except Exception:
                pass
        return out

    def resolve(self, node, key=None):
        if isinstance(node, _Ref):
            if key is not None:
                if key in self._resolving:
                    raise LoadError(f"Circular !ref involving <{key}>")
                self._resolving.add(key)
                try:
                    return self.resolve_ref(node.expr)
                finally:
                    self._resolving.discard(key)
            return self.resolve_ref(node.expr)
        if isinstance(node, _Placeholder):
            raise LoadError(
                f"Placeholder for key {key!r} was not overridden "
                "(pass e.g. --{key} VALUE on the command line)")
        if isinstance(node, _Tagged):
            if id(node) in self._instances:
                return self._instances[id(node)]
            obj = _import_obj(node.path)
            args = self.resolve(node.args) if node.args is not None else None
            if node.kind == "name":
                if isinstance(args, dict):
                    result = functools.partial(obj, **args)
                elif isinstance(args, list):
                    result = functools.partial(obj, *args)
                else:
                    result = obj
            else:  # "new" instantiates, "apply" calls at load time
                if isinstance(args, dict):
                    result = obj(**args)
                elif isinstance(args, list):
                    result = obj(*args)
                else:
                    result = obj()
            self._instances[id(node)] = result
            return result
        if isinstance(node, dict):
            return {k: self.resolve(v, key=k if key is None else f"{key}.{k}")
                    for k, v in node.items()}
        if isinstance(node, list):
            return [self.resolve(v) for v in node]
        return node


def _safe_eval(expr):
    tree = ast.parse(expr, mode="eval")
    allowed = (ast.Expression, ast.BinOp, ast.UnaryOp, ast.Constant,
               ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod,
               ast.Pow, ast.USub, ast.UAdd)
    for n in ast.walk(tree):
        if not isinstance(n, allowed):
            raise ValueError(f"Disallowed expression: {expr}")
    return eval(compile(tree, "<config>", "eval"))  # noqa: S307 - AST-filtered


def _merge_overrides(raw, overrides):
    if not overrides:
        return raw
    if isinstance(overrides, str):
        overrides = _Reader(overrides).read() or {}
    for key, value in overrides.items():
        raw[key] = value
    return raw


def load_hyperyaml(stream, overrides=None, resolve=True):
    """Load an experiment YAML with overrides applied before resolution.

    Returns a plain dict; tagged nodes become live objects exactly like
    HyperPyYAML's ``load_hyperpyyaml`` (which the reference calls at every
    recipe entry, e.g. ``MIR_ST500/train_audio_ssl.py:446``).

    Example
    -------
    >>> hp = load_hyperyaml('''
    ... n_out: 40
    ... base_lr: 0.1
    ... lr: !ref <base_lr> * 2
    ... head: !new:svt_speechbrain_tpu_torch.nnet.linear.Linear
    ...     input_size: 8
    ...     n_neurons: !ref <n_out>
    ... ''', overrides={"n_out": 20})
    >>> hp["lr"]
    0.2
    >>> type(hp["head"]).__name__, tuple(hp["head"].w.shape)
    ('Linear', (8, 20))
    """
    if hasattr(stream, "read"):
        stream = stream.read()
    raw = _Reader(stream).read() or {}
    raw = _merge_overrides(raw, overrides)
    if not resolve:
        return raw
    resolver = _Resolver(raw)
    resolved = {}
    for key, value in raw.items():
        # lazily resolved refs see already-overridden raw values
        resolved[key] = resolver.resolve(value, key=key)
    return resolved


# The reference imports this under the hyperpyyaml name; keep an alias.
load_hyperpyyaml = load_hyperyaml


def convert_to_yaml(overrides):
    """Convert ``--arg value`` CLI leftovers to a YAML overrides string
    (reference ``core.py:304-318``)."""
    yaml_string = ""
    joined_args = "=".join(overrides)
    split_args = joined_args.split("=")
    for arg in split_args:
        if arg.startswith("--"):
            yaml_string += "\n" + arg[len("--"):] + ":"
        else:
            yaml_string += " " + arg
    return yaml_string.strip()
