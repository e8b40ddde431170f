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

PyYAML is imported only when a file is loaded, so the engine and the recipes
import without it.
"""
from __future__ import annotations

import ast
import functools
import importlib
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


def _make_loader():
    import yaml

    class Loader(yaml.SafeLoader):
        pass

    def ref_constructor(loader, node):
        return _Ref(loader.construct_scalar(node))

    def placeholder_constructor(loader, node):
        return _Placeholder()

    def tuple_constructor(loader, node):
        value = loader.construct_scalar(node)
        return tuple(yaml.safe_load(value.replace("(", "[").replace(")", "]")))

    def multi(kind):
        def constructor(loader, tag_suffix, node):
            if isinstance(node, yaml.MappingNode):
                args = loader.construct_mapping(node, deep=True)
            elif isinstance(node, yaml.SequenceNode):
                args = loader.construct_sequence(node, deep=True)
            elif isinstance(node, yaml.ScalarNode):
                scalar = loader.construct_scalar(node)
                args = None if scalar in ("", None) else [yaml.safe_load(scalar)]
            else:
                args = None
            return _Tagged(kind, tag_suffix, args)

        return constructor

    Loader.add_constructor("!ref", ref_constructor)
    Loader.add_constructor("!PLACEHOLDER", placeholder_constructor)
    Loader.add_constructor("!tuple", tuple_constructor)
    Loader.add_multi_constructor("!new:", multi("new"))
    Loader.add_multi_constructor("!name:", multi("name"))
    Loader.add_multi_constructor("!apply:", multi("apply"))
    return Loader


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
        import yaml

        overrides = yaml.load(overrides, Loader=_make_loader()) or {}
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
    import yaml

    if hasattr(stream, "read"):
        stream = stream.read()
    raw = yaml.load(stream, Loader=_make_loader()) or {}
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
