"""The port's own YAML reader (``svt_speechbrain_tpu_torch/config.py``,
``_Reader``) against PyYAML: every yaml file of both packages' recipes, of
the port's interface exports and of the test fixtures read unresolved by
both, structures and types equal; the override strings the
command line builds; PyYAML's YAML 1.1 scalar rules; each construct the
reader does not read raising ``LoadError`` with its line; and
``load_hyperyaml`` on a recipe yaml resolving as the PyYAML-based reader of
the JAX package does."""
import datetime
import glob
import math
import os

import pytest
import yaml

from svt_speechbrain_tpu import config as jconfig

from svt_speechbrain_tpu_torch import config
from svt_speechbrain_tpu_torch.core import parse_arguments
from tests.conftest import REPO_ROOT

YAMLS = sorted(
    glob.glob(os.path.join(REPO_ROOT, "recipes", "**", "*.yaml"),
              recursive=True)
    + glob.glob(os.path.join(REPO_ROOT, "svt_speechbrain_tpu_torch",
                             "recipes", "**", "*.yaml"), recursive=True)
    + glob.glob(os.path.join(REPO_ROOT, "svt_speechbrain_tpu_torch",
                             "pretrained", "hparams", "*.yaml"))
    + glob.glob(os.path.join(REPO_ROOT, "tests", "fixtures", "*.yaml")))


def _plain(node):
    """Either reader's unresolved structure with its tag objects as tuples,
    so that the JAX package's classes and the port's compare."""
    name = type(node).__name__
    if name == "_Ref":
        return ("ref", node.expr)
    if name == "_Placeholder":
        return ("placeholder",)
    if name == "_Tagged":
        return ("tagged", node.kind, node.path, _plain(node.args))
    if isinstance(node, dict):
        return {_plain(k): _plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_plain(v) for v in node)
    return node


def _typed(node):
    """``node`` with every scalar paired with its type, so that 1 and 1.0
    and True differ."""
    if isinstance(node, dict):
        return {_typed(k): _typed(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_typed(v) for v in node)
    if isinstance(node, float) and math.isnan(node):
        return ("nan",)
    return (type(node).__name__, node)


def _pyyaml(text):
    return yaml.load(text, Loader=jconfig._make_loader())


def _port(text):
    return config._Reader(text).read()


def _same(text):
    """Both readers give the same typed structure, or both refuse."""
    try:
        theirs = _typed(_plain(_pyyaml(text)))
    except yaml.YAMLError:
        with pytest.raises(config.LoadError):
            _port(text)
        return None
    ours = _typed(_plain(_port(text)))
    assert ours == theirs
    return ours


def test_there_are_fourteen_recipe_yamls():
    assert len([p for p in YAMLS if "recipes" in p]) == 14


@pytest.mark.parametrize("path", YAMLS,
                         ids=[os.path.relpath(p, REPO_ROOT) for p in YAMLS])
def test_recipe_yaml_reads_as_pyyaml(path):
    with open(path) as f:
        text = f.read()
    _same(text)
    raw = config.load_hyperyaml(text, resolve=False)
    assert _typed(_plain(raw)) == _typed(_plain(
        jconfig.load_hyperyaml(text, resolve=False)))


SCALARS = [
    "1e-5", "1.0e-5", "1.0E+5", "-1.5", "+.5", ".5", "1.", "1_000.5",
    "6.8523015e+5", "190:20:30.15", ".inf", "-.Inf", "+.INF", ".nan", ".NaN",
    "0", "-0", "+12", "010", "08", "0o17", "0x1F", "-0x_1f", "0b1011",
    "1_000", "190:20:30", "12:61", "yes", "Yes", "YES", "no", "on", "OFF",
    "true", "False", "TRUE", "y", "n", "~", "null", "Null", "NULL", "nul",
    "2001-12-14", "2001-12-14t21:59:43.10-05:00",
    "2001-12-14 21:59:43.10 Z", "2001-12-15T02:59:43.1Z", "2001-1-1",
    "abc", "a b  c", "a#b", "http://x.org/a?b=c", "<lr> * 2", "-", "-x",
    ":x", "a:b", "x'y", '"a b"', "'a b'", "'it''s'", r'"tab\there"',
    r'"\x41\u00e9\U0001F600\\\"\/\0"', '""', "''", "[]", "{}",
]


@pytest.mark.parametrize("scalar", SCALARS)
def test_scalars_resolve_as_yaml_1_1(scalar):
    got = _same(f"key: {scalar}\n")
    listed = _same(f"- {scalar}\n")
    if got is not None:
        assert listed == [got[("str", "key")]]


def test_scalar_types():
    hp = _port("a: 1e-5\nb: 1.0e-5\nc: yes\nd: ~\ne: .inf\nf: 0x1F\n"
               "g: 1_000\nh: 2001-12-14\ni: 010\n")
    assert hp == {"a": "1e-5", "b": 1e-5, "c": True, "d": None,
                  "e": math.inf, "f": 31, "g": 1000,
                  "h": datetime.date(2001, 12, 14), "i": 8}


STRUCTURES = [
    "a:\n- 1\n- 2\nb: 3\n",
    "a:\n  - 1\n  - [2, 3]\n",
    "- a: 1\n  b: 2\n- c\n- - x\n  - y\n-\n- d: 4\n",
    "a:\n  b:\n    c: 1\n  d: 2\ne:\n",
    "a: b # c\nd: e#f   # g\n# whole line\n\n  # indented comment\nh: i\n",
    '"quoted key": 1\n\'single\': 2\n1: int key\n~: null key\n',
    "a: [1, 'x', {b: 2}, [c, d], ]\n",
    'a: {"x": 1, y: [2,3], z: , w}\n',
    "a: {x: 1} # comment\n",
    "--- # one document\na: 1\n",
    "top scalar\n",
    "[a, b]\n",
    "a: !ref <b>\nb: !ref <c>/<d>\nc: !PLACEHOLDER # a note\nd: !tuple (1, 2)\n",
    "f: !new:pkg.mod.Cls\n   x: 1\n   y: !ref <z>\n"
    "g: !name:pkg.mod.fn\nh: !apply:pkg.mod.fn [1, 2]\n"
    "i: !new:pkg.mod.Cls {alpha: 0.5, nhead: 4}\nj: !new:pkg.mod.Cls 5\n"
    "k: !new:pkg.mod.Cls\n   - 1\n   - !ref <z>\nl: !new:pkg.mod.Cls ''\n",
    "m:\n   - !ref <a>/x.csv\n   - !ref <a>/y.csv\nn:\n- !new:pkg.A\n"
    "  - !name:pkg.B\n",
    "o: !new:pkg.A\n   args: {a: !ref <b>, c: [!ref <d>, e]}\n",
]


@pytest.mark.parametrize("text", STRUCTURES)
def test_structures_read_as_pyyaml(text):
    _same(text)


def test_command_line_overrides_read_as_pyyaml():
    argv = ["recipe.yaml", "--device", "cpu", "--data_folder=/data/set",
            "--test_csv=[/d/a.csv, /d/b.csv]", "--number_of_epochs=2",
            "--lr", "1.0e-5", "--sorting=random",
            "--wav2vec2=!new:svt_speechbrain_tpu_torch.models.wav2vec2."
            'HuggingFaceWav2Vec2 {source: tiny-test, arch_overrides: '
            '{"num_layers": 2, "hidden_size": 32, "do_stable": true}}',
            "--fusion", "!new:pkg.FusionRCA", "{alpha: 0.5, nhead: 4}",
            "--pretrain=False"]
    _, run_opts, overrides = parse_arguments(argv)
    assert run_opts["device"] == "cpu"
    got = _same(overrides)
    assert len(got) == 8
    assert config._Reader(overrides).read()["lr"] == 1e-5


REFUSED = [
    ("a: &x 1\nb: *x\n", 1, "anchors"),
    ("a: 1\nb: *x\n", 2, "anchors"),
    ("a: |\n  text\n", 1, "block scalars"),
    ("a: >\n  text\n", 1, "block scalars"),
    ("a: 1\n---\nb: 2\n", 2, "one document"),
    ("a: 1\n...\n", 2, "one document"),
    ("%YAML 1.1\n---\na: 1\n", 1, "directives"),
    ("a: [1,\n  2]\n", 1, "across lines"),
    ("a: {b: 1,\n  c: 2}\n", 1, "across lines"),
    ("a: 'one\n  two'\n", 1, "across lines"),
    ("a: one\n  two\n", 2, "next line"),
    ("a: b: c\n", 1, "': '"),
    ("? a\n: b\n", 1, "complex keys"),
    ("<<: {a: 1}\n", 1, "merge"),
    ("a: !!str 5\n", 1, "not read"),
    ("a: !foo x\n", 1, "not read"),
    ("a: !tuple (1, !ref <b>)\n", 1, "inside a tagged scalar"),
    ("a:\n\tb: 1\n", 2, "tab"),
    ("a: 1\n  b: 2\n", 2, "next line"),
    ("a:\n    b: 1\n  c: 2\n", 3, "indentation"),
    ("a: [x: 1]\n", 1, "mapping inside a flow sequence"),
    ('a: "bad \\q escape"\n', 1, "escape"),
    ("a: !ref\n  - x\n", 2, "takes a scalar"),
]


@pytest.mark.parametrize("text,line,words", REFUSED)
def test_unread_constructs_raise_with_their_line(text, line, words):
    with pytest.raises(config.LoadError, match=f"line {line}: .*{words}"):
        config._Reader(text).read()


def test_load_hyperyaml_resolves_a_recipe_yaml_as_before(tmp_path):
    """The MIR-ST500 yaml of each package, resolved with overrides by its
    own package; the port's values equal the JAX ones' wherever both are
    plain values (the objects differ by package)."""
    rel = os.path.join("MIR_ST500", "hparams", "train_audio_ssl.yaml")
    overrides = (f"data_folder: {tmp_path}\nlr: 1.0e-3\n"
                 f"test_csv: [{tmp_path}/a.csv]\n")
    with open(os.path.join(REPO_ROOT, "recipes", rel)) as f:
        theirs = jconfig.load_hyperyaml(f, overrides)
    with open(os.path.join(REPO_ROOT, "svt_speechbrain_tpu_torch", "recipes",
                           rel)) as f:
        ours = config.load_hyperyaml(f, overrides)
    plain = (str, int, float, bool, type(None))
    compared = 0
    for key, value in theirs.items():
        if isinstance(value, plain) or (
                isinstance(value, (list, dict)) and all(
                    isinstance(v, plain) for v in (
                        value.values() if isinstance(value, dict)
                        else value))):
            assert _typed(ours[key]) == _typed(value), key
            compared += 1
    assert compared > 30
    assert ours["lr"] == 1e-3 and ours["test_csv"] == [f"{tmp_path}/a.csv"]
    assert type(ours["epoch_counter"]).__module__.startswith(
        "svt_speechbrain_tpu_torch")
    assert ours["modules"]["model"] is ours["model"]
