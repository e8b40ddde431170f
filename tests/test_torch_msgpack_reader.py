"""The port's own msgpack decoder (``convert_jax._MsgpackReader``, behind
``load_msgpack``) against the ``msgpack`` package and flax: trees written by
the JAX package's ``save_msgpack`` and by flax's ``to_bytes`` (f32, ints,
int8, bool, numpy scalars, nested dicts, an optax state, a bfloat16 leaf),
every leaf bit for bit; the refusals; and the small JAX export in
``tests/fixtures/`` that ``chip_smoke.py`` reads on the card, against its
``.npz``."""
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from svt_speechbrain_tpu.tasks.amt import save_msgpack

from svt_speechbrain_tpu_torch import convert_jax
from tests.conftest import REPO_ROOT

FIXTURE = os.path.join(REPO_ROOT, "tests", "fixtures", "jax_export_small")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(_leaves(value, f"{prefix}{key}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _bits_equal(ours, theirs):
    if isinstance(ours, torch.Tensor):
        assert ours.dtype == torch.bfloat16
        assert str(theirs.dtype) == "bfloat16"
        np.testing.assert_array_equal(
            ours.view(torch.uint16).numpy(),
            np.asarray(theirs).view(np.uint16))
        return
    assert type(ours) is type(theirs)
    if isinstance(ours, (np.ndarray, np.generic)):
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
        assert np.asarray(ours).tobytes() == np.asarray(theirs).tobytes()
    else:
        assert ours == theirs


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "encoder": {"layers": {str(i): {
            "w": rng.standard_normal((8, 4)).astype(np.float32),
            "b": rng.standard_normal(4).astype(np.float32)}
            for i in range(3)}},
        "ints": {"i32": rng.integers(-2**31, 2**31 - 1, 7, dtype=np.int32),
                 "i64": rng.integers(-2**62, 2**62, 3, dtype=np.int64),
                 "u8": rng.integers(0, 255, 5, dtype=np.uint8),
                 "q8": rng.integers(-127, 128, (4, 4), dtype=np.int8)},
        "mask": rng.random(6) > 0.5,
        "f64": rng.standard_normal((2, 3)),
        "f16": rng.standard_normal(5).astype(np.float16),
        "scalars": {"step": np.int32(17), "lr": np.float32(3e-4),
                    "flag": np.bool_(True)},
        "empty": np.zeros((0, 3), np.float32),
        "big": rng.standard_normal(70000).astype(np.float32),
    }


def _flax_read(path):
    with open(path, "rb") as f:
        return serialization.msgpack_restore(f.read())


@pytest.mark.parametrize("seed", [0, 1])
def test_save_msgpack_trees_bit_for_bit(tmp_path, seed):
    path = str(tmp_path / "tree.msgpack")
    save_msgpack(_tree(seed), path)
    ours, theirs = _leaves(convert_jax.load_msgpack(path)), \
        _leaves(_flax_read(path))
    assert sorted(ours) == sorted(theirs)
    for key in ours:
        _bits_equal(ours[key], theirs[key])


def test_msgpack_package_gives_the_same_structure(tmp_path):
    """Without flax's extension hook the ``msgpack`` package yields the
    raw extension payloads; the port's structure has the same keys, and
    each array's bytes are the payload's buffer."""
    path = str(tmp_path / "tree.msgpack")
    save_msgpack(_tree(2), path)
    with open(path, "rb") as f:
        raw = _leaves(msgpack.unpackb(f.read(), raw=False))
    ours = _leaves(convert_jax.load_msgpack(path))
    assert sorted(raw) == sorted(ours)
    for key, ext in raw.items():
        assert ext.code in (1, 3)
        shape, dtype, buf = msgpack.unpackb(ext.data, raw=True)
        assert np.asarray(ours[key]).tobytes() == buf
        assert list(np.shape(ours[key])) == list(shape)


def test_optax_states_bit_for_bit(tmp_path):
    """Adam and Adadelta under ``inject_hyperparams`` (the JAX Brain's two
    recipe optimizers) after two updates, through ``to_bytes``."""
    params = {"w": jnp.arange(12.0).reshape(3, 4), "b": jnp.ones(4)}
    grads = jax.tree_util.tree_map(lambda p: 0.1 * p + 0.01, params)
    for tx in (optax.inject_hyperparams(optax.adam)(learning_rate=1e-3),
               optax.inject_hyperparams(optax.adadelta)(
                   learning_rate=1.0, rho=0.95, eps=1e-8)):
        state = tx.init(params)
        for _ in range(2):
            _, state = tx.update(grads, state, params)
        path = str(tmp_path / "opt.msgpack")
        with open(path, "wb") as f:
            f.write(serialization.to_bytes(state))
        ours, theirs = _leaves(convert_jax.load_msgpack(path)), \
            _leaves(_flax_read(path))
        assert sorted(ours) == sorted(theirs) and len(ours) >= 5
        for key in ours:
            _bits_equal(ours[key], theirs[key])


def test_bfloat16_leaf_is_a_torch_bfloat16_tensor(tmp_path):
    tree = {"w": jnp.asarray(np.linspace(-3, 3, 12).reshape(3, 4),
                             jnp.bfloat16),
            "s": jnp.asarray(1.5, jnp.bfloat16)}
    path = str(tmp_path / "bf16.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(jax.device_get(tree)))
    ours, theirs = convert_jax.load_msgpack(path), _flax_read(path)
    for key in tree:
        _bits_equal(ours[key], theirs[key])
    assert ours["w"].shape == (3, 4) and ours["s"].shape == ()


def test_refusals(tmp_path):
    path = str(tmp_path / "x.msgpack")

    def write(obj):
        with open(path, "wb") as f:
            f.write(obj)

    write(msgpack.packb({"a": msgpack.ExtType(7, b"xx")}))
    with pytest.raises(ValueError, match="extension type 7"):
        convert_jax.load_msgpack(path)
    write(msgpack.packb({"a": {"__msgpack_chunked_array__": True}}))
    with pytest.raises(ValueError, match="chunked"):
        convert_jax.load_msgpack(path)
    write(msgpack.packb({"a": [1, 2, 3]})[:-1])
    with pytest.raises(ValueError, match="ends early"):
        convert_jax.load_msgpack(path)
    write(b"\xc1")
    with pytest.raises(ValueError, match="0xc1"):
        convert_jax.load_msgpack(path)


def test_plain_msgpack_values():
    """Every msgpack type, against the ``msgpack`` package."""
    obj = {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63,
                    -1, -32, -33, -128, -129, -32768, -32769, -2**31 - 1,
                    -2**63],
           "floats": [0.5, -1e300, float("inf")], "none": None,
           "bools": [True, False], "str": ["", "a" * 31, "b" * 32,
                                           "c" * 300, "ü" * 40000],
           "bin": [b"", b"x" * 300, b"y" * 70000],
           "nested": {str(i): {"k": [i] * 17} for i in range(20)},
           "array16": list(range(20)), 3: "int key"}
    data = msgpack.packb(obj, use_bin_type=True)
    assert convert_jax._MsgpackReader(data, "t").read_all() == \
        msgpack.unpackb(data, raw=False, strict_map_key=False)
    f32 = msgpack.packb(1.5, use_single_float=True)
    assert convert_jax._MsgpackReader(f32, "t").read_all() == 1.5


def write_fixture(prefix=FIXTURE):
    """Write ``<prefix>.{msgpack,npz}`` (by default the committed
    ``tests/fixtures/jax_export_small``): a small JAX
    export (a 2-layer head and an int8 matrix with its scales, as the
    JAX package's ``save_msgpack`` writes them) and its leaves."""
    rng = np.random.default_rng(2024)
    tree = {"model": {"w": rng.standard_normal((16, 20)).astype(np.float32),
                      "b": rng.standard_normal(20).astype(np.float32)},
            "proj": {"w_q8": rng.integers(-127, 128, (16, 8),
                                          dtype=np.int8),
                     "w_scale": rng.random(8).astype(np.float32)},
            "count": {"step": np.int32(5)}}
    save_msgpack(tree, prefix + ".msgpack")
    np.savez(prefix + ".npz", **{k.replace("/", "."): np.asarray(v)
                                  for k, v in _leaves(tree).items()})


def test_small_export_fixture_bit_for_bit(tmp_path):
    """The committed fixture is what ``write_fixture`` writes, and the
    port's reader gives its ``.npz``'s leaves bit for bit."""
    write_fixture(str(tmp_path / "again"))
    with open(tmp_path / "again.msgpack", "rb") as f:
        again = f.read()
    with open(FIXTURE + ".msgpack", "rb") as f:
        assert f.read() == again
    ours = _leaves(convert_jax.load_msgpack(FIXTURE + ".msgpack"))
    with np.load(FIXTURE + ".npz") as npz:
        expect = {k.replace(".", "/"): npz[k] for k in npz.files}
    assert sorted(ours) == sorted(expect)
    for key, value in ours.items():
        assert np.asarray(value).dtype == expect[key].dtype
        assert np.asarray(value).tobytes() == expect[key].tobytes()
