"""The port's reader of tpudet's ``.tpudet`` checkpoints.

The decoder is held against the ``msgpack`` package (which the tests may
import and the port may not) on every msgpack type, and the flax layer on top
of it against tpudet's ``save_state``: equal leaf for leaf, bfloat16 and
chunked leaves included. Then whole models: a checkpoint written by tpudet's
``save_weight`` loads into the port's model with the same tensors, the same
forward (1e-4 normwise: the two frameworks sum convolutions in other orders),
the same velocity and step.
"""

import math

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

from tpudet.models.retinanet import RetinaNet as JaxRetinaNet
from tpudet.models.ssd import SSD300 as JaxSSD300
from tpudet.runtime import checkpoint as jax_ckpt
from tpudet.runtime import optim as jax_optim
from tpudet_torch.models import RetinaNet
from tpudet_torch.models.ssd import SSD300
from tpudet_torch.runtime import checkpoint, transfer

torch.set_num_threads(1)

PIXEL_MEAN = np.asarray([123.68, 116.779, 103.979], np.float32)


# ------------------------------------------------------------ msgpack
def _ext(code, data):
    return msgpack.ExtType(code, data)


_scalars = (st.none() | st.booleans()
            | st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1)
            | st.floats(allow_nan=False) | st.text() | st.binary()
            | st.builds(msgpack.ExtType, st.integers(0, 127), st.binary()))
_values = st.recursive(
    _scalars,
    lambda inner: st.lists(inner, max_size=20)
    | st.dictionaries(st.text(max_size=8), inner, max_size=20),
    max_leaves=60)


@settings(max_examples=150, deadline=None)
@given(value=_values, single_float=st.booleans())
def test_unpackb_matches_msgpack(value, single_float):
    """Every type: nil, bool, all int widths, float32 and float64, str, bin,
    array, map, ext (the fixext sizes too), against ``msgpack.unpackb``."""
    blob = msgpack.packb(value, use_bin_type=True, use_single_float=single_float)
    want = msgpack.unpackb(blob, raw=False, ext_hook=_ext, strict_map_key=False)
    got = checkpoint.unpackb(blob, ext_hook=_ext)
    assert got == want
    assert type(got) is type(want)


@pytest.mark.parametrize("n", [15, 16, 255, 256, 65535, 65536])
def test_unpackb_sized_forms(n):
    """The 8-, 16- and 32-bit length forms of str, bin, array and map."""
    value = {"s": "x" * n, "b": b"\x01" * n, "a": list(range(min(n, 70000))),
             "m": {str(i): i for i in range(n)}}
    blob = msgpack.packb(value, use_bin_type=True)
    assert checkpoint.unpackb(blob) == msgpack.unpackb(blob, raw=False)


def test_unpackb_rejects_bad_input():
    with pytest.raises(ValueError, match="no ext_hook"):
        checkpoint.unpackb(msgpack.packb(msgpack.ExtType(5, b"ab")))
    with pytest.raises(ValueError, match="extra data"):
        checkpoint.unpackb(msgpack.packb(1) + msgpack.packb(2))
    with pytest.raises(ValueError, match="truncated"):
        checkpoint.unpackb(msgpack.packb("abcdef")[:-2])
    with pytest.raises(ValueError, match="invalid msgpack type byte 0xc1"):
        checkpoint.unpackb(b"\xc1")


# ------------------------------------------------------------ flax's layer
def _leaves_equal(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            _leaves_equal(got[k], want[k])
    elif isinstance(want, np.ndarray) and want.dtype == jnp.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


def _state():
    rng = np.random.default_rng(0)
    return {
        "params": {"a": {"kernel": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
                         "bias": np.zeros(4, np.float32)},
                   "half": jnp.asarray(rng.normal(size=(5, 3)), jnp.bfloat16)},
        "ints": {"i8": np.arange(-3, 3, dtype=np.int8), "u64": np.arange(4, dtype=np.uint64),
                 "i32": np.arange(6, dtype=np.int32).reshape(2, 3),
                 "f64": rng.normal(size=7), "f16": np.ones(3, np.float16)},
        "flags": np.asarray([True, False]),
        "empty": np.zeros((0, 3), np.float32), "scalar0d": np.float32(2.5),
        "npscalar": np.int64(-7), "bf16scalar": jnp.bfloat16(1.5),
        "global_step": 12, "none": None, "pi": math.pi, "opt": {},
    }


def test_tpudet_save_state_loads_leaf_for_leaf(tmp_path):
    """tpudet ``save_state`` -> the port's ``load_state``, by prefix; flax's
    own ``msgpack_restore`` of the same file is the reference."""
    fname = jax_ckpt.save_state(str(tmp_path / "run" / "ckpt"), _state(), 12)
    with open(fname, "rb") as f:
        want = serialization.msgpack_restore(f.read())
    got = checkpoint.load_state(str(tmp_path / "run" / "ckpt"))
    _leaves_equal(got, want)
    assert float(got["bf16scalar"]) == 1.5 and got["params"]["half"].shape == (5, 3)


def test_chunked_leaves_are_reassembled(tmp_path, monkeypatch):
    """flax splits leaves above ``MAX_CHUNK_SIZE`` into chunks; the port joins
    them (float32 and bfloat16)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    state = {"big": np.arange(100, dtype=np.float32).reshape(4, 25),
             "small": np.arange(3, dtype=np.float32),
             "half": jnp.asarray(np.arange(90).reshape(9, 10), jnp.bfloat16)}
    blob = serialization.msgpack_serialize(jax.device_get(state))
    raw = msgpack.unpackb(blob, raw=False, ext_hook=_ext)
    assert raw["big"]["__msgpack_chunked_array__"] and len(raw["big"]["chunks"]) == 7
    got = checkpoint.msgpack_restore(blob)
    _leaves_equal(got, serialization.msgpack_restore(blob))


def test_other_ext_codes_raise():
    """Ext code 2 (flax's complex), msgpack's timestamp (-1) and any code but 1
    and 3 raise."""
    for code, value in ((2, msgpack.ExtType(2, b"\x00" * 8)),
                        (127, msgpack.ExtType(127, b"")),
                        (-1, msgpack.Timestamp(0))):
        blob = msgpack.packb({"x": value})
        with pytest.raises(ValueError, match=f"ext type {code} "):
            checkpoint.msgpack_restore(blob)


def test_resolve_takes_files_suffixes_and_the_newest_step(tmp_path):
    """As tpudet's ``_resolve``, over both suffixes; the port's file wins a tie."""
    base = tmp_path / "m"
    for name in ("m-3.tpudet", "m-12.tpudet", "m-5.pt", "m-12.pt", "x.tpudet"):
        (tmp_path / name).write_bytes(b"")
    assert checkpoint.resolve(str(base)) == str(tmp_path / "m-12.pt")
    (tmp_path / "m-40.tpudet").write_bytes(b"")
    assert checkpoint.resolve(str(base)) == str(tmp_path / "m-40.tpudet")
    assert checkpoint.resolve(str(tmp_path / "m-3")) == str(tmp_path / "m-3.tpudet")
    assert checkpoint.resolve(str(tmp_path / "x.tpudet")) == str(tmp_path / "x.tpudet")
    with pytest.raises(FileNotFoundError):
        checkpoint.resolve(str(tmp_path / "none"))


# ------------------------------------------------------------ whole models
def _ssd_config(**kw):
    cfg = {"mode": "train", "data_format": "channels_last", "num_classes": 20,
           "batch_size": 2, "weight_decay": 5e-4, "nms_score_threshold": 0.15,
           "nms_max_boxes": 10, "nms_iou_threshold": 0.45, "pretraining_weight": None,
           "seed": 3}
    cfg.update(kw)
    return cfg


def _retina_config(**kw):
    cfg = {"mode": "train", "data_format": "channels_last", "num_classes": 4,
           "weight_decay": 1e-4, "keep_prob": 1.0, "batch_size": 2,
           "nms_score_threshold": 0.2, "nms_max_boxes": 5, "nms_iou_threshold": 0.45,
           "data_shape": [64, 64, 3], "is_bottleneck": True,
           "residual_block_list": [1, 1, 1], "init_conv_filters": 8,
           "is_pretraining": False, "alpha": 0.25, "gamma": 2.0, "seed": 3}
    cfg.update(kw)
    return cfg


class _JaxSSD76(JaxSSD300):
    input_size = 76


class _SSD76(SSD300):
    input_size = 76


def _tree_like(tree, fn):
    return {k: _tree_like(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("family", ["ssd", "retinanet"])
def test_tpudet_checkpoint_loads_into_the_port(tmp_path, family):
    """tpudet ``save_weight`` (params, perturbed statistics, a non-zero
    Momentum velocity, step 7) -> the port's ``load_weight``: the same
    tensors and velocity exactly, the same step, and the same eval forward."""
    if family == "ssd":
        jm, port_cls, cfg, size = _JaxSSD76(_ssd_config()), _SSD76, _ssd_config(), 76
    else:
        jm, port_cls, cfg, size = (JaxRetinaNet(_retina_config()), RetinaNet,
                                   _retina_config(), 64)
    rng = np.random.default_rng(1)
    jm.batch_stats = _tree_like(jax.device_get(jm.batch_stats),
                                lambda v: rng.uniform(0.5, 2.0, np.shape(v)).astype(
                                    np.float32))
    velocity = _tree_like(jax.device_get(jm.params),
                          lambda v: rng.normal(size=np.shape(v)).astype(np.float32))
    jm.opt_state = jax_optim.MomentumState(velocity)
    jm.global_step = 7
    jm.save_weight("latest", str(tmp_path / family / "model"))

    pm = port_cls(dict(cfg, seed=11), device="cpu")
    pm.load_weight(str(tmp_path / family / "model"))
    variables = {"params": jax.device_get(jm.params), "batch_stats": jm.batch_stats}
    want = transfer.from_flax(variables)
    got = pm.net.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    for k, v in transfer.velocity_from_flax(velocity).items():
        assert torch.equal(pm.velocity[k], v), k
    assert pm.global_step == 7

    image = rng.uniform(0, 255, (1, size, size, 3)).astype(np.float32)
    outs = jax.tree.leaves(jm.net.apply(variables, jnp.asarray(image - PIXEL_MEAN), False))
    x = torch.tensor(np.transpose(image - PIXEL_MEAN, (0, 3, 1, 2)))
    with torch.no_grad():
        mine = pm.net.eval()(x)
    mine = [mine] if isinstance(mine, torch.Tensor) else mine
    mine = [t for item in mine for t in (item if isinstance(item, tuple) else (item,))]
    assert len(mine) == len(outs)
    for g, w in zip(mine, outs):
        assert _rel(g.permute(0, 2, 3, 1).numpy(), np.asarray(w)) < 1e-4


def test_port_checkpoint_still_round_trips(tmp_path):
    """The port's own ``.pt`` files resolve beside ``.tpudet`` ones."""
    pm = RetinaNet(_retina_config(), device="cpu")
    pm.global_step = 3
    pm.save_weight("latest", str(tmp_path / "m"))
    other = RetinaNet(_retina_config(seed=9), device="cpu")
    other.load_weight(str(tmp_path / "m"))
    assert other.global_step == 3
    for k, v in pm.net.state_dict().items():
        assert torch.equal(other.net.state_dict()[k], v), k
