"""The port's reader of TF checkpoints (``runtime/pretrain.py``) against
tpudet's ``load_vgg16``, which reads them through TF, on V1 and V2
checkpoints that TF writes here: the same names, dtypes, shapes and bytes.
Each test skips where TensorFlow is absent (the card machine has none);
nothing is fetched.
"""

import warnings

import numpy as np
import pytest
import torch

from tpudet.runtime import pretrain as jax_pretrain
from tpudet_torch.models.ssd import SSD300
from tpudet_torch.runtime import pretrain

torch.set_num_threads(1)

FORMATS = {"v1": 1, "v2": 2}  # tf.compat.v1.train.SaverDef.V1 / V2


def _values(partitioned):
    """Two conv layers of vgg_16 (conv5_3 at full size: 9.4 MB), one tensor
    outside ``vgg_16/conv*`` and a step; with ``partitioned`` also a conv
    kernel that the saver stores in three slices, cut at channels 67 and 134
    (multi-byte slice keys)."""
    rng = np.random.default_rng(0)
    vals = {"vgg_16/conv1/conv1_1/weights": rng.normal(size=(3, 3, 3, 64)),
            "vgg_16/conv1/conv1_1/biases": rng.normal(size=(64,)),
            "vgg_16/conv5/conv5_3/weights": rng.normal(size=(3, 3, 512, 512)),
            "vgg_16/fc6/weights": rng.normal(size=(7, 7, 8, 16))}
    vals = {k: v.astype(np.float32) for k, v in vals.items()}
    vals["global_step"] = np.int64(7)
    if partitioned:
        vals["vgg_16/conv2/conv2_1/weights"] = rng.normal(
            size=(3, 3, 16, 200)).astype(np.float32)
    return vals


@pytest.fixture(scope="module")
def tf():
    """TensorFlow, imported by the tests that use it (not at collection, where
    every worker would load it)."""
    return pytest.importorskip("tensorflow")


def _write(tf, path, fmt, partitioned=False):
    """A checkpoint of :func:`_values` at ``path`` in TF's format ``fmt``."""
    vals = _values(partitioned)
    with tf.Graph().as_default():
        variables = []
        for name, v in vals.items():
            part = (tf.compat.v1.fixed_size_partitioner(3, axis=3)
                    if name.startswith("vgg_16/conv2") else None)
            variables.append(tf.compat.v1.get_variable(
                name, initializer=tf.constant(v), partitioner=part))
        saver = tf.compat.v1.train.Saver(write_version=FORMATS[fmt])
        with tf.compat.v1.Session() as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            saver.save(sess, str(path), write_meta_graph=False)
    return vals


def _both(path):
    """Port's and tpudet's ``load_vgg16`` on ``path``, with their warnings."""
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = pretrain.load_vgg16(str(path))
        n = len(w)
        want = jax_pretrain.load_vgg16(str(path))
    return got, want, [str(x.message) for x in w[:n]], [str(x.message) for x in w[n:]]


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].tobytes() == w.tobytes(), k


@pytest.mark.parametrize("fmt", ["v1", "v2"])
def test_load_vgg16_reads_tf_checkpoints_as_tpudet(tf, tmp_path, fmt):
    """Only the ``vgg_16/conv*`` names, bit for bit as TF reads them. A V2
    checkpoint is a prefix whose bare path does not exist."""
    path = tmp_path / "vgg_16.ckpt"
    vals = _write(tf, path, fmt)
    assert path.exists() == (fmt == "v1")
    got, want, warned, _ = _both(path)
    assert not warned
    _assert_same(got, want)
    assert sorted(got) == sorted(k for k in vals if k.startswith("vgg_16/conv"))
    for k, v in got.items():
        np.testing.assert_array_equal(v, vals[k])


@pytest.mark.parametrize("fmt", ["v1", "v2"])
def test_read_tf_checkpoint_reads_every_tensor(tf, tmp_path, fmt):
    """Every tensor, the int64 scalar and the non-conv kernel included."""
    path = tmp_path / "model.ckpt"
    vals = _write(tf, path, fmt)
    got = pretrain.read_tf_checkpoint(str(path))
    assert got.keys() == vals.keys()
    for k, v in vals.items():
        assert got[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k], v)


@pytest.mark.parametrize("fmt", ["v1", "v2"])
def test_partitioned_tensor_reads_as_tpudet(tf, tmp_path, fmt):
    """A conv kernel saved in three slices: V2 puts it together from its
    slices' entries, as TF's reader does; TF's V1 reader refuses sliced
    tensors, so tpudet and the port both warn and keep random init."""
    path = tmp_path / "vgg_16.ckpt"
    vals = _write(tf, path, fmt, partitioned=True)
    got, want, warned, their_warning = _both(path)
    if fmt == "v1":
        assert got is None and want is None
        assert "Sliced checkpoints are not supported" in warned[0]
        assert "Sliced checkpoints are not supported" in their_warning[0]
        return
    assert not warned
    _assert_same(got, want)
    np.testing.assert_array_equal(got["vgg_16/conv2/conv2_1/weights"],
                                  vals["vgg_16/conv2/conv2_1/weights"])


@pytest.mark.parametrize("damage", ["compressed_block", "truncated", "empty"])
def test_unreadable_checkpoint_warns_as_tpudet(tf, tmp_path, damage):
    """A block marked compressed (snappy, not read), a file cut short and an
    empty file: both readers warn and return None."""
    path = tmp_path / "vgg_16.ckpt"
    _write(tf, tmp_path / "good.ckpt", "v1")
    data = bytearray((tmp_path / "good.ckpt").read_bytes())
    if damage == "compressed_block":
        data[_first_data_block_end(data)] = 1  # the block's type byte: snappy
    elif damage == "truncated":
        data = data[:len(data) // 2]
    else:
        data = b""
    path.write_bytes(bytes(data))
    got, want, warned, their_warning = _both(path)
    assert got is None and want is None
    assert warned and warned[0].startswith(f"could not read TF checkpoint {str(path)!r}")
    assert their_warning
    if damage == "compressed_block":
        assert "compressed" in warned[0]


def _varint(buf, pos):
    value = shift = 0
    while True:
        byte = buf[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        shift += 7
        if byte < 0x80:
            return value, pos


def _first_data_block_end(data):
    """Where the first data block of an SSTable ends (its trailer's type
    byte): the footer's index handle, then the index block's first entry,
    whose value is that block's handle."""
    footer = data[-48:]
    _, pos = _varint(footer, _varint(footer, 0)[1])  # past the metaindex handle
    index_offset, _ = _varint(footer, pos)
    _, pos = _varint(data, index_offset)             # shared key bytes: 0
    key_len, pos = _varint(data, pos)
    _, pos = _varint(data, pos)                      # value length
    offset, pos = _varint(data, pos + key_len)
    size, _ = _varint(data, pos)
    return offset + size


@pytest.mark.parametrize("fmt", ["v1", "v2"])
def test_ssd_injects_vgg16_from_a_tf_checkpoint(tf, tmp_path, fmt):
    """The training scripts' ``pretraining_weight: "./vgg_16.ckpt"``: SSD300 takes
    conv1_1 from the checkpoint (HWIO -> OIHW); the layers whose kernel or
    bias the file lacks (conv5_3 has no bias here) stay at random init with
    a warning, as in tpudet."""
    path = tmp_path / "vgg_16.ckpt"
    vals = _write(tf, path, fmt)
    cfg = {"mode": "test", "data_format": "channels_last", "num_classes": 20,
           "batch_size": 1, "weight_decay": 5e-4, "nms_score_threshold": 0.15,
           "nms_max_boxes": 10, "nms_iou_threshold": 0.45,
           "pretraining_weight": str(path), "seed": 3}
    with pytest.warns(UserWarning, match="conv5_3 missing"):
        model = SSD300(cfg, device="cpu")
    trunk = model.net.feature_extractor.vgg
    np.testing.assert_array_equal(trunk.conv1_1.conv.weight.detach().numpy(),
                                  vals["vgg_16/conv1/conv1_1/weights"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(trunk.conv1_1.conv.bias.detach().numpy(),
                                  vals["vgg_16/conv1/conv1_1/biases"])
    random = SSD300(dict(cfg, pretraining_weight=None), device="cpu")
    assert torch.equal(trunk.conv5_3.conv.weight,
                       random.net.feature_extractor.vgg.conv5_3.conv.weight)
