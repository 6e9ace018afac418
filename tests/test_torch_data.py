"""The port's data subsystem against tpudet's on the same inputs.

Records, shards and indexes must be byte-identical; the augmentor and the
loaders bit-equal at one seed (the port's copy makes the same ``Generator``
draws in the same order, in float32). The inputs are the committed mini VOC set
(``tests/torch_data/voc_mini``, written by ``tests/torch_make_voc_mini.py``)
and arrays made here with numpy; nothing is downloaded.
"""

import ast
import os
import random
import sys
from pathlib import Path

import numpy as np
import pytest

from tpudet.data import example_proto as j_proto
from tpudet.data import imagenet as j_imagenet
from tpudet.data import pipeline as j_pipeline
from tpudet.data import tfrecord as j_tfrecord
from tpudet.data import voc as j_voc
from tpudet.data.augment import image_augmentor as j_augment
from tpudet_torch.data import classes as t_classes
from tpudet_torch.data import example_proto as t_proto
from tpudet_torch.data import imagenet as t_imagenet
from tpudet_torch.data import pipeline as t_pipeline
from tpudet_torch.data import tfrecord as t_tfrecord
from tpudet_torch.data import voc as t_voc
from tpudet_torch.data.augment import image_augmentor as t_augment

REPO = Path(__file__).resolve().parents[1]
MINI = REPO / "tests" / "torch_data" / "voc_mini"
XML_DIR, IMG_DIR = str(MINI / "Annotations"), str(MINI / "JPEGImages")
DRIVERS = ("testSSD300", "testSSD512", "testYOLOv2", "testYOLOv3", "testcenternet",
           "testfcos", "testlhrcnn", "testpfpnet", "testrefinedet", "testretinanet")


def driver_augmentor_config(name):
    """``image_augmentor_config`` of ``drivers/{name}.py``, read without
    importing the script."""
    tree = ast.parse((REPO / "drivers" / f"{name}.py").read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "image_augmentor_config"):
            return ast.literal_eval(node.value)
    raise KeyError(name)


def mini_xmls():
    return sorted(str(p) for p in (MINI / "Annotations").glob("*.xml"))


def same_bytes(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# ------------------------------------------------------------ crc32c
PAYLOADS = {"empty": b"", "check": b"123456789", "one": b"\x00",
            "seven": bytes(range(7)), "eight": bytes(range(8)),
            "random": np.random.default_rng(0).integers(0, 256, 4099, np.uint8).tobytes()}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_crc32c_and_masked_crc_match_tpudet(name):
    data = PAYLOADS[name]
    assert t_tfrecord.crc32c(data) == j_tfrecord.crc32c(data)
    assert t_tfrecord.crc32c(data, 0x1234) == j_tfrecord.crc32c(data, 0x1234)
    assert t_tfrecord._masked_crc(data) == j_tfrecord._masked_crc(data)


def test_crc32c_numpy_table_matches_the_c_library(monkeypatch):
    assert t_tfrecord._load_native(), "g++ is here: the C library must build and load"
    assert t_tfrecord.crc32c(b"123456789") == 0xE3069283
    data = PAYLOADS["random"][:1000]
    want = t_tfrecord.crc32c(data)
    monkeypatch.setattr(t_tfrecord, "_native", False)
    assert t_tfrecord.crc32c(data) == want


def test_crc32c_library_loads_once_under_concurrent_first_calls(monkeypatch):
    import threading

    opened = []
    real_open = t_tfrecord._open_native
    monkeypatch.setattr(t_tfrecord, "_native", None)
    monkeypatch.setattr(t_tfrecord, "_open_native",
                        lambda: opened.append(1) or real_open())
    data = PAYLOADS["random"]
    results = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: results.append(t_tfrecord.crc32c(data)))
                   for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert opened == [1] and results == [j_tfrecord.crc32c(data)] * 32


def test_crc32c_library_builds_under_build_not_native():
    assert t_tfrecord._load_native()
    path = t_tfrecord.library_path()
    assert path.parent == REPO / "build" / "native" and path.is_file()


# ------------------------------------------------------------ Example proto
EXAMPLES = {
    "voc": {"image": [b"\xff\xd8jpeg"],
            "shape": [np.asarray([375, 500, 3], np.int32).tobytes()],
            "ground_truth": [np.arange(10, dtype=np.float32).tobytes()]},
    "mixed": {"floats": [1.5, -2.25, 3.0], "label": [7, -3, 2 ** 40, 0],
              "names": [b"a", b"", b"ccc"]},
    "imagenet": {"image": [b"x" * 300], "shape": [b"\x01\x02"], "label": [999]},
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_encode_example_is_byte_identical_and_both_decoders_agree(name):
    feats = EXAMPLES[name]
    buf = t_proto.encode_example(feats)
    assert buf == j_proto.encode_example(feats)
    assert t_proto.decode_example(buf) == j_proto.decode_example(buf)


# ------------------------------------------------------------ TFRecord files
def _records():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 256, n, np.uint8).tobytes() for n in (0, 1, 100, 5000, 17)]


def test_tfrecord_files_are_identical_and_each_side_reads_the_other(tmp_path):
    records = _records()
    paths = {}
    for side, mod in (("port", t_tfrecord), ("tpudet", j_tfrecord)):
        paths[side] = str(tmp_path / f"{side}.tfrecord")
        with mod.TFRecordWriter(paths[side]) as w:
            for r in records:
                w.write(r)
    assert Path(paths["port"]).read_bytes() == Path(paths["tpudet"]).read_bytes()
    assert list(t_tfrecord.read_records(paths["tpudet"], verify=True)) == records
    assert list(j_tfrecord.read_records(paths["port"], verify=True)) == records
    index = t_tfrecord.index_records(paths["port"])
    assert index == j_tfrecord.index_records(paths["port"])


def test_read_records_verify_raises_on_a_corrupt_record(tmp_path):
    path = tmp_path / "bad.tfrecord"
    with t_tfrecord.TFRecordWriter(str(path)) as w:
        w.write(b"payload")
    raw = bytearray(path.read_bytes())
    raw[14] ^= 1
    path.write_bytes(bytes(raw))
    assert list(t_tfrecord.read_records(str(path))) == [b"paxload"]
    with pytest.raises(IOError, match="corrupt"):
        list(t_tfrecord.read_records(str(path), verify=True))


# ------------------------------------------------------------ VOC
@pytest.mark.parametrize("index", range(8))
def test_xml_to_features_matches_lxml(index):
    xml = mini_xmls()[index]
    assert t_voc.xml_to_features(xml, IMG_DIR) == j_voc.xml_to_features(xml, IMG_DIR)


def test_xml_to_features_raises_keyerror_for_an_unknown_class(tmp_path):
    text = Path(mini_xmls()[0]).read_text().replace("<name>bicycle</name>",
                                                    "<name>unicorn</name>")
    assert "unicorn" in text
    xml = tmp_path / "unknown.xml"
    xml.write_text(text)
    with pytest.raises(KeyError, match="unicorn"):
        j_voc.xml_to_features(str(xml), IMG_DIR)
    with pytest.raises(KeyError, match="unicorn"):
        t_voc.xml_to_features(str(xml), IMG_DIR)


def test_voc_classes_match_tpudet():
    from tpudet.data import classes as j_classes

    assert t_classes.VOC_CLASSES == j_classes.VOC_CLASSES
    assert t_classes.classname_to_ids == j_classes.classname_to_ids


@pytest.mark.parametrize("shards", [1, 3])
def test_dataset2tfrecord_shards_are_byte_identical(tmp_path, shards):
    t_out = t_voc.dataset2tfrecord(XML_DIR, IMG_DIR, str(tmp_path / "port"), "voc",
                                   shards)
    j_out = j_voc.dataset2tfrecord(XML_DIR, IMG_DIR, str(tmp_path / "tpudet"), "voc",
                                   shards)
    assert [os.path.basename(p) for p in t_out] == [os.path.basename(p) for p in j_out]
    for t, j in zip(t_out, j_out):
        assert Path(t).read_bytes() == Path(j).read_bytes()
        assert t_tfrecord.index_records(t) == j_tfrecord.index_records(j)
    assert sum(len(list(t_tfrecord.read_records(p, verify=True))) for p in t_out) == 8


def _block_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # `import cv2` raises ImportError


@pytest.mark.parametrize("decoder", ["cv2", "PIL"])
def test_parse_voc_record_matches_tpudet(tmp_path, monkeypatch, decoder):
    if decoder == "PIL":
        _block_cv2(monkeypatch)
    else:
        pytest.importorskip("cv2")
    for xml in mini_xmls():
        record = t_proto.encode_example(t_voc.xml_to_features(xml, IMG_DIR))
        got, want = t_voc.parse_voc_record(record), j_voc.parse_voc_record(record)
        for g, w in zip(got, want):
            same_bytes(g, w)
        assert got[0].shape == tuple(got[1]) and got[0].dtype == np.float32


# ------------------------------------------------------------ augmentor
def _mini_image(index=0):
    record = t_proto.encode_example(t_voc.xml_to_features(mini_xmls()[index], IMG_DIR))
    return t_voc.parse_voc_record(record)


def _extra_configs():
    base = driver_augmentor_config("testSSD300")
    return {
        "constant": dict(base, output_shape=[520, 520], fill_mode="CONSTANT",
                         constant_values=7.0, rotate=None),
        "keep_aspect": dict(base, keep_aspect_ratios=True, zoom_size=[320, 320],
                            crop_method="center", constant_values=3.0),
        "nearest": dict(base, fill_mode="NEAREST_NEIGHBOR", flip_prob=[0.5, 0.5],
                        rotate=[1.0, -5.0, 5.0]),
        "channels_first": dict(base, data_format="channels_first", color_jitter_prob=1.0),
    }


AUG_CASES = [*DRIVERS, *sorted(_extra_configs()), "no_ground_truth", "zero_rows",
             "zero_box_fallback"]


@pytest.mark.parametrize("case", AUG_CASES)
def test_image_augmentor_is_bit_equal_to_tpudet(case):
    image, shape, gt = _mini_image(AUG_CASES.index(case) % 8)
    if case in DRIVERS:
        cfg = driver_augmentor_config(case)
    elif case in ("no_ground_truth", "zero_rows", "zero_box_fallback"):
        cfg = driver_augmentor_config("testSSD300")
    else:
        cfg = _extra_configs()[case]
    if case == "no_ground_truth":
        gt = None
        cfg = {k: v for k, v in cfg.items() if k != "pad_truth_to"}
    elif case == "zero_rows":
        gt = np.zeros((0, 5), np.float32)
    elif case == "zero_box_fallback":
        gt = np.asarray([[0, 0, 0, 0, 4]], np.float32)  # centre on the border
    if cfg["data_format"] == "channels_first":
        image = image.transpose(2, 0, 1).copy()
    for seed in (0, 1):
        want = j_augment(image=image, input_shape=shape, ground_truth=gt,
                         rng=np.random.default_rng(seed), **cfg)
        got = t_augment(image=image, input_shape=shape, ground_truth=gt,
                        rng=np.random.default_rng(seed), **cfg)
        if gt is None:
            same_bytes(got, want)
        else:
            for g, w in zip(got, want):
                same_bytes(g, w)


# ------------------------------------------------------------ loaders
@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    out = tmp_path_factory.mktemp("voc_shards")
    return t_voc.dataset2tfrecord(XML_DIR, IMG_DIR, str(out), "voc", 2)


def _small_config():
    return dict(driver_augmentor_config("testSSD300"), output_shape=[96, 96],
                pad_truth_to=12)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_voc_loader_batches_match_tpudet(shards, num_workers):
    t_init, t_it = t_pipeline.get_generator(shards, 3, 1024, _small_config(), seed=5,
                                            num_workers=num_workers)
    j_init, j_it = j_pipeline.get_generator(shards, 3, 1024, _small_config(), seed=5,
                                            num_workers=num_workers)
    try:
        assert t_init == t_it.reset
        for _ in range(3):
            got, want = next(t_it), next(j_it)
            assert got[0].shape == (3, 96, 96, 3) and got[1].shape == (3, 12, 5)
            for g, w in zip(got, want):
                same_bytes(g, w)
    finally:
        t_it.close()
        j_it.close()


def test_voc_loader_surfaces_a_producer_error(tmp_path):
    path = str(tmp_path / "bad.tfrecord")
    feats = t_voc.xml_to_features(mini_xmls()[0], IMG_DIR)
    feats["image"] = [b"not a jpeg"]
    with t_tfrecord.TFRecordWriter(path) as w:
        w.write(t_proto.encode_example(feats))
    _, it = t_pipeline.get_generator([path], 1, 1, _small_config())
    try:
        with pytest.raises(RuntimeError, match="producer failed"):
            next(it)
    finally:
        it.close()


def _imagenet_shards(root):
    """The mini set's JPEGs as a two-class ImageNet layout, written by both
    sides' ``dataset2tfrecord`` under the same ``random`` seed."""
    img_dir = root / "train"
    for i, src in enumerate(sorted((MINI / "JPEGImages").glob("*.jpg"))):
        d = img_dir / ("n0000%d" % (i % 2))
        d.mkdir(parents=True, exist_ok=True)
        (d / src.name).write_bytes(src.read_bytes())
    out = {}
    for side, mod in (("port", t_imagenet), ("tpudet", j_imagenet)):
        random.seed(11)
        out[side] = mod.dataset2tfrecord(str(img_dir), str(root / side), "imagenet", 2)
    return out


def test_imagenet_records_and_loader_match_tpudet(tmp_path):
    out = _imagenet_shards(tmp_path)
    for t, j in zip(out["port"], out["tpudet"]):
        assert Path(t).read_bytes() == Path(j).read_bytes()
    cfg = {"data_format": "channels_last", "output_shape": [64, 64],
           "zoom_size": [72, 72], "crop_method": "random", "flip_prob": [0.0, 0.5],
           "fill_mode": "BILINEAR", "color_jitter_prob": 0.5}
    _, t_it = t_imagenet.get_generator(out["port"], 3, 64, cfg, seed=2)
    _, j_it = j_imagenet.get_generator(out["port"], 3, 64, cfg, seed=2)
    for _ in range(3):  # 8 records, batch 3: the third batch starts a new epoch
        got, want = next(t_it), next(j_it)
        assert got[0].shape == (3, 64, 64, 3) and got[1].dtype == np.int64
        for g, w in zip(got, want):
            same_bytes(g, w)


def test_every_port_module_imports_without_cv2_pil_or_lxml():
    import subprocess

    code = ("import sys\n"
            "for name in ('cv2', 'PIL', 'lxml', 'jax', 'tpudet'):\n"
            "    sys.modules[name] = None  # importing any of them raises\n"
            "import importlib, pkgutil, tpudet_torch\n"
            "mods = [m.name for m in pkgutil.walk_packages(tpudet_torch.__path__,\n"
            "                                               'tpudet_torch.')]\n"
            "for m in mods:\n"
            "    importlib.import_module(m)\n"
            "print(len(mods))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout) >= 50


def test_chip_smoke_feeds_with_the_ssd300_drivers_augmentor_config():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    assert chip_smoke.SSD300_AUGMENTOR == driver_augmentor_config("testSSD300")
    assert len(mini_xmls()) == 8 and chip_smoke.voc_mini() == MINI
