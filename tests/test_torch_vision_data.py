"""The port's ``vision.transforms`` and ``vision.datasets`` held against
the JAX package's on the CPU: every transform on the same image under
one numpy seed (the random ones draw from the global ``np.random``, so
the crops, flips and jitters are the reference's), bit for bit; the
synthetic datasets' images and labels; and the real-archive parsers
(CIFAR-10/100 tar.gz, MNIST idx, VOC2012 tar, Flowers) on archives the
test writes itself, as ``tests/test_datasets_real.py`` does."""

import gzip
import io
import pickle
import struct
import tarfile

import numpy as np
import pytest

from paddle_tpu.vision import datasets as jds
from paddle_tpu.vision import transforms as jt
from paddle_tpu_torch.vision import datasets as tds
from paddle_tpu_torch.vision import transforms as tt


def _img(seed=0, shape=(20, 24, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


TRANSFORMS = [
    ("Normalize", dict(mean=[0.5, 0.4, 0.3], std=[0.2, 0.3, 0.4],
                       data_format="HWC")),
    ("ToTensor", {}), ("Transpose", {}), ("Resize", dict(size=(9, 13))),
    ("RandomHorizontalFlip", dict(prob=0.5)),
    ("RandomVerticalFlip", dict(prob=0.5)),
    ("RandomCrop", dict(size=12, padding=2)), ("CenterCrop", dict(size=8)),
    ("Pad", dict(padding=(1, 2, 3, 4), fill=(9, 8, 7))),
    ("Pad", dict(padding=2, padding_mode="reflect")),
    ("Grayscale", dict(num_output_channels=3)),
    ("BrightnessTransform", dict(value=0.4)),
    ("ContrastTransform", dict(value=(0.5, 1.5))),
    ("SaturationTransform", dict(value=0.6)),
    ("HueTransform", dict(value=0.3)),
    ("ColorJitter", dict(brightness=0.2, contrast=0.3, saturation=0.4,
                         hue=0.1)),
    ("RandomResizedCrop", dict(size=10)),
]


@pytest.mark.parametrize("name,kw", TRANSFORMS,
                         ids=[f"{n}{i}" for i, (n, _) in
                              enumerate(TRANSFORMS)])
def test_transform_matches_jax(name, kw):
    img = _img(1)
    outs = []
    for mod in (jt, tt):
        t = getattr(mod, name)(**kw)
        np.random.seed(7)
        outs.append([np.asarray(t(img)) for _ in range(4)])
    for want, got in zip(*outs):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_compose_pipeline_matches_jax():
    def pipe(m):
        return m.Compose([m.RandomCrop(16, padding=2),
                          m.RandomHorizontalFlip(), m.ToTensor(),
                          m.Normalize([0.5] * 3, [0.25] * 3)])

    img = _img(2)
    np.random.seed(3)
    want = [pipe(jt)(img) for _ in range(3)]
    np.random.seed(3)
    got = [pipe(tt)(img) for _ in range(3)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_transform_refusals_match_jax():
    for mod in (jt, tt):
        with pytest.raises(ValueError, match="exceeds"):
            mod.CenterCrop(64)(_img())
        with pytest.raises(ValueError):
            mod.HueTransform(0.7)
        with pytest.raises(ValueError):
            mod.BrightnessTransform((1.5, 0.5))


@pytest.mark.parametrize("cls,kw", [
    ("Cifar10", dict(size=6)), ("Cifar10", dict(mode="test", size=5)),
    ("Cifar100", dict(size=4, seed=3)), ("MNIST", dict(size=5)),
    ("FashionMNIST", dict(size=3, mode="test")),
    ("VOC2012", dict(size=2, mode="valid")), ("Flowers", dict(size=3))])
def test_synthetic_datasets_match_jax(cls, kw):
    want, got = getattr(jds, cls)(**kw), getattr(tds, cls)(**kw)
    assert len(got) == len(want)
    for i in range(len(want)):
        for g, w in zip(got[i], want[i]):
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_synthetic_defaults_and_transform():
    assert len(tds.Cifar10()) == 1024 and len(tds.Cifar10(mode="test")) \
        == 256
    flip = tds.Cifar10(size=2, transform=tt.Transpose())
    assert flip[0][0].shape == (3, 32, 32) and flip[0][0].dtype == np.uint8
    with pytest.raises(RuntimeError, match="download"):
        tds.Cifar10(download=True)
    with pytest.raises(ValueError, match="together"):
        tds.MNIST(image_path="x")


def _cifar_tar(path, names, label_key, n=4, seed=0):
    rng = np.random.default_rng(seed)
    with tarfile.open(path, "w:gz") as tf:
        for name in names:
            blob = pickle.dumps({
                b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                label_key: rng.integers(0, 100, n).tolist()})
            info = tarfile.TarInfo(f"cifar-batches-py/{name}")
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))
    return path


def _same_items(got, want):
    assert len(got) == len(want)
    for i in range(len(want)):
        for g, w in zip(got[i], want[i]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_cifar_parsers_match_jax(tmp_path):
    c10 = _cifar_tar(str(tmp_path / "c10.tar.gz"),
                     [f"data_batch_{i}" for i in range(1, 6)] +
                     ["test_batch"], b"labels")
    for mode in ("train", "test"):
        _same_items(tds.Cifar10(data_file=c10, mode=mode),
                    jds.Cifar10(data_file=c10, mode=mode))
    assert len(tds.Cifar10(data_file=c10)) == 20
    c100 = _cifar_tar(str(tmp_path / "c100.tar.gz"), ["train", "test"],
                      b"fine_labels", n=6, seed=1)
    _same_items(tds.Cifar100(data_file=c100), jds.Cifar100(data_file=c100))
    with pytest.raises(ValueError, match="no 'train' batches"):
        tds.Cifar10(data_file=c100)


def test_mnist_parser_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (5, 28, 28), dtype=np.uint8)
    lbls = rng.integers(0, 10, 5).astype(np.uint8)
    ip, lp = str(tmp_path / "img.gz"), str(tmp_path / "lbl")
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, 5, 28, 28) + imgs.tobytes())
    with open(lp, "wb") as f:                # not gzipped: also read
        f.write(struct.pack(">II", 2049, 5) + lbls.tobytes())
    _same_items(tds.MNIST(image_path=ip, label_path=lp),
                jds.MNIST(image_path=ip, label_path=lp))
    bad = str(tmp_path / "bad.gz")
    with gzip.open(bad, "wb") as f:
        f.write(struct.pack(">IIII", 1234, 1, 28, 28))
    with pytest.raises(ValueError, match="magic"):
        tds.MNIST._parse_images(bad)


def test_voc_and_flowers_parsers_match_jax(tmp_path):
    PIL = pytest.importorskip("PIL.Image")
    scipy_io = pytest.importorskip("scipy.io")
    rng = np.random.default_rng(4)

    def png(arr, fmt):
        buf = io.BytesIO()
        PIL.fromarray(arr).save(buf, format=fmt)
        return buf.getvalue()

    voc = str(tmp_path / "voc.tar")
    with tarfile.open(voc, "w") as tf:
        def add(name, data):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
        root = "VOCdevkit/VOC2012/"
        add(root + "ImageSets/Segmentation/trainval.txt", b"a\nb\n")
        for i in ("a", "b"):
            add(f"{root}JPEGImages/{i}.jpg", png(
                rng.integers(0, 256, (8, 8, 3), dtype=np.uint8), "PNG"))
            add(f"{root}SegmentationClass/{i}.png", png(
                rng.integers(0, 21, (8, 8), dtype=np.uint8), "PNG"))
    _same_items(tds.VOC2012(data_file=voc), jds.VOC2012(data_file=voc))
    flw = str(tmp_path / "102flowers.tgz")
    with tarfile.open(flw, "w:gz") as tf:
        for k in (1, 2, 3):
            data = png(rng.integers(0, 256, (6, 6, 3), dtype=np.uint8),
                       "PNG")
            info = tarfile.TarInfo("jpg/image_%05d.jpg" % k)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    lab, sid = str(tmp_path / "labels.mat"), str(tmp_path / "setid.mat")
    scipy_io.savemat(lab, {"labels": np.array([[5, 9, 1]])})
    scipy_io.savemat(sid, {"trnid": np.array([[1]]),
                           "valid": np.array([[2]]),
                           "tstid": np.array([[3, 1]])})
    for mode in ("train", "valid", "test"):
        _same_items(tds.Flowers(flw, lab, sid, mode=mode),
                    jds.Flowers(flw, lab, sid, mode=mode))
