"""Vision datasets: a copy of ``paddle_tpu/vision/datasets`` (numpy; items
are ``(CHW float32 image, int64 label)`` unless a transform says
otherwise).

Two modes:

- ``data_file``/``image_path`` given: parse the REAL archive formats —
  CIFAR's pickled-batch tar.gz, MNIST's idx-ubyte gzip — exactly like the
  reference parsers (``cifar.py _load_data``, ``mnist.py
  _parse_dataset``).
- no path (default): deterministic synthetic data with the real
  shapes/label spaces.  The package downloads nothing, so
  ``download=True`` raises with a pointer to the file-path mode, as the
  reference's does.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile

import numpy as np

from ...io import Dataset

__all__ = ["Cifar10", "Cifar100", "MNIST", "FashionMNIST",
           "VOC2012", "Flowers"]


def _no_download(name):
    raise RuntimeError(
        f"{name}: download=True is not supported (the package downloads "
        "nothing). Pass data_file=/path/to/archive (CIFAR: the "
        "cifar-*-python.tar.gz; MNIST: image_path/label_path idx-ubyte "
        ".gz files) or use the synthetic default (no path).")


class _SyntheticImages(Dataset):
    num_classes = 10
    image_shape = (3, 32, 32)

    def __init__(self, mode="train", transform=None, size=None, seed=0):
        self.mode = mode
        self.transform = transform
        self.size = size or (1024 if mode == "train" else 256)
        rng = np.random.default_rng(seed + (0 if mode == "train" else 1))
        c, h, w = self.image_shape
        # HWC uint8 like the real decoded datasets
        self.images = rng.integers(0, 256, (self.size, h, w, c),
                                   dtype=np.uint8)
        self.labels = rng.integers(0, self.num_classes, (self.size,),
                                   dtype=np.int64)

    def _finish_init(self):
        self.size = len(self.images)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = (img.astype(np.float32) / 255.0).transpose(2, 0, 1)
        return img, self.labels[idx]

    def __len__(self):
        return self.size


class _Cifar(_SyntheticImages):
    _label_key = b"labels"

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None, size=None, seed=0):
        if data_file:
            self.mode = mode
            self.transform = transform
            self.images, self.labels = self._parse(data_file, mode)
            self._finish_init()
        elif download:
            _no_download(type(self).__name__)
        else:
            super().__init__(mode=mode, transform=transform, size=size,
                             seed=seed)

    def _members(self, mode):
        raise NotImplementedError

    def _parse(self, data_file, mode):
        """Reference cifar.py: each tar member is a pickled dict with
        b'data' ([N, 3072] uint8, CHW-flattened) and the label list."""
        wanted = self._members(mode)
        images, labels = [], []
        with tarfile.open(data_file, "r:*") as tf:
            names = {os.path.basename(m.name): m for m in tf.getmembers()
                     if m.isfile()}
            for base in wanted:
                if base not in names:
                    continue
                with tf.extractfile(names[base]) as f:
                    batch = pickle.load(f, encoding="bytes")
                data = np.asarray(batch[b"data"], np.uint8)
                images.append(data.reshape(-1, 3, 32, 32)
                              .transpose(0, 2, 3, 1))  # -> HWC
                labels.append(np.asarray(batch[self._label_key], np.int64))
        if not images:
            raise ValueError(
                f"{type(self).__name__}: no '{mode}' batches found in "
                f"{data_file} (expected members like {wanted[0]})")
        return np.concatenate(images), np.concatenate(labels)


class Cifar10(_Cifar):
    num_classes = 10
    image_shape = (3, 32, 32)
    _label_key = b"labels"

    def _members(self, mode):
        if mode == "train":
            return [f"data_batch_{i}" for i in range(1, 6)]
        return ["test_batch"]


class Cifar100(_Cifar):
    num_classes = 100
    image_shape = (3, 32, 32)
    _label_key = b"fine_labels"

    def _members(self, mode):
        return ["train"] if mode == "train" else ["test"]


def _open_maybe_gz(path):
    with open(path, "rb") as probe:
        magic = probe.read(2)
    return gzip.open(path, "rb") if magic == b"\x1f\x8b" else \
        open(path, "rb")


class MNIST(_SyntheticImages):
    num_classes = 10
    image_shape = (1, 28, 28)

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=False, backend=None, size=None,
                 seed=0):
        if bool(image_path) != bool(label_path):
            raise ValueError(
                "MNIST: image_path and label_path must be given together "
                "(got only one) — a silent synthetic fallback would look "
                "like real data")
        if image_path and label_path:
            self.mode = mode
            self.transform = transform
            self.images = self._parse_images(image_path)
            self.labels = self._parse_labels(label_path)
            if len(self.images) != len(self.labels):
                raise ValueError(
                    f"MNIST: {len(self.images)} images vs "
                    f"{len(self.labels)} labels")
            self._finish_init()
        elif download and not (image_path or label_path):
            _no_download(type(self).__name__)
        else:
            super().__init__(mode=mode, transform=transform, size=size,
                             seed=seed)

    @staticmethod
    def _parse_images(path):
        """idx3-ubyte: >u4 magic 2051 | count | rows | cols | pixels."""
        with _open_maybe_gz(path) as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            if magic != 2051:
                raise ValueError(
                    f"MNIST image file {path}: bad magic {magic} "
                    "(want 2051)")
            buf = f.read(n * rows * cols)
        return np.frombuffer(buf, np.uint8).reshape(n, rows, cols, 1)

    @staticmethod
    def _parse_labels(path):
        """idx1-ubyte: >u4 magic 2049 | count | labels."""
        with _open_maybe_gz(path) as f:
            magic, n = struct.unpack(">II", f.read(8))
            if magic != 2049:
                raise ValueError(
                    f"MNIST label file {path}: bad magic {magic} "
                    "(want 2049)")
            buf = f.read(n)
        return np.frombuffer(buf, np.uint8).astype(np.int64)


class FashionMNIST(MNIST):
    pass


class VOC2012(Dataset):
    """Segmentation pairs (reference
    ``python/paddle/vision/datasets/voc2012.py``): items are
    ``(image, label)`` — RGB image and the class-index mask png (0..20,
    255 = void border), both HWC/HW uint8 before transforms.

    ``data_file``: the real VOCtrainval tar (ImageSets/Segmentation/
    {mode}.txt lists the ids; JPEGImages/<id>.jpg +
    SegmentationClass/<id>.png).  Without a path: synthetic image/mask
    pairs with the 21-class label space."""

    num_classes = 21

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None, size=None, seed=0):
        if mode not in ("train", "valid", "test"):
            raise ValueError(
                f"mode should be 'train', 'valid' or 'test', got {mode}")
        self.mode = mode
        self.transform = transform
        if data_file:
            self._open(data_file, mode)
            return
        if download:
            _no_download(type(self).__name__)
        self._tar = None
        self.size = (128 if mode == "train" else 32) if size is None \
            else size
        rng = np.random.default_rng(
            seed + {"train": 0, "valid": 1, "test": 2}[mode])
        self._images = rng.integers(0, 256, (self.size, 64, 64, 3),
                                    dtype=np.uint8)
        masks = rng.integers(0, self.num_classes, (self.size, 64, 64))
        masks[:, :2, :] = 255  # void border rows like real masks
        self._masks = masks.astype(np.uint8)

    def _open(self, data_file, mode):
        import tarfile
        # reference MODE_FLAG_MAP (voc2012.py:36): 'train' reads the
        # trainval superset, 'test' reads train.txt, 'valid' reads val
        split = {"train": "trainval", "valid": "val",
                 "test": "train"}[mode]
        self._tar = tarfile.open(data_file, "r:*")
        members = {m.name: m for m in self._tar.getmembers()
                   if m.isfile()}
        list_name = [n for n in members if n.endswith(
            f"ImageSets/Segmentation/{split}.txt")]
        if len(list_name) != 1:
            raise ValueError(
                f"VOC2012: no ImageSets/Segmentation/{split}.txt in "
                f"{data_file}")
        ids = self._tar.extractfile(members[list_name[0]]) \
            .read().decode().split()
        root = list_name[0].split("ImageSets/")[0]
        self._pairs = []
        for i in ids:
            jpg = f"{root}JPEGImages/{i}.jpg"
            png = f"{root}SegmentationClass/{i}.png"
            if jpg in members and png in members:
                self._pairs.append((members[jpg], members[png]))
        self.size = len(self._pairs)

    def __getitem__(self, idx):
        if self._tar is not None:
            import io
            from PIL import Image
            jm, pm = self._pairs[idx]
            img = np.asarray(Image.open(io.BytesIO(
                self._tar.extractfile(jm).read())).convert("RGB"))
            mask = np.asarray(Image.open(io.BytesIO(
                self._tar.extractfile(pm).read())))
        else:
            img, mask = self._images[idx], self._masks[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, mask

    def __len__(self):
        return self.size


class Flowers(Dataset):
    """102-category flowers (reference
    ``python/paddle/vision/datasets/flowers.py``): items are
    ``(image, label)`` with the 1-based class id in an int64 [1] array.

    Real files: ``data_file`` = 102flowers.tgz (jpg/image_NNNNN.jpg),
    ``label_file`` = imagelabels.mat, ``setid_file`` = setid.mat
    (trnid/valid/tstid index lists).  Without paths: synthetic images
    over the real label space."""

    num_classes = 102
    # reference flowers.py:38 deliberately swaps trnid/tstid (the
    # dataset's test split outnumbers train ~6x, so 'train' uses tstid)
    _split_key = {"train": "tstid", "valid": "valid", "test": "trnid"}

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=False,
                 backend=None, size=None, seed=0):
        if mode not in self._split_key:
            raise ValueError(
                f"mode should be 'train', 'valid' or 'test', got {mode}")
        self.mode = mode
        self.transform = transform
        if data_file:
            if not (label_file and setid_file):
                raise ValueError("Flowers needs data_file + label_file + "
                                 "setid_file together")
            self._open(data_file, label_file, setid_file, mode)
            return
        if download:
            _no_download(type(self).__name__)
        self._tar = None
        self.size = (256 if mode == "train" else 64) if size is None \
            else size
        rng = np.random.default_rng(
            seed + {"train": 0, "valid": 1, "test": 2}[mode])
        self._images = rng.integers(0, 256, (self.size, 64, 64, 3),
                                    dtype=np.uint8)
        self.labels = rng.integers(1, self.num_classes + 1,
                                   (self.size,)).astype(np.int64)

    def _open(self, data_file, label_file, setid_file, mode):
        import tarfile
        import scipy.io
        self._tar = tarfile.open(data_file, "r:*")
        self._members = {m.name: m for m in self._tar.getmembers()
                         if m.isfile()}
        self.labels = np.asarray(
            scipy.io.loadmat(label_file)["labels"]).ravel() \
            .astype(np.int64)
        self.indexes = np.asarray(scipy.io.loadmat(setid_file)[
            self._split_key[mode]]).ravel().astype(np.int64)
        self.size = len(self.indexes)

    def __getitem__(self, idx):
        if self._tar is not None:
            import io
            from PIL import Image
            index = int(self.indexes[idx])
            name = "jpg/image_%05d.jpg" % index
            img = np.asarray(Image.open(io.BytesIO(
                self._tar.extractfile(self._members[name]).read()))
                .convert("RGB"))
            label = np.asarray([self.labels[index - 1]], np.int64)
        else:
            img = self._images[idx]
            label = np.asarray([self.labels[idx]], np.int64)
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return self.size
