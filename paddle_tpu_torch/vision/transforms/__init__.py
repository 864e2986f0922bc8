"""Image transforms: a copy of ``paddle_tpu/vision/transforms`` (numpy on
HWC/HW arrays).  Random draws go through the global ``np.random``, so
one numpy seed gives the reference's crops, flips and jitters."""

from __future__ import annotations

import numpy as np

__all__ = ["Compose", "Normalize", "ToTensor", "Resize", "Transpose",
           "RandomHorizontalFlip", "RandomCrop"]


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class Normalize:
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)
        self.data_format = data_format

    def __call__(self, img):
        img = np.asarray(img, dtype=np.float32)
        if self.data_format == "CHW":
            mean = self.mean.reshape(-1, 1, 1)
            std = self.std.reshape(-1, 1, 1)
        else:
            mean = self.mean
            std = self.std
        return (img - mean) / std


class ToTensor:
    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def __call__(self, img):
        arr = np.asarray(img, dtype=np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[None] if self.data_format == "CHW" else arr[..., None]
        elif self.data_format == "CHW" and arr.shape[-1] in (1, 3, 4):
            arr = arr.transpose(2, 0, 1)
        return arr


class Transpose:
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def __call__(self, img):
        return np.asarray(img).transpose(self.order)


class Resize:
    def __init__(self, size, interpolation="bilinear"):
        self.size = size if isinstance(size, (tuple, list)) else (size, size)

    def __call__(self, img):
        arr = np.asarray(img)
        h, w = self.size
        # nearest resize (dependency-free)
        ih, iw = arr.shape[0], arr.shape[1]
        rows = (np.arange(h) * ih // h)
        cols = (np.arange(w) * iw // w)
        return arr[rows][:, cols]


class RandomHorizontalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            return np.asarray(img)[:, ::-1].copy()
        return img


class RandomCrop:
    def __init__(self, size, padding=0):
        self.size = size if isinstance(size, (tuple, list)) else (size, size)
        self.padding = padding

    def __call__(self, img):
        arr = np.asarray(img)
        if self.padding:
            pad = [(self.padding, self.padding), (self.padding, self.padding)]
            if arr.ndim == 3:
                pad.append((0, 0))
            arr = np.pad(arr, pad)
        h, w = self.size
        top = np.random.randint(0, arr.shape[0] - h + 1)
        left = np.random.randint(0, arr.shape[1] - w + 1)
        return arr[top:top + h, left:left + w]


class CenterCrop:
    """Crop the central region (reference transforms.CenterCrop)."""

    def __init__(self, size):
        self.size = size if isinstance(size, (tuple, list)) else (size, size)

    def __call__(self, img):
        arr = np.asarray(img)
        h, w = self.size
        if h > arr.shape[0] or w > arr.shape[1]:
            raise ValueError(
                f"CenterCrop size {self.size} exceeds image shape "
                f"{arr.shape[:2]}")
        top = (arr.shape[0] - h) // 2
        left = (arr.shape[1] - w) // 2
        return arr[top:top + h, left:left + w]


class RandomVerticalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            return np.asarray(img)[::-1].copy()
        return img


class Pad:
    """Pad HWC/HW images on all (or per-side) borders."""

    def __init__(self, padding, fill=0, padding_mode="constant"):
        if isinstance(padding, int):
            padding = (padding, padding, padding, padding)  # l, t, r, b
        elif len(padding) == 2:
            padding = (padding[0], padding[1], padding[0], padding[1])
        self.padding = padding
        self.fill = fill
        self.mode = padding_mode

    def __call__(self, img):
        arr = np.asarray(img)
        l, t, r, b = self.padding
        pad2d = [(t, b), (l, r)]
        if self.mode != "constant":
            pad = pad2d + ([(0, 0)] if arr.ndim == 3 else [])
            return np.pad(arr, pad, mode=self.mode)
        if isinstance(self.fill, (tuple, list)) and arr.ndim == 3:
            # per-channel fill color (reference accepts RGB tuples)
            return np.stack(
                [np.pad(arr[..., c], pad2d, constant_values=self.fill[c])
                 for c in range(arr.shape[-1])], axis=-1)
        pad = pad2d + ([(0, 0)] if arr.ndim == 3 else [])
        return np.pad(arr, pad, constant_values=self.fill)


class Grayscale:
    """HWC RGB -> grayscale with the ITU-R 601 luma weights."""

    def __init__(self, num_output_channels=1):
        self.num_output_channels = num_output_channels

    def __call__(self, img):
        arr = np.asarray(img, dtype=np.float32)
        if arr.ndim == 2:
            gray = arr
        else:
            gray = (0.299 * arr[..., 0] + 0.587 * arr[..., 1]
                    + 0.114 * arr[..., 2])
        gray = gray.astype(np.asarray(img).dtype)
        if self.num_output_channels == 3:
            return np.stack([gray] * 3, axis=-1)
        return gray[..., None]


def _jitter_range(value):
    """Reference semantics: scalar v -> [max(0, 1-v), 1+v]; (lo, hi) tuple
    passes through.  Returns None when the jitter is a no-op."""
    if isinstance(value, (tuple, list)):
        lo, hi = float(value[0]), float(value[1])
        if lo < 0 or lo > hi:
            raise ValueError(
                f"jitter range must satisfy 0 <= lo <= hi, got ({lo}, {hi})")
        if lo == hi == 1.0:
            return None
        return (lo, hi)
    if value == 0:
        return None
    return (max(0.0, 1.0 - value), 1.0 + value)


class BrightnessTransform:
    def __init__(self, value):
        self.range = _jitter_range(value)

    def __call__(self, img):
        if self.range is None:
            return img
        arr = np.asarray(img).astype(np.float32)
        alpha = np.random.uniform(*self.range)
        return np.clip(arr * alpha, 0, 255).astype(np.asarray(img).dtype)


class ContrastTransform:
    def __init__(self, value):
        self.range = _jitter_range(value)

    def __call__(self, img):
        if self.range is None:
            return img
        arr = np.asarray(img).astype(np.float32)
        alpha = np.random.uniform(*self.range)
        mean = arr.mean()
        return np.clip(mean + alpha * (arr - mean), 0, 255) \
            .astype(np.asarray(img).dtype)


class SaturationTransform:
    """Blend with the grayscale image (standard saturation jitter)."""

    def __init__(self, value):
        self.range = _jitter_range(value)

    def __call__(self, img):
        if self.range is None:
            return img
        arr = np.asarray(img).astype(np.float32)
        alpha = np.random.uniform(*self.range)
        gray = (0.299 * arr[..., 0] + 0.587 * arr[..., 1]
                + 0.114 * arr[..., 2])[..., None]
        return np.clip(gray + alpha * (arr - gray), 0, 255) \
            .astype(np.asarray(img).dtype)


class HueTransform:
    """Shift hue in HSV space (value in [0, 0.5], reference range)."""

    def __init__(self, value):
        if isinstance(value, (tuple, list)):
            lo, hi = float(value[0]), float(value[1])
            if not -0.5 <= lo <= hi <= 0.5:
                raise ValueError("hue range must lie in [-0.5, 0.5]")
            self.range = None if lo == hi == 0.0 else (lo, hi)
        else:
            if not 0 <= value <= 0.5:
                raise ValueError("hue value must be in [0, 0.5]")
            self.range = None if value == 0 else (-value, value)

    def __call__(self, img):
        if self.range is None:
            return img
        arr = np.asarray(img).astype(np.float32) / 255.0
        r, g, b = arr[..., 0], arr[..., 1], arr[..., 2]
        maxc = arr.max(-1)
        minc = arr.min(-1)
        v = maxc
        span = np.where(maxc > 0, maxc - minc, 0.0)
        s_ = np.where(maxc > 0, span / np.maximum(maxc, 1e-12), 0.0)
        safe = np.maximum(span, 1e-12)
        rc = (maxc - r) / safe
        gc = (maxc - g) / safe
        bc = (maxc - b) / safe
        h = np.where(r == maxc, bc - gc,
                     np.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
        h = (h / 6.0) % 1.0
        h = (h + np.random.uniform(*self.range)) % 1.0
        i = (h * 6.0).astype(np.int32) % 6
        f = h * 6.0 - np.floor(h * 6.0)
        p_ = v * (1.0 - s_)
        q_ = v * (1.0 - s_ * f)
        t_ = v * (1.0 - s_ * (1.0 - f))
        choices = [(v, t_, p_), (q_, v, p_), (p_, v, t_),
                   (p_, q_, v), (t_, p_, v), (v, p_, q_)]
        out = np.zeros_like(arr)
        for idx, (rr, gg, bb) in enumerate(choices):
            m = i == idx
            out[..., 0][m] = rr[m]
            out[..., 1][m] = gg[m]
            out[..., 2][m] = bb[m]
        return np.clip(out * 255.0, 0, 255).astype(np.asarray(img).dtype)


class ColorJitter:
    """Brightness/contrast/saturation/hue jitter (reference ColorJitter;
    saturation blends with luma, hue shifts in HSV)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self.transforms = [BrightnessTransform(brightness),
                           ContrastTransform(contrast),
                           SaturationTransform(saturation),
                           HueTransform(hue)]

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class RandomResizedCrop:
    """Random area/aspect crop then resize (reference semantics,
    nearest-neighbor resize)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
        self.size = size if isinstance(size, (tuple, list)) else (size, size)
        self.scale = scale
        self.ratio = ratio

    def __call__(self, img):
        arr = np.asarray(img)
        ih, iw = arr.shape[0], arr.shape[1]
        area = ih * iw
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            aspect = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                              np.log(self.ratio[1])))
            w = int(round(np.sqrt(target * aspect)))
            h = int(round(np.sqrt(target / aspect)))
            if 0 < w <= iw and 0 < h <= ih:
                top = np.random.randint(0, ih - h + 1)
                left = np.random.randint(0, iw - w + 1)
                crop = arr[top:top + h, left:left + w]
                return Resize(self.size)(crop)
        return Resize(self.size)(CenterCrop((min(ih, iw),) * 2)(arr))


__all__ += ["CenterCrop", "RandomVerticalFlip", "Pad", "Grayscale",
            "BrightnessTransform", "ContrastTransform",
            "SaturationTransform", "HueTransform", "ColorJitter",
            "RandomResizedCrop"]
