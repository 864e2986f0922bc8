"""PP-OCR-style text detection + recognition models (BASELINE config 4:
"PP-OCRv4 det+rec").

Capability analogue of PaddleOCR's DB text detector (MobileNetV3-ish
backbone -> DBFPN neck -> DB head with differentiable binarization,
arXiv:1911.08947) and CRNN/SVTR-style recognizer (conv feature extractor
-> BiLSTM encoder -> CTC head), trained with the framework's own
``F.ctc_loss``.  All forwards are static-shape; the (inherently
data-dependent) box extraction post-process runs on host like the
reference's C++/numpy postprocess ops.

Port of ``paddle_tpu/models/ocr.py``: the same layers, names and
forwards over the port's ``nn``; each model is built on ``meta`` and
materialized once on ``device=`` (the card unless ``"cpu"``) from
``seed=``.  ``db_postprocess`` and ``ctc_greedy_decode`` are the
reference's host code, copied (they read a tensor through numpy).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import torch

from .. import nn
from ..nn import functional as F
from ..nn.common import built_on_meta


class _ConvBNAct(nn.Layer):
    def __init__(self, in_c, out_c, k, stride=1, groups=1, act="hardswish"):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, k, stride=stride,
                              padding=(k - 1) // 2, groups=groups,
                              bias_attr=False)
        self.bn = nn.BatchNorm2D(out_c)
        self._act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        if self._act == "hardswish":
            return F.hardswish(x)
        if self._act == "relu":
            return F.relu(x)
        return x


class _DetBackbone(nn.Layer):
    """Compact 4-stage conv backbone emitting {1/4, 1/8, 1/16, 1/32}
    features (the role MobileNetV3 plays in PP-OCR det)."""

    def __init__(self, in_channels=3, scale=0.5):
        super().__init__()
        c = [int(16 * scale * m) for m in (1, 2, 4, 8, 12)]
        self.stem = _ConvBNAct(in_channels, c[0], 3, stride=2)
        self.stage1 = nn.Sequential(_ConvBNAct(c[0], c[1], 3, stride=2),
                                    _ConvBNAct(c[1], c[1], 3))
        self.stage2 = nn.Sequential(_ConvBNAct(c[1], c[2], 3, stride=2),
                                    _ConvBNAct(c[2], c[2], 3))
        self.stage3 = nn.Sequential(_ConvBNAct(c[2], c[3], 3, stride=2),
                                    _ConvBNAct(c[3], c[3], 3))
        self.stage4 = nn.Sequential(_ConvBNAct(c[3], c[4], 3, stride=2),
                                    _ConvBNAct(c[4], c[4], 3))
        self.out_channels = [c[1], c[2], c[3], c[4]]

    def forward(self, x):
        x = self.stem(x)
        c2 = self.stage1(x)
        c3 = self.stage2(c2)
        c4 = self.stage3(c3)
        c5 = self.stage4(c4)
        return c2, c3, c4, c5


class DBFPN(nn.Layer):
    """DB feature pyramid: lateral 1x1 + top-down upsample-add, then each
    level reduced and upsampled to 1/4 scale and concatenated (PaddleOCR
    ppocr/modeling/necks/db_fpn.py)."""

    def __init__(self, in_channels, out_channels=96):
        super().__init__()
        self.out_channels = out_channels
        self.lat = nn.LayerList([
            nn.Conv2D(c, out_channels, 1, bias_attr=False)
            for c in in_channels])
        self.smooth = nn.LayerList([
            nn.Conv2D(out_channels, out_channels // 4, 3, padding=1,
                      bias_attr=False)
            for _ in in_channels])

    def forward(self, feats):
        c2, c3, c4, c5 = feats
        p5 = self.lat[3](c5)
        p4 = self.lat[2](c4) + F.interpolate(p5, scale_factor=2,
                                             mode="nearest")
        p3 = self.lat[1](c3) + F.interpolate(p4, scale_factor=2,
                                             mode="nearest")
        p2 = self.lat[0](c2) + F.interpolate(p3, scale_factor=2,
                                             mode="nearest")
        outs = [self.smooth[0](p2),
                F.interpolate(self.smooth[1](p3), scale_factor=2,
                              mode="nearest"),
                F.interpolate(self.smooth[2](p4), scale_factor=4,
                              mode="nearest"),
                F.interpolate(self.smooth[3](p5), scale_factor=8,
                              mode="nearest")]
        return torch.cat(outs, dim=1)


class DBHead(nn.Layer):
    """Probability + threshold maps; approximate binary map
    B = 1 / (1 + exp(-k (P - T))) (differentiable binarization)."""

    def __init__(self, in_channels, k=50):
        super().__init__()
        self.k = k
        self.prob = self._branch(in_channels)
        self.thresh = self._branch(in_channels)

    @staticmethod
    def _branch(c):
        return nn.Sequential(
            nn.Conv2D(c, c // 4, 3, padding=1, bias_attr=False),
            nn.BatchNorm2D(c // 4), nn.ReLU(),
            nn.Conv2DTranspose(c // 4, c // 4, 2, stride=2),
            nn.BatchNorm2D(c // 4), nn.ReLU(),
            nn.Conv2DTranspose(c // 4, 1, 2, stride=2),
            nn.Sigmoid())

    def forward(self, x):
        p = self.prob(x)
        if not self.training:
            return {"maps": p}
        t = self.thresh(x)
        binary = F.sigmoid(self.k * (p - t))
        return {"maps": torch.cat([p, t, binary], dim=1)}


@dataclass
class DBNetConfig:
    in_channels: int = 3
    backbone_scale: float = 0.5
    fpn_channels: int = 96
    k: int = 50


class DBNet(nn.Layer):
    """DB text detector (det branch of PP-OCR)."""

    @built_on_meta
    def __init__(self, config: DBNetConfig = None):
        super().__init__()
        config = config or DBNetConfig()
        self.backbone = _DetBackbone(config.in_channels,
                                     config.backbone_scale)
        self.neck = DBFPN(self.backbone.out_channels, config.fpn_channels)
        self.head = DBHead(config.fpn_channels, config.k)

    def forward(self, x):
        return self.head(self.neck(self.backbone(x)))


class DBLoss(nn.Layer):
    """BCE on the probability map + L1 on the threshold map + dice on the
    binary map (PaddleOCR DBLoss, weights 5/10/1 simplified)."""

    def __init__(self, alpha=5.0, beta=10.0, eps=1e-6):
        super().__init__()
        self.alpha, self.beta, self.eps = alpha, beta, eps

    def forward(self, preds, gt_prob, gt_thresh=None, gt_mask=None):
        maps = preds["maps"]
        p, t, b = maps[:, 0:1], maps[:, 1:2], maps[:, 2:3]
        bce = F.binary_cross_entropy(p, gt_prob)
        loss = self.alpha * bce
        if gt_thresh is not None:
            loss = loss + self.beta * (t - gt_thresh).abs().mean()
        inter = (b * gt_prob).sum()
        union = b.sum() + gt_prob.sum() + self.eps
        dice = 1.0 - 2.0 * inter / union
        return loss + dice


def _host(t):
    """A tensor (any device) or array as a numpy array."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t)


def db_postprocess(prob_map, bitmap_thresh=0.3, box_thresh=0.6,
                   min_size=3):
    """Extract axis-aligned text boxes from the probability map (host op;
    simplified flood-fill connected components vs the reference's
    pyclipper polygon path)."""
    pm = _host(prob_map)
    results = []
    for img in pm[:, 0]:  # [H, W]
        mask = img > bitmap_thresh
        visited = np.zeros_like(mask, bool)
        boxes = []
        h, w = mask.shape
        for sy in range(h):
            for sx in range(w):
                if not mask[sy, sx] or visited[sy, sx]:
                    continue
                stack = [(sy, sx)]
                visited[sy, sx] = True
                ys, xs = [], []
                while stack:
                    y, x = stack.pop()
                    ys.append(y)
                    xs.append(x)
                    for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                        ny, nx = y + dy, x + dx
                        if (0 <= ny < h and 0 <= nx < w and mask[ny, nx]
                                and not visited[ny, nx]):
                            visited[ny, nx] = True
                            stack.append((ny, nx))
                y1, y2 = min(ys), max(ys)
                x1, x2 = min(xs), max(xs)
                if (y2 - y1 + 1) < min_size or (x2 - x1 + 1) < min_size:
                    continue
                score = float(img[y1:y2 + 1, x1:x2 + 1].mean())
                if score >= box_thresh:
                    boxes.append([x1, y1, x2 + 1, y2 + 1, score])
        results.append(np.asarray(boxes, np.float32).reshape(-1, 5))
    return results


# ---------------------------------------------------------------- recognition

@dataclass
class CRNNConfig:
    in_channels: int = 3
    num_classes: int = 97       # charset + blank
    hidden_size: int = 96
    image_height: int = 32


class CRNN(nn.Layer):
    """CRNN recognizer: conv stack (height-collapsing) -> BiLSTM -> CTC
    logits [T, B, num_classes] (PaddleOCR rec_crnn architecture)."""

    @built_on_meta
    def __init__(self, config: CRNNConfig = None):
        super().__init__()
        config = config or CRNNConfig()
        self.config = config
        ch = (64, 128, 256, 256)
        self.convs = nn.Sequential(
            _ConvBNAct(config.in_channels, ch[0], 3, act="relu"),
            nn.MaxPool2D(2, 2),                       # H/2, W/2
            _ConvBNAct(ch[0], ch[1], 3, act="relu"),
            nn.MaxPool2D(2, 2),                       # H/4, W/4
            _ConvBNAct(ch[1], ch[2], 3, act="relu"),
            _ConvBNAct(ch[2], ch[3], 3, act="relu"),
            nn.MaxPool2D((2, 1), (2, 1)),             # H/8, W/4
        )
        feat_h = config.image_height // 8
        self.encoder = nn.LSTM(ch[3] * feat_h, config.hidden_size,
                               direction="bidirect")
        self.fc = nn.Linear(2 * config.hidden_size, config.num_classes)

    def forward(self, x):
        feat = self.convs(x)                     # [B, C, H', W']
        b, c, h, w = feat.shape
        feat = feat.permute(0, 3, 1, 2).reshape(b, w, c * h)
        out, _ = self.encoder(feat)              # [B, W', 2*hidden]
        logits = self.fc(out)                    # [B, T, num_classes]
        return logits


class CTCHeadLoss(nn.Layer):
    """CTC loss over CRNN logits (blank = 0, reference warpctc parity)."""

    def __init__(self, blank: int = 0):
        super().__init__()
        self.blank = blank

    def forward(self, logits, labels, label_lengths):
        # logits [B, T, C] -> log_probs [T, B, C]
        log_probs = F.log_softmax(logits.transpose(0, 1), axis=-1)
        t, b = log_probs.shape[0], log_probs.shape[1]
        input_lengths = torch.full((b,), t, dtype=torch.int64,
                                   device=logits.device)
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          blank=self.blank, reduction="mean")


def ctc_greedy_decode(logits, blank: int = 0):
    """Greedy CTC decode: argmax per step, collapse repeats, drop blanks.
    Host op (variable-length output)."""
    arr = _host(logits)
    preds = arr.argmax(axis=-1)  # [B, T]
    out = []
    for seq in preds:
        collapsed = []
        prev = None
        for s in seq:
            if s != prev and s != blank:
                collapsed.append(int(s))
            prev = s
        out.append(collapsed)
    return out


class PPOCRSystem(nn.Layer):
    """det+rec pipeline facade: detect boxes, crop, recognize.  A model
    not given is built at its default config on ``device=`` (the card
    unless ``"cpu"``) from ``seed=``; given ones are kept as they are."""

    def __init__(self, det: DBNet = None, rec: CRNN = None, *, device=None,
                 seed=0):
        super().__init__()
        self.det = det or DBNet(device=device, seed=seed)
        self.rec = rec or CRNN(device=device, seed=seed)

    def forward(self, images):
        det_out = self.det(images)
        return det_out

    def recognize_crops(self, crops):
        return self.rec(crops)
