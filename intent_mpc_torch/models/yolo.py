"""FastestDet-style person detector (the reference's YOLO helper; port of
intent_mpc_tpu/models/yolo.py).

The reference runs a ShuffleNetV2-backbone anchor-free detector
(onboard_detector/scripts/yolo_detector/: module/shufflenetv2.py,
module/custom_layers.py, module/detector.py, utils/tool.py handle_preds)
on the color image and feeds the "person" boxes into the dynamic
detector's YOLO fusion branch (perception.fuse_external_2d).

  * `FastestDet` is the network as an nn.Module tree whose state_dict keys
    are the reference checkpoint's own (backbone.first_conv.0.weight,
    backbone.stage2.0.branch_main.0.weight, ..., SPP.S3.6.weight,
    detect_head.cls_layers.conv5x5.4.running_var): ShuffleV2Block stages
    [4, 8, 4] with channels [24, 48, 96, 192], FPN-lite fusion (stage 4
    upsampled, stage 2 average-pooled, concatenated with stage 3), SPP with
    5x5 depthwise chains, and the obj / reg / cls DetectHead. The
    convolutions are PyTorch's (no Pallas kernel computes them in the JAX
    package either).
  * `decode` is handle_preds as fixed-shape tensors for a batch of images:
    grid decode (tanh center offsets, sigmoid sizes), score = obj^0.6 *
    clsmax^0.4, confidence mask, top-k by a stable descending sort (equal
    scores keep the lower cell index first, as lax.top_k does), and
    class-aware greedy NMS as a masked pass over the K kept boxes.
  * `person_rects` filters to one class id and emits [tlx, tly, w, h]
    image rectangles and a valid mask, the stream fuse_external_2d reads.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from intent_mpc_torch.utils.device import constant, f32, resolve_device
from intent_mpc_torch.utils.rounding import recip32

STAGE_REPEATS = (4, 8, 4)
STAGE_OUT = (-1, 24, 48, 96, 192)
INPUT_SIZE = 352
PERSON_CLASS = 0          # coco.names line 0 = "person"
NUM_CLASSES = 80


def _conv(cin, cout, k, stride=1, pad=0, groups=1):
    return nn.Conv2d(cin, cout, k, stride, pad, groups=groups, bias=False)


class ShuffleV2Block(nn.Module):
    """module/shufflenetv2.py ShuffleV2Block: a stride-2 block projects its
    whole input; a stride-1 block passes half its channels through and
    transforms the other half (channel shuffle first)."""

    def __init__(self, inp, oup, mid, stride):
        super().__init__()
        self.stride = stride
        outputs = oup - inp
        self.branch_main = nn.Sequential(
            _conv(inp, mid, 1), nn.BatchNorm2d(mid), nn.ReLU(inplace=True),
            _conv(mid, mid, 3, stride, 1, groups=mid), nn.BatchNorm2d(mid),
            _conv(mid, outputs, 1), nn.BatchNorm2d(outputs),
            nn.ReLU(inplace=True))
        if stride == 2:
            self.branch_proj = nn.Sequential(
                _conv(inp, inp, 3, stride, 1, groups=inp),
                nn.BatchNorm2d(inp),
                _conv(inp, inp, 1), nn.BatchNorm2d(inp), nn.ReLU(inplace=True))

    def forward(self, x):
        if self.stride == 1:
            x_proj, x2 = self.channel_shuffle(x)
            return torch.cat([x_proj, self.branch_main(x2)], dim=1)
        return torch.cat([self.branch_proj(x), self.branch_main(x)], dim=1)

    @staticmethod
    def channel_shuffle(x):
        n, c, h, w = x.shape
        x = x.reshape(n * c // 2, 2, h * w).permute(1, 0, 2)
        x = x.reshape(2, -1, c // 2, h, w)
        return x[0], x[1]


class ShuffleNetV2(nn.Module):
    def __init__(self):
        super().__init__()
        self.first_conv = nn.Sequential(
            _conv(3, STAGE_OUT[1], 3, 2, 1), nn.BatchNorm2d(STAGE_OUT[1]),
            nn.ReLU(inplace=True))
        self.maxpool = nn.MaxPool2d(kernel_size=3, stride=2, padding=1)
        inp = STAGE_OUT[1]
        for si, reps in enumerate(STAGE_REPEATS):
            oup = STAGE_OUT[si + 2]
            blocks = []
            for i in range(reps):
                if i == 0:
                    blocks.append(ShuffleV2Block(inp, oup, oup // 2, 2))
                else:
                    blocks.append(ShuffleV2Block(inp // 2, oup, oup // 2, 1))
                inp = oup
            setattr(self, "stage%d" % (si + 2), nn.Sequential(*blocks))

    def forward(self, x):
        x = self.maxpool(self.first_conv(x))
        p1 = self.stage2(x)
        p2 = self.stage3(p1)
        p3 = self.stage4(p2)
        return p1, p2, p3


class Conv1x1(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv1x1 = nn.Sequential(_conv(cin, cout, 1), nn.BatchNorm2d(cout),
                                     nn.ReLU(inplace=True))

    def forward(self, x):
        return self.conv1x1(x)


def _dw5(c, n):
    """n chained depthwise 5x5 conv + BN + ReLU triples."""
    layers = []
    for _ in range(n):
        layers += [_conv(c, c, 5, 1, 2, groups=c), nn.BatchNorm2d(c),
                   nn.ReLU(inplace=True)]
    return nn.Sequential(*layers)


class SPP(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.Conv1x1 = Conv1x1(cin, cout)
        self.S1 = _dw5(cout, 1)
        self.S2 = _dw5(cout, 2)
        self.S3 = _dw5(cout, 3)
        self.output = nn.Sequential(_conv(cout * 3, cout, 1),
                                    nn.BatchNorm2d(cout))

    def forward(self, x):
        x = self.Conv1x1(x)
        y = torch.cat([self.S1(x), self.S2(x), self.S3(x)], dim=1)
        return F.relu(x + self.output(y))


class Head(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv5x5 = nn.Sequential(
            _conv(cin, cin, 5, 1, 2, groups=cin), nn.BatchNorm2d(cin),
            nn.ReLU(inplace=True), _conv(cin, cout, 1), nn.BatchNorm2d(cout))

    def forward(self, x):
        return self.conv5x5(x)


class DetectHead(nn.Module):
    def __init__(self, c, num_classes):
        super().__init__()
        self.conv1x1 = Conv1x1(c, c)
        self.obj_layers = Head(c, 1)
        self.reg_layers = Head(c, 4)
        self.cls_layers = Head(c, num_classes)

    def forward(self, x):
        x = self.conv1x1(x)
        obj = torch.sigmoid(self.obj_layers(x))
        reg = self.reg_layers(x)
        cls = torch.softmax(self.cls_layers(x), dim=1)
        return torch.cat([obj, reg, cls], dim=1)


class FastestDet(nn.Module):
    """module/detector.py Detector: img (N, 3, 352, 352) in [0, 1] ->
    preds (N, 5 + C, 22, 22) (any multiple of 32 per side works)."""

    def __init__(self, num_classes: int = NUM_CLASSES):
        super().__init__()
        self.backbone = ShuffleNetV2()
        self.avg_pool = nn.AvgPool2d(kernel_size=3, stride=2, padding=1)
        self.SPP = SPP(sum(STAGE_OUT[-3:]), STAGE_OUT[-2])
        self.detect_head = DetectHead(STAGE_OUT[-2], num_classes)

    def forward(self, x):
        p1, p2, p3 = self.backbone(x)
        p3 = F.interpolate(p3, scale_factor=2, mode="nearest")
        p1 = self.avg_pool(p1)       # count_include_pad: the divisor is 9
        return self.detect_head(self.SPP(torch.cat([p1, p2, p3], dim=1)))


def random_params(seed: int, num_classes: int = NUM_CLASSES
                  ) -> Dict[str, np.ndarray]:
    """Seeded parameters in the JAX package's layout (the checkpoint's key
    names, numpy float32, no num_batches_tracked): He-scaled convolutions
    and batch norms near identity, so activations stay O(1) through the
    network. The reference checkpoint is not in the repository; these
    stand in for it."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in FastestDet(num_classes).state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        shape = tuple(v.shape)
        if len(shape) == 4:
            fan_in = shape[1] * shape[2] * shape[3]
            a = rng.normal(0.0, np.sqrt(2.0 / fan_in), shape)
        elif k.endswith(".weight") or k.endswith(".running_var"):
            a = rng.uniform(0.5, 1.0, shape)
        else:
            a = rng.normal(0.0, 0.1, shape)
        out[k] = a.astype(np.float32)
    return out


def build_detector(state_dict=None, num_classes: int = NUM_CLASSES,
                   device=None) -> FastestDet:
    """The network in eval mode (batch norms use their running stats) on
    the card unless `device` names another, with `state_dict` loaded
    (utils/convert.yolo_state_dict makes one from JAX-layout params)."""
    dev = resolve_device(device)
    net = FastestDet(num_classes)
    if state_dict is not None:
        net.load_state_dict(state_dict)
    return net.to(dev).eval()


class Detections(NamedTuple):
    boxes: torch.Tensor     # (N, K, 4) [x1, y1, x2, y2], normalized [0, 1]
    scores: torch.Tensor    # (N, K)
    classes: torch.Tensor   # (N, K) int32
    valid: torch.Tensor     # (N, K) bool


def decode(preds: torch.Tensor, conf_thresh: float = 0.65,
           nms_thresh: float = 0.45, max_det: int = 16) -> Detections:
    """handle_preds (utils/tool.py) for N images: preds (N, 5 + C, H, W) ->
    the top max_det boxes per image after class-aware greedy NMS."""
    N, _, H, W = preds.shape
    dev = preds.device
    pred = preds.permute(0, 2, 3, 1)                    # (N, H, W, 5 + C)
    pobj = pred[..., 0]
    preg = pred[..., 1:5]
    pcls = pred[..., 5:]
    clsmax, cat = torch.max(pcls, dim=-1)
    score = torch.pow(pobj, 0.6) * torch.pow(clsmax, 0.4)
    gy, gx = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    bw = torch.sigmoid(preg[..., 2])
    bh = torch.sigmoid(preg[..., 3])
    # the division by the grid size, as XLA folds it: times 1 / W in float32
    bcx = (torch.tanh(preg[..., 0]) + gx) * f32(recip32(W), dev)
    bcy = (torch.tanh(preg[..., 1]) + gy) * f32(recip32(H), dev)
    x1, y1 = bcx - 0.5 * bw, bcy - 0.5 * bh
    x2, y2 = bcx + 0.5 * bw, bcy + 0.5 * bh

    flat_score = torch.where(score > conf_thresh, score,
                             torch.zeros_like(score)).reshape(N, -1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1).reshape(N, -1, 4)
    cats = cat.reshape(N, -1)
    top_s, top_i = torch.sort(flat_score, dim=-1, descending=True, stable=True)
    top_s, top_i = top_s[:, :max_det], top_i[:, :max_det]
    b = torch.gather(boxes, 1, top_i[..., None].expand(N, max_det, 4))
    c = torch.gather(cats, 1, top_i).to(torch.int32)

    # class-aware greedy NMS (torchvision.ops.batched_nms): each class in
    # its own coordinate island, then plain greedy NMS over the
    # score-sorted top-k
    bb = b + c.to(torch.float32)[..., None] * 10.0
    area = torch.clamp(bb[..., 2] - bb[..., 0], min=0) \
        * torch.clamp(bb[..., 3] - bb[..., 1], min=0)
    xx1 = torch.maximum(bb[:, :, None, 0], bb[:, None, :, 0])
    yy1 = torch.maximum(bb[:, :, None, 1], bb[:, None, :, 1])
    xx2 = torch.minimum(bb[:, :, None, 2], bb[:, None, :, 2])
    yy2 = torch.minimum(bb[:, :, None, 3], bb[:, None, :, 3])
    ov = torch.clamp(xx2 - xx1, min=0) * torch.clamp(yy2 - yy1, min=0)
    iou = ov / torch.clamp(area[:, :, None] + area[:, None, :] - ov,
                           min=1e-9)                     # (N, K, K)
    over = iou > nms_thresh
    k_ar = torch.arange(max_det, device=dev)
    keep = top_s > 0.0
    for i in range(max_det):
        # i is suppressed if a higher-scored kept box overlaps it
        sup = torch.any((k_ar < i) & keep & over[:, i], dim=-1)
        keep = torch.where(k_ar == i, keep & ~sup[:, None], keep)
    return Detections(boxes=b, scores=top_s, classes=c, valid=keep)


def person_rects(det: Detections, img_w: int, img_h: int,
                 person_class: int = PERSON_CLASS
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Person-class detections as pixel-space [tlx, tly, w, h] rects
    (N, K, 4) and a valid mask (N, K): the det2d stream that
    perception.fuse_external_2d consumes (the reference's bbox_callback
    keeps target_classes == ["person"], yolo_detector.py:72-86)."""
    ok = det.valid & (det.classes == person_class)
    scale = constant((float(img_w), float(img_h), float(img_w),
                      float(img_h)), det.boxes.device)
    bx = det.boxes * scale
    rects = torch.stack([bx[..., 0], bx[..., 1], bx[..., 2] - bx[..., 0],
                         bx[..., 3] - bx[..., 1]], dim=-1)
    return rects, ok
