"""YOLO detector family as a cfg-driven JAX CNN.

Replaces darknet's C/CUDA inference engine (Thirdparty/darknet/src/network.c
forward_network :188 / forward_network_gpu :762, convolutional cudnn kernels)
with XLA: conv-BN(folded)-leaky blocks in NHWC feeding cuDNN/XLA convolutions, maxpool via
reduce_window, region (YOLOv2, region_layer.c:76-90 box decode) and yolo
(YOLOv3) heads, letterboxing (yolo_v3.c YoloDetect), and fixed-shape greedy
NMS (box.c do_nms_sort semantics, IoU 0.45).

The shipped KITTI model is yolov2-tiny 352x352, 1 class
(bin/kitti/yolov2-tiny.cfg); yolov3-style route/shortcut/upsample layers are
supported for the full-size models.  Weights come from io/darknet.py (folded
BN) or random init for benchmarks.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from stereo_semantic_vo_tpu.io import darknet


class Detections(NamedTuple):
    boxes: jax.Array   # (N, 4) [x1, y1, x2, y2] in original-image pixels
    scores: jax.Array  # (N,)
    classes: jax.Array  # (N,) int32
    valid: jax.Array   # (N,) bool


def _leaky(x):
    return jnp.where(x > 0, x, 0.1 * x)


def _conv(x, w, b, stride):
    # NHWC x HWIO -> NHWC
    pad = "SAME"
    y = jax.lax.conv_general_dilated(
        x, w, (stride, stride), pad,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32,
    )
    return y + b[None, None, None, :]


def _maxpool(x, size, stride):
    if size == 2 and stride == 1:
        # darknet pads right/bottom to keep the spatial size
        pads = ((0, 0), (0, 1), (0, 1), (0, 0))
    else:
        pads = ((0, 0), (0, 0), (0, 0), (0, 0))
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (1, size, size, 1), (1, stride, stride, 1), pads
    )


def forward(
    params: dict[int, dict[str, np.ndarray]],
    sections: list[dict[str, Any]],
    x: jax.Array,
) -> list[tuple[dict, jax.Array]]:
    """Run the cfg graph on (B, H, W, 3) input in [0, 1].

    Returns [(head_section, raw_feature_map NHWC), ...] for every
    region/yolo head (yolov3 has several).
    """
    outputs: list[jax.Array] = []
    heads: list[tuple[dict, jax.Array]] = []
    for li, sec in enumerate(sections[1:]):
        t = sec["type"]
        if t == "convolutional":
            p = params[li]
            w = jnp.asarray(p["w"])
            b = jnp.asarray(p["b"])
            x = _conv(x, w, b, int(sec.get("stride", 1)))
            if sec.get("activation", "linear") == "leaky":
                x = _leaky(x)
        elif t == "maxpool":
            x = _maxpool(x, int(sec.get("size", 2)), int(sec.get("stride", 2)))
        elif t == "route":
            layers = sec.get("layers", ())
            if not isinstance(layers, tuple):
                layers = (layers,)
            idxs = [l if l >= 0 else li + l for l in layers]
            x = jnp.concatenate([outputs[i] for i in idxs], axis=-1)
        elif t == "shortcut":
            frm = int(sec["from"])
            idx = frm if frm >= 0 else li + frm
            x = x + outputs[idx]
            if sec.get("activation", "linear") == "leaky":
                x = _leaky(x)
        elif t == "upsample":
            s = int(sec.get("stride", 2))
            B, H, W, C = x.shape
            x = jax.image.resize(x, (B, H * s, W * s, C), "nearest")
        elif t in ("region", "yolo"):
            heads.append((sec, x))
        outputs.append(x)
    return heads


def decode_head(
    sec: dict, feat: jax.Array, num_classes: int
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Decode one region/yolo head -> (boxes_rel (N,4) cx,cy,w,h in [0,1] of
    the network input, scores (N, classes), objectness (N,)).

    region (v2): anchors in grid-cell units, softmax classes
      (region_layer.c:76-83: bx=(i+sig tx)/W, bw=exp(tw)*anchor/W).
    yolo (v3): anchors in input pixels (mask-selected), sigmoid classes.
    """
    B, H, W, C = feat.shape
    is_region = sec["type"] == "region"
    anchors = np.asarray(sec.get("anchors", ()), np.float32).reshape(-1, 2)
    if is_region:
        n_anchor = int(sec.get("num", 5))
    else:
        mask = sec.get("mask", (0, 1, 2))
        if not isinstance(mask, tuple):
            mask = (mask,)
        anchors = anchors[list(mask)]
        n_anchor = len(mask)
    nc = num_classes
    # darknet layout is NCHW with channel blocks per anchor; our NHWC feat
    # has C = n_anchor * (5 + nc) with the same per-anchor block order
    f = feat.reshape(B, H, W, n_anchor, 5 + nc)
    tx, ty, tw, th, tobj = (f[..., 0], f[..., 1], f[..., 2], f[..., 3], f[..., 4])
    tcls = f[..., 5:]

    gx = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)[None, :, :, None]
    gy = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)[None, :, :, None]
    bx = (gx + jax.nn.sigmoid(tx)) / W
    by = (gy + jax.nn.sigmoid(ty)) / H
    aw = jnp.asarray(anchors[:, 0])[None, None, None, :]
    ah = jnp.asarray(anchors[:, 1])[None, None, None, :]
    if is_region:
        bw = jnp.exp(tw) * aw / W
        bh = jnp.exp(th) * ah / H
    else:
        net_w = float(sec.get("_net_w", 416))
        net_h = float(sec.get("_net_h", 416))
        bw = jnp.exp(tw) * aw / net_w
        bh = jnp.exp(th) * ah / net_h
    obj = jax.nn.sigmoid(tobj)
    if is_region and int(sec.get("softmax", 0)) == 1:
        cls = jax.nn.softmax(tcls, axis=-1)
    else:
        cls = jax.nn.sigmoid(tcls)
    boxes = jnp.stack([bx, by, bw, bh], axis=-1).reshape(B, -1, 4)
    return boxes, cls.reshape(B, -1, nc), obj.reshape(B, -1)


def iou_xyxy(a: jax.Array, b: jax.Array) -> jax.Array:
    """(N, 4) x (M, 4) -> (N, M) IoU for [x1,y1,x2,y2] boxes."""
    x1 = jnp.maximum(a[:, None, 0], b[None, :, 0])
    y1 = jnp.maximum(a[:, None, 1], b[None, :, 1])
    x2 = jnp.minimum(a[:, None, 2], b[None, :, 2])
    y2 = jnp.minimum(a[:, None, 3], b[None, :, 3])
    inter = jnp.maximum(x2 - x1, 0) * jnp.maximum(y2 - y1, 0)
    area_a = jnp.maximum(a[:, 2] - a[:, 0], 0) * jnp.maximum(a[:, 3] - a[:, 1], 0)
    area_b = jnp.maximum(b[:, 2] - b[:, 0], 0) * jnp.maximum(b[:, 3] - b[:, 1], 0)
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / jnp.maximum(union, 1e-9)


def nms_fixed(
    boxes: jax.Array, scores: jax.Array, max_out: int, iou_th: float
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Greedy NMS with static shapes: pick max_out boxes by score, suppressing
    overlaps > iou_th (do_nms_sort semantics, box.c:58).  Returns
    (boxes (max_out, 4), scores (max_out,), valid (max_out,))."""
    N = boxes.shape[0]
    iou = iou_xyxy(boxes, boxes)

    def body(carry, _):
        alive_scores, = carry
        i = jnp.argmax(alive_scores)
        s = alive_scores[i]
        keep = s > 0.0
        suppress = iou[i] > iou_th
        new_scores = jnp.where(suppress | (jnp.arange(N) == i), 0.0, alive_scores)
        new_scores = jnp.where(keep, new_scores, alive_scores)
        return (new_scores,), (boxes[i], s, keep)

    (_,), (b, s, v) = jax.lax.scan(body, (scores,), None, length=max_out)
    return b, s, v


@functools.partial(jax.jit, static_argnames=("net_w", "net_h", "img_w", "img_h"))
def letterbox(img: jax.Array, net_w: int, net_h: int, img_w: int, img_h: int) -> jax.Array:
    """(H, W, 3) [0,1] -> (net_h, net_w, 3), aspect-preserving, 0.5-padded
    (darknet letterbox_image, image.c)."""
    scale = min(net_w / img_w, net_h / img_h)
    new_w = int(img_w * scale)
    new_h = int(img_h * scale)
    resized = jax.image.resize(img, (new_h, new_w, 3), "linear")
    out = jnp.full((net_h, net_w, 3), 0.5, img.dtype)
    oy = (net_h - new_h) // 2
    ox = (net_w - new_w) // 2
    return jax.lax.dynamic_update_slice(out, resized, (oy, ox, 0))


def unletterbox_boxes(
    boxes_rel: jax.Array, net_w: int, net_h: int, img_w: int, img_h: int
) -> jax.Array:
    """(N, 4) cx,cy,w,h relative to net input -> (N, 4) x1y1x2y2 image px."""
    scale = min(net_w / img_w, net_h / img_h)
    new_w = img_w * scale
    new_h = img_h * scale
    ox = (net_w - new_w) / 2.0
    oy = (net_h - new_h) / 2.0
    cx = (boxes_rel[:, 0] * net_w - ox) / scale
    cy = (boxes_rel[:, 1] * net_h - oy) / scale
    w = boxes_rel[:, 2] * net_w / scale
    h = boxes_rel[:, 3] * net_h / scale
    return jnp.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=-1)


class YoloDetector:
    """cfg + weights -> a jitted detect(image) -> Detections callable.

    The on-device replacement for the reference's Semantic thread
    (src/semantic.cc) — detection is a pure jitted call inside the frame
    step, not an unsynchronized producer/consumer thread.
    """

    def __init__(
        self,
        cfg_text: str,
        weights_bytes: bytes | None = None,
        conf_threshold: float = 0.8,
        nms_iou: float = 0.45,
        max_boxes: int = 32,
        seed: int = 0,
    ):
        self.sections = darknet.parse_cfg(cfg_text)
        net = self.sections[0]
        self.net_w = int(net.get("width", 416))
        self.net_h = int(net.get("height", 416))
        for sec in self.sections:
            if sec["type"] in ("region", "yolo"):
                sec["_net_w"] = self.net_w
                sec["_net_h"] = self.net_h
                self.num_classes = int(sec.get("classes", 1))
        if weights_bytes is not None:
            self.params = darknet.load_weights(self.sections, weights_bytes)
        else:
            self.params = darknet.random_weights(self.sections, seed)
        self.conf_threshold = conf_threshold
        self.nms_iou = nms_iou
        self.max_boxes = max_boxes
        self._jit_cache: dict[tuple[int, int], Any] = {}

    def _build(self, img_h: int, img_w: int):
        sections = self.sections
        params = self.params
        nc = self.num_classes

        def detect(img):  # (H, W, 3) float32 [0,1]
            x = letterbox(img, self.net_w, self.net_h, img_w, img_h)[None]
            heads = forward(params, sections, x)
            all_boxes, all_scores, all_cls = [], [], []
            for sec, feat in heads:
                boxes, cls, obj = decode_head(sec, feat, nc)
                score = obj[..., None] * cls  # (1, N, nc)
                best_c = jnp.argmax(score[0], axis=-1)
                best_s = jnp.max(score[0], axis=-1)
                all_boxes.append(boxes[0])
                all_scores.append(best_s)
                all_cls.append(best_c)
            boxes = jnp.concatenate(all_boxes)
            scores = jnp.concatenate(all_scores)
            classes = jnp.concatenate(all_cls)
            scores = jnp.where(scores >= self.conf_threshold, scores, 0.0)
            boxes_px = unletterbox_boxes(boxes, self.net_w, self.net_h, img_w, img_h)
            b, s, v = nms_fixed(boxes_px, scores, self.max_boxes, self.nms_iou)
            cls_out = classes[jnp.argmax(iou_xyxy(b, boxes_px), axis=1)]
            return Detections(boxes=b, scores=s, classes=cls_out, valid=v)

        return jax.jit(detect)

    def detect(self, img: jax.Array) -> Detections:
        """img: (H, W, 3) float32 in [0, 1] (or grayscale (H, W))."""
        if img.ndim == 2:
            img = jnp.stack([img, img, img], axis=-1)
        key = (img.shape[0], img.shape[1])
        if key not in self._jit_cache:
            self._jit_cache[key] = self._build(*key)
        return self._jit_cache[key](img)
