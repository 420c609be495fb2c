"""YOLO training path — the JAX replacement for darknet's trainer.

The reference ships a full CNN *training* engine beside inference
(Thirdparty/darknet/src/detector.c:train_detector, network.c train_network /
get_current_rate :90, region_layer.c forward_region_layer :158 training
branch, yolo_layer.c forward_yolo_layer :132, batchnorm_layer.c :135,
convolutional_layer.c update path).  This module provides the same
capabilities as one jitted value-and-grad step over a device mesh:

* trainable forward pass with live batch-norm (batch statistics + darknet's
  0.99/0.01 rolling update, batchnorm_layer.c:143-146, eps added to the
  stddev per blas.c normalize_cpu :154);
* the region (YOLOv2) loss with darknet's exact assignment rules
  (region_layer.c:158-319): logistic x/y/objectness, softmax classes,
  noobject push-to-zero gated by best-IoU > thresh, 12800-seen burn-in pull
  to anchor priors, bias-matched best-anchor assignment at the truth cell,
  coord scale (2 - w*h), rescore option;
* the yolo (YOLOv3) loss (yolo_layer.c:93-220): ignore/truth thresholds,
  mask-selected anchors, per-class logistic;
* darknet's learning-rate policies (network.c get_current_rate :90):
  burn-in power ramp, constant/step/steps/exp/poly/sig;
* SGD with momentum + decoupled conv-weight decay, matching
  convolutional_layer update (axpy -decay*batch on weights only);
* data-parallel scaling: the train step is pure, so it shards over the
  ``data`` axis of a Mesh with a psum of gradients — the JAX analogue
  of darknet's (absent) multi-GPU path.

Deliberate divergence (documented, not accidental): darknet's
backward_region_layer/backward_yolo_layer pass deltas straight through the
head activations (their gradient_array calls are commented out,
region_layer.c:322-330).  We define the loss on the *activated* outputs and
let JAX autodiff apply the exact logistic/softmax Jacobians — strictly more
correct, same fixed points.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from stereo_semantic_vo_tpu.io import darknet
from stereo_semantic_vo_tpu.models.yolo import _leaky, _maxpool

MAX_TRUTHS = 30  # darknet l.truths = 30 boxes per image (region_layer.c:33)
BURN_IN_SEEN = 12800  # coord burn-in horizon (region_layer.c:255)


# --------------------------------------------------------------------------
# trainable forward (live batch-norm)
# --------------------------------------------------------------------------


def _conv_raw(x, w, stride):
    return jax.lax.conv_general_dilated(
        x, w, (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32,
    )


def _batchnorm(x, p, train: bool):
    """Darknet batch-norm (batchnorm_layer.c:135-155): per-channel mean over
    (N, H, W), Bessel-corrected variance (blas.c variance_cpu :112 divides by
    N-1); normalize by (sqrt(var) + 1e-6); rolling stats updated as
    0.99*rolling + 0.01*batch.

    Returns (y, new_mean, new_var) — rolling stats unchanged in eval mode.
    """
    if train:
        n = x.shape[0] * x.shape[1] * x.shape[2]
        mean = jnp.mean(x, axis=(0, 1, 2))
        var = jnp.sum(jnp.square(x - mean[None, None, None, :]), axis=(0, 1, 2)) / max(
            n - 1, 1
        )
        new_rm = 0.99 * p["mean"] + 0.01 * mean
        new_rv = 0.99 * p["var"] + 0.01 * var
    else:
        mean, var = p["mean"], p["var"]
        new_rm, new_rv = p["mean"], p["var"]
    inv = 1.0 / (jnp.sqrt(var) + 1e-6)
    y = (x - mean[None, None, None, :]) * (p["scales"] * inv)[None, None, None, :]
    return y + p["b"][None, None, None, :], new_rm, new_rv


def forward_train(
    params: dict[int, dict[str, Any]],
    sections: list[dict[str, Any]],
    x: jax.Array,
    train: bool = True,
) -> tuple[list[tuple[dict, jax.Array]], dict[int, dict[str, Any]]]:
    """Run the cfg graph with *unfolded* params on (B, H, W, 3) input.

    Returns ([(head_section, raw NHWC feature)...], params with updated
    rolling BN statistics).  Mirrors models.yolo.forward but keeps BN live
    so the graph is trainable (network.c forward_network :188 with
    net.train=1).
    """
    outputs: list[jax.Array] = []
    heads: list[tuple[dict, jax.Array]] = []
    new_params = dict(params)
    for li, sec in enumerate(sections[1:]):
        t = sec["type"]
        if t == "convolutional":
            p = params[li]
            x = _conv_raw(x, jnp.asarray(p["w"]), int(sec.get("stride", 1)))
            if "scales" in p:
                x, rm, rv = _batchnorm(x, jax.tree.map(jnp.asarray, p), train)
                np_ = dict(p)
                np_["mean"], np_["var"] = rm, rv
                new_params[li] = np_
            else:
                x = x + jnp.asarray(p["b"])[None, None, None, :]
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
    return heads, new_params


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------


class LossStats(NamedTuple):
    loss: jax.Array      # scalar: 0.5 * sum(delta^2) (darknet cost is sum)
    avg_iou: jax.Array   # mean IoU of assigned boxes
    recall: jax.Array    # fraction of truths with IoU > .5
    avg_obj: jax.Array   # mean objectness at assigned cells
    count: jax.Array     # number of assigned truths


def _iou_cxcywh(a, b):
    """IoU of [cx, cy, w, h] boxes, broadcasting (box.c box_iou)."""
    ax1, ax2 = a[..., 0] - a[..., 2] / 2, a[..., 0] + a[..., 2] / 2
    ay1, ay2 = a[..., 1] - a[..., 3] / 2, a[..., 1] + a[..., 3] / 2
    bx1, bx2 = b[..., 0] - b[..., 2] / 2, b[..., 0] + b[..., 2] / 2
    by1, by2 = b[..., 1] - b[..., 3] / 2, b[..., 1] + b[..., 3] / 2
    iw = jnp.maximum(jnp.minimum(ax2, bx2) - jnp.maximum(ax1, bx1), 0.0)
    ih = jnp.maximum(jnp.minimum(ay2, by2) - jnp.maximum(ay1, by1), 0.0)
    inter = iw * ih
    union = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    return inter / jnp.maximum(union, 1e-9)


def region_loss(
    feat: jax.Array,
    sec: dict,
    truths: jax.Array,
    truths_mask: jax.Array,
    seen: jax.Array | int = BURN_IN_SEEN,
) -> LossStats:
    """Darknet region-layer training loss, fully vectorized.

    feat: (B, H, W, A*(5+nc)) raw head output (NHWC).
    truths: (B, T, 5) [cx, cy, w, h, class] relative coords; truths_mask (B, T).
    seen: images seen so far (drives the <12800 coord burn-in,
    region_layer.c:255-263).

    Assignment semantics reproduced from region_layer.c:158-319:
      * every anchor cell gets noobject_scale*(0 - obj) unless its predicted
        box has best-IoU > thresh against any truth (:231-253);
      * burn-in pulls all coords to the anchor prior with scale .01 (:255);
      * each truth is assigned to its center cell and the anchor with best
        shape-IoU (bias_match, :268-288); coord scale is
        coord_scale*(2 - w*h) (:292), objectness target 1 (or IoU when
        rescore=1, :300-305), classes softmax/logistic one-hot (:310-313).
    Later truths overwrite earlier ones on collision — reproduced with a
    sequential scan over the T truth slots.
    """
    B, H, W, C = feat.shape
    A = int(sec.get("num", 5))
    nc = int(sec.get("classes", 1))
    anchors = jnp.asarray(
        np.asarray(sec.get("anchors", ()), np.float32).reshape(-1, 2)[:A]
    )  # grid-cell units
    object_scale = float(sec.get("object_scale", 5))
    noobject_scale = float(sec.get("noobject_scale", 1))
    class_scale = float(sec.get("class_scale", 1))
    coord_scale = float(sec.get("coord_scale", 1))
    thresh = float(sec.get("thresh", 0.6))
    rescore = int(sec.get("rescore", 0))
    bias_match = int(sec.get("bias_match", 0))
    use_softmax = int(sec.get("softmax", 0)) == 1

    f = feat.reshape(B, H, W, A, 5 + nc)
    sx = jax.nn.sigmoid(f[..., 0])
    sy = jax.nn.sigmoid(f[..., 1])
    tw = f[..., 2]
    th = f[..., 3]
    obj = jax.nn.sigmoid(f[..., 4])
    cls = jax.nn.softmax(f[..., 5:], axis=-1) if use_softmax else jax.nn.sigmoid(f[..., 5:])

    gx = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)[None, :, :, None]
    gy = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)[None, :, :, None]
    aw = anchors[:, 0][None, None, None, :]
    ah = anchors[:, 1][None, None, None, :]
    pred = jnp.stack(
        [(gx + sx) / W, (gy + sy) / H, jnp.exp(tw) * aw / W, jnp.exp(th) * ah / H],
        axis=-1,
    )  # (B, H, W, A, 4) relative

    # -- noobject term: best IoU of each predicted box against all truths ----
    t_boxes = jnp.where(truths_mask[..., None], truths[..., :4], 0.0)  # (B,T,4)
    iou_all = _iou_cxcywh(
        pred[:, :, :, :, None, :], t_boxes[:, None, None, None, :, :]
    )  # (B,H,W,A,T)
    iou_all = jnp.where(truths_mask[:, None, None, None, :], iou_all, 0.0)
    best_iou = jnp.max(iou_all, axis=-1) if truths.shape[1] else jnp.zeros_like(obj)
    d_noobj = jnp.where(best_iou > thresh, 0.0, noobject_scale * (0.0 - obj))

    # -- burn-in coord prior pull (region_layer.c:255-263) --------------------
    in_burn = jnp.asarray(seen) < BURN_IN_SEEN
    burn = 0.01
    d_burn_x = burn * (0.5 - sx)
    d_burn_y = burn * (0.5 - sy)
    d_burn_w = burn * (0.0 - tw)  # log(anchor/anchor) = 0
    d_burn_h = burn * (0.0 - th)
    zero = jnp.zeros_like(sx)
    d_x = jnp.where(in_burn, d_burn_x, zero)
    d_y = jnp.where(in_burn, d_burn_y, zero)
    d_w = jnp.where(in_burn, d_burn_w, zero)
    d_h = jnp.where(in_burn, d_burn_h, zero)
    d_obj = d_noobj
    d_cls = jnp.zeros_like(cls)

    # -- per-truth assignment (sequential: later truths overwrite) -----------
    bidx = jnp.arange(B)

    def assign(carry, t):
        d_x, d_y, d_w, d_h, d_obj, d_cls, iou_sum, rec, obj_sum, cnt = carry
        tb = truths[:, t, :]  # (B, 5)
        valid = truths_mask[:, t]
        ci = jnp.clip((tb[:, 0] * W).astype(jnp.int32), 0, W - 1)
        cj = jnp.clip((tb[:, 1] * H).astype(jnp.int32), 0, H - 1)
        # best anchor by shape IoU at origin (bias_match uses anchor w/h)
        cand_w = (anchors[:, 0] / W)[None, :] if bias_match else jnp.exp(tw[bidx, cj, ci]) * anchors[:, 0][None, :] / W
        cand_h = (anchors[:, 1] / H)[None, :] if bias_match else jnp.exp(th[bidx, cj, ci]) * anchors[:, 1][None, :] / H
        shape_pred = jnp.stack(
            [jnp.zeros_like(cand_w), jnp.zeros_like(cand_w), cand_w, cand_h], -1
        )  # (B, A, 4)
        shape_truth = jnp.concatenate(
            [jnp.zeros((B, 2)), tb[:, 2:4]], axis=-1
        )  # (B, 4)
        an = jnp.argmax(_iou_cxcywh(shape_pred, shape_truth[:, None, :]), axis=-1)

        scale = coord_scale * (2.0 - tb[:, 2] * tb[:, 3])
        tx = tb[:, 0] * W - ci.astype(jnp.float32)
        ty = tb[:, 1] * H - cj.astype(jnp.float32)
        tw_t = jnp.log(jnp.maximum(tb[:, 2] * W / anchors[an, 0], 1e-9))
        th_t = jnp.log(jnp.maximum(tb[:, 3] * H / anchors[an, 1], 1e-9))

        iou_t = _iou_cxcywh(pred[bidx, cj, ci, an], tb[:, :4])
        obj_here = obj[bidx, cj, ci, an]
        obj_target = (
            jax.lax.stop_gradient(iou_t) if rescore == 1 else jnp.ones_like(iou_t)
        )

        def setv(d, v):
            return d.at[bidx, cj, ci, an].set(jnp.where(valid, v, d[bidx, cj, ci, an]))

        d_x = setv(d_x, scale * (tx - sx[bidx, cj, ci, an]))
        d_y = setv(d_y, scale * (ty - sy[bidx, cj, ci, an]))
        d_w = setv(d_w, scale * (tw_t - tw[bidx, cj, ci, an]))
        d_h = setv(d_h, scale * (th_t - th[bidx, cj, ci, an]))
        d_obj = setv(d_obj, object_scale * (obj_target - obj_here))
        onehot = jax.nn.one_hot(tb[:, 4].astype(jnp.int32), nc)
        d_cls = d_cls.at[bidx, cj, ci, an].set(
            jnp.where(
                valid[:, None],
                class_scale * (onehot - cls[bidx, cj, ci, an]),
                d_cls[bidx, cj, ci, an],
            )
        )
        iou_sum = iou_sum + jnp.sum(jnp.where(valid, iou_t, 0.0))
        rec = rec + jnp.sum(jnp.where(valid & (iou_t > 0.5), 1.0, 0.0))
        obj_sum = obj_sum + jnp.sum(jnp.where(valid, obj_here, 0.0))
        cnt = cnt + jnp.sum(valid.astype(jnp.float32))
        return (d_x, d_y, d_w, d_h, d_obj, d_cls, iou_sum, rec, obj_sum, cnt), None

    T = truths.shape[1]
    (d_x, d_y, d_w, d_h, d_obj, d_cls, iou_sum, rec, obj_sum, cnt), _ = jax.lax.scan(
        assign,
        (d_x, d_y, d_w, d_h, d_obj, d_cls, 0.0, 0.0, 0.0, 0.0),
        jnp.arange(T),
    )

    sq = (
        jnp.sum(jnp.square(d_x))
        + jnp.sum(jnp.square(d_y))
        + jnp.sum(jnp.square(d_w))
        + jnp.sum(jnp.square(d_h))
        + jnp.sum(jnp.square(d_obj))
        + jnp.sum(jnp.square(d_cls))
    )
    safe = jnp.maximum(cnt, 1.0)
    return LossStats(0.5 * sq, iou_sum / safe, rec / safe, obj_sum / safe, cnt)


def yolo_loss(
    feat: jax.Array,
    sec: dict,
    truths: jax.Array,
    truths_mask: jax.Array,
    net_w: int,
    net_h: int,
) -> LossStats:
    """Darknet yolo-layer (v3) training loss (yolo_layer.c:132-220).

    Anchors in input pixels, mask-selected per head; every anchor cell gets
    (0 - obj) unless best-IoU > ignore_thresh; each truth assigned to its
    center cell and globally best shape anchor (only if that anchor belongs
    to this head's mask); coord scale (2 - w*h); per-class logistic one-hot.
    """
    B, H, W, C = feat.shape
    mask = sec.get("mask", (0, 1, 2))
    if not isinstance(mask, tuple):
        mask = (mask,)
    mask = tuple(int(m) for m in mask)
    A = len(mask)
    all_anchors = np.asarray(sec.get("anchors", ()), np.float32).reshape(-1, 2)
    anchors = jnp.asarray(all_anchors[list(mask)])  # (A, 2) input px
    all_anchors_j = jnp.asarray(all_anchors)  # (A_total, 2)
    nc = int(sec.get("classes", 1))
    ignore_thresh = float(sec.get("ignore_thresh", 0.5))
    truth_thresh = float(sec.get("truth_thresh", 1.0))

    f = feat.reshape(B, H, W, A, 5 + nc)
    sx = jax.nn.sigmoid(f[..., 0])
    sy = jax.nn.sigmoid(f[..., 1])
    tw = f[..., 2]
    th = f[..., 3]
    obj = jax.nn.sigmoid(f[..., 4])
    cls = jax.nn.sigmoid(f[..., 5:])

    gx = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)[None, :, :, None]
    gy = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)[None, :, :, None]
    pred = jnp.stack(
        [
            (gx + sx) / W,
            (gy + sy) / H,
            jnp.exp(tw) * anchors[:, 0][None, None, None, :] / net_w,
            jnp.exp(th) * anchors[:, 1][None, None, None, :] / net_h,
        ],
        axis=-1,
    )

    t_boxes = jnp.where(truths_mask[..., None], truths[..., :4], 0.0)
    iou_all = _iou_cxcywh(pred[:, :, :, :, None, :], t_boxes[:, None, None, None, :, :])
    iou_all = jnp.where(truths_mask[:, None, None, None, :], iou_all, 0.0)
    best_iou = jnp.max(iou_all, axis=-1)
    d_obj = jnp.where(best_iou > ignore_thresh, 0.0, 0.0 - obj)
    # truth_thresh branch (default 1 => never taken) intentionally elided
    del truth_thresh

    zero = jnp.zeros_like(sx)
    d_x, d_y, d_w, d_h = zero, zero, zero, zero
    d_cls = jnp.zeros_like(cls)
    bidx = jnp.arange(B)
    mask_arr = jnp.asarray(mask, jnp.int32)

    def assign(carry, t):
        d_x, d_y, d_w, d_h, d_obj, d_cls, iou_sum, rec, obj_sum, cnt = carry
        tb = truths[:, t, :]
        valid = truths_mask[:, t]
        ci = jnp.clip((tb[:, 0] * W).astype(jnp.int32), 0, W - 1)
        cj = jnp.clip((tb[:, 1] * H).astype(jnp.int32), 0, H - 1)
        # global best anchor by shape IoU (yolo_layer.c:199-210)
        shape_pred = jnp.stack(
            [
                jnp.zeros((B, all_anchors_j.shape[0])),
                jnp.zeros((B, all_anchors_j.shape[0])),
                jnp.broadcast_to(all_anchors_j[:, 0] / net_w, (B, all_anchors_j.shape[0])),
                jnp.broadcast_to(all_anchors_j[:, 1] / net_h, (B, all_anchors_j.shape[0])),
            ],
            -1,
        )
        shape_truth = jnp.concatenate([jnp.zeros((B, 2)), tb[:, 2:4]], axis=-1)
        best_n = jnp.argmax(_iou_cxcywh(shape_pred, shape_truth[:, None, :]), axis=-1)
        # position of best_n inside this head's mask, -1 if absent
        in_mask = mask_arr[None, :] == best_n[:, None]  # (B, A)
        an = jnp.argmax(in_mask, axis=-1)
        owned = jnp.any(in_mask, axis=-1)
        ok = valid & owned

        scale = 2.0 - tb[:, 2] * tb[:, 3]
        tx = tb[:, 0] * W - ci.astype(jnp.float32)
        ty = tb[:, 1] * H - cj.astype(jnp.float32)
        tw_t = jnp.log(jnp.maximum(tb[:, 2] * net_w / all_anchors_j[best_n, 0], 1e-9))
        th_t = jnp.log(jnp.maximum(tb[:, 3] * net_h / all_anchors_j[best_n, 1], 1e-9))
        iou_t = _iou_cxcywh(pred[bidx, cj, ci, an], tb[:, :4])
        obj_here = obj[bidx, cj, ci, an]

        def setv(d, v):
            return d.at[bidx, cj, ci, an].set(jnp.where(ok, v, d[bidx, cj, ci, an]))

        d_x = setv(d_x, scale * (tx - sx[bidx, cj, ci, an]))
        d_y = setv(d_y, scale * (ty - sy[bidx, cj, ci, an]))
        d_w = setv(d_w, scale * (tw_t - tw[bidx, cj, ci, an]))
        d_h = setv(d_h, scale * (th_t - th[bidx, cj, ci, an]))
        d_obj = setv(d_obj, 1.0 - obj_here)
        onehot = jax.nn.one_hot(tb[:, 4].astype(jnp.int32), nc)
        d_cls = d_cls.at[bidx, cj, ci, an].set(
            jnp.where(ok[:, None], onehot - cls[bidx, cj, ci, an], d_cls[bidx, cj, ci, an])
        )
        iou_sum = iou_sum + jnp.sum(jnp.where(ok, iou_t, 0.0))
        rec = rec + jnp.sum(jnp.where(ok & (iou_t > 0.5), 1.0, 0.0))
        obj_sum = obj_sum + jnp.sum(jnp.where(ok, obj_here, 0.0))
        cnt = cnt + jnp.sum(ok.astype(jnp.float32))
        return (d_x, d_y, d_w, d_h, d_obj, d_cls, iou_sum, rec, obj_sum, cnt), None

    (d_x, d_y, d_w, d_h, d_obj, d_cls, iou_sum, rec, obj_sum, cnt), _ = jax.lax.scan(
        assign,
        (d_x, d_y, d_w, d_h, d_obj, d_cls, 0.0, 0.0, 0.0, 0.0),
        jnp.arange(truths.shape[1]),
    )
    sq = (
        jnp.sum(jnp.square(d_x))
        + jnp.sum(jnp.square(d_y))
        + jnp.sum(jnp.square(d_w))
        + jnp.sum(jnp.square(d_h))
        + jnp.sum(jnp.square(d_obj))
        + jnp.sum(jnp.square(d_cls))
    )
    safe = jnp.maximum(cnt, 1.0)
    return LossStats(0.5 * sq, iou_sum / safe, rec / safe, obj_sum / safe, cnt)


# --------------------------------------------------------------------------
# learning-rate schedule (network.c get_current_rate :90)
# --------------------------------------------------------------------------


def learning_rate(net_sec: dict, batch_num) -> jax.Array:
    """Darknet's LR policy as a jittable function of the batch counter."""
    lr = float(net_sec.get("learning_rate", 1e-3))
    burn_in = int(net_sec.get("burn_in", 0))
    power = float(net_sec.get("power", 4))
    policy = str(net_sec.get("policy", "constant")).strip()
    b = jnp.asarray(batch_num, jnp.float32)

    if policy == "steps":
        steps = net_sec.get("steps", ())
        scales = net_sec.get("scales", ())
        if not isinstance(steps, tuple):
            steps, scales = (steps,), (scales,)
        rate = jnp.asarray(lr)
        for s, sc in zip(steps, scales):
            rate = jnp.where(b >= float(s), rate * float(sc), rate)
    elif policy == "step":
        rate = lr * jnp.power(
            float(net_sec.get("scale", 1.0)), jnp.floor(b / float(net_sec.get("step", 1)))
        )
    elif policy == "exp":
        rate = lr * jnp.power(float(net_sec.get("gamma", 1.0)), b)
    elif policy == "poly":
        mb = float(net_sec.get("max_batches", 1))
        rate = lr * jnp.power(jnp.maximum(1.0 - b / mb, 0.0), power)
    elif policy == "sig":
        gamma = float(net_sec.get("gamma", 1.0))
        step = float(net_sec.get("step", 1))
        rate = lr / (1.0 + jnp.exp(gamma * (b - step)))
    else:  # constant / random (random is for training-time jitter; use lr)
        rate = jnp.asarray(lr)

    if burn_in > 0:
        ramp = lr * jnp.power(b / burn_in, power)
        rate = jnp.where(b < burn_in, ramp, rate)
    return rate


# --------------------------------------------------------------------------
# trainer
# --------------------------------------------------------------------------


class TrainState(NamedTuple):
    params: Any          # {idx: {'w','b'[,'scales','mean','var']}} pytree
    momentum: Any        # same tree shape as the trainable leaves
    batch_num: jax.Array  # int32 optimizer steps (darknet *net.seen/batch)
    seen: jax.Array       # int32 images seen (drives region burn-in)


class YoloTrainer:
    """cfg-driven trainer: jitted SGD(momentum, decay) value-and-grad step.

    The JAX analogue of darknet's train_detector loop
    (detector.c:train_detector) minus the disk-based data loader: feed
    (images, truths, truths_mask) batches, get a new TrainState + stats.

    Trainable leaves are conv weights/biases and BN scales (darknet updates
    exactly these, convolutional_layer.c update_convolutional_layer); BN
    rolling mean/var follow the forward pass, not the gradient.  Weight decay
    hits conv weights only, scaled by batch size as darknet does
    (axpy -decay*batch).
    """

    def __init__(self, cfg_text: str, weights_bytes: bytes | None = None, seed: int = 0):
        self.sections = darknet.parse_cfg(cfg_text)
        net = self.sections[0]
        self.net_w = int(net.get("width", 416))
        self.net_h = int(net.get("height", 416))
        self.batch = int(net.get("batch", 1))
        self.momentum_coef = float(net.get("momentum", 0.9))
        self.decay = float(net.get("decay", 0.0))
        self.net_sec = net
        if weights_bytes is not None:
            raw = darknet.load_weights_raw(self.sections, weights_bytes)
        else:
            raw = darknet.random_weights_raw(self.sections, seed)
        params = jax.tree.map(jnp.asarray, raw)
        self.state = TrainState(
            params=params,
            momentum=jax.tree.map(
                jnp.zeros_like, {k: self._trainable(v) for k, v in params.items()}
            ),
            batch_num=jnp.asarray(0, jnp.int32),
            seen=jnp.asarray(0, jnp.int32),
        )
        self._step = jax.jit(self._make_step())

    @staticmethod
    def _trainable(p: dict) -> dict:
        out = {"w": p["w"], "b": p["b"]}
        if "scales" in p:
            out["scales"] = p["scales"]
        return out

    def _make_step(self):
        sections = self.sections
        net_sec = self.net_sec
        net_w, net_h = self.net_w, self.net_h
        mom_c, decay, batch = self.momentum_coef, self.decay, self.batch

        def loss_fn(params, images, truths, truths_mask, seen):
            heads, new_params = forward_train(params, sections, images, train=True)
            total = 0.0
            stats = None
            for sec, feat in heads:
                if sec["type"] == "region":
                    s = region_loss(feat, sec, truths, truths_mask, seen)
                else:
                    s = yolo_loss(feat, sec, truths, truths_mask, net_w, net_h)
                total = total + s.loss
                stats = s if stats is None else LossStats(
                    stats.loss + s.loss,
                    (stats.avg_iou + s.avg_iou) / 2,
                    (stats.recall + s.recall) / 2,
                    (stats.avg_obj + s.avg_obj) / 2,
                    stats.count + s.count,
                )
            return total, (stats, new_params)

        def step(state: TrainState, images, truths, truths_mask):
            (loss, (stats, fwd_params)), grads = jax.value_and_grad(
                loss_fn, has_aux=True
            )(state.params, images, truths, truths_mask, state.seen)
            lr = learning_rate(net_sec, state.batch_num)

            # darknet update (convolutional_layer.c:524-542):
            #   u_t = grad + decay*batch*w + momentum * u_{t-1}
            #   w  -= (lr / batch) * u_t
            # (the momentum buffer is scaled by `momentum` after each use, and
            # the learning rate stays OUTSIDE the buffer)
            new_params = {}
            new_mom = {}
            for idx, p in state.params.items():
                g = grads[idx]
                m = state.momentum[idx]
                fp = fwd_params[idx]
                np_, nm = dict(p), {}
                for key in m:
                    gk = g[key]
                    if key == "w" and decay > 0:
                        gk = gk + decay * batch * p[key]
                    u = gk + mom_c * m[key]
                    nm[key] = u
                    np_[key] = p[key] - (lr / batch) * u
                if "mean" in p:  # rolling stats follow the forward pass
                    np_["mean"], np_["var"] = fp["mean"], fp["var"]
                new_params[idx] = np_
                new_mom[idx] = nm
            new_state = TrainState(
                params=new_params,
                momentum=new_mom,
                batch_num=state.batch_num + 1,
                seen=state.seen + images.shape[0],
            )
            return new_state, loss, stats

        return step

    def train_step(self, images, truths, truths_mask):
        """images (B, H, W, 3) in [0,1] at net size; truths (B, T, 5)
        [cx,cy,w,h,class] relative; truths_mask (B, T) bool."""
        self.state, loss, stats = self._step(self.state, images, truths, truths_mask)
        return float(loss), stats

    def export_weights(self) -> bytes:
        """Serialize to darknet .weights (reference checkpoint format)."""
        raw = jax.tree.map(np.asarray, self.state.params)
        return darknet.save_weights_raw(self.sections, raw, seen=int(self.state.seen))

    def folded_params(self):
        """Inference params (BN folded) for models.yolo.YoloDetector."""
        raw = jax.tree.map(np.asarray, self.state.params)
        return darknet.fold_params(raw)
