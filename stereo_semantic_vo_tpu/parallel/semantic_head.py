"""Replicated semantic-detection head over the device mesh.

SURVEY.md §2.3 item 3 / BASELINE.json: "replicating the semantic-detection
head per host".  The YOLO weights are replicated; frames are sharded over the
``data`` axis, so every device runs detection on its own stream — the
on-device analogue of the reference's one-GPU-per-process darknet thread
(src/semantic.cc), with no shared mutable state to race on.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from stereo_semantic_vo_tpu.io import darknet
from stereo_semantic_vo_tpu.models import yolo
from stereo_semantic_vo_tpu.parallel.mesh import DATA_AXIS


def make_replicated_detector(
    mesh: Mesh,
    cfg_text: str,
    weights_bytes: bytes | None = None,
    conf_threshold: float = 0.8,
    nms_iou: float = 0.45,
    max_boxes: int = 32,
    img_hw: tuple[int, int] = (376, 1241),
):
    """Returns detect_batch(images (B, H, W, 3) in [0,1]) -> Detections with a
    leading batch axis, B sharded over the mesh's data axis; weights
    replicated.  B must be a multiple of the mesh size."""
    sections = darknet.parse_cfg(cfg_text)
    net = sections[0]
    net_w, net_h = int(net.get("width", 416)), int(net.get("height", 416))
    num_classes = 1
    for sec in sections:
        if sec["type"] in ("region", "yolo"):
            sec["_net_w"] = net_w
            sec["_net_h"] = net_h
            num_classes = int(sec.get("classes", 1))
    params = (
        darknet.load_weights(sections, weights_bytes)
        if weights_bytes is not None
        else darknet.random_weights(sections)
    )
    params = jax.tree.map(jnp.asarray, params)
    img_h, img_w = img_hw

    def detect_one(img, prm):
        x = yolo.letterbox(img, net_w, net_h, img_w, img_h)[None]
        heads = yolo.forward(prm, sections, x)
        all_b, all_s = [], []
        for sec, feat in heads:
            boxes, cls, obj = yolo.decode_head(sec, feat, num_classes)
            score = obj[..., None] * cls
            all_b.append(boxes[0])
            all_s.append(jnp.max(score[0], axis=-1))
        boxes = jnp.concatenate(all_b)
        scores = jnp.concatenate(all_s)
        scores = jnp.where(scores >= conf_threshold, scores, 0.0)
        boxes_px = yolo.unletterbox_boxes(boxes, net_w, net_h, img_w, img_h)
        b, s, v = yolo.nms_fixed(boxes_px, scores, max_boxes, nms_iou)
        return b, s, v

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P()),  # images sharded, weights replicated
        out_specs=P(DATA_AXIS),
        check_vma=False,
    )
    def detect_batch_sharded(images, prm):
        return jax.vmap(lambda im: detect_one(im, prm))(images)

    def detect_batch(images: jax.Array):
        b, s, v = detect_batch_sharded(images, params)
        return yolo.Detections(boxes=b, scores=s, classes=jnp.zeros(s.shape, jnp.int32), valid=v)

    return detect_batch
