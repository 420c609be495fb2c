"""CLI driver — the reference's ``./stereo_kitti vocab settings sequence``
(main.cpp:100-208), argparse edition.

Examples:
  # offline semantic boxes (the reference's shipped mode)
  python -m stereo_semantic_vo_tpu.run --sequence /data/kitti/odometry/01 \
      --seq-id 01 --boxes-dir /data/boxes/0.05results --out out/

  # online YOLO detection (jitted JAX CNN instead of a darknet thread)
  python -m stereo_semantic_vo_tpu.run --sequence ... --yolo-cfg yolov2-tiny.cfg \
      --yolo-weights yolov2-tiny.weights

  # geometry only
  python -m stereo_semantic_vo_tpu.run --sequence ... --no-semantics
"""

from __future__ import annotations

import argparse
import json


def main() -> None:
    p = argparse.ArgumentParser(description="Stereo semantic VO in JAX")
    p.add_argument("--sequence", required=True, help="KITTI sequence dir (times.txt, image_2/, image_3/)")
    p.add_argument("--seq-id", default="00", help="KITTI sequence id for intrinsics (00..12)")
    p.add_argument("--boxes-dir", default=None, help="offline YOLO box files dir (<frame+1>.txt)")
    p.add_argument("--yolo-cfg", default=None, help="darknet cfg for online detection")
    p.add_argument("--yolo-weights", default=None, help="darknet .weights for online detection")
    p.add_argument("--out", default="out", help="output dir for trajectories")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--no-semantics", action="store_true")
    p.add_argument("--gt", default=None, help="KITTI GT pose file for ATE report")
    p.add_argument("--local-ba", type=int, default=0, metavar="N",
                   help="run windowed local BA every N frames (0 = off)")
    p.add_argument("--dense-stereo", action="store_true",
                   help="reference-faithful dense SGM disparity sampled at keypoints")
    args = p.parse_args()

    import dataclasses

    from stereo_semantic_vo_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    from stereo_semantic_vo_tpu.core.config import VOConfig
    from stereo_semantic_vo_tpu.engine.pipeline import VOPipeline
    from stereo_semantic_vo_tpu.io import kitti

    cfg = VOConfig.kitti(args.seq_id)
    if args.no_semantics:
        cfg = dataclasses.replace(cfg, use_semantics=False)
    if args.dense_stereo:
        cfg = dataclasses.replace(
            cfg, stereo=dataclasses.replace(cfg.stereo, sparse_mode="dense")
        )

    detector = None
    if args.yolo_cfg:
        from stereo_semantic_vo_tpu.models.yolo import YoloDetector

        weights = open(args.yolo_weights, "rb").read() if args.yolo_weights else None
        detector = YoloDetector(
            open(args.yolo_cfg).read(),
            weights_bytes=weights,
            conf_threshold=cfg.semantic.online_conf_threshold,
            nms_iou=cfg.semantic.nms_iou,
            max_boxes=cfg.semantic.max_boxes,
        )

    paths = kitti.load_sequence_paths(args.sequence)
    frames = kitti.iter_frames(
        paths, args.boxes_dir, cfg.semantic.max_boxes, args.max_frames,
        image_hw=(cfg.camera.height, cfg.camera.width),
    )
    pipe = VOPipeline(cfg, detector=detector, out_dir=args.out, local_ba_every=args.local_ba)
    summary = pipe.run(frames)
    report = {k: v for k, v in summary.items() if k != "positions"}

    if args.gt:
        from stereo_semantic_vo_tpu.engine.trajectory import load_kitti_poses
        from stereo_semantic_vo_tpu.eval.ate import ate_rmse

        gt = load_kitti_poses(args.gt)[: summary["n_frames"]]
        est = load_kitti_poses(f"{args.out}/cameratrajectory_kitti.txt")
        report["ate_rmse_m"] = ate_rmse(est, gt)

    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
