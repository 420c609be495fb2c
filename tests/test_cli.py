"""CLI driver integration: run python -m stereo_semantic_vo_tpu.run on a tiny
synthetic KITTI-layout sequence end-to-end (subprocess)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.test_tracker import H, W, render

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def seq_with_gt(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("cli_seq")
    os.makedirs(root / "image_2")
    os.makedirs(root / "image_3")
    n = 4
    for t in range(n):
        left, right = render(t)
        Image.fromarray(np.asarray(left).astype(np.uint8)).save(root / "image_2" / f"{t:06d}.png")
        Image.fromarray(np.asarray(right).astype(np.uint8)).save(root / "image_3" / f"{t:06d}.png")
    np.savetxt(root / "times.txt", np.arange(n) * 0.1)
    # GT: identity rotations, lateral translation
    from tests.test_tracker import TX_STEP

    gt = np.zeros((n, 12))
    for t in range(n):
        gt[t] = [1, 0, 0, t * TX_STEP, 0, 1, 0, 0, 0, 0, 1, 0]
    np.savetxt(root / "gt.txt", gt)
    return str(root)


class TestCLI:
    def test_end_to_end_with_ate(self, seq_with_gt, tmp_path):
        """NOTE: the CLI uses full-KITTI intrinsics; the synthetic sequence is
        smaller, so ATE is not meaningful here — this validates the plumbing
        (args, IO, trajectory files, ATE report path), not accuracy."""
        env = dict(os.environ)
        env.update(
            JAX_PLATFORMS="cpu",
            PYTHONPATH=REPO,
        )
        out = subprocess.run(
            [
                sys.executable, "-m", "stereo_semantic_vo_tpu.run",
                "--sequence", seq_with_gt,
                "--seq-id", "04",
                "--out", str(tmp_path / "out"),
                "--gt", os.path.join(seq_with_gt, "gt.txt"),
                "--max-frames", "3",
            ],
            capture_output=True, text=True, timeout=900, env=env, cwd=REPO,
        )
        assert out.returncode == 0, out.stderr[-2000:]
        lines = out.stdout.strip().splitlines()
        start = next(i for i, l in enumerate(lines) if l.startswith("{"))
        report = json.loads("\n".join(lines[start:]))
        assert report["n_frames"] == 3
        assert "ate_rmse_m" in report
        assert (tmp_path / "out" / "cameratrajectory_kitti.txt").exists()
        assert (tmp_path / "out" / "cameratrajectory_tum.txt").exists()
