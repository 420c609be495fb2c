"""Quality report: dense SGM vs the reference MSA solver, plus
ORB left/right matching, on the reference's vendored real stereo fixtures.

Prints one line per fixture with density / agreement metrics; used to
calibrate the bounds asserted in tests/test_real_images.py and to fill the
table in docs/REAL_IMAGES.md.

Run: JAX_PLATFORMS=cpu python tools/real_image_report.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

import jax.numpy as jnp
import numpy as np

from fixtures_io import FIXTURES, load_fixture, read_rgb
from stereo_semantic_vo_tpu.core.config import ORBConfig, StereoConfig
from stereo_semantic_vo_tpu.kernels.hamming import hamming_distance_matrix, masked_best_match
from stereo_semantic_vo_tpu.ops import orb
from stereo_semantic_vo_tpu.ops.dense_stereo import dense_disparity


def dense_metrics(name: str, refine: bool, color: bool = False) -> dict:
    """color=True uses MSA's 3-channel cost (MSA.cpp:78-97) where the source
    carries color (the PNG Middlebury pairs; urban/cones PGMs are grayscale
    captures, so color cannot apply there)."""
    left, right, ndisp, msa = load_fixture(name)
    cfg = StereoConfig(max_disparity=ndisp, refine=refine)
    lrgb = rrgb = None
    if color:
        lp, rp = FIXTURES[name][:2]
        lrgb, rrgb = read_rgb(lp), read_rgb(rp)
        if lrgb is None:
            return {}
        lrgb, rrgb = jnp.asarray(lrgb), jnp.asarray(rrgb)
    out = dense_disparity(jnp.asarray(left), jnp.asarray(right), cfg,
                          left_rgb=lrgb, right_rgb=rrgb)
    disp = np.asarray(out.disparity)
    valid = np.asarray(out.valid)
    H, W = left.shape
    # evaluation region: columns that can see their match, small border
    xs = np.arange(W)[None, :]
    region = np.zeros((H, W), bool)
    region[4:-4, 4:-4] = True
    region &= xs >= ndisp
    msa_ok = msa > 0
    both = region & msa_ok & valid
    err = np.abs(disp - msa)
    return {
        "name": name,
        "H": H,
        "W": W,
        "ndisp": ndisp,
        "density": float(valid[region].mean()),
        "msa_density": float(msa_ok[region].mean()),
        "overlap": float(both[region].mean()),
        "agree1": float((err[both] <= 1.0).mean()),
        "agree3": float((err[both] <= 3.0).mean()),
        "med_err": float(np.median(err[both])),
        "rms": float(np.sqrt(np.mean(err[both] ** 2))),
    }


def orb_metrics(name: str) -> dict:
    left, right, ndisp, _ = load_fixture(name)
    cfg = ORBConfig(max_keypoints=512)
    kl = orb.extract_orb(jnp.asarray(left), cfg)
    kr = orb.extract_orb(jnp.asarray(right), cfg)
    dist = hamming_distance_matrix(kl.desc, kr.desc)
    idx, best, second = masked_best_match(dist, kl.valid, kr.valid)
    good = np.asarray(kl.valid) & (np.asarray(best) < 40)
    uvl = np.asarray(kl.uv)[good]
    uvr = np.asarray(kr.uv)[np.asarray(idx)[good]]
    dv = np.abs(uvl[:, 1] - uvr[:, 1])          # rectified: rows must agree
    dx = uvl[:, 0] - uvr[:, 0]                  # disparity must be in [0, ndisp)
    epi_ok = dv <= 2.0
    disp_ok = (dx >= -1.0) & (dx <= ndisp + 1.0)
    return {
        "name": name,
        "n_kp": int(np.asarray(kl.valid).sum()),
        "n_match": int(good.sum()),
        "epi_inlier": float(epi_ok.mean()) if good.sum() else 0.0,
        "full_inlier": float((epi_ok & disp_ok).mean()) if good.sum() else 0.0,
    }


if __name__ == "__main__":
    names = sys.argv[1:] or list(FIXTURES)
    print("== dense SGM vs MSA golden ==")
    for n in names:
        for refine in (False, True):
            for color in (False, True):
                m = dense_metrics(n, refine, color)
                if not m:
                    continue
                print(
                    f"{m['name']:8s} refine={int(refine)} color={int(color)}"
                    f" {m['W']}x{m['H']} d={m['ndisp']}"
                    f"  density={m['density']:.3f} (msa {m['msa_density']:.3f},"
                    f" overlap {m['overlap']:.3f})"
                    f"  agree@1px={m['agree1']:.3f} @3px={m['agree3']:.3f}"
                    f"  med={m['med_err']:.2f} rms={m['rms']:.2f}"
                )
    print("== ORB left/right matching ==")
    for n in names:
        m = orb_metrics(n)
        print(
            f"{m['name']:8s} kp={m['n_kp']} matches={m['n_match']}"
            f"  epi_inlier={m['epi_inlier']:.3f} full_inlier={m['full_inlier']:.3f}"
        )
