import os

import numpy as np
import pytest

from stereo_semantic_vo_tpu.core.config import VOConfig, ORBConfig, CameraConfig
from stereo_semantic_vo_tpu.engine.state import init_state
from stereo_semantic_vo_tpu.utils.checkpoint import load_state, save_state
from stereo_semantic_vo_tpu.utils.profiling import StageTimer


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        cfg = VOConfig(
            camera=CameraConfig(width=64, height=48),
            orb=ORBConfig(max_keypoints=32),
        )
        state = init_state(cfg)
        state = state._replace(frame_idx=state.frame_idx + 5)
        p = str(tmp_path / "ckpt.npz")
        save_state(p, state)
        back = load_state(p, init_state(cfg))
        assert int(back.frame_idx) == 4
        np.testing.assert_array_equal(back.map_Xw, state.map_Xw)
        np.testing.assert_array_equal(back.map_create_id, state.map_create_id)


class TestStageTimer:
    def test_summary(self):
        t = StageTimer()
        for _ in range(3):
            with t.stage("a"):
                pass
        s = t.summary()
        assert s["a"]["n"] == 3 and s["a"]["median_s"] >= 0.0
        assert "a" in t.report()


class TestPersistentCache:
    """utils/cache.enable_persistent_cache: ``JAX_COMPILATION_CACHE_DIR``
    wins when set; otherwise the fixed, git-ignored ``.jax_cache`` of the
    checkout (a fixed path, because the path is part of the cache key)."""

    @pytest.mark.parametrize("from_env", [True, False])
    def test_cache_dir(self, from_env, tmp_path, monkeypatch):
        import jax

        from stereo_semantic_vo_tpu.utils.cache import enable_persistent_cache

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        if from_env:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
            want = str(tmp_path / "c")
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            want = os.path.join(repo, ".jax_cache")
        before = (jax.config.jax_compilation_cache_dir,
                  jax.config.jax_persistent_cache_min_compile_time_secs)
        try:
            got = enable_persistent_cache()
            assert got == want
            assert os.path.isdir(want)
            assert jax.config.jax_compilation_cache_dir == want
        finally:
            jax.config.update("jax_compilation_cache_dir", before[0])
            jax.config.update("jax_persistent_cache_min_compile_time_secs", before[1])
