"""The port's libav decoder (``videollamb_torch/native``) on the CPU host.

- On a 64 x 48 mp4v clip its frames equal the JAX package's native
  decoder's and OpenCV's, byte for byte, as do the two packages'
  ``load_video``.
- On a 56 x 48 clip, where the JAX package's library corrupts the heap
  (ROADMAP.md, queue C), the port's copy decodes frames equal to OpenCV's.
  It runs in a subprocess, so that a heap fault fails the test instead of
  the test process.
- It builds under ``build/native`` at the repository root, never into the
  source tree.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from videollamb_torch.data import video_reader  # noqa: E402
from videollamb_torch.native import video_decoder  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INDICES = [0, 3, 7, 12, 19]


@pytest.fixture(autouse=True)
def native():
    """Decided at run time, not at import: building needs libav."""
    if not video_decoder.available():
        pytest.skip("the native decoder does not build here (no libav)")


def _clip(path, width, height=48, frames=20):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10, (width, height))
    rng = np.random.default_rng(width)
    for _ in range(frames):
        writer.write(rng.integers(0, 255, size=(height, width, 3), dtype=np.uint8))
    writer.release()
    return str(path)


def _cv2_frames(path, indices):
    cap = cv2.VideoCapture(path)
    frames = []
    for _ in range(max(indices) + 1):
        ok, frame = cap.read()
        assert ok
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    return np.stack(frames)[indices]


def test_frames_equal_jax_native_and_cv2(tmp_path):
    from videollamb_tpu.data import video_reader as jax_reader
    from videollamb_tpu.native import video_decoder as jax_decoder

    path = _clip(tmp_path / "c64.mp4", 64)
    ours = video_decoder.read_frames(path, INDICES)
    assert ours.shape == (len(INDICES), 48, 64, 3)
    np.testing.assert_array_equal(ours, _cv2_frames(path, INDICES))
    assert video_decoder.probe(path) == (20, 10.0)
    if jax_decoder.available():
        np.testing.assert_array_equal(ours, jax_decoder.read_frames(path, INDICES))
        assert video_decoder.probe(path) == jax_decoder.probe(path)
    assert video_reader.video_backend() == "native"
    np.testing.assert_array_equal(video_reader.load_video(path, num_frames=8),
                                  jax_reader.load_video(path, num_frames=8))
    np.testing.assert_array_equal(video_reader.load_video(path, num_frames=8, backend="cv2"),
                                  video_reader.load_video(path, num_frames=8))


def test_56_pixel_clip_decodes_equal_cv2_in_a_subprocess(tmp_path):
    path = _clip(tmp_path / "c56.mp4", 56)
    out = tmp_path / "frames.npy"
    code = ("import sys, numpy as np\n"
            "from videollamb_torch.native import video_decoder as v\n"
            f"np.save({str(out)!r}, v.read_frames({path!r}, {INDICES!r}))\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    np.testing.assert_array_equal(np.load(out), _cv2_frames(path, INDICES))


def test_library_builds_under_build_native():
    path = video_decoder.library_path()
    assert path.exists()
    assert path.parent == video_decoder.BUILD_DIR
    assert str(path).startswith(os.path.join(REPO, "build", "native"))
    assert not any(name.endswith(".so") for name in os.listdir(video_decoder.SRC_DIR))
