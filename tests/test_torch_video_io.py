"""The port's host video decode and VGGT preprocessing
(``videogpa_torch/data/video_io.py``) against the JAX package's
(``videogpa_tpu/data/video_io.py``) on mp4s written here with OpenCV. Both
are host numpy + OpenCV + PIL code, so every result is equal bit for bit."""

import cv2
import numpy as np
import pytest

import videogpa_tpu.data.video_io as jio
import videogpa_torch.data.video_io as tio


def _write_mp4(path, frames, fps=8):
    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    assert writer.isOpened()
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """A landscape and a portrait clip with texture that moves."""
    root = tmp_path_factory.mktemp("videos")
    rng = np.random.default_rng(0)
    out = {}
    for name, (T, H, W) in {"land": (9, 48, 80), "port": (7, 96, 64)}.items():
        bg = cv2.GaussianBlur(rng.uniform(0, 255, (H + 40, W + 40, 3)).astype(np.uint8),
                              (0, 0), 2)
        frames = np.stack([bg[2 * t:2 * t + H, 3 * t:3 * t + W] for t in range(T)])
        _write_mp4(root / f"{name}.mp4", frames)
        out[name] = str(root / f"{name}.mp4")
    return out


@pytest.mark.parametrize("name", ["land", "port"])
def test_decode_and_sampling_equal_the_jax_package(videos, name):
    path = videos[name]
    assert tio.video_frame_count(path) == jio.video_frame_count(path) > 0
    np.testing.assert_array_equal(tio.read_video_frames(path), jio.read_video_frames(path))
    idx = np.array([0, 3, 3, 5, 100])  # repeats; past the end: the last frame decoded
    got = tio.read_video_frames(path, idx)
    np.testing.assert_array_equal(got, jio.read_video_frames(path, idx))
    np.testing.assert_array_equal(got[-1], got[3])
    for n, size in ((4, 64), (20, 518)):  # n past the clip's length: every frame
        got = tio.sample_uniform_frames(path, n_frames=n, size=size)
        assert got.dtype == np.uint8 and got.shape[1:] == (size, size, 3)
        np.testing.assert_array_equal(got, jio.sample_uniform_frames(path, n_frames=n,
                                                                     size=size))


def test_unreadable_video_raises_as_the_jax_package(tmp_path):
    bad = tmp_path / "bad.mp4"
    bad.write_bytes(b"not a video")
    for mod in (tio, jio):
        with pytest.raises(RuntimeError):
            mod.read_video_frames(str(bad))
    assert tio.video_frame_count(str(bad)) == jio.video_frame_count(str(bad))


@pytest.mark.parametrize("mode", ["crop", "pad"])
@pytest.mark.parametrize("shape", [(3, 48, 80), (2, 96, 64), (2, 518, 518), (2, 300, 300)])
def test_preprocess_images_vggt_equals_the_jax_package(mode, shape):
    frames = np.random.default_rng(sum(shape)).integers(0, 256, shape + (3,), dtype=np.uint8)
    got = tio.preprocess_images_vggt(frames, mode=mode)
    want = jio.preprocess_images_vggt(frames, mode=mode)
    assert got.dtype == np.float32 and got.shape[:3] == (1, shape[0], 3)
    np.testing.assert_array_equal(got, want)
    crop = tio.center_crop_and_resize(frames[0], 40)
    np.testing.assert_array_equal(crop, jio.center_crop_and_resize(frames[0], 40))
    with pytest.raises(ValueError, match="crop"):
        tio.preprocess_images_vggt(frames, mode="stretch")
