"""The port's video writers (``ppi_tpu_torch/utils/video.py``) against
``ppi_tpu/utils/video.py`` on the same frames: the MJPEG AVI muxer writes
the same bytes, ``VideoRenderStream`` rewrites ``.mp4`` to ``.avi`` where
no ffmpeg backend exists, and the GIF writers (imageio, and PIL where
imageio is missing, as on the card's machine) write decodable GIFs."""

import numpy as np
import pytest

import torch_helpers  # noqa: F401  (sets torch threads)
from ppi_tpu.utils import video as jvideo
from ppi_tpu_torch.utils import video


def _frames(n=5, h=24, w=40, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 255, w).astype(np.uint8)
    out = []
    for t in range(n):
        f = rng.integers(0, 256, (h, w, 3)).astype(np.uint8) // 4
        f[..., 0] += x[None, :] // 2
        f[..., 1] += np.uint8((t * 37) % 128)
        out.append(f)
    return out


@pytest.mark.parametrize("fps", [10, 25])
def test_mjpeg_avi_bytes_equal_jax(tmp_path, fps):
    """Bytes equal (bound: none): the same RIFF layout, the same PIL JPEG
    frames, the same patched sizes and index."""
    frames = _frames()
    with jvideo.MjpegAviWriter(tmp_path / "j.avi", fps=fps) as w:
        for f in frames:
            w.append(f)
    with video.MjpegAviWriter(tmp_path / "t.avi", fps=fps) as w:
        for f in frames:
            w.append(f)
    assert (tmp_path / "t.avi").read_bytes() == \
        (tmp_path / "j.avi").read_bytes()
    decoded = video.read_avi_frames(tmp_path / "t.avi")
    assert len(decoded) == len(frames)
    assert decoded[0].shape == frames[0].shape


def test_mjpeg_avi_refuses_a_new_frame_size(tmp_path):
    with video.MjpegAviWriter(tmp_path / "t.avi") as w:
        w.append(_frames(1)[0])
        with pytest.raises(ValueError, match="frame size changed"):
            w.append(np.zeros((8, 8, 3), np.uint8))


@pytest.mark.parametrize("suffix", [".mp4", ".avi", ".gif"])
def test_stream_dispatch_matches_jax(tmp_path, suffix):
    """The same backend and final path as JAX's stream for each suffix
    (``.mp4`` becomes ``.avi`` here, where no ffmpeg plugin exists), and
    the same bytes."""
    frames = _frames(3)
    paths = {}
    for name, mod in (("j", jvideo), ("t", video)):
        with mod.VideoRenderStream(tmp_path / f"{name}{suffix}",
                                   fps=12) as s:
            for f in frames:
                s.append(f)
        paths[name] = s.path
        assert s._backend == ("imageio" if suffix == ".gif" else
                              "mjpeg-avi"), (name, s._backend)
    assert paths["t"].suffix == paths["j"].suffix
    assert paths["t"].read_bytes() == paths["j"].read_bytes()


def test_gif_without_imageio_uses_pil(tmp_path, monkeypatch):
    """Where imageio is missing (the card's machine) ``save_gif`` and the
    stream write the GIF with PIL: every frame decodes, equal to the input
    within the palette's quantization (mean absolute error < 8 levels)."""
    from PIL import Image, ImageSequence
    monkeypatch.setattr(video, "_imageio", lambda: None)
    frames = _frames(4)
    out = video.save_gif(tmp_path / "a.gif", frames, fps=10)
    with video.VideoRenderStream(tmp_path / "b.gif", fps=10) as s:
        for f in frames:
            s.append(f)
    assert s._backend == "pil"
    for path in (out, s.path):
        got = [np.asarray(im.convert("RGB"))
               for im in ImageSequence.Iterator(Image.open(path))]
        assert len(got) == len(frames)
        for g, f in zip(got, frames):
            assert np.abs(g.astype(int) - f.astype(int)).mean() < 8
