"""Streaming video writer and GIF output.

Port of ``ppi_tpu/utils/video.py`` (which imports no JAX; the port keeps
its own copy). ``MjpegAviWriter`` is a pure-Python MJPEG-in-AVI muxer (JPEG
frames from PIL in a RIFF container, the sizes and the ``idx1`` index
patched on close, so memory is O(1) in the episode's length).
``VideoRenderStream`` is the context-manager sink: ``.mp4`` through
imageio's ffmpeg writer where it exists, otherwise the suffix is rewritten
to ``.avi`` (the JAX package's file-format choice, logged); ``.avi``
through the muxer; anything else (``.gif``) through ``save_gif``'s
writers.

``save_gif`` writes frames with imageio, as the JAX package does, and with
PIL's GIF encoder on a machine without imageio (the card's machine has
PIL only).
"""

import io
import logging
import struct
from pathlib import Path

import numpy as np

__all__ = ["VideoRenderStream", "MjpegAviWriter", "save_gif",
           "read_avi_frames"]


class MjpegAviWriter:
    """Minimal AVI (RIFF) muxer for MJPEG streams, stdlib + PIL only."""

    def __init__(self, path, fps: int = 25, quality: int = 90):
        self.path = Path(path)
        self.fps = int(fps)
        self.quality = int(quality)
        self._f = None
        self._frames = 0
        self._index = []       # (offset_in_movi, size) per frame
        self._wh = None

    # -- RIFF plumbing ------------------------------------------------------
    def _u32(self, v):
        return struct.pack("<I", int(v) & 0xFFFFFFFF)

    def _open(self, w, h):
        self._wh = (w, h)
        f = self._f = open(self.path, "wb")
        f.write(b"RIFF" + self._u32(0) + b"AVI ")          # patched on close
        # hdrl list
        strh = (b"vids" + b"MJPG" + self._u32(0) + self._u32(0)
                + self._u32(0)
                + self._u32(1) + self._u32(self.fps)       # scale, rate
                + self._u32(0) + self._u32(0)              # start, length*
                + self._u32(w * h * 3) + self._u32(10_000)
                + self._u32(0)
                + struct.pack("<4h", 0, 0, w, h))
        strf = (self._u32(40) + self._u32(w) + self._u32(h)
                + struct.pack("<HH", 1, 24) + b"MJPG"
                + self._u32(w * h * 3) + self._u32(0) + self._u32(0)
                + self._u32(0) + self._u32(0))
        strl = (b"LIST" + self._u32(4 + 8 + len(strh) + 8 + len(strf))
                + b"strl"
                + b"strh" + self._u32(len(strh)) + strh
                + b"strf" + self._u32(len(strf)) + strf)
        avih = (self._u32(1_000_000 // self.fps) + self._u32(0)
                + self._u32(0) + self._u32(0x10)           # AVIF_HASINDEX
                + self._u32(0)                             # total frames*
                + self._u32(0) + self._u32(1) + self._u32(10_000)
                + self._u32(w) + self._u32(h)
                + self._u32(0) * 4)
        hdrl = (b"LIST"
                + self._u32(4 + 8 + len(avih) + len(strl))
                + b"hdrl"
                + b"avih" + self._u32(len(avih)) + avih
                + strl)
        f.write(hdrl)
        # positions of the fields patched on close (*)
        self._pos_total_frames = 12 + 8 + 4 + 8 + 16
        self._pos_stream_length = 12 + 8 + 4 + 8 + len(avih) + 8 + 4 + 8 + 32
        f.write(b"LIST" + self._u32(0) + b"movi")          # patched on close
        self._movi_start = f.tell() - 4                    # points at 'movi'

    def append(self, frame: np.ndarray):
        """frame: (H, W, 3) uint8 RGB."""
        from PIL import Image

        frame = np.ascontiguousarray(frame)
        h, w = frame.shape[:2]
        if self._f is None:
            self._open(w, h)
        if (w, h) != self._wh:
            raise ValueError(f"frame size changed mid-stream: {(w, h)} "
                             f"after {self._wh}")
        buf = io.BytesIO()
        Image.fromarray(frame).save(buf, format="JPEG",
                                    quality=self.quality)
        data = buf.getvalue()
        if len(data) % 2:
            data += b"\x00"
        offset = self._f.tell() - self._movi_start         # rel to 'movi'
        self._f.write(b"00dc" + self._u32(len(data)) + data)
        self._index.append((offset, len(data)))
        self._frames += 1

    def close(self):
        if self._f is None:
            return
        f = self._f
        movi_end = f.tell()
        # idx1
        f.write(b"idx1" + self._u32(16 * len(self._index)))
        for offset, size in self._index:
            f.write(b"00dc" + self._u32(0x10) + self._u32(offset)
                    + self._u32(size))
        riff_end = f.tell()
        f.seek(4)
        f.write(self._u32(riff_end - 8))
        f.seek(self._pos_total_frames)
        f.write(self._u32(self._frames))
        f.seek(self._pos_stream_length)
        f.write(self._u32(self._frames))
        f.seek(self._movi_start - 4)
        f.write(self._u32(movi_end - self._movi_start))
        f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _GifFrames:
    """A GIF sink with imageio's writer interface (``append_data``,
    ``close``): the frames are kept and written by ``save_gif`` on close."""

    def __init__(self, path, fps):
        self.path, self.fps, self.frames = path, fps, []

    def append_data(self, frame):
        self.frames.append(np.array(frame, np.uint8))

    def close(self):
        if self.frames:
            save_gif(self.path, self.frames, fps=self.fps)


def _imageio():
    """imageio's v2 interface, or None where it is not installed."""
    try:
        import imageio.v2 as imageio
    except ImportError:
        return None
    return imageio


class VideoRenderStream:
    """Streaming frame sink: ``with VideoRenderStream(path) as v:
    v.append(frame)``. ``.mp4`` through imageio-ffmpeg where present
    (otherwise rewritten to ``.avi``), ``.avi`` through the MJPEG muxer,
    anything else through imageio (PIL's GIF encoder without imageio)."""

    def __init__(self, path, fps: int = 25):
        self.path = Path(path)
        self.fps = fps
        self._writer = None
        self._backend = None

    def _ensure(self, frame):
        if self._writer is not None:
            return
        imageio = _imageio()
        if self.path.suffix == ".mp4":
            try:
                w = imageio.get_writer(self.path, fps=self.fps,
                                       format="FFMPEG")
                self._writer, self._backend = w, "ffmpeg"
                return
            except Exception:
                # no imageio, or imageio without its ffmpeg plugin
                self.path = self.path.with_suffix(".avi")
                logging.info("no ffmpeg backend; writing MJPEG %s", self.path)
        if self.path.suffix == ".avi":
            self._writer = MjpegAviWriter(self.path, fps=self.fps)
            self._backend = "mjpeg-avi"
        elif imageio is not None:
            self._writer = imageio.get_writer(self.path, fps=self.fps)
            self._backend = "imageio"
        else:
            self._writer = _GifFrames(self.path, self.fps)
            self._backend = "pil"

    def append(self, frame: np.ndarray):
        frame = np.asarray(frame, np.uint8)
        self._ensure(frame)
        if self._backend == "mjpeg-avi":
            self._writer.append(frame)
        else:
            self._writer.append_data(frame)

    def close(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def save_gif(path, frames, fps: int = 25) -> Path:
    """Write (H, W, 3) uint8 ``frames`` as a looping GIF: imageio's
    ``mimsave`` (the JAX package's writer) where imageio is installed, else
    PIL's GIF encoder (an adaptive palette a frame)."""
    path = Path(path)
    imageio = _imageio()
    if imageio is not None:
        imageio.mimsave(path, list(frames), fps=fps, loop=0)
        return path
    from PIL import Image
    images = [Image.fromarray(np.asarray(f, np.uint8)) for f in frames]
    images[0].save(path, format="GIF", save_all=True,
                   append_images=images[1:], duration=1000.0 / fps, loop=0)
    return path


def read_avi_frames(path):
    """The frames of an MJPEG AVI written by ``MjpegAviWriter``, decoded
    with PIL: a list of (H, W, 3) uint8 arrays, one a ``00dc`` chunk of the
    ``movi`` list."""
    from PIL import Image
    data = Path(path).read_bytes()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path}: not a RIFF AVI file")
    movi = data.index(b"movi") + 4
    end = data.index(b"idx1", movi)
    frames, pos = [], movi
    while pos < end:
        tag = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        if tag == b"00dc":
            img = Image.open(io.BytesIO(data[pos + 8:pos + 8 + size]))
            frames.append(np.asarray(img.convert("RGB")))
        pos += 8 + size + (size % 2)
    return frames
