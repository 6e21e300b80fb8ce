"""Frame output: positions to the host when a frame is due, rasterized and
written as PNG (and GIF) by a worker thread.

The port of `pdb_sph_tpu/io/frames.py`; the encoders are the same code, so
both packages write the same bytes for the same frames. `FrameWriter.submit`
copies a tensor (on the card or the CPU) to a host numpy array on the
calling thread before it returns: the worker thread never touches a device
tensor, and the caller may reuse or free the tensor at once.

PNG and GIF encoding is dependency-free (zlib + struct from the stdlib).
"""

from __future__ import annotations

import os
import queue
import struct
import threading
import zlib

import numpy as np
import torch

from ..render import renderer


def write_gif(path: str, frames_rgb, fps: float = 30.0,
              levels: int = 64, palette_rgb=None) -> None:
    """Minimal animated GIF89a encoder (stdlib only) — the reference's demo
    artifacts are gifs (README.md:4-15). Quantizes to a `levels`-entry
    palette of luminance-ordered bins (the point-sprite scene is
    near-monochrome, so uniform luminance bins of the splat color work
    well). The palette samples come from `palette_rgb` — an (m, 3) uint8
    pixel sample, ideally drawn from frames ACROSS the run (a dark first
    frame used to posterize everything after it) — falling back to the
    first frame when omitted. `frames_rgb` may be any iterable of
    (h, w, 3) uint8 arrays — frames are streamed, never held all at
    once."""
    import itertools

    it = iter(frames_rgb)
    try:
        first = next(it)
    except StopIteration:
        raise ValueError("no frames") from None
    h, w, _ = first.shape

    # palette: linear blend background -> splat color over the sample pixels
    if palette_rgb is None:
        palette_rgb = first.reshape(-1, 3)
    f0 = np.asarray(palette_rgb, np.float32).reshape(-1, 3)
    lum = f0 @ np.float32([0.299, 0.587, 0.114])
    order = np.argsort(lum)
    idxs = np.linspace(0, len(order) - 1, levels).astype(int)
    palette = f0[order[idxs]].astype(np.uint8)          # (levels, 3)
    pal_size = 1 << max(2, int(np.ceil(np.log2(levels))))
    pal = np.zeros((pal_size, 3), np.uint8)
    pal[:levels] = palette

    def quantize(rgb):
        px = rgb.reshape(-1, 1, 3).astype(np.int32)
        d = ((px - palette[None, :, :].astype(np.int32)) ** 2).sum(-1)
        return d.argmin(axis=1).astype(np.uint8)

    def lzw(data: np.ndarray, min_code: int) -> bytes:
        clear, end = 1 << min_code, (1 << min_code) + 1
        table = {bytes([i]): i for i in range(clear)}
        next_code = end + 1
        size = min_code + 1
        out = bytearray()
        acc = 0
        nbits = 0

        def emit(code):
            nonlocal acc, nbits
            acc |= code << nbits
            nbits += size
            while nbits >= 8:
                out.append(acc & 0xFF)
                acc >>= 8
                nbits -= 8

        emit(clear)
        buf = b""
        for b in data.tobytes():
            nxt = buf + bytes([b])
            if nxt in table:
                buf = nxt
            else:
                emit(table[buf])
                table[nxt] = next_code
                next_code += 1
                if next_code > (1 << size) and size < 12:
                    size += 1
                elif next_code > (1 << 12):
                    emit(clear)
                    table = {bytes([i]): i for i in range(clear)}
                    next_code = end + 1
                    size = min_code + 1
                buf = bytes([b])
        if buf:
            emit(table[buf])
        emit(end)
        if nbits:
            out.append(acc & 0xFF)
        return bytes(out)

    min_code = max(2, int(np.ceil(np.log2(pal_size))))
    delay = max(1, round(100.0 / fps))
    parts = [b"GIF89a", struct.pack("<HHBBB", w, h,
                                    0x80 | (min_code - 1), 0, 0),
             pal.tobytes(),
             b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]  # loop forever
    for rgb in itertools.chain([first], it):
        parts.append(b"\x21\xf9\x04\x04" + struct.pack("<H", delay) + b"\x00\x00")
        parts.append(b"\x2c" + struct.pack("<HHHH", 0, 0, w, h) + b"\x00")
        compressed = lzw(quantize(rgb), min_code)
        parts.append(bytes([min_code]))
        for i in range(0, len(compressed), 255):
            block = compressed[i:i + 255]
            parts.append(bytes([len(block)]) + block)
        parts.append(b"\x00")
    parts.append(b"\x3b")
    with open(path, "wb") as f:
        f.write(b"".join(parts))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Minimal RGB8 PNG encoder (stdlib only)."""
    h, w, c = rgb.shape
    assert c == 3 and rgb.dtype == np.uint8

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG written by write_png (8-bit RGB, filter 0 rows)."""
    raw = open(path, "rb").read()
    if raw[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    idat = b""
    w = h = None
    while pos + 8 <= len(raw):
        ln = int.from_bytes(raw[pos:pos + 4], "big")
        tag = raw[pos + 4:pos + 8]
        data = raw[pos + 8:pos + 8 + ln]
        if tag == b"IHDR":
            w, h, bit, ctype = struct.unpack(">IIBB", data[:10])
            if bit != 8 or ctype != 2:
                raise ValueError(f"{path}: unsupported PNG (want 8-bit RGB)")
        elif tag == b"IDAT":
            idat += data
        pos += 12 + ln
    dec = zlib.decompress(idat)
    stride = 1 + w * 3
    arr = np.frombuffer(dec, np.uint8).reshape(h, stride)
    if (arr[:, 0] != 0).any():
        raise ValueError(f"{path}: non-zero PNG row filters unsupported")
    return arr[:, 1:].reshape(h, w, 3).copy()


class FrameWriter:
    """Asynchronous rasterize-and-write sink.

    submit() copies positions to host memory and returns; a worker thread
    renders and encodes. close() drains the queue.
    """

    def __init__(self, out_dir: str, width: int = 1280, height: int = 720,
                 max_pending: int = 4, gif_path: str | None = None,
                 gif_fps: float = 30.0, orbit_deg: float = 0.0,
                 **render_kwargs):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.width, self.height = width, height
        self.render_kwargs = render_kwargs
        self.orbit_deg = orbit_deg        # camera yaw around the look-at
                                          # point per rendered frame — the
                                          # headless equivalent of the
                                          # reference's fly camera
                                          # (src/camera.h:29-136)
        self._submitted = 0
        self.gif_path = gif_path
        self.gif_fps = gif_fps
        self._gif_files: list[str] = []   # frames stream from disk at close;
                                          # holding RGB in RAM would grow
                                          # unbounded on long runs
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._err: BaseException | None = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self.frames_written = 0

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, idx, pos = item
            try:
                kwargs = self.render_kwargs
                if self.orbit_deg:
                    kwargs = dict(kwargs)
                    eye = np.asarray(
                        kwargs.get("eye", renderer.DEFAULT_EYE), np.float32)
                    tgt = np.asarray(
                        kwargs.get("target", renderer.DEFAULT_TARGET),
                        np.float32)
                    a = np.deg2rad(self.orbit_deg * idx)
                    c, s = np.cos(a), np.sin(a)
                    r = eye - tgt                 # yaw about the world-up axis
                    kwargs["eye"] = tuple(tgt + np.float32(
                        [c * r[0] + s * r[2], r[1], -s * r[0] + c * r[2]]))
                rgb = renderer.render(pos, self.width, self.height,
                                      **kwargs)
                fname = os.path.join(self.out_dir, f"frame_{step:06d}.png")
                write_png(fname, rgb)
                if self.gif_path:
                    self._gif_files.append(fname)
                self.frames_written += 1
            except BaseException as e:
                # Surface immediately on stderr (a long run that stops
                # producing frames mid-way used to look like success until
                # close()), and re-raise from the next submit()/close().
                if self._err is None:
                    import traceback

                    traceback.print_exc()
                self._err = e

    def submit(self, step: int, positions) -> None:
        """Queue positions (n, 3), a tensor or an array, for frame `step`;
        the host copy is taken here, on the calling thread."""
        if self._err:
            raise RuntimeError("frame writer failed") from self._err
        if isinstance(positions, torch.Tensor):
            pos = positions.detach().to("cpu", copy=True).numpy()
        else:
            pos = np.array(positions)
        self._q.put((int(step), self._submitted, pos))
        self._submitted += 1

    def close(self) -> None:
        self._q.put(None)
        self._worker.join()
        if self._err:
            raise RuntimeError("frame writer failed") from self._err
        if self.gif_path and self._gif_files:
            # Palette sample: subsampled pixels from up to 8 frames spread
            # across the whole run, so early dark frames don't posterize
            # the settled fluid (and vice versa).
            picks = self._gif_files[:: max(1, len(self._gif_files) // 8)]
            sample = np.concatenate(
                [read_png(f)[::8, ::8].reshape(-1, 3) for f in picks]
            )
            write_gif(self.gif_path, (read_png(f) for f in self._gif_files),
                      fps=self.gif_fps, palette_rgb=sample)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
