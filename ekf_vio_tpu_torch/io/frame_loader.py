"""Threaded PNG decoding for the EuRoC loader, with a stdlib fallback.

Port of ``ekf_vio_tpu/io/frame_loader.py``: a ``ctypes`` binding to
``native/frameloader.cpp`` (a pool of libpng decoder threads delivering
grayscale float32 frames in order through a bounded ring, optionally
box-downscaled by an integer factor).  The library is built from that
source at first use into ``ekf_vio_tpu_torch/_build/`` with g++ (keyed
by a hash of the source and the flags); ``native/`` itself is never
written.  Where g++ or libpng is missing, frames are decoded by
``read_png``, a small reader on ``zlib`` (8-bit gray, gray+alpha, RGB
and RGBA, non-interlaced) with the native loader's luma weights and box
downscale, in float32 and in the same order, so both routes give the
same frames.  ``FrameLoader.route`` says which one runs.  This is host
I/O: no device work.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
import zlib
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "frameloader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-ffp-contract=off", "-shared")
LIBS = ("-lpng", "-lz", "-lpthread")


def build() -> Path | None:
    """The native loader built from ``native/frameloader.cpp`` into
    ``_build/``, or None where g++, libpng or the source is missing."""
    cxx = shutil.which("g++")
    if cxx is None or not SOURCE.exists():
        return None
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(CXX_FLAGS + LIBS).encode())
    out = BUILD_DIR / f"libframeloader-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp,
                               *LIBS], capture_output=True)
        if proc.returncode != 0:
            return None
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.cache
def _lib():
    path = build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    fp, ci = ctypes.POINTER(ctypes.c_float), ctypes.c_int
    lib.fl_create.restype = ctypes.c_void_p
    lib.fl_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ci, ci, ci, ci]
    lib.fl_next.restype = ci
    lib.fl_next.argtypes = [ctypes.c_void_p, fp, ctypes.POINTER(ci),
                            ctypes.POINTER(ci)]
    lib.fl_destroy.argtypes = [ctypes.c_void_p]
    lib.fl_decode_one.restype = ci
    lib.fl_decode_one.argtypes = [ctypes.c_char_p, ci, fp, ci,
                                  ctypes.POINTER(ci), ctypes.POINTER(ci)]
    return lib


def native_available() -> bool:
    return _lib() is not None


_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> channels


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters: [h, stride] uint8 samples."""
    rows = []
    up = [0] * stride  # the prior row of the first row is zeros
    pos = 0
    for _ in range(h):
        ftype, line = raw[pos], raw[pos + 1: pos + 1 + stride]
        pos += stride + 1
        if ftype == 0:
            row = list(line)
        elif ftype == 2:
            row = [(v + b) & 0xFF for v, b in zip(line, up)]
        elif ftype == 1:
            row = list(line)
            for x in range(bpp, stride):
                row[x] = (row[x] + row[x - bpp]) & 0xFF
        elif ftype == 3:
            row = list(line)
            for x in range(stride):
                a = row[x - bpp] if x >= bpp else 0
                row[x] = (row[x] + ((a + up[x]) >> 1)) & 0xFF
        elif ftype == 4:
            row = list(line)
            for x in range(stride):
                a = row[x - bpp] if x >= bpp else 0
                b = up[x]
                c = up[x - bpp] if x >= bpp else 0
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                row[x] = (row[x] + p) & 0xFF
        else:
            raise ValueError(f"PNG filter type {ftype}")
        rows.append(row)
        up = row
    return np.asarray(rows, np.uint8).reshape(h, stride)


def read_png(path: str) -> np.ndarray:
    """[H, W] float32 grayscale of an 8-bit non-interlaced PNG, as
    ``frameloader.cpp`` decodes it: gray as is, RGB(A) as 0.299 R + 0.587
    G + 0.114 B in float32, gray+alpha as its gray."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos: pos + 4])
        kind = data[pos + 4: pos + 8]
        body = data[pos + 8: pos + 8 + length]
        pos += length + 12
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray, gray+alpha,"
                         f" RGB and RGBA PNGs are read here")
    ch = _CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    px = px.reshape(h, w, ch)
    if ch < 3:
        return px[..., 0].astype(np.float32)
    f = px[..., :3].astype(np.float32)
    return (np.float32(0.299) * f[..., 0] + np.float32(0.587) * f[..., 1]
            + np.float32(0.114) * f[..., 2])


def box_downscale(img: np.ndarray, s: int) -> np.ndarray:
    """The native loader's integer box downscale: the s x s block summed
    in float32 row by row, left to right, times 1 / s^2."""
    if s <= 1:
        return img
    h2, w2 = img.shape[0] // s, img.shape[1] // s
    acc = np.zeros((h2, w2), np.float32)
    for dy in range(s):
        for dx in range(s):
            acc += img[dy: h2 * s: s, dx: w2 * s: s]
    return acc * (np.float32(1.0) / np.float32(s * s))


class FrameLoader:
    """In-order frames from PNG paths.  Iterate to get (index, float32
    [H, W]) tuples; ``route`` is "native" (threaded libpng decode,
    overlapped with the caller's work) or "python" (``read_png`` in the
    caller's thread).  An undecodable frame is skipped."""

    def __init__(self, paths, inverse_scale: int = 1, n_threads: int = 4,
                 capacity: int = 8):
        self._lib = _lib()
        self.paths = [str(p) for p in paths]
        self.inverse_scale = inverse_scale
        self._handle = None
        self.route = "python" if self._lib is None else "native"
        if self._lib is None:
            return
        w, h = ctypes.c_int(), ctypes.c_int()
        buf = np.empty(1 << 24, np.float32)
        rc = self._lib.fl_decode_one(
            self.paths[0].encode(), inverse_scale,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), buf.size,
            ctypes.byref(w), ctypes.byref(h))
        if rc != 0:
            raise IOError(f"cannot decode {self.paths[0]} (rc={rc})")
        self.width, self.height = w.value, h.value
        self._names = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths])
        self._handle = self._lib.fl_create(self._names, len(self.paths),
                                           inverse_scale, n_threads, capacity)

    def __iter__(self):
        if self.route == "python":
            return self._iter_python()
        return self._iter_native()

    def _iter_native(self):
        out = np.empty((self.height, self.width), np.float32)
        w, h = ctypes.c_int(), ctypes.c_int()
        while True:
            rc = self._lib.fl_next(
                self._handle,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                ctypes.byref(w), ctypes.byref(h))
            if rc == -1:
                return
            if rc == -2:
                continue  # undecodable frame skipped
            yield rc, out.copy()

    def _iter_python(self):
        for i, p in enumerate(self.paths):
            try:
                im = read_png(p)
            except (OSError, ValueError, zlib.error):
                continue
            yield i, box_downscale(im, self.inverse_scale)

    def close(self):
        if self._handle is not None:
            self._lib.fl_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
