"""PNG reading and writing with zlib + numpy only.

The frame formats of the TUM RGB-D benchmark: 8-bit RGB color images
and 16-bit grayscale depth images, non-interlaced.  The odometry
driver decodes with the native loader (cvo_rgbd_tpu.native) when it
builds; this module is its fallback and the writer `synth.py` renders
datasets with.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG color types: 0 gray, 2 RGB, 4 gray+alpha, 6 RGBA
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(tag: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(tag + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", crc)


def _paeth(a, b, c):
    """Paeth predictor (PNG spec 9.4) on int arrays."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(raw, bpp, filter_type):
    """Filter [H, stride] uint8 scanlines with one PNG filter type."""
    x = raw.astype(np.int32)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    pred = {
        0: 0,
        1: left,
        2: up,
        3: (left + up) // 2,
        4: _paeth(left, up, upleft),
    }[filter_type]
    return ((x - pred) & 0xFF).astype(np.uint8)


def encode_png(img, filter_type: int = 2, level: int = 6) -> bytes:
    """Encode uint8 [H,W,3] (RGB) or uint16 [H,W] (gray) as PNG bytes.
    `filter_type` (0-4) is applied to every scanline."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        color, depth, data = 2, 8, img
    elif img.dtype == np.uint16 and img.ndim == 2:
        color, depth, data = 0, 16, img.astype(">u2")
    else:
        raise ValueError(
            f"expected uint8 [H,W,3] or uint16 [H,W], got "
            f"{img.dtype} {img.shape}"
        )
    h, w = img.shape[:2]
    raw = np.ascontiguousarray(data).view(np.uint8).reshape(h, -1)
    bpp = _CHANNELS[color] * depth // 8
    rows = _filter_rows(raw, bpp, filter_type)
    scan = np.concatenate(
        [np.full((h, 1), filter_type, np.uint8), rows], axis=1
    )
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    return (
        _SIGNATURE
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(scan.tobytes(), level))
        + _chunk(b"IEND", b"")
    )


def write_png(path, img, filter_type: int = 2):
    with open(path, "wb") as f:
        f.write(encode_png(img, filter_type))


def _unfilter(scan, h, stride, bpp):
    """Reconstruct [H, stride] scanlines from filtered data."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for r in range(h):
        ft = scan[r, 0]
        line = scan[r, 1:].astype(np.int32)
        if ft == 0:
            cur = line
        elif ft == 1:
            # sub: running sum along each of the bpp byte lanes
            lanes = np.zeros(-(-stride // bpp) * bpp, np.int32)
            lanes[:stride] = line
            cur = np.cumsum(lanes.reshape(-1, bpp), axis=0).reshape(-1)
            cur = cur[:stride] & 0xFF
        elif ft == 2:
            cur = (line + prev) & 0xFF
        elif ft in (3, 4):
            cur = np.zeros(stride, np.int32)
            for i in range(0, stride, bpp):
                a = cur[i - bpp:i] if i else np.zeros(bpp, np.int32)
                b = prev[i:i + bpp]
                if ft == 3:
                    pred = (a + b) // 2
                else:
                    c = prev[i - bpp:i] if i else np.zeros(bpp, np.int32)
                    pred = _paeth(a, b, c)
                cur[i:i + bpp] = (line[i:i + bpp] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ft}")
        out[r] = cur
        prev = cur
    return out


def decode_png(data: bytes):
    """Decode PNG bytes -> uint8 [H,W,C] / [H,W] or uint16 [H,W(,C)]."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    off = 8
    idat = []
    ihdr = None
    while off < len(data):
        (n,) = struct.unpack(">I", data[off:off + 4])
        tag = data[off + 4:off + 8]
        body = data[off + 8:off + 8 + n]
        off += 12 + n
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = ihdr
    if interlace or depth not in (8, 16) or color not in _CHANNELS:
        raise ValueError(
            f"unsupported PNG: depth {depth}, color type {color}, "
            f"interlace {interlace}"
        )
    ch = _CHANNELS[color]
    bpp = ch * depth // 8
    stride = w * bpp
    scan = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = _unfilter(scan.reshape(h, stride + 1), h, stride, bpp)
    if depth == 16:
        img = raw.view(">u2").astype(np.uint16)
    else:
        img = raw
    return img.reshape((h, w, ch) if ch > 1 else (h, w))


def read_png(path):
    with open(path, "rb") as f:
        return decode_png(f.read())
