"""PNG decode/encode (numpy copy of funky_tpu/models/png_io.py).

Decode prefers PIL, then falls back to a pure-Python implementation
(stdlib zlib + numpy unfiltering). Unlike the JAX package this copy has no
native-decoder route: it must import where jax is not installed.

The reference decodes textures with the `image` crate into RGBA8
(gltf_loader.rs:96-127) and uploads them as R8G8B8A8_SRGB
(gltf_renderer.rs:1495), i.e. the sampler returns *linear* light. Decoding
to linear float is done in models/scene.py, not here — this module returns
raw RGBA8 bytes exactly like the reference loader.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def decode_png(data: bytes) -> np.ndarray:
    """Decode a PNG byte string to an (H, W, 4) uint8 RGBA array."""
    try:
        import io  # noqa: PLC0415

        from PIL import Image  # noqa: PLC0415

        img = Image.open(io.BytesIO(data)).convert("RGBA")
        return np.asarray(img, np.uint8)
    except ImportError:
        return _decode_png_pure(data)


def read_png(path: str | Path) -> np.ndarray:
    return decode_png(Path(path).read_bytes())


def write_png(path: str | Path, rgba: np.ndarray) -> None:
    """Write (H, W, 3|4) uint8 (or float in [0,1]) as PNG."""
    arr = np.asarray(rgba)
    if arr.dtype != np.uint8:
        arr = np.clip(np.asarray(arr, np.float32) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    h, w, c = arr.shape
    color_type = {3: 2, 4: 6}[c]

    # filter type 0 per scanline
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1).tobytes()

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    png = (_PNG_SIG + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    Path(path).write_bytes(png)


# ---------------------------------------------------------------------------
# Pure-Python decoder (fallback): gray/RGB/RGBA/palette at bit depths
# 1/2/4/8/16, all filters, Adam7 interlacing — the same format coverage
# the reference gets from the `image` crate (gltf_loader.rs:96-127;
# 16-bit channels fold to 8 by the high byte, like `DynamicImage::to_rgba8`).
# ---------------------------------------------------------------------------

# Adam7 pass grid: (x0, y0, dx, dy) per pass (PNG spec 8.2).
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _scanlines_to_pixels(flat: np.ndarray, w: int, h: int, channels: int,
                         bit_depth: int) -> np.ndarray:
    """Unfiltered scanline bytes (h, stride) -> (h, w, channels) uint8
    (16-bit folds to the high byte; sub-byte depths unpack + rescale)."""
    if bit_depth == 8:
        return flat[:, :w * channels].reshape(h, w, channels)
    if bit_depth == 16:
        u16 = flat[:, :w * channels * 2].reshape(
            h, w * channels, 2).astype(np.uint16)
        return ((u16[..., 0] << 8 | u16[..., 1]) >> 8).astype(
            np.uint8).reshape(h, w, channels)
    # 1/2/4-bit (gray or palette indices, always 1 channel)
    bits = np.unpackbits(flat, axis=1)
    per = bit_depth
    vals = bits[:, :w * per].reshape(h, w, per)
    weights = (1 << np.arange(per - 1, -1, -1)).astype(np.uint8)
    return (vals * weights).sum(axis=-1, dtype=np.uint16)[..., None].astype(
        np.uint8)


def _decode_subimage(raw: memoryview, w: int, h: int, channels: int,
                     bit_depth: int):
    """One (sub-)image of filtered scanlines; returns (pixels, bytes
    consumed). pixels is (h, w, channels) uint8 pre-rescale."""
    stride = (w * channels * bit_depth + 7) // 8
    bpp = max(1, channels * bit_depth // 8)
    n = h * (stride + 1)
    rows = np.frombuffer(raw[:n], np.uint8).reshape(h, stride + 1)
    flat = _unfilter(rows[:, 1:].copy(), rows[:, 0], bpp)
    return _scanlines_to_pixels(flat, w, h, channels, bit_depth), n


def _decode_png_pure(data: bytes) -> np.ndarray:
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos = 8
    width = height = bit_depth = color_type = interlace = None
    idat = bytearray()
    palette: np.ndarray | None = None
    trns: np.ndarray | None = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            width, height, bit_depth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload)
        elif tag == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(payload, np.uint8)
        elif tag == b"IDAT":
            idat.extend(payload)
        elif tag == b"IEND":
            break
    assert width is not None
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    raw = memoryview(zlib.decompress(bytes(idat)))

    if interlace == 0:
        img, _ = _decode_subimage(raw, width, height, channels, bit_depth)
    elif interlace == 1:
        img = np.zeros((height, width, channels), np.uint8)
        off = 0
        for x0, y0, dx, dy in _ADAM7:
            wp = (width - x0 + dx - 1) // dx
            hp = (height - y0 + dy - 1) // dy
            if wp <= 0 or hp <= 0:
                continue
            sub, used = _decode_subimage(raw[off:], wp, hp, channels,
                                         bit_depth)
            off += used
            img[y0::dy, x0::dx] = sub
    else:
        raise ValueError(f"bad PNG interlace method {interlace}")

    if bit_depth in (1, 2, 4) and color_type == 0:
        # rescale sub-byte gray to full range (e.g. 1-bit 1 -> 255)
        img = (img.astype(np.uint16) * (255 // ((1 << bit_depth) - 1))
               ).astype(np.uint8)

    if color_type == 3:  # palette
        assert palette is not None
        idx = img[..., 0]
        rgb = palette[idx]
        a = np.full((height, width), 255, np.uint8)
        if trns is not None:
            mask = idx < len(trns)
            a[mask] = trns[idx[mask]]
        return np.concatenate([rgb, a[..., None]], axis=-1)
    if color_type == 0:  # gray
        return np.concatenate(
            [np.repeat(img, 3, axis=-1),
             np.full((height, width, 1), 255, np.uint8)], axis=-1)
    if color_type == 4:  # gray+alpha
        return np.concatenate(
            [np.repeat(img[..., :1], 3, axis=-1), img[..., 1:]], axis=-1)
    if color_type == 2:  # rgb
        return np.concatenate(
            [img, np.full((height, width, 1), 255, np.uint8)], axis=-1)
    return img  # rgba


def _unfilter(rows: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """Reverse PNG scanline filters. Rows mutated in place (uint8)."""
    h, stride = rows.shape
    prev = np.zeros(stride, np.uint16)
    for y in range(h):
        f = filters[y]
        row = rows[y].astype(np.uint16)
        if f == 0:
            pass
        elif f == 1:  # Sub
            for x in range(bpp, stride):
                row[x] = (row[x] + row[x - bpp]) & 0xFF
        elif f == 2:  # Up
            row = (row + prev) & 0xFF
        elif f == 3:  # Average
            for x in range(stride):
                left = row[x - bpp] if x >= bpp else 0
                row[x] = (row[x] + ((left + prev[x]) >> 1)) & 0xFF
        elif f == 4:  # Paeth
            for x in range(stride):
                a = int(row[x - bpp]) if x >= bpp else 0
                b = int(prev[x])
                c = int(prev[x - bpp]) if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[x] = (row[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter {f}")
        rows[y] = row.astype(np.uint8)
        prev = row
    return rows


def srgb_to_linear(srgb: np.ndarray) -> np.ndarray:
    """Exact sRGB EOTF — what R8G8B8A8_SRGB sampling performs in hardware."""
    s = np.asarray(srgb, np.float32)
    return np.where(s <= 0.04045, s / 12.92, ((s + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(linear):
    """Exact sRGB OETF — what writing to an _SRGB swapchain image performs.

    numpy in, numpy out.
    """
    lin = np.clip(np.asarray(linear, np.float32), 0.0, 1.0)
    return np.where(lin <= 0.0031308,
                    lin * 12.92,
                    1.055 * np.power(lin, 1.0 / 2.4) - 0.055)
