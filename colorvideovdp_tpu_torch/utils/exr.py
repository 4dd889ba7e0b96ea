"""Minimal OpenEXR scanline codec (FLOAT/HALF, NONE/ZIP/ZIPS compression).

Counterpart of the JAX package's ``utils/exr.py``: a reader and writer for
the subset ColorVideoVDP uses, RGB(A) or grey scanline images, since no
OpenEXR binding can be assumed. Zip blocks go through the native helper
(``utils/native.py``) where it is built, and zlib + numpy otherwise.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2


def _attr(name: str, type_name: str, data: bytes) -> bytes:
    return (
        name.encode() + b"\x00" + type_name.encode() + b"\x00"
        + struct.pack("<i", len(data)) + data
    )


def _channels_attr(names, pixel_type: int) -> bytes:
    out = b""
    for n in sorted(names):
        out += (
            n.encode() + b"\x00" + struct.pack("<i", pixel_type)
            + struct.pack("<i", 0) + struct.pack("<ii", 1, 1)
        )
    return out + b"\x00"


def write(fname: str, img: np.ndarray, half: bool = False,
          compression: str = "zip"):
    """Write (H, W, C) float image as scanline EXR; C in {1, 3}."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    H, W, C = img.shape
    names = ["Y"] if C == 1 else ["R", "G", "B"]
    ptype = _PT_HALF if half else _PT_FLOAT
    dtype = np.float16 if half else np.float32
    comp_id = {"none": 0, "zips": 2, "zip": 3}[compression]
    lines_per_chunk = {0: 1, 2: 1, 3: 16}[comp_id]

    header = b""
    header += _attr("channels", "chlist", _channels_attr(names, ptype))
    header += _attr("compression", "compression", struct.pack("<B", comp_id))
    box = struct.pack("<iiii", 0, 0, W - 1, H - 1)
    header += _attr("dataWindow", "box2i", box)
    header += _attr("displayWindow", "box2i", box)
    header += _attr("lineOrder", "lineOrder", struct.pack("<B", 0))
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    # channel-sorted scanline planes
    order = np.argsort(names)  # alphabetical channel order
    chunks = []
    for y0 in range(0, H, lines_per_chunk):
        ny = min(lines_per_chunk, H - y0)
        rows = []
        for y in range(y0, y0 + ny):
            for ci in order:
                rows.append(img[y, :, ci].astype(dtype).tobytes())
        data = b"".join(rows)
        if comp_id != 0:
            data = _exr_zip_compress(data)
        chunks.append((y0, data))

    with open(fname, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, 2))
        f.write(header)
        offset_pos = f.tell()
        f.write(b"\x00" * 8 * len(chunks))
        offsets = []
        for y0, data in chunks:
            offsets.append(f.tell())
            f.write(struct.pack("<ii", y0, len(data)))
            f.write(data)
        f.seek(offset_pos)
        for o in offsets:
            f.write(struct.pack("<Q", o))


def _exr_zip_compress(data: bytes) -> bytes:
    # OpenEXR zip (ImfZip.cpp): split bytes into two halves by alternation,
    # delta-predict over the whole buffer, then deflate. Uses the native
    # helper where it is built, numpy otherwise.
    from . import native

    out = native.exr_zip_compress(data) if native.available() else None
    if out is not None:
        return out
    arr = np.frombuffer(data, np.uint8)
    half = (len(arr) + 1) // 2
    buf = np.concatenate([arr[0::2], arr[1::2]])
    d = buf.astype(np.int16)
    d[1:] = (buf[1:].astype(np.int16) - buf[:-1].astype(np.int16) + 128) % 256
    out = zlib.compress(d.astype(np.uint8).tobytes())
    return out if len(out) < len(data) else data


def _exr_zip_decompress_fast(data: bytes, expected: int) -> bytes:
    if len(data) == expected:
        return data
    from . import native

    out = native.exr_zip_decompress(data, expected) if native.available() \
        else None
    if out is not None:
        return out
    raw = zlib.decompress(data)
    d = np.frombuffer(raw, np.uint8).astype(np.int64)
    # prefix-sum undo of the delta predictor (d[0] kept verbatim)
    adj = d - 128
    adj[0] = d[0]
    rec = (np.cumsum(adj) % 256).astype(np.uint8)
    # undo the two-half byte split
    half = (len(rec) + 1) // 2
    out = np.empty_like(rec)
    out[0::2] = rec[:half]
    out[1::2] = rec[half:]
    return out.tobytes()


def read(fname: str) -> np.ndarray:
    """Read a scanline EXR (NONE/ZIP/ZIPS) into (H, W, C) float32."""
    with open(fname, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"'{fname}' is not an EXR file")
    if version & 0x200:
        raise ValueError("tiled EXR not supported")
    pos = 8
    channels = []
    comp_id = 3
    dw = None
    while True:
        end = buf.index(b"\x00", pos)
        name = buf[pos:end].decode()
        pos = end + 1
        if name == "":
            break
        end = buf.index(b"\x00", pos)
        tname = buf[pos:end].decode()
        pos = end + 1
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        data = buf[pos : pos + size]
        pos += size
        if name == "channels":
            cp = 0
            while data[cp] != 0:
                ce = data.index(b"\x00", cp)
                cname = data[cp:ce].decode()
                ptype = struct.unpack_from("<i", data, ce + 1)[0]
                channels.append((cname, ptype))
                cp = ce + 1 + 16
        elif name == "compression":
            comp_id = data[0]
        elif name == "dataWindow":
            dw = struct.unpack("<iiii", data)
    if comp_id not in (0, 2, 3):
        raise ValueError(f"EXR compression {comp_id} not supported")
    x0, y0, x1, y1 = dw
    W, H = x1 - x0 + 1, y1 - y0 + 1
    lines_per_chunk = 16 if comp_id == 3 else 1
    n_chunks = -(-H // lines_per_chunk)
    offsets = struct.unpack_from(f"<{n_chunks}Q", buf, pos)

    ch_sorted = sorted(channels)  # file stores channels alphabetically
    dtypes = {c: (np.float16 if t == _PT_HALF else
                  np.float32 if t == _PT_FLOAT else np.uint32)
              for c, t in channels}
    planes = {c: np.empty((H, W), np.float32) for c, _ in channels}
    for off in offsets:
        y, size = struct.unpack_from("<ii", buf, off)
        data = buf[off + 8 : off + 8 + size]
        ny = min(lines_per_chunk, y1 - y + 1)
        expected = sum(
            W * ny * np.dtype(dtypes[c]).itemsize for c, _ in ch_sorted
        )
        raw = _exr_zip_decompress_fast(data, expected) if comp_id else data
        rp = 0
        for yy in range(y, y + ny):
            for cname, _t in ch_sorted:
                nbytes = W * np.dtype(dtypes[cname]).itemsize
                row = np.frombuffer(raw, dtypes[cname], W, rp)
                planes[cname][yy - y0] = row.astype(np.float32)
                rp += nbytes
    names = [c for c, _ in channels]
    if set(names) >= {"R", "G", "B"}:
        return np.stack([planes["R"], planes["G"], planes["B"]], axis=-1)
    if len(names) == 1:
        return planes[names[0]][:, :, None]
    return np.stack([planes[c] for c, _ in ch_sorted], axis=-1)
