"""Flow-map file IO in the DSEC benchmark's submission format (port of
``event_based_optical_flow_tpu/flow/io.py``).

The DSEC optical-flow benchmark exchanges flow as 16-bit 3-channel
PNGs: R = u * 128 + 2^15 (width-direction displacement), G = v * 128 +
2^15 (height direction), B = valid mask (> 0).  The writer is the exact
inverse of the DSEC loader's decode (``data/dsec.py``).

PIL cannot write 48-bit RGB PNGs and silently truncates them to 8 bits
on reading, so both directions are written here from the PNG spec
(zlib, 16-bit big-endian samples).  The port decodes with this spec
decoder on every machine (the JAX package prefers cv2 where it imports,
and a native defilter); the two give the same arrays.
"""

import os
import struct
import zlib

import numpy as np


def encode_png16(img: np.ndarray) -> bytes:
    """[H, W, 3] uint16 -> 16-bit RGB PNG bytes (filter 0 scanlines)."""
    img = np.ascontiguousarray(img, np.uint16)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"expected [H, W, 3], got {img.shape}")
    raw = b"".join(b"\x00" + img[i].astype(">u2").tobytes() for i in range(h))

    def chunk(tag, data):
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    ihdr = struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw))
        + chunk(b"IEND", b"")
    )


def _defilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """PNG scanline reconstruction (RFC 2083 §6): inflated IDAT payload
    -> [h, stride] uint8.  None and Up are whole-row numpy operations, Sub
    a wrapping prefix sum per byte-offset residue class mod ``bpp``;
    Average and Paeth need the running left neighbour and go byte by
    byte."""
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for i in range(h):
        ftype = raw[i * (stride + 1)]
        line = np.frombuffer(raw, np.uint8, stride, i * (stride + 1) + 1)
        if ftype == 0:  # None
            cur = line
        elif ftype == 1:  # Sub: cur[j] = line[j] + cur[j - bpp]
            cur = np.empty(stride, np.uint8)
            for r in range(bpp):
                np.cumsum(line[r::bpp], dtype=np.uint8, out=cur[r::bpp])
        elif ftype == 2:  # Up
            cur = line + prev
        else:  # Average / Paeth
            cur8 = np.empty(stride, np.int64)
            line64 = line.astype(np.int64)
            prev64 = prev.astype(np.int64)
            for j in range(stride):
                a = cur8[j - bpp] if j >= bpp else 0
                b = prev64[j]
                if ftype == 3:
                    pred = (a + b) >> 1
                elif ftype == 4:
                    c = prev64[j - bpp] if j >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                else:
                    raise ValueError(f"bad PNG filter type {ftype}")
                cur8[j] = (line64[j] + pred) & 0xFF
            cur = cur8.astype(np.uint8)
        out[i] = cur
        prev = out[i]
    return out


def decode_png16(data: bytes) -> np.ndarray:
    """16-bit RGB PNG bytes -> [H, W, 3] uint16.  Handles all five
    scanline filters (third-party encoders pick one per row), several IDAT
    chunks, and rejects anything that is not 16-bit RGB non-interlaced."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, w = 8, None
    idat = []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, color, comp, filt, interlace = struct.unpack(">IIBBBBB", body)
            if (depth, color, comp, filt, interlace) != (16, 2, 0, 0, 0):
                raise ValueError(
                    f"unsupported PNG: depth={depth} color={color} interlace={interlace}"
                    " (need 16-bit RGB, non-interlaced)"
                )
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if w is None or not idat:
        raise ValueError("PNG missing IHDR/IDAT")
    raw = zlib.decompress(b"".join(idat))
    stride = w * 6  # 3 channels x 2 bytes
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG payload size {len(raw)} != {h}x({stride}+1)")
    out = _defilter(raw, h, stride, bpp=6)  # the filters work bytewise at pixel offsets
    return (out.reshape(h, w, 3, 2).astype(np.uint16)[..., 0] << 8) | out.reshape(h, w, 3, 2)[..., 1]


def read_png16(path) -> np.ndarray:
    """A 16-bit RGB PNG file as float64 [H, W, 3] (RGB order)."""
    with open(path, "rb") as f:
        return decode_png16(f.read()).astype(np.float64)


def write_flow_dsec_png(path, flow: np.ndarray, valid: np.ndarray = None) -> None:
    """Write a [2, H, W] displacement field (flow[0] the height direction,
    flow[1] the width direction, pixels over the window) as a DSEC
    submission PNG.  ``valid`` ([H, W] bool-like) defaults to all valid.
    Values are clipped to the representable +-255.99 px and quantized to
    1/128 px."""
    flow = np.asarray(flow, np.float64)
    if flow.ndim != 3 or flow.shape[0] != 2:
        raise ValueError(f"expected [2, H, W] flow, got {flow.shape}")
    _, h, w = flow.shape
    u = flow[1]  # width direction -> R channel
    v = flow[0]  # height direction -> G channel
    img = np.zeros((h, w, 3), np.uint16)
    img[..., 0] = np.clip(np.rint(u * 128.0 + 2**15), 0, 65535).astype(np.uint16)
    img[..., 1] = np.clip(np.rint(v * 128.0 + 2**15), 0, 65535).astype(np.uint16)
    img[..., 2] = (
        np.ones((h, w), np.uint16)
        if valid is None
        else (np.asarray(valid) > 0).astype(np.uint16)
    )
    with open(path, "wb") as f:
        f.write(encode_png16(img))


def save_flow_frame(out_dir, frame_index: int, flow: np.ndarray, fmt: str) -> None:
    """One frame's flow dump for the eval loops (``output.save_flow``):
    ``dsec_png`` -> <out_dir>/flow_submission/<NNNNNN>.png (the benchmark's
    layout), ``npz`` -> flow_submission/<NNNNNN>.npz with key ``flow``
    [2, H, W] float32."""
    sub = os.path.join(out_dir, "flow_submission")
    os.makedirs(sub, exist_ok=True)
    if fmt == "dsec_png":
        write_flow_dsec_png(os.path.join(sub, f"{frame_index:06d}.png"), flow)
    elif fmt == "npz":
        np.savez_compressed(
            os.path.join(sub, f"{frame_index:06d}.npz"),
            flow=np.asarray(flow, np.float32),
        )
    else:
        raise ValueError(f"unknown save_flow format {fmt!r} (dsec_png | npz)")
