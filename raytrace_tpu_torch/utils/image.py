"""Image files: PNG (gamma-mapped), PFM and EXR (linear float) writers and
readers, and image error metrics — a copy of raytrace_tpu/utils/image.py,
which is pure numpy already.

Numpy in, numpy out: a caller holding a tensor passes
`img.detach().cpu().numpy()`. For the same float32 array every writer puts
the same bytes on disk as the JAX package's.

The reference delegates image output to pbrt's film->WriteImage (EXR);
we write PFM for lossless linear radiance and PNG for quick looks.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def to_srgb(img: np.ndarray) -> np.ndarray:
    """Linear → sRGB with the standard piecewise curve (pbrt's ToneMap)."""
    img = np.clip(np.asarray(img, np.float64), 0.0, 1.0)
    return np.where(
        img <= 0.0031308, img * 12.92, 1.055 * img ** (1.0 / 2.4) - 0.055
    )


def write_png(path: str, img: np.ndarray, gamma: bool = True) -> None:
    """Write [H, W, 3] float (linear radiance) as 8-bit PNG via stdlib zlib."""
    if gamma:
        img = to_srgb(img)
    data = (np.clip(img, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    h, w, _ = data.shape
    raw = b"".join(
        b"\x00" + data[y].tobytes() for y in range(h)
    )

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def write_pfm(path: str, img: np.ndarray) -> None:
    """Write [H, W, 3] float32 as PFM (linear, lossless)."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"PF\n%d %d\n-1.0\n" % (w, h))
        f.write(img[::-1].tobytes())  # PFM is bottom-up


def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        if f.readline().strip() != b"PF":
            raise ValueError(f"{path}: not an RGB PFM file")
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(), "<f4" if scale < 0 else ">f4")
    return data.reshape(h, w, 3)[::-1].copy()


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """L2 image error (the vendored-but-unused sdkComparePPM analogue,
    util/cuda/helper_image.h — actually wired up this time)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def relative_error(a: np.ndarray, ref: np.ndarray, floor: float = 1e-2) -> float:
    """Mean relative radiance error with a luminance floor."""
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.mean(np.abs(a - ref) / np.maximum(np.abs(ref), floor)))


def write_exr(path: str, img: np.ndarray) -> None:
    """Write [H, W, 3] float32 as OpenEXR 2.0, scanline, uncompressed FLOAT
    channels — dependency-free. This closes the reference's film-output
    parity: pbrt writes the photon-mapping film as EXR
    (photonmappingrenderer.cpp:283 film->WriteImage → pbrt WriteImage .exr).

    Layout: magic+version, attribute header (channels B,G,R FLOAT;
    compression NO_COMPRESSION; data/display windows; scanline-increasing-y;
    the 4 required display attributes), a per-scanline offset table, then
    one block per scanline: y:int32, byte count, B row, G row, R row.
    """
    img = np.ascontiguousarray(np.asarray(img, np.float32))
    h, w, c = img.shape
    if c != 3:
        raise ValueError("write_exr expects RGB")

    def attr(name: bytes, typ: bytes, payload: bytes) -> bytes:
        return name + b"\x00" + typ + b"\x00" + struct.pack(
            "<I", len(payload)) + payload

    def chan(name: bytes) -> bytes:
        # name, pixel type 2 = FLOAT, pLinear 0 + 3 reserved, x/y sampling 1
        return name + b"\x00" + struct.pack("<iBBBBii", 2, 0, 0, 0, 0, 1, 1)

    channels = chan(b"B") + chan(b"G") + chan(b"R") + b"\x00"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (
        attr(b"channels", b"chlist", channels)
        + attr(b"compression", b"compression", b"\x00")  # NO_COMPRESSION
        + attr(b"dataWindow", b"box2i", box)
        + attr(b"displayWindow", b"box2i", box)
        + attr(b"lineOrder", b"lineOrder", b"\x00")  # increasing y
        + attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
        + attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0))
        + attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
        + b"\x00"
    )
    magic = struct.pack("<I", 20000630) + struct.pack("<I", 2)
    row_bytes = 3 * 4 * w
    block_bytes = 8 + row_bytes  # y + size prefix + pixel data
    table_start = len(magic) + len(header)
    data_start = table_start + 8 * h
    offsets = b"".join(
        struct.pack("<Q", data_start + y * block_bytes) for y in range(h)
    )
    with open(path, "wb") as f:
        f.write(magic)
        f.write(header)
        f.write(offsets)
        for y in range(h):
            f.write(struct.pack("<iI", y, row_bytes))
            f.write(img[y, :, 2].tobytes())  # B
            f.write(img[y, :, 1].tobytes())  # G
            f.write(img[y, :, 0].tobytes())  # R


def read_exr(path: str) -> np.ndarray:
    """Read the scanline FLOAT EXR files write_exr produces (round-trip /
    test support; not a general EXR reader)."""
    with open(path, "rb") as f:
        buf = f.read()
    if struct.unpack("<I", buf[:4])[0] != 20000630:
        raise ValueError(f"{path}: not an EXR file")
    pos = 8
    names = []
    width = height = None
    while buf[pos] != 0:
        nend = buf.index(b"\x00", pos)
        name = buf[pos:nend]
        tend = buf.index(b"\x00", nend + 1)
        typ = buf[nend + 1:tend]
        size = struct.unpack("<I", buf[tend + 1:tend + 5])[0]
        payload = buf[tend + 5:tend + 5 + size]
        if name == b"dataWindow":
            x0, y0, x1, y1 = struct.unpack("<iiii", payload)
            width, height = x1 - x0 + 1, y1 - y0 + 1
        if name == b"channels":
            p = 0
            while payload[p] != 0:
                ne = payload.index(b"\x00", p)
                names.append(payload[p:ne].decode())
                if struct.unpack("<i", payload[ne + 1:ne + 5])[0] != 2:
                    raise ValueError("read_exr only supports FLOAT channels")
                p = ne + 1 + 16
        if name == b"compression":
            if payload != b"\x00":
                raise ValueError("read_exr only supports uncompressed files")
        pos = tend + 5 + size
    pos += 1  # header terminator
    offsets = struct.unpack(f"<{height}Q", buf[pos:pos + 8 * height])
    img = np.zeros((height, width, 3), np.float32)
    order = {"R": 0, "G": 1, "B": 2}
    for o in offsets:
        y, nb = struct.unpack("<iI", buf[o:o + 8])
        row = np.frombuffer(buf[o + 8:o + 8 + nb], "<f4").reshape(
            len(names), width)
        for k, nm in enumerate(sorted(names)):
            if nm in order:
                img[y, :, order[nm]] = row[k]
    return img
