"""Image IO: OpenEXR (self-contained writer/reader, no deps) + PNG via PIL.

The reference writes EXR/PNG through the `exr`/`image` crates
(crates/akari_render/src/util/mod.rs:57-147). Python has no baked-in OpenEXR
module in this environment, so we implement the subset we need: single-part
scanline float32 RGB, no compression — valid EXR readable by any tool.
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_MAGIC = 20000630
_PIXEL_FLOAT = 2  # OpenEXR pixel type FLOAT


def _attr(name: str, type_: str, data: bytes) -> bytes:
    return name.encode() + b"\0" + type_.encode() + b"\0" + struct.pack("<i", len(data)) + data


def write_exr(path: str | Path, img: np.ndarray) -> None:
    """Write [H, W, 3] float32 linear RGB as uncompressed scanline EXR."""
    img = np.asarray(img, dtype=np.float32)
    assert img.ndim == 3 and img.shape[2] == 3, f"expected HxWx3, got {img.shape}"
    h, w, _ = img.shape

    # channel list, alphabetical: B, G, R
    chlist = b""
    for name in (b"B", b"G", b"R"):
        chlist += name + b"\0" + struct.pack("<i", _PIXEL_FLOAT) + struct.pack("<BBBB", 0, 0, 0, 0)
        chlist += struct.pack("<ii", 1, 1)
    chlist += b"\0"

    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = b"".join(
        [
            _attr("channels", "chlist", chlist),
            _attr("compression", "compression", struct.pack("<B", 0)),
            _attr("dataWindow", "box2i", box),
            _attr("displayWindow", "box2i", box),
            _attr("lineOrder", "lineOrder", struct.pack("<B", 0)),
            _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
            _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0)),
            _attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
            b"\0",
        ]
    )

    preamble = struct.pack("<ii", _MAGIC, 2) + header
    table_start = len(preamble)
    data_start = table_start + 8 * h
    line_size = 8 + 3 * 4 * w  # y + size prefix + 3 channels of floats
    offsets = struct.pack("<" + "Q" * h, *[data_start + i * line_size for i in range(h)])

    with open(path, "wb") as f:
        f.write(preamble)
        f.write(offsets)
        bgr = img[:, :, ::-1]  # B, G, R channel order, planar per scanline
        for y in range(h):
            f.write(struct.pack("<ii", y, 3 * 4 * w))
            f.write(np.ascontiguousarray(bgr[y].T).tobytes())


def read_exr(path: str | Path) -> np.ndarray:
    """Read an uncompressed scanline float RGB EXR (as written by write_exr)."""
    return read_exr_bytes(Path(path).read_bytes())


def read_exr_bytes(raw: bytes) -> np.ndarray:
    """Decode an uncompressed scanline float RGB EXR from memory — used for
    EXR image-texture buffers embedded in scene files (ref load.rs:588-614
    routes exr textures through a float decode)."""
    magic, version = struct.unpack_from("<ii", raw, 0)
    assert magic == _MAGIC, "not an EXR file"
    pos = 8
    attrs = {}
    while raw[pos] != 0:
        name_end = raw.index(b"\0", pos)
        name = raw[pos:name_end].decode()
        pos = name_end + 1
        type_end = raw.index(b"\0", pos)
        pos = type_end + 1
        (size,) = struct.unpack_from("<i", raw, pos)
        pos += 4
        attrs[name] = raw[pos : pos + size]
        pos += size
    pos += 1
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    assert attrs["compression"][0] == 0, "only uncompressed EXR supported"
    # parse channel names
    ch = attrs["channels"]
    cpos, names = 0, []
    while ch[cpos] != 0:
        cend = ch.index(b"\0", cpos)
        names.append(ch[cpos:cend].decode())
        cpos = cend + 1 + 16
    offsets = struct.unpack_from("<" + "Q" * h, raw, pos)
    img = np.zeros((h, w, len(names)), np.float32)
    for y, off in enumerate(offsets):
        _, size = struct.unpack_from("<ii", raw, off)
        line = np.frombuffer(raw, np.float32, count=len(names) * w, offset=off + 8)
        img[y] = line.reshape(len(names), w).T
    order = {n: i for i, n in enumerate(names)}
    if set(names) >= {"R", "G", "B"}:
        img = img[:, :, [order["R"], order["G"], order["B"]]]
    return img


def write_png(path: str | Path, img: np.ndarray, srgb_encode: bool = True) -> None:
    """Write [H, W, 3] linear float RGB to 8-bit PNG (sRGB-encoded by default)."""
    from PIL import Image

    img = np.asarray(img, dtype=np.float32)
    if srgb_encode:
        img = np.where(
            img <= 0.0031308, img * 12.92, 1.055 * np.maximum(img, 1e-10) ** (1 / 2.4) - 0.055
        )
    u8 = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    Image.fromarray(u8).save(str(path))


def write_image(path: str | Path, img: np.ndarray) -> None:
    """Dispatch by extension like the reference's util::write_image."""
    p = str(path)
    Path(p).parent.mkdir(parents=True, exist_ok=True)
    if p.endswith(".exr"):
        write_exr(p, img)
    elif p.endswith(".png"):
        write_png(p, img)
    else:
        raise ValueError(f"unsupported image extension: {p}")
