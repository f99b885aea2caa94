"""Label map -> RGB colormap, and the classification-map PNGs.

Port-owned copy of ``hsimae_tpu/utils/colormap.py``: the same 20-entry
palette (class 0 renders black) and palette lookup. ``save_colormap`` writes
the PNG itself with ``zlib`` and ``struct`` (the JAX package calls
matplotlib, which the card's machine lacks): an 8-bit RGB image, row 0 at
the top, one IDAT chunk of unfiltered rows.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional

import numpy as np

# Palette indexed by class id; VOC-style bit-reversal colors.
_PALETTE = np.array(
    [
        [0, 0, 0],
        [128, 0, 0],
        [0, 128, 0],
        [128, 128, 0],
        [0, 0, 128],
        [128, 0, 128],
        [0, 128, 128],
        [0, 64, 128],
        [64, 0, 0],
        [192, 0, 0],
        [64, 128, 0],
        [192, 128, 0],
        [64, 0, 128],
        [192, 0, 128],
        [64, 128, 128],
        [192, 128, 128],
        [0, 64, 0],
        [128, 64, 0],
        [0, 192, 0],
        [128, 192, 0],
    ],
    dtype=np.uint8,
)

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def label_to_colormap(label: np.ndarray) -> np.ndarray:
    label = np.asarray(label, dtype=np.int64)
    assert label.max(initial=0) < len(_PALETTE), "only 20 classes are supported"
    return _PALETTE[label]


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png_rgb(rgb: np.ndarray, text: Optional[Dict[str, str]] = None) -> bytes:
    """An ``[h, w, 3]`` uint8 image as PNG bytes (bit depth 8, colour type 2,
    filter byte 0 before each row), with a ``tEXt`` chunk for each
    ``keyword: text`` of ``text`` (Latin-1)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, c = rgb.shape
    assert c == 3, rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    texts = b"".join(_chunk(b"tEXt", k.encode("latin-1") + b"\0" + v.encode("latin-1"))
                     for k, v in (text or {}).items())
    return (_PNG_SIGNATURE + _chunk(b"IHDR", ihdr) + texts
            + _chunk(b"IDAT", zlib.compress(rows.tobytes())) + _chunk(b"IEND", b""))


def save_colormap(path: str, label: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png_rgb(label_to_colormap(label)))
