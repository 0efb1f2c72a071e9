"""PNG reading and writing with ``zlib`` and numpy.

The port's replacement for ``PIL.Image.open(path).convert("RGB")`` in
the KITTI reader: 8-bit RGB and RGBA images (alpha dropped), not
interlaced; any other colour type, bit depth or interlace raises.

Each decoded row is unfiltered with the predictor its filter byte names
(None, Sub, Up, Average, Paeth).  Sub, Up and None only need the row
above, so an image without Average and Paeth rows is undone row by row,
one vectorised step per row (Sub as a running sum).  Average and Paeth
also read the pixel to the left, which is already unfiltered: a pixel
depends on its left, upper and upper-left neighbours, all on earlier
anti-diagonals.  Such an image is undone one anti-diagonal at a time
(H + W - 1 steps, every pixel of a diagonal at once, each row with its
own predictor), not pixel by pixel, and several frames of one size take
the steps together (``decode_pngs``), which spreads numpy's cost per call
over the batch.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {2: 3, 6: 4}                 # colour type -> samples per pixel
NONE, SUB, UP, AVERAGE, PAETH = range(5)


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        pos += 12 + length


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(filt, ftype):
    """Images with None, Sub and Up rows only: one step per row."""
    H, W, C = filt.shape
    out = np.empty((H, W, C), np.uint8)
    above = np.zeros((W, C), np.uint8)
    for r in range(H):
        row = filt[r]
        if ftype[r] == SUB:
            row = np.cumsum(row, axis=0, dtype=np.uint8)   # wraps mod 256
        elif ftype[r] == UP:
            row = row + above
        out[r] = row
        above = out[r]
    return out


def _unfilter_diagonals(filt, ftype):
    """Any filter mix, for a batch of images of one size: filt [F, H, W,
    C], ftype [F, H] -> [F, H, W, C] uint8, one step per anti-diagonal
    r + c = d for the whole batch.

    The images are skewed so that diagonal d is one slice of ``rec``
    (pixel (r, c) at rec[r + c + 2, :, r + 1]); its left and upper
    neighbours are then diagonal d - 1 at r + 1 and r, and its upper-left
    one diagonal d - 2 at r.  Entries left of an image stay zero (the
    predictors' outside value); entries right of it are never read by a
    pixel of the image."""
    F, H, W, C = filt.shape
    D = H + W - 1
    rr, cc = np.indices((H, W))
    f = np.zeros((D, F, H, C), np.int16)
    f[rr + cc, :, rr] = filt.transpose(1, 2, 0, 3)
    rec = np.zeros((D + 2, F, H + 1, C), np.int16)   # two zero diagonals
    kind = np.broadcast_to(ftype[:, :, None], (F, H, C))
    sub, up, avg, paeth = (kind == k for k in (SUB, UP, AVERAGE, PAETH))
    any_avg, any_paeth = avg.any(), paeth.any()
    for d in range(D):
        a, b, ul = rec[d + 1, :, 1:], rec[d + 1, :, :-1], rec[d, :, :-1]
        pred = np.where(sub, a, 0)
        pred = np.where(up, b, pred)
        if any_avg:
            pred = np.where(avg, (a + b) >> 1, pred)
        if any_paeth:
            pred = np.where(paeth, _paeth(a, b, ul), pred)
        np.bitwise_and(f[d] + pred, 0xFF, out=rec[d + 2, :, 1:])
    return rec[rr + cc + 2, :, rr + 1].transpose(2, 0, 1, 3).astype(np.uint8)


def _parse(data: bytes):
    """PNG bytes -> (filtered rows [H, W, C] uint8, filter types [H])."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    W, H, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in CHANNELS or interlace != 0:
        raise ValueError(f"PNG with bit depth {depth}, colour type {colour}, "
                         f"interlace {interlace}: only 8-bit RGB/RGBA, not "
                         "interlaced, is read")
    C = CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (1 + W * C):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected "
                         f"{H * (1 + W * C)}")
    raw = raw.reshape(H, 1 + W * C)
    ftype = raw[:, 0]
    if (ftype > PAETH).any():
        raise ValueError(f"PNG filter type {int(ftype.max())} is not 0-4")
    return raw[:, 1:].reshape(H, W, C), ftype


def decode_pngs(blobs: Sequence[bytes], batch: int = 16
                ) -> List[np.ndarray]:
    """PNG files' bytes -> [H, W, 3] uint8 RGB each.  Images of one size
    that need the diagonal pass share it, ``batch`` at a time: numpy's
    cost per call then spreads over the batch."""
    parsed = [_parse(b) for b in blobs]
    out: List[Optional[np.ndarray]] = [None] * len(parsed)
    groups: Dict[tuple, List[int]] = {}
    for i, (filt, ftype) in enumerate(parsed):
        if ((ftype == AVERAGE) | (ftype == PAETH)).any():
            groups.setdefault(filt.shape, []).append(i)
        else:
            out[i] = _unfilter_rows(filt, ftype)[..., :3]
    for members in groups.values():
        for s in range(0, len(members), batch):
            part = members[s:s + batch]
            imgs = _unfilter_diagonals(
                np.stack([parsed[i][0] for i in part]),
                np.stack([parsed[i][1] for i in part]))
            for i, img in zip(part, imgs):
                out[i] = img[..., :3]
    return [np.ascontiguousarray(x) for x in out]


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, 3] uint8 RGB."""
    return decode_pngs([data])[0]


def read_pngs(paths: Sequence[str]) -> List[np.ndarray]:
    """Decode the PNG files at ``paths`` -> [H, W, 3] uint8 RGB each."""
    blobs = []
    for p in paths:
        with open(p, "rb") as fh:
            blobs.append(fh.read())
    return decode_pngs(blobs)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(img: np.ndarray, filters=(NONE, SUB, UP, AVERAGE, PAETH),
               level: int = 6) -> bytes:
    """[H, W, 3|4] uint8 -> PNG bytes; row r takes filter
    ``filters[r % len(filters)]``."""
    img = np.ascontiguousarray(img, np.uint8)
    H, W, C = img.shape
    colour = {3: 2, 4: 6}[C]
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    ul = np.zeros_like(x)
    ul[1:, 1:] = x[:-1, :-1]
    pred = {NONE: np.zeros_like(x), SUB: a, UP: b, AVERAGE: (a + b) >> 1,
            PAETH: _paeth(a, b, ul)}
    ftype = np.asarray([filters[r % len(filters)] for r in range(H)],
                       np.uint8)
    rows = np.empty((H, 1 + W * C), np.uint8)
    rows[:, 0] = ftype
    for k in set(ftype.tolist()):
        sel = ftype == k
        rows[sel, 1:] = ((x[sel] - pred[k][sel]) & 0xFF).reshape(
            int(sel.sum()), W * C)
    header = struct.pack(">IIBBBBB", W, H, 8, colour, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray,
              filters=(NONE, SUB, UP, AVERAGE, PAETH)) -> None:
    """Write [H, W, 3|4] uint8 ``img`` to ``path`` as PNG."""
    with open(path, "wb") as fh:
        fh.write(encode_png(img, filters))
