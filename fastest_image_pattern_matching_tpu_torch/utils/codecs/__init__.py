"""Lossless frame decoders and writers in numpy and the standard library
(zlib), with the grey levels of OpenCV's cv2.imread(path,
IMREAD_GRAYSCALE): PNG (png.py), PNM (pnm.py) and baseline TIFF
(tiff.py). utils/imageio.py routes files to them by their magic bytes."""


import numpy as np


def gray14(r, g, b) -> np.ndarray:
    """OpenCV's 14-bit luma on 8-bit R, G, B (int64 arrays), as its PxM,
    Sun raster and TIFF (RGBA) decoders grey colour:
    (4899 R + 9617 G + 1868 B + 8192) >> 14."""
    return ((4899 * r + 9617 * g + 1868 * b + 8192) >> 14).astype(np.uint8)


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """An image turned as its EXIF / TIFF Orientation (1-8) asks, as
    OpenCV's imread turns it (other values leave it as it is), C-ordered."""
    turned = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
              4: lambda a: a[::-1], 5: lambda a: a.T,
              6: lambda a: np.rot90(a, -1), 7: lambda a: a[::-1, ::-1].T,
              8: lambda a: np.rot90(a)}.get(orientation, lambda a: a)
    return np.ascontiguousarray(turned(img))


def exif_orientation(exif: bytes) -> int:
    """The Orientation tag (274) of IFD0 in a TIFF-structured EXIF block,
    or 1 where it is missing or malformed."""
    big = {b"II": "little", b"MM": "big"}.get(exif[:2])
    if big is None or len(exif) < 8:
        return 1
    off = int.from_bytes(exif[4:8], big)
    if off + 2 > len(exif):
        return 1
    for k in range(int.from_bytes(exif[off:off + 2], big)):
        e = off + 2 + 12 * k
        if e + 12 > len(exif):
            break
        if int.from_bytes(exif[e:e + 2], big) == 274:
            return int.from_bytes(exif[e + 8:e + 10], big)
    return 1
