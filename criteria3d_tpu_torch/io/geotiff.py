"""Single-band GeoTIFF raster IO, pure spec implementation.

The port's own copy of ``criteria3d_tpu/io/geotiff.py``, line for line
(host numpy and ``struct``; the same bytes for the same arrays).

The reference's optional ``agrolib/gdalHandler`` imports rasters through
GDAL (gdalHandler.cpp: gdalReadRaster -> Crit3DRasterGrid with the
geotransform applied). This module covers the raster half for the common
agro-hydrology exchange case — single-band GeoTIFF in a projected CRS —
without the GDAL dependency:

* read: strip- or tile-organised, uint8/16/32, int16/32, float32/64,
  compression none (1), LZW (5) or PackBits (32773), horizontal-difference
  predictor (2), either byte order; georeferencing from
  ModelPixelScale + ModelTiepoint (GeoTIFF spec 2.6.1) and the GDAL
  NODATA ascii tag;
* write: uncompressed float32 strips with pixel scale / tiepoint / nodata
  so the output re-imports into GIS tools.

Returns the same :class:`criteria3d_tpu_torch.io.esri.RasterHeader` the rest of
the IO stack uses (north-up rasters; row 0 = northernmost, as ESRI grids).
"""

from __future__ import annotations

import struct

import numpy as np

from criteria3d_tpu_torch.io.esri import RasterHeader

__all__ = ["read_geotiff", "write_geotiff"]

# TIFF tag ids
_W, _H = 256, 257
_BITS, _COMP, _PHOTO = 258, 259, 262
_STRIP_OFF, _SPP, _ROWS_PER_STRIP, _STRIP_CNT = 273, 277, 278, 279
_PLANAR, _PREDICTOR = 284, 317
_TILE_W, _TILE_H, _TILE_OFF, _TILE_CNT = 322, 323, 324, 325
_SAMPLE_FMT = 339
_MODEL_PIXEL_SCALE, _MODEL_TIEPOINT = 33550, 33922
_MODEL_TRANSFORMATION = 34264
_GDAL_NODATA = 42113

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
              10: 8, 11: 4, 12: 8, 16: 8, 17: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f",
             12: "d", 16: "Q", 17: "q"}


def _read_ifd_entries(buf, off, bo, big):
    if big:
        n = struct.unpack(bo + "Q", buf[off:off + 8])[0]
        entry_size, base = 20, off + 8
    else:
        n = struct.unpack(bo + "H", buf[off:off + 2])[0]
        entry_size, base = 12, off + 2
    entries = {}
    for i in range(n):
        e = buf[base + i * entry_size: base + (i + 1) * entry_size]
        if big:
            tag, typ = struct.unpack(bo + "HH", e[:4])
            count = struct.unpack(bo + "Q", e[4:12])[0]
            payload = e[12:20]
        else:
            tag, typ = struct.unpack(bo + "HH", e[:4])
            count = struct.unpack(bo + "I", e[4:8])[0]
            payload = e[8:12]
        size = _TYPE_SIZE.get(typ, 1) * count
        if size <= len(payload):
            raw = payload[:size]
        else:
            ptr = struct.unpack(bo + ("Q" if big else "I"), payload)[0]
            raw = buf[ptr:ptr + size]
        if typ in (2, 7):                       # ascii / undefined
            entries[tag] = raw
        elif typ == 5:                          # rational
            vals = struct.unpack(bo + "I" * (2 * count), raw)
            entries[tag] = [vals[2 * i] / max(vals[2 * i + 1], 1)
                            for i in range(count)]
        else:
            fmt = _TYPE_FMT.get(typ)
            if fmt is None:
                continue
            entries[tag] = list(struct.unpack(bo + fmt * count, raw))
    return entries


def _unpackbits(data: bytes, expected: int) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data) and len(out) < expected:
        n = data[i]
        i += 1
        if n < 128:
            out += data[i:i + n + 1]
            i += n + 1
        elif n > 128:
            out += data[i:i + 1] * (257 - n)
            i += 1
        # n == 128: no-op
    return bytes(out)


def _lzw_decode(data: bytes, expected: int) -> bytes:
    """TIFF-variant LZW (MSB-first bit packing, early code change)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    table = []

    def reset():
        nonlocal table
        table = [bytes([i]) for i in range(256)] + [b"", b""]

    reset()
    bitpos = 0
    nbits = 9
    prev = None
    total_bits = len(data) * 8
    while bitpos + nbits <= total_bits and len(out) < expected:
        byte0 = bitpos >> 3
        chunk = data[byte0:byte0 + 4].ljust(4, b"\0")
        word = struct.unpack(">I", chunk)[0]
        code = (word >> (32 - (bitpos & 7) - nbits)) & ((1 << nbits) - 1)
        bitpos += nbits
        if code == EOI:
            break
        if code == CLEAR:
            reset()
            nbits = 9
            prev = None
            continue
        if prev is None:
            entry = table[code]
            out += entry
        else:
            if code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            else:
                entry = prev + prev[:1]
                table.append(entry)
            out += entry
        prev = entry
        # TIFF "early change": bump width one code early
        if len(table) + 1 >= (1 << nbits) and nbits < 12:
            nbits += 1
    return bytes(out)


def read_geotiff(path: str) -> tuple[np.ndarray, RasterHeader]:
    """Read a single-band GeoTIFF; returns (values (R, C) float64, header).

    NODATA cells are set to the header's nodata value (GDAL tag when
    present, else -9999).
    """
    with open(path, "rb") as f:
        buf = f.read()

    order = buf[:2]
    if order == b"II":
        bo = "<"
    elif order == b"MM":
        bo = ">"
    else:
        raise ValueError(f"{path}: not a TIFF file")
    magic = struct.unpack(bo + "H", buf[2:4])[0]
    if magic == 42:
        big = False
        ifd_off = struct.unpack(bo + "I", buf[4:8])[0]
    elif magic == 43:                           # BigTIFF
        big = True
        ifd_off = struct.unpack(bo + "Q", buf[8:16])[0]
    else:
        raise ValueError(f"{path}: bad TIFF magic {magic}")

    t = _read_ifd_entries(buf, ifd_off, bo, big)

    width = int(t[_W][0])
    height = int(t[_H][0])
    spp = int(t.get(_SPP, [1])[0])
    if spp != 1:
        raise ValueError(f"{path}: {spp} samples/pixel; single-band only")
    if int(t.get(_PLANAR, [1])[0]) != 1:
        raise ValueError(f"{path}: planar configuration unsupported")
    bits = int(t.get(_BITS, [8])[0])
    comp = int(t.get(_COMP, [1])[0])
    fmt = int(t.get(_SAMPLE_FMT, [1])[0])
    predictor = int(t.get(_PREDICTOR, [1])[0])

    dtype = {
        (1, 8): "u1", (1, 16): "u2", (1, 32): "u4",
        (2, 8): "i1", (2, 16): "i2", (2, 32): "i4",
        (3, 32): "f4", (3, 64): "f8",
    }.get((fmt, bits))
    if dtype is None:
        raise ValueError(f"{path}: sample format {fmt}/{bits} unsupported")
    dt = np.dtype(bo + dtype)
    px = dt.itemsize

    def decode(raw: bytes, n_expected: int) -> bytes:
        if comp == 1:
            return raw[:n_expected]
        if comp == 5:
            return _lzw_decode(raw, n_expected)
        if comp == 32773:
            return _unpackbits(raw, n_expected)
        raise ValueError(f"{path}: compression {comp} unsupported")

    data = np.empty((height, width), dtype=dt)
    if _TILE_OFF in t:
        tw, th = int(t[_TILE_W][0]), int(t[_TILE_H][0])
        offs, cnts = t[_TILE_OFF], t[_TILE_CNT]
        tiles_across = (width + tw - 1) // tw
        for i, (o, c) in enumerate(zip(offs, cnts)):
            tr, tc = divmod(i, tiles_across)
            raw = decode(buf[int(o):int(o) + int(c)], tw * th * px)
            tile = np.frombuffer(raw, dtype=dt, count=tw * th).reshape(th, tw)
            if predictor == 2:
                tile = np.cumsum(tile.astype(np.int64), axis=1).astype(dt)
            r0, c0 = tr * th, tc * tw
            data[r0:min(r0 + th, height), c0:min(c0 + tw, width)] = \
                tile[:min(th, height - r0), :min(tw, width - c0)]
    else:
        rows_per = int(t.get(_ROWS_PER_STRIP, [height])[0])
        offs, cnts = t[_STRIP_OFF], t[_STRIP_CNT]
        r = 0
        for o, c in zip(offs, cnts):
            nrows = min(rows_per, height - r)
            raw = decode(buf[int(o):int(o) + int(c)], nrows * width * px)
            strip = np.frombuffer(raw, dtype=dt,
                                  count=nrows * width).reshape(nrows, width)
            if predictor == 2:
                strip = np.cumsum(strip.astype(np.int64), axis=1).astype(dt)
            data[r:r + nrows] = strip
            r += nrows
    values = data.astype(np.float64)

    nodata = -9999.0
    if _GDAL_NODATA in t:
        try:
            nodata = float(t[_GDAL_NODATA].split(b"\0")[0])
        except ValueError:
            pass
    values = np.where(np.isclose(values, nodata) | ~np.isfinite(values),
                      -9999.0, values)

    # georeferencing: pixel scale + tiepoint (north-up), or an axis-aligned
    # ModelTransformation matrix (the alternative GDAL output style)
    sx = sy = 1.0
    origin_x = origin_y = 0.0
    if _MODEL_PIXEL_SCALE in t or _MODEL_TIEPOINT in t:
        if _MODEL_PIXEL_SCALE in t:
            ps = t[_MODEL_PIXEL_SCALE]
            sx, sy = float(ps[0]), float(ps[1])
        if _MODEL_TIEPOINT in t:
            tp = t[_MODEL_TIEPOINT]
            # raster point (I,J,K) -> model (X,Y,Z); standard (0,0) upper-left
            origin_x = float(tp[3]) - float(tp[0]) * sx
            origin_y = float(tp[4]) + float(tp[1]) * sy
    elif _MODEL_TRANSFORMATION in t:
        # 4x4 row-major matrix: X = m[0]*col + m[1]*row + m[3],
        #                       Y = m[4]*col + m[5]*row + m[7]
        m = [float(v) for v in t[_MODEL_TRANSFORMATION]]
        if m[1] != 0.0 or m[4] != 0.0:
            raise ValueError(f"{path}: rotated ModelTransformation "
                             "unsupported (non-axis-aligned georeferencing)")
        sx, sy = m[0], -m[5]
        origin_x, origin_y = m[3], m[7]
        if sx <= 0 or sy <= 0:
            raise ValueError(f"{path}: unsupported axis orientation in "
                             f"ModelTransformation (scale {m[0]} x {m[5]})")
    # plain (ungeoreferenced) TIFFs keep the 1.0 / (0,0) defaults
    header = RasterHeader(
        nrows=height, ncols=width,
        xllcorner=origin_x,
        yllcorner=origin_y - height * sy,
        cellsize=sx, nodata=-9999.0)
    if abs(sx - sy) > 1e-6 * max(sx, sy):
        raise ValueError(f"{path}: non-square pixels ({sx} x {sy})")
    return values, header


def write_geotiff(path: str, values: np.ndarray, header: RasterHeader) -> None:
    """Write a single-band float32 GeoTIFF (uncompressed, north-up)."""
    arr = np.ascontiguousarray(np.asarray(values, dtype="<f4"))
    R, C = arr.shape
    pixel_data = arr.tobytes()
    if len(pixel_data) >= 2 ** 32:
        raise ValueError(f"raster {R}x{C} exceeds the 4 GB classic-TIFF "
                         "limit (BigTIFF writing not supported)")
    nodata_ascii = f"{header.nodata}\0".encode()

    entries = []       # (tag, type, count, value_bytes)

    def entry(tag, typ, count, packed):
        entries.append((tag, typ, count, packed))

    le = struct.pack
    entry(_W, 4, 1, le("<I", C))
    entry(_H, 4, 1, le("<I", R))
    entry(_BITS, 3, 1, le("<H", 32) + b"\0\0")
    entry(_COMP, 3, 1, le("<H", 1) + b"\0\0")
    entry(_PHOTO, 3, 1, le("<H", 1) + b"\0\0")
    entry(_STRIP_OFF, 4, 1, None)               # patched below
    entry(_SPP, 3, 1, le("<H", 1) + b"\0\0")
    entry(_ROWS_PER_STRIP, 4, 1, le("<I", R))
    entry(_STRIP_CNT, 4, 1, le("<I", len(pixel_data)))
    entry(_SAMPLE_FMT, 3, 1, le("<H", 3) + b"\0\0")
    scale = struct.pack("<3d", header.cellsize, header.cellsize, 0.0)
    entry(_MODEL_PIXEL_SCALE, 12, 3, scale)
    top_y = header.yllcorner + R * header.cellsize
    tie = struct.pack("<6d", 0.0, 0.0, 0.0, header.xllcorner, top_y, 0.0)
    entry(_MODEL_TIEPOINT, 12, 6, tie)
    entry(_GDAL_NODATA, 2, len(nodata_ascii), nodata_ascii)

    n = len(entries)
    ifd_off = 8
    data_off = ifd_off + 2 + n * 12 + 4         # after IFD + next-IFD ptr
    # lay out out-of-line values
    out_of_line = []
    for i, (tag, typ, count, packed) in enumerate(entries):
        if packed is not None and len(packed) > 4:
            out_of_line.append((i, packed))
    ool_bytes = b"".join(p for _, p in out_of_line)
    strips_off = data_off + len(ool_bytes)

    buf = bytearray()
    buf += b"II" + le("<H", 42) + le("<I", ifd_off)
    buf += le("<H", n)
    cursor = data_off
    ool_iter = iter(out_of_line)
    ool_positions = {}
    for i, (tag, typ, count, packed) in enumerate(entries):
        if packed is not None and len(packed) > 4:
            ool_positions[i] = cursor
            cursor += len(packed)
    for i, (tag, typ, count, packed) in enumerate(entries):
        if tag == _STRIP_OFF:
            val = le("<I", strips_off)
        elif packed is None:
            val = le("<I", 0)
        elif len(packed) > 4:
            val = le("<I", ool_positions[i])
        else:
            val = packed.ljust(4, b"\0")
        buf += le("<HH", tag, typ) + le("<I", count) + val
    buf += le("<I", 0)                          # no next IFD
    buf += ool_bytes
    buf += pixel_data

    with open(path, "wb") as f:
        f.write(bytes(buf))
