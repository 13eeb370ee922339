"""The port's GeoTIFF reader and writer (``io/geotiff.py``, and ``.tif``
through ``io/esri.read_raster``) against the JAX package's.

The inputs are those of tests/test_geotiff.py: a seeded float raster with a
nodata cell, a hand-built big-endian int16 strip file with the horizontal
predictor, a PackBits stream, Pillow's LZW and PackBits files (uint8 and
float32 with the predictor), the ModelTransformation georeferencing (and a
rotated one, refused), a raster taller than 65,535 rows; and the DEM of
``problems.write_project(n=16)`` as a GeoTIFF. Every file is read equal
(values and header) by both packages, ``write_geotiff`` writes the same
bytes, and a project loaded from the ``.tif`` DEM gives the same grid.
"""

import dataclasses
import struct

import numpy as np
import pytest

from criteria3d_tpu.io import esri as JE
from criteria3d_tpu.io import geotiff as JG
from criteria3d_tpu.project import Criteria3DProject as JProject
from criteria3d_tpu_torch import problems
from criteria3d_tpu_torch.io import esri as TE
from criteria3d_tpu_torch.io import geotiff as TG
from criteria3d_tpu_torch.project import Criteria3DProject as TProject
from tests.test_torch_core import assert_fields

HDR = dict(nrows=25, ncols=18, xllcorner=650000.0, yllcorner=4900000.0,
           cellsize=50.0, nodata=-9999.0)


def read_both(path):
    """Read ``path`` with both packages; values and header equal."""
    tv, th = TG.read_geotiff(path)
    jv, jh = JG.read_geotiff(path)
    np.testing.assert_array_equal(tv, jv)
    assert tv.dtype == jv.dtype == np.float64
    assert dataclasses.asdict(th) == dataclasses.asdict(jh)
    return tv, th


def write_both(tmp_path, name, data, hdr=HDR):
    """Write ``data`` with both packages; the bytes must be equal."""
    pt, pj = str(tmp_path / f"t_{name}"), str(tmp_path / f"j_{name}")
    TG.write_geotiff(pt, data, TE.RasterHeader(**hdr))
    JG.write_geotiff(pj, data, JE.RasterHeader(**hdr))
    assert open(pt, "rb").read() == open(pj, "rb").read()
    return pt


def test_roundtrip_equal(tmp_path):
    rng = np.random.default_rng(1)
    data = rng.normal(100.0, 10.0, (25, 18))
    data[0, 0] = -9999.0
    data[3, 4] = np.nan
    path = write_both(tmp_path, "dem.tif", data)
    out, hdr = read_both(path)
    np.testing.assert_allclose(out[1:], np.where(np.isnan(data), -9999.0, data)[1:],
                               rtol=1e-6)
    assert out[0, 0] == -9999.0 and out[3, 4] == -9999.0
    assert (hdr.nrows, hdr.ncols, hdr.cellsize) == (25, 18, 50.0)
    assert hdr.yllcorner == pytest.approx(4900000.0)


def test_big_endian_int16_with_predictor(tmp_path):
    """tests/test_geotiff.py's hand-built MM-order int16 strip file."""
    R, C = 4, 6
    vals = np.arange(R * C, dtype=np.int16).reshape(R, C) * 3 + 100
    diff = vals.copy()
    diff[:, 1:] = vals[:, 1:] - vals[:, :-1]
    pixel = diff.astype(">i2").tobytes()

    def entry(tag, typ, count, val_bytes):
        return struct.pack(">HH", tag, typ) + struct.pack(">I", count) \
            + val_bytes.ljust(4, b"\0")

    n = 10
    strips_off = 8 + 2 + n * 12 + 4
    e = b"".join([
        entry(256, 3, 1, struct.pack(">H", C)), entry(257, 3, 1, struct.pack(">H", R)),
        entry(258, 3, 1, struct.pack(">H", 16)), entry(259, 3, 1, struct.pack(">H", 1)),
        entry(273, 4, 1, struct.pack(">I", strips_off)),
        entry(277, 3, 1, struct.pack(">H", 1)), entry(278, 3, 1, struct.pack(">H", R)),
        entry(279, 4, 1, struct.pack(">I", len(pixel))),
        entry(317, 3, 1, struct.pack(">H", 2)), entry(339, 3, 1, struct.pack(">H", 2))])
    buf = b"MM" + struct.pack(">H", 42) + struct.pack(">I", 8) \
        + struct.pack(">H", n) + e + struct.pack(">I", 0) + pixel
    path = tmp_path / "be.tif"
    path.write_bytes(buf)
    out, _ = read_both(str(path))
    np.testing.assert_array_equal(out, vals.astype(np.float64))


def test_packbits_and_lzw_decoders_equal():
    enc = bytes([2, 1, 2, 3, 253, 0xAB, 128, 0, 9])
    for n in (7, 8, 100):
        assert TG._unpackbits(enc, n) == JG._unpackbits(enc, n)
    assert TG._unpackbits(enc, 7) == bytes([1, 2, 3]) + bytes([0xAB]) * 4
    # an LZW stream: 9-bit codes 256 (clear), 65, 66, 258, 257 (end)
    bits = "".join(format(c, "09b") for c in (256, 65, 66, 258, 257))
    bits += "0" * (-len(bits) % 8)
    stream = int(bits, 2).to_bytes(len(bits) // 8, "big")
    assert TG._lzw_decode(stream, 10) == JG._lzw_decode(stream, 10) == b"ABAB"


@pytest.mark.parametrize("kind", ["lzw_u8", "packbits_u8", "lzw_f32"])
def test_pillow_files_read_equal(tmp_path, kind):
    """LZW and PackBits files of an independent writer (Pillow)."""
    from PIL import Image
    rng = np.random.default_rng(0)
    if kind == "lzw_f32":
        data = rng.normal(50.0, 5.0, (40, 31)).astype(np.float32)
        Image.fromarray(data, mode="F").save(str(tmp_path / "x.tif"),
                                             compression="tiff_lzw")
    else:
        data = rng.integers(0, 6, (64, 53), dtype=np.uint8) * 7
        Image.fromarray(data).save(str(tmp_path / "x.tif"),
                                   compression="tiff_lzw" if kind == "lzw_u8"
                                   else "packbits")
    out, hdr = read_both(str(tmp_path / "x.tif"))
    np.testing.assert_array_equal(out, data.astype(np.float64))
    assert (hdr.cellsize, hdr.xllcorner) == (1.0, 0.0)


def test_model_transformation_georef(tmp_path):
    """tests/test_geotiff.py's rewrite of PixelScale + Tiepoint into one
    axis-aligned ModelTransformation: the same header from both; a rotated
    matrix is refused by both."""
    data = np.arange(12.0, dtype=np.float32).reshape(3, 4)
    path = write_both(tmp_path, "t.tif", data)
    raw = bytearray(open(path, "rb").read())
    n = struct.unpack_from("<H", raw, 8)[0]
    cs, xll, yll = HDR["cellsize"], HDR["xllcorner"], HDR["yllcorner"]
    top_y = yll + 3 * cs
    matrix = struct.pack("<16d", cs, 0, 0, xll, 0, -cs, 0, top_y, *([0] * 8))
    off = len(raw)
    raw += matrix
    patched = 0
    for i in range(n):
        e = 10 + i * 12
        tag = struct.unpack_from("<H", raw, e)[0]
        if tag in (TG._MODEL_PIXEL_SCALE, TG._MODEL_TIEPOINT) and not patched:
            struct.pack_into("<HHII", raw, e, 34264, 12, 16, off)
            patched += 1
        elif tag in (TG._MODEL_PIXEL_SCALE, TG._MODEL_TIEPOINT):
            struct.pack_into("<HHII", raw, e, 34264 + 1, 3, 1, 0)
    (tmp_path / "t2.tif").write_bytes(bytes(raw))
    out, hdr = read_both(str(tmp_path / "t2.tif"))
    np.testing.assert_array_equal(out, data.astype(np.float64))
    assert (hdr.cellsize, hdr.xllcorner) == (cs, xll)
    assert hdr.yllcorner == pytest.approx(yll)
    raw[off:off + len(matrix)] = struct.pack("<16d", cs, 0.1, 0, xll, 0.1, -cs, 0,
                                             top_y, *([0] * 8))
    (tmp_path / "t3.tif").write_bytes(bytes(raw))
    for g in (TG, JG):
        with pytest.raises(ValueError, match="rotated"):
            g.read_geotiff(str(tmp_path / "t3.tif"))


def test_long_dimension_tags(tmp_path):
    """A raster taller than 65,535 rows (LONG dimension tags)."""
    data = np.zeros((70000, 3), dtype=np.float32)
    data[0, 0], data[-1, -1] = 7.0, 9.0
    out, _ = read_both(write_both(tmp_path, "tall.tif", data))
    assert out.shape == (70000, 3) and out[0, 0] == 7.0 and out[-1, -1] == 9.0


def test_files_of_either_writer_read_equal(tmp_path):
    """A file written by either package reads equal in both (also through
    read_raster, with and without its extension); files that are not TIFF
    or hold several samples a pixel are refused alike."""
    rng = np.random.default_rng(5)
    data = rng.uniform(-50.0, 900.0, (9, 13))
    hdr = dict(HDR, nrows=9, ncols=13, xllcorner=-120.5, cellsize=2.5)
    for name, g, e in (("t.tif", TG, TE), ("j.tif", JG, JE)):
        g.write_geotiff(str(tmp_path / name), data, e.RasterHeader(**hdr))
        v, h = read_both(str(tmp_path / name))
        for path in (str(tmp_path / name), str(tmp_path / name[:-4])):
            tv, th = TE.read_raster(path)
            jv, jh = JE.read_raster(path)
            np.testing.assert_array_equal(tv, v)
            np.testing.assert_array_equal(jv, v)
            assert dataclasses.asdict(th) == dataclasses.asdict(jh)
    (tmp_path / "bad.tif").write_bytes(b"XX\0\0")
    from PIL import Image
    Image.fromarray(np.zeros((4, 5, 3), np.uint8)).save(str(tmp_path / "rgb.tif"))
    for g in (TG, JG):
        with pytest.raises(ValueError, match="not a TIFF"):
            g.read_geotiff(str(tmp_path / "bad.tif"))
        with pytest.raises(ValueError, match="single-band"):
            g.read_geotiff(str(tmp_path / "rgb.tif"))


def test_project_loads_a_tif_dem(tmp_path):
    """problems.dem_as_geotiff: the project's DEM as a GeoTIFF; Criteria3D
    Project.load and initialize of both packages give the same DEM, header
    and grid (bit-equal or rel 1e-14, as from the .flt DEM)."""
    ini = problems.write_project(str(tmp_path / "p"), n=16, seed=0, n_stations=6)
    flt, flt_hdr = TE.read_raster(str(tmp_path / "p" / "MAPS" / "dem.flt"))
    tif = problems.dem_as_geotiff(ini)
    assert tif.endswith("MAPS/dem.tif") and "dem = MAPS/dem.tif" in open(ini).read()
    tp = TProject.load(ini, output_dir=str(tmp_path / "t"))
    jp = JProject.load(ini, output_dir=str(tmp_path / "j"))
    np.testing.assert_array_equal(tp.dem, jp.dem)
    np.testing.assert_array_equal(tp.dem, flt)
    assert dataclasses.asdict(tp.header) == dataclasses.asdict(jp.header)
    assert dataclasses.asdict(tp.header) == dataclasses.asdict(flt_hdr)
    tp.initialize(device="cpu")
    jp.initialize()
    assert_fields(jp.grid, tp.grid, rtol=1e-14)
