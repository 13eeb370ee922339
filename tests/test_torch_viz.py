"""The port's quick-look PNGs and headless renderers (``io/quicklook.py``,
``viz/``) against the JAX package's.

The inputs are those of tests/test_viz.py and tests/test_cli.py: the
seeded Gaussian hill with a nodata corner, an overlay ramp, a station, a
two-day sine series, a seeded lapse scatter, two soil horizons, constant
APNG frames. Both packages render the same arrays; every image must be
equal pixel for pixel and every file byte for byte (numpy, ``struct`` and
``zlib`` in both). The HTML report is byte-equal with its footer, which
carries the package's name and the time, masked.
"""

import datetime as dt
import re

import numpy as np
import pytest

from criteria3d_tpu import viz as JV
from criteria3d_tpu.io import quicklook as JQ
from criteria3d_tpu.io.esri import RasterHeader as JHeader
from criteria3d_tpu.viz import font as JF
from criteria3d_tpu_torch import viz as TV
from criteria3d_tpu_torch.io import quicklook as TQ
from criteria3d_tpu_torch.io.esri import RasterHeader as THeader
from criteria3d_tpu_torch.viz import font as TF

NODATA = -9999.0


@pytest.fixture(scope="module")
def hill_dem():
    yy, xx = np.mgrid[:40, :50]
    dem = 100.0 + 30.0 * np.exp(-((yy - 20.0) ** 2 + (xx - 25.0) ** 2)
                                / 150.0)
    dem[:4, :4] = NODATA
    return dem


HDR = dict(nrows=40, ncols=50, xllcorner=1000.0, yllcorner=2000.0,
           cellsize=10.0, nodata=NODATA)


def same_file(tmp_path, name, write_j, write_t):
    """Both packages write ``name``; the bytes must be equal."""
    pj, pt = tmp_path / f"j_{name}", tmp_path / f"t_{name}"
    rj, rt = write_j(str(pj)), write_t(str(pt))
    assert pj.read_bytes() == pt.read_bytes(), name
    return rj, rt


def same_canvas(tmp_path, name, make):
    """``make(viz)`` in each package; equal RGBA and equal PNG bytes."""
    cj, ct = make(JV), make(TV)
    np.testing.assert_array_equal(ct.rgba, cj.rgba)
    same_file(tmp_path, name, cj.save, ct.save)
    return ct


def test_font_glyphs_equal():
    assert sorted(TF.GLYPHS) == sorted(JF.GLYPHS)
    for ch in JF.GLYPHS:
        np.testing.assert_array_equal(TF.GLYPHS[ch], JF.GLYPHS[ch])
    for s, scale in (("A1", 2), ("é", 1), ("Z x1.5  ROT 20°", 1), ("", 3)):
        np.testing.assert_array_equal(TF.render_text_mask(s, scale),
                                      JF.render_text_mask(s, scale))
    assert TV.text_size("ABC", 2) == JV.text_size("ABC", 2)


@pytest.mark.parametrize("scale", sorted(JQ.COLOR_SCALES))
def test_quicklook_scales_and_png_bytes(tmp_path, scale):
    """classify_colors, render_rgba and write_png_raster (with and without
    the legend bar, free and fixed range) on the EXPORTPNG test's ramp."""
    np.testing.assert_array_equal(TQ.classify_colors(scale),
                                  JQ.classify_colors(scale))
    data = np.linspace(0.0, 30.0, 64).reshape(8, 8)
    data[0, 0] = NODATA
    np.testing.assert_array_equal(TQ.render_rgba(data, scale),
                                  JQ.render_rgba(data, scale))
    for legend, vmin, vmax in ((True, None, None), (False, 5.0, 20.0)):
        rj, rt = same_file(
            tmp_path, f"{legend}.png",
            lambda p: JQ.write_png_raster(p, data, scale, vmin=vmin, vmax=vmax,
                                          legend=legend),
            lambda p: TQ.write_png_raster(p, data, scale, vmin=vmin, vmax=vmax,
                                          legend=legend))
        assert rj == rt


def test_canvas_primitives(tmp_path):
    def make(v):
        cv = v.Canvas(40, 30)
        cv.line(0, 0, 39, 29, (255, 0, 0), width=1)
        cv.polyline([(1, 28), (20, 3), (38, 25)], (9, 9, 9), width=2)
        for i, shape in enumerate(("circle", "square", "triangle")):
            cv.marker(10 + 10 * i, 20, (0, 128, 0), size=5, shape=shape)
        cv.text(2, 2, "HI", color=(0, 0, 255))
        cv.text(38, 28, "SE", anchor="se", scale=1)
        cv.frame_rect(3, 3, 30, 20, (1, 2, 3))
        tile = np.zeros((4, 4, 4), np.uint8)
        tile[..., 0] = 200
        tile[..., 3] = 128
        cv.blit(2, 2, tile)
        cv.blit(-2, 28, tile)
        return cv
    same_canvas(tmp_path, "c.png", make)


def test_hillshade_equal(hill_dem):
    for scale in ("gray", "dtm"):
        np.testing.assert_array_equal(TV.hillshade_rgb(hill_dem, 10.0, scale),
                                      JV.hillshade_rgb(hill_dem, 10.0, scale))


@pytest.mark.parametrize("case", ["overlay_points", "dem_only", "decimated"])
def test_render_map_equal(tmp_path, hill_dem, case):
    overlay = np.where(np.isclose(hill_dem, NODATA), NODATA,
                       np.linspace(0, 1, 50)[None, :] * np.ones((40, 1)))
    x = 1000.0 + 30.5 * 10.0
    y = 2000.0 + (40 - 10 - 0.5) * 10.0

    def make(v):
        hdr = (JHeader if v is JV else THeader)(**HDR)
        if case == "overlay_points":
            return v.render_map(hill_dem, header=hdr, overlay=overlay,
                                overlay_scale="precipitation",
                                points=[(x, y, "ST1"), (x - 100.0, y)],
                                title="T", target_width=500)
        if case == "dem_only":
            return v.render_map(hill_dem, 10.0, title="DEM")
        big = np.tile(np.linspace(0, 100, 600)[None, :], (450, 1))
        return v.render_map(big, 5.0, target_width=200)
    same_canvas(tmp_path, f"{case}.png", make)


@pytest.mark.parametrize("case", ["relief", "top_down", "overlay", "empty",
                                  "decimated"])
def test_render_surface3d_equal(tmp_path, hill_dem, case):
    ov = np.where(np.isclose(hill_dem, NODATA), NODATA, 5.0)

    def make(v):
        if case == "relief":
            return v.render_surface3d(hill_dem, 10.0, width=400, height=300,
                                      title="V", rotation_deg=30.0)
        if case == "top_down":
            return v.render_surface3d(hill_dem, 10.0, width=400, height=300,
                                      tilt_deg=0.0)
        if case == "overlay":
            return v.render_surface3d(hill_dem, 10.0, width=300, height=220,
                                      overlay=ov, overlay_scale="surface_water")
        if case == "empty":
            return v.render_surface3d(np.full((5, 5), NODATA), 1.0,
                                      width=120, height=90)
        return v.render_surface3d(hill_dem, 10.0, width=200, height=150,
                                  max_cells=500)
    same_canvas(tmp_path, f"{case}.png", make)


def test_charts_equal(tmp_path):
    t = [dt.datetime(2024, 5, 1) + dt.timedelta(hours=h) for h in range(48)]
    y1 = 15 + 8 * np.sin(np.arange(48) / 24 * 2 * np.pi)
    y2 = np.full(48, 10.0)
    y2[20:30] = np.nan
    rng = np.random.default_rng(0)
    x = rng.uniform(100, 900, 50)
    y = 20.0 - 0.0065 * x + rng.normal(0, 0.2, 50)
    same_canvas(tmp_path, "line.png", lambda v: v.line_chart(
        {"T": (t, y1), "D": (t, y2)}, title="M", ylabel="C"))
    same_canvas(tmp_path, "num.png", lambda v: v.line_chart(
        {"P": ([0.0, 1.0, 2.0], [1.0, np.nan, 3.0])}))
    same_canvas(tmp_path, "scatter.png", lambda v: v.scatter_chart(
        x, y, xlabel="Z", ylabel="T", title="PROXY T"))
    for v in (JV, TV):
        with pytest.raises(ValueError, match="numeric x"):
            v.line_chart({"A": (t, y1), "B": ([0.0, 1.0], [1.0, 2.0])})


def test_soil_curves_equal(tmp_path):
    loam = dict(name="LOAM", vg_alpha=3.6, vg_n=1.56, vg_he=0.02,
                theta_s=0.43, theta_r=0.078, k_sat=2.9e-6)
    clay = dict(name="CLAY", vg_alpha=0.8, vg_n=1.09, vg_he=0.05,
                theta_s=0.38, theta_r=0.068, k_sat=5.6e-7)
    same_canvas(tmp_path, "ret.png", lambda v: v.retention_plot(
        [loam, clay], lab_points=[(10.0, 0.30)]))
    same_canvas(tmp_path, "cond.png", lambda v: v.conductivity_plot([loam, clay]))


def mask_footer(html: str) -> str:
    out, n = re.subn(r"<footer>[^<]*</footer>", "<footer/>", html)
    assert n == 1
    return out


def test_html_report_equal_footer_masked(tmp_path, hill_dem):
    def make(v, path):
        rep = v.HtmlReport("Run <x>")
        rep.section("Terrain & maps")
        rep.figure(v.render_map(hill_dem, 10.0, target_width=200), "map")
        rep.figure(np.full((3, 4, 4), 77, np.uint8))
        rep.paragraph("MBR < 1e-3 & stable")
        rep.preformatted("a\n<b>")
        rep.table([["MBR", "1.2e-4"], ["hours", 24]],
                  header=["metric", "value"])
        rep.write(path)
        return open(path, encoding="utf-8").read()
    j = make(JV, str(tmp_path / "j.html"))
    t = make(TV, str(tmp_path / "t.html"))
    assert "criteria3d_tpu_torch report" in t
    assert mask_footer(t) == mask_footer(j)
    for v in (JV, TV):
        with pytest.raises(ValueError, match="RGBA"):
            v.HtmlReport("x").figure(np.zeros((3, 4)))


def test_apng_and_animation_equal(tmp_path, hill_dem):
    frames = [np.full((8, 6, 4), v, np.uint8) for v in (10, 120, 250)]
    same_file(tmp_path, "a.png", lambda p: JV.write_apng(p, frames, delay_ms=100),
              lambda p: TV.write_apng(p, frames, delay_ms=100))
    same_file(tmp_path, "s.png", lambda p: JV.write_apng(p, frames[:1]),
              lambda p: TV.write_apng(p, frames[:1]))
    rasters = [np.where(np.isclose(hill_dem, NODATA), NODATA, float(v))
               for v in (0.0, 0.5, 1.0)]
    nj, nt = same_file(
        tmp_path, "m.png",
        lambda p: JV.animate_maps(p, hill_dem, 10.0, rasters, target_width=120,
                                  labels=["A", "B", "C"]),
        lambda p: TV.animate_maps(p, hill_dem, 10.0, rasters, target_width=120,
                                  labels=["A", "B", "C"]))
    assert nj == nt == 3
