"""Headless visualization — the framework's GUI analogue.

The port's own copy of ``criteria3d_tpu/viz/``, line for line: host numpy
rendering, the same PNG, APNG and HTML bytes for the same arrays (the
report's footer carries the port's name and the time).

The reference ships a Qt GUI (bin/CRITERIA3D mainwindow + mapGraphics
canvas, an OpenGL 3-D terrain viewer — glWidget.cpp/viewer3d.cpp/
geometry.cpp — and qcustomplot-based meteo/soil/proxy chart widgets).
This package provides the same *capabilities* headlessly, with zero
dependencies beyond numpy + stdlib zlib: every renderer composes RGBA
arrays on a :class:`~criteria3d_tpu_torch.viz.canvas.Canvas` and writes PNG
through :func:`criteria3d_tpu_torch.io.quicklook.write_png`.

===============  =====================================================
module           reference analogue
===============  =====================================================
``canvas``       QPainter-ish RGBA raster canvas + 5x7 bitmap font
``mapview``      mapGraphics raster canvas (RasterObject + hillshade
                 slope shading, station markers, legend)
``view3d``       bin/CRITERIA3D 3-D viewer (geometry.cpp triangle mesh,
                 shadowDtmColor slope shading, rotation + magnify)
``charts``       meteoWidget / proxyWidget time-series & scatter plots
``soilplot``     soilWidget water-retention / conductivity curves
``report``       standalone HTML run report (data-URI PNGs)
===============  =====================================================
"""

from criteria3d_tpu_torch.viz.canvas import Canvas, text_size
from criteria3d_tpu_torch.viz.mapview import hillshade_rgb, render_map
from criteria3d_tpu_torch.viz.view3d import render_surface3d
from criteria3d_tpu_torch.viz.charts import line_chart, scatter_chart
from criteria3d_tpu_torch.viz.soilplot import (retention_plot,
                                               conductivity_plot)
from criteria3d_tpu_torch.viz.report import HtmlReport
from criteria3d_tpu_torch.viz.animate import animate_maps, write_apng

__all__ = [
    "Canvas", "text_size", "hillshade_rgb", "render_map",
    "render_surface3d", "line_chart", "scatter_chart",
    "retention_plot", "conductivity_plot", "HtmlReport",
    "animate_maps", "write_apng",
]
