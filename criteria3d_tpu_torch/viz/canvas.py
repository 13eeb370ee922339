"""Minimal RGBA raster canvas — the QPainter of the headless GUI analogue.

Every viz renderer (mapview, view3d, charts, soilplot) draws onto a
:class:`Canvas`: a (H, W, 4) uint8 numpy buffer with alpha-composited
blits, anti-alias-free lines (sampled, like Bresenham), markers and 5x7
bitmap text.  ``save()`` writes through the quicklook PNG container
(io/quicklook.py) so the whole stack stays numpy + stdlib zlib.
"""

from __future__ import annotations

import numpy as np

from criteria3d_tpu_torch.io.quicklook import write_png
from criteria3d_tpu_torch.viz.font import ADVANCE, GLYPH_H, render_text_mask

__all__ = ["Canvas", "text_size"]


def text_size(s: str, scale: int = 1) -> tuple[int, int]:
    """(width, height) in pixels of a string at the given scale."""
    return ADVANCE * len(s) * scale, GLYPH_H * scale


def _rgba(color) -> np.ndarray:
    c = tuple(int(v) for v in color)
    if len(c) == 3:
        c = c + (255,)
    return np.array(c, np.uint8)


class Canvas:
    def __init__(self, width: int, height: int,
                 background=(255, 255, 255, 255)):
        self.width = int(width)
        self.height = int(height)
        self.rgba = np.empty((self.height, self.width, 4), np.uint8)
        self.rgba[:] = _rgba(background)

    # -- low-level ---------------------------------------------------

    def fill_rect(self, x0: int, y0: int, w: int, h: int, color) -> None:
        x0, y0 = max(int(x0), 0), max(int(y0), 0)
        x1 = min(int(x0 + w), self.width)
        y1 = min(int(y0 + h), self.height)
        if x1 > x0 and y1 > y0:
            self.rgba[y0:y1, x0:x1] = _rgba(color)

    def frame_rect(self, x0: int, y0: int, w: int, h: int, color) -> None:
        self.fill_rect(x0, y0, w, 1, color)
        self.fill_rect(x0, y0 + h - 1, w, 1, color)
        self.fill_rect(x0, y0, 1, h, color)
        self.fill_rect(x0 + w - 1, y0, 1, h, color)

    def blit(self, x0: int, y0: int, rgba: np.ndarray) -> None:
        """Alpha-composite an (h, w, 4) tile at (x0, y0), clipped."""
        h, w = rgba.shape[:2]
        sx0, sy0 = max(-x0, 0), max(-y0, 0)
        dx0, dy0 = max(x0, 0), max(y0, 0)
        dx1 = min(x0 + w, self.width)
        dy1 = min(y0 + h, self.height)
        if dx1 <= dx0 or dy1 <= dy0:
            return
        src = rgba[sy0:sy0 + (dy1 - dy0), sx0:sx0 + (dx1 - dx0)]
        dst = self.rgba[dy0:dy1, dx0:dx1]
        a = src[..., 3:4].astype(np.float64) / 255.0
        out = src[..., :3] * a + dst[..., :3] * (1.0 - a)
        dst[..., :3] = np.round(out).astype(np.uint8)
        dst[..., 3] = np.maximum(dst[..., 3], src[..., 3])

    def _plot(self, xs: np.ndarray, ys: np.ndarray, color) -> None:
        keep = (xs >= 0) & (xs < self.width) & (ys >= 0) & (ys < self.height)
        self.rgba[ys[keep], xs[keep]] = _rgba(color)

    # -- shapes ------------------------------------------------------

    def line(self, x0, y0, x1, y1, color, width: int = 1) -> None:
        n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
        t = np.linspace(0.0, 1.0, n)
        xs = np.round(x0 + (x1 - x0) * t).astype(np.int64)
        ys = np.round(y0 + (y1 - y0) * t).astype(np.int64)
        r = width // 2
        for dy in range(-r, width - r):
            for dx in range(-r, width - r):
                self._plot(xs + dx, ys + dy, color)

    def polyline(self, points, color, width: int = 1) -> None:
        pts = np.asarray(points, np.float64)
        for i in range(len(pts) - 1):
            self.line(pts[i, 0], pts[i, 1], pts[i + 1, 0], pts[i + 1, 1],
                      color, width)

    def marker(self, x, y, color, size: int = 5, shape: str = "circle",
               outline=(0, 0, 0)) -> None:
        """Station/point marker (mapGraphics StationMarker analogue)."""
        r = max(size // 2, 1)
        yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
        if shape == "circle":
            inside = xx * xx + yy * yy <= r * r
            edge = inside & (xx * xx + yy * yy >= (r - 1) * (r - 1))
        elif shape == "square":
            inside = np.ones_like(xx, bool)
            edge = (np.abs(xx) == r) | (np.abs(yy) == r)
        elif shape == "triangle":
            inside = (yy >= -r) & (np.abs(xx) * 2 <= (yy + r))
            edge = inside & ~((yy - 1 >= -r) & (np.abs(xx) * 2 <= (yy - 1 + r)))
        else:
            raise ValueError(f"unknown marker shape {shape!r}")
        ys, xs = np.nonzero(inside)
        self._plot(xs + int(x) - r, ys + int(y) - r, color)
        ys, xs = np.nonzero(edge)
        self._plot(xs + int(x) - r, ys + int(y) - r, outline)

    def text(self, x, y, s: str, color=(0, 0, 0), scale: int = 1,
             anchor: str = "nw") -> None:
        """Draw a string; anchor is one of nw/ne/n/center/sw/se."""
        mask = render_text_mask(s, scale)
        h, w = mask.shape
        if "e" in anchor:
            x = x - w
        elif anchor in ("n", "s", "center"):
            x = x - w // 2
        if "s" in anchor:
            y = y - h
        elif anchor == "center":
            y = y - h // 2
        tile = np.zeros((h, w, 4), np.uint8)
        tile[..., :3] = _rgba(color)[:3]
        tile[..., 3] = np.where(mask, 255, 0)
        self.blit(int(x), int(y), tile)

    # -- IO ----------------------------------------------------------

    def save(self, path) -> None:
        write_png(path, self.rgba)
