"""Standalone HTML run reports.

The GUI's role of "look at the run" collapses headlessly into one
artifact: an HTML file embedding every rendered Canvas as a data-URI PNG
plus summary tables (mass-balance, boundary flows, outputs), viewable in
any browser with zero server or dependency.  This is the capability
answer to mainwindow.cpp's dashboard for batch/TPU-cluster runs.
"""

from __future__ import annotations

import base64
import datetime
import html
import io
import struct
import zlib

import numpy as np

__all__ = ["HtmlReport"]

_CSS = """
body{font-family:system-ui,sans-serif;margin:2em auto;max-width:64em;
     color:#222;background:#fafafa}
h1{border-bottom:2px solid #888;padding-bottom:.2em}
h2{margin-top:1.6em;color:#334}
figure{margin:1em 0;text-align:center}
figcaption{font-size:.85em;color:#666;margin-top:.3em}
img{max-width:100%;border:1px solid #ccc;background:#fff}
table{border-collapse:collapse;margin:.8em 0}
td,th{border:1px solid #bbb;padding:.25em .7em;font-size:.9em}
th{background:#eee;text-align:left}
pre{background:#eee;padding:.6em;overflow-x:auto}
footer{margin-top:2em;font-size:.8em;color:#888}
"""


def _png_bytes(rgba: np.ndarray) -> bytes:
    h, w = rgba.shape[:2]

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + rgba[r].tobytes() for r in range(h))
    buf = io.BytesIO()
    buf.write(b"\x89PNG\r\n\x1a\n")
    buf.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)))
    buf.write(chunk(b"IDAT", zlib.compress(raw, 6)))
    buf.write(chunk(b"IEND", b""))
    return buf.getvalue()


class HtmlReport:
    """Accumulate sections, figures and tables; ``write(path)`` emits a
    single self-contained HTML file."""

    def __init__(self, title: str):
        self.title = title
        self._body: list[str] = []

    def section(self, heading: str) -> "HtmlReport":
        self._body.append(f"<h2>{html.escape(heading)}</h2>")
        return self

    def paragraph(self, text: str) -> "HtmlReport":
        self._body.append(f"<p>{html.escape(text)}</p>")
        return self

    def preformatted(self, text: str) -> "HtmlReport":
        self._body.append(f"<pre>{html.escape(text)}</pre>")
        return self

    def figure(self, canvas, caption: str = "") -> "HtmlReport":
        """Embed a viz Canvas (or raw (H, W, 4) uint8 array) inline."""
        rgba = canvas.rgba if hasattr(canvas, "rgba") else np.asarray(canvas)
        if rgba.ndim != 3 or rgba.shape[-1] != 4:
            raise ValueError(
                f"figure: expected (H, W, 4) RGBA array, got {rgba.shape}")
        rgba = np.ascontiguousarray(np.clip(rgba, 0, 255).astype(np.uint8))
        b64 = base64.b64encode(_png_bytes(rgba)).decode("ascii")
        cap = (f"<figcaption>{html.escape(caption)}</figcaption>"
               if caption else "")
        self._body.append(
            f'<figure><img src="data:image/png;base64,{b64}" '
            f'alt="{html.escape(caption)}"/>{cap}</figure>')
        return self

    def table(self, rows, header=None) -> "HtmlReport":
        parts = ["<table>"]
        if header:
            parts.append("<tr>" + "".join(
                f"<th>{html.escape(str(c))}</th>" for c in header) + "</tr>")
        for row in rows:
            parts.append("<tr>" + "".join(
                f"<td>{html.escape(str(c))}</td>" for c in row) + "</tr>")
        parts.append("</table>")
        self._body.append("".join(parts))
        return self

    def render(self) -> str:
        stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M")
        return (
            "<!DOCTYPE html><html><head><meta charset='utf-8'>"
            f"<title>{html.escape(self.title)}</title>"
            f"<style>{_CSS}</style></head><body>"
            f"<h1>{html.escape(self.title)}</h1>"
            + "".join(self._body)
            + f"<footer>criteria3d_tpu_torch report — {stamp}</footer>"
            "</body></html>")

    def write(self, path) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.render())
