"""The port's command shell (``criteria3d_tpu_torch.cli``) against the JAX
package's.

Both shells run the same batch scripts in directories of the same layout:
a DEM-only script (the 12 x 10 ramp DEM of tests/test_cli.py with uniform
rain, the uniform soil of the JAX shell) and a project script
(``problems.write_project(n=16)`` with its stations, two hours from 10 h).
Both run under the float64 parameters, where the port holds JAX's heads to
1e-9 m, so every printed line is equal except ``VERSION`` (the package's
name) and no line is an ``ERROR:`` unless the script asks for one. The
CSVs, the DEM-derived PNGs and the report with its footer masked are
byte-equal; the images of the model's state (ponding, root-zone water
content), rendered from float64 maps that agree to ~1e-11, are compared as
decoded pixels, of which at most 0.1% may differ (a cell on a colour-class
edge). ``FAST ON`` (float32 CG) is held to the f32 envelope: both |MBR| <
2e-3.
"""

import base64
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from criteria3d_tpu import cli as JCLI
from criteria3d_tpu_torch import cli as TCLI
from criteria3d_tpu_torch import problems
from criteria3d_tpu_torch.io.esri import RasterHeader, write_flt
from tests.test_viz import decode_png

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DEM_SCRIPT = """VERSION
DEM dem.flt
INIT
RUN 2 5
INFO
EXPORTPNG dem out/dem.png
EXPORTPNG pond out/pond.png
MAP out/map.png pond
MAP out/map_dem.png
VIEW3D out/v3d.png dem 30 60
ANIM out/anim.png 2 pond
STATE SAVE st
STATE LOAD st
INFO
REPORT out/run.html
EXIT
"""

PROJECT_SCRIPT = """VERSION
LOG out/shell.log
PROJ prj/synthetic.ini
GRID prj/DATA/grid.xml
INIT
RUN 2 2023-03-21T10
INFO
EXPORTPNG swc out/swc.png
EXPORTPNG dem out/dem.png dtm
MAP out/map.png swc
VIEW3D out/v3d.png dem
CHART S00 out/chart.png AIR_TEMPERATURE PRECIPITATION
PROXY out/proxy.png AIR_TEMPERATURE 2023-03-21T08
HOURLYCSV S01 out/s01.csv
DAILYCSV S01 out/daily.csv
STATE SAVE st
STATE LOAD st
REPORT out/run.html
POINT prj/DATA/meteo.db
QUIT
"""

# files whose pixels follow the model's state
STATE_IMAGES = {"pond.png", "map.png", "anim.png", "swc.png"}


def run_shell(module, root, script, monkeypatch, capsys, argv=()):
    """Run ``script`` through ``module.main`` with ``root`` as the working
    directory; returns the printed lines with ``root`` masked."""
    monkeypatch.chdir(root)
    (root / "batch.txt").write_text(script)
    assert module.main([*argv, "batch.txt"]) == 0
    out = capsys.readouterr().out
    return out.replace(str(root), "<root>").splitlines()


def output_files(root) -> dict:
    out = {}
    for d, _, files in os.walk(root / "out"):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def pixel_share(a: bytes, b: bytes, tmp) -> float:
    """The share of decoded pixels that differ between two PNG files."""
    (tmp / "a.png").write_bytes(a)
    (tmp / "b.png").write_bytes(b)
    x, y = decode_png(tmp / "a.png"), decode_png(tmp / "b.png")
    assert x.shape == y.shape
    return float((x != y).any(-1).mean())


def split_html(html: str):
    """(text with the footer and every data-URI masked, [png bytes])."""
    images = [base64.b64decode(m) for m in
              re.findall(r'src="data:image/png;base64,([^"]*)"', html)]
    text = re.sub(r'src="data:image/png;base64,[^"]*"', 'src=""', html)
    text, n = re.subn(r"<footer>[^<]*</footer>", "<footer/>", text)
    assert n == 1
    return text, images


def compare_outputs(jroot, troot, tmp):
    jf, tf = output_files(jroot), output_files(troot)
    assert sorted(tf) == sorted(jf) and tf
    shares = {}
    for name, jb in jf.items():
        tb = tf[name]
        base = os.path.basename(name)
        if base.endswith(".html"):
            jt, ji = split_html(jb.decode())
            tt, ti = split_html(tb.decode())
            assert tt == jt, name
            assert len(ti) == len(ji)
            for k, (a, b) in enumerate(zip(ti, ji)):
                shares[f"{name}[{k}]"] = 0.0 if a == b else pixel_share(a, b, tmp)
        elif base in STATE_IMAGES:
            assert tb[:8] == b"\x89PNG\r\n\x1a\n"
            shares[name] = 0.0 if tb == jb else pixel_share(tb, jb, tmp)
        elif base == "shell.log":
            assert (tb.decode().replace(str(troot), "<root>")
                    == jb.decode().replace(str(jroot), "<root>")), name
        else:
            assert tb == jb, name
    assert max(shares.values(), default=0.0) <= 1e-3, shares
    return jf


def dem_dir(root):
    root.mkdir()
    dem = 100.0 + np.arange(12)[:, None] * 0.5 * np.ones((1, 10))
    write_flt(str(root / "dem"), dem,
              RasterHeader(nrows=12, ncols=10, xllcorner=0, yllcorner=0,
                           cellsize=10.0, nodata=-9999.0))
    return root


def equal_but_version(tl, jl):
    assert len(tl) == len(jl)
    diff = [(a, b) for a, b in zip(tl, jl) if a != b]
    assert diff == [("criteria3d_tpu_torch 0.1.0",
                     f"criteria3d_tpu {JCLI.criteria3d_tpu.__version__}")], diff


def test_dem_only_script_matches_jax(tmp_path, monkeypatch, capsys):
    """The DEM-only script: printed lines equal but VERSION, no ERROR,
    every file written; the DEM PNG byte-equal, the state images as
    pixels, the report with its footer masked."""
    jroot, troot = dem_dir(tmp_path / "j"), dem_dir(tmp_path / "t")
    jl = run_shell(JCLI, jroot, DEM_SCRIPT, monkeypatch, capsys)
    tl = run_shell(TCLI, troot, DEM_SCRIPT, monkeypatch, capsys, ("--device", "cpu"))
    assert not [x for x in tl if "ERROR" in x], tl
    equal_but_version(tl, jl)
    files = compare_outputs(jroot, troot, tmp_path)
    assert len(files) == 7 and "hour 1: MBR=" in "\n".join(tl)
    assert sorted(os.listdir(troot / "st")) == sorted(os.listdir(jroot / "st"))


def test_project_script_matches_jax(tmp_path, monkeypatch, capsys):
    """The project script (PROJ, GRID, two interpolated float64 hours with
    outputs, the station charts and CSVs, state, report, LOG): printed
    lines equal but VERSION, no ERROR, the same output tree; the CSVs and
    DEM PNGs byte-equal, the state images as pixels."""
    src = tmp_path / "src"
    ini = problems.write_project(str(src), n=16, seed=0, n_stations=6)
    problems.write_meteo_grid(str(src), ini, cell=20.0, margin=20.0, seed=0)
    roots = []
    for name in ("j", "t"):
        root = tmp_path / name
        root.mkdir()
        shutil.copytree(src, root / "prj")
        roots.append(root)
    jroot, troot = roots
    jl = run_shell(JCLI, jroot, PROJECT_SCRIPT, monkeypatch, capsys)
    tl = run_shell(TCLI, troot, PROJECT_SCRIPT, monkeypatch, capsys, ("--device", "cpu"))
    assert not [x for x in tl if "ERROR" in x], tl
    equal_but_version(tl, jl)
    text = "\n".join(tl)
    assert "2023-03-21 11:00:00: MBR=" in text and "Meteo grid: 5x5 cells" in text
    assert "No data loaded for this point." in text
    compare_outputs(jroot, troot, tmp_path)
    rasters = sorted(os.listdir(troot / "OUTPUT" / "rasters" / "20230321"))
    assert rasters == sorted(os.listdir(jroot / "OUTPUT" / "rasters" / "20230321"))
    assert len(rasters) == 2 * 2 * 4


@pytest.mark.parametrize("line, reason", [
    ("FROB 3", "Invalid command: FROB"),
    ("DEM missing.flt", "ERROR: "),
    ("PROJ missing.ini", "ERROR: "),
    ("RUN x", "INITIALIZE first."),
    ("STATE LOAD nowhere", "INITIALIZE first."),
    ("EXPORTPNG swc out/x.png", "nothing to render for 'swc'"),
])
def test_refusals_print_alike(tmp_path, monkeypatch, capsys, line, reason):
    """An unknown command, a missing file and a command before its inputs
    print the same line in both shells, and the shell goes on."""
    jroot, troot = dem_dir(tmp_path / "j"), dem_dir(tmp_path / "t")
    script = f"{line}\nINFO\n"
    jl = run_shell(JCLI, jroot, script, monkeypatch, capsys)
    tl = run_shell(TCLI, troot, script, monkeypatch, capsys, ("--device", "cpu"))
    assert tl == jl
    assert reason in tl[1] and tl[-1] == "No model loaded."


def test_fast_mode_within_f32_envelope(tmp_path, monkeypatch, capsys):
    """FAST ON (float32 sweeps, CG with the default diagonal
    preconditioner, as the JAX shell has it): both shells print their
    MBRs, each |MBR| < 2e-3."""
    script = "FAST ON\nDEM dem.flt\nINIT\nRUN 2 5\nEXIT\n"
    mbrs = []
    for module, name, argv in ((JCLI, "j", ()), (TCLI, "t", ("--device", "cpu"))):
        lines = run_shell(module, dem_dir(tmp_path / name), script, monkeypatch, capsys,
                          argv)
        assert "fast mode: ON" in lines
        mbrs.append([float(re.search(r"MBR=(\S+)", x).group(1)) for x in lines
                     if x.startswith("hour ")])
    assert len(mbrs[0]) == len(mbrs[1]) == 2
    assert max(abs(v) for v in mbrs[0] + mbrs[1]) < 2e-3


def test_module_entry_point_needs_a_device(tmp_path):
    """``python -m criteria3d_tpu_torch.cli`` in a fresh interpreter: with
    ``--device cpu`` it runs a script; without a card
    and without the option it stops with resolve_device's message and
    exit code 2 before running any command."""
    dem_dir(tmp_path / "d")
    script = tmp_path / "d" / "s.txt"
    script.write_text("VERSION\nDEM dem.flt\nINIT\nINFO\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    ok = subprocess.run([sys.executable, "-m", "criteria3d_tpu_torch.cli", "--device",
                         "cpu", "s.txt"], capture_output=True, text=True,
                        cwd=tmp_path / "d", env=env, timeout=300)
    assert ok.returncode == 0, ok.stderr
    assert "criteria3d_tpu_torch 0.1.0" in ok.stdout and "dt_curr: " in ok.stdout
    assert "ERROR" not in ok.stdout
    if torch.cuda.is_available():
        return
    no = subprocess.run([sys.executable, "-m", "criteria3d_tpu_torch.cli", "s.txt"],
                        capture_output=True, text=True, cwd=tmp_path / "d", env=env,
                        timeout=300)
    assert no.returncode == 2 and no.stdout == ""
    assert "no CUDA device" in no.stderr
