"""2-D (row, col) domain decomposition over an in-process mesh of devices.

Counterpart of ``criteria3d_tpu/parallel/sharding.py``. A :class:`Mesh` is
a (rows, cols) array of ``torch.device`` with JAX's axis names 'row' and
'col'; a device may repeat, so one card (or the CPU) can hold several
blocks, as JAX's virtual CPU devices do. A field's block (i, j) holds the
(i, j)-th tile of its last two dims and lives on ``devices[i, j]``; the
exchanges between blocks are copies, across devices where they differ.

What is decomposed is the loop JAX writes by hand under ``shard_map``: the
bundled-Jacobi solve (``solver/jacobi_bundle.jacobi_solve_loop`` with a
``mesh``). JAX partitions the rest of the step with GSPMD from the arrays'
shardings; PyTorch has no counterpart, so :func:`shard_pytree` checks the
decomposition as JAX's ``_spec_for`` does and places every tensor on the
mesh's home device, ``devices[0, 0]``, where assembly, CG, heat and the
balance run whole (the same numbers within float32 reduction order).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from criteria3d_tpu_torch.device import map_tensors

__all__ = ["Mesh", "make_mesh", "check_shardable", "shard_pytree",
           "replicate_pytree", "split_blocks", "join_blocks",
           "halo_exchange", "pad_to_multiple"]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (rows, cols) object array of ``torch.device``, axes ('row', 'col');
    compared and hashed by identity, so it may sit in a frozen
    ``SolverParameters``."""

    devices: np.ndarray

    @property
    def shape(self) -> dict:
        return {"row": self.devices.shape[0], "col": self.devices.shape[1]}

    @property
    def home(self) -> torch.device:
        """Where the unpartitioned part of the step runs."""
        return self.devices[0, 0]


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A ('row', 'col') mesh, factorising the device count as square as
    possible (8 gives (2, 4), 4 gives (2, 2)). ``devices`` defaults to
    every visible CUDA device, and raises when there is none; pass
    ``[torch.device("cpu")] * n`` for a mesh of CPU blocks, or
    ``[torch.device("cuda")] * n`` for n blocks on one card."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=[torch.device('cpu')] * n "
                "for a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"make_mesh: {n_devices} devices asked for, "
                             f"{len(devices)} given")
        devices = devices[:n_devices]
    n = len(devices)
    rows = int(np.floor(np.sqrt(n)))
    while n % rows != 0:
        rows -= 1
    arr = np.empty((rows, n // rows), dtype=object)
    for k, d in enumerate(devices):
        arr[divmod(k, n // rows)] = d
    arr.flags.writeable = False
    return Mesh(arr)


def check_shardable(leaf: torch.Tensor, mesh: Mesh) -> bool:
    """Whether ``leaf`` is split over the mesh (its trailing two dims) or
    replicated (fewer than 2 dims, or trailing dims (1, 1): the broadcast
    helper fields), as JAX's ``_spec_for``. A full-size field whose
    trailing dims do not divide the mesh raises: silently replicating the
    whole state would defeat the decomposition."""
    shape = tuple(leaf.shape)
    if len(shape) < 2:
        return False
    r, c = shape[-2], shape[-1]
    mr, mc = mesh.shape["row"], mesh.shape["col"]
    if r == 1 and c == 1:
        return False
    if r % mr != 0 or c % mc != 0 or r < mr or c < mc:
        raise ValueError(
            f"field of shape {shape} cannot be sharded over mesh "
            f"{mesh.shape}: trailing dims ({r}, {c}) must be divisible by "
            f"({mr}, {mc}). Pad the domain first "
            "(criteria3d_tpu_torch.parallel.sharding.pad_to_multiple).")
    return True


def _place(tree, mesh: Mesh):
    def put(t):
        check_shardable(t, mesh)
        return t.to(mesh.home)
    if isinstance(tree, torch.Tensor):
        return put(tree)
    return map_tensors(tree, put)


def shard_pytree(tree, mesh: Mesh):
    """Every tensor of a tensor or frozen dataclass checked against the
    mesh (:func:`check_shardable`) and placed on its home device: the
    bundled-Jacobi loop splits its inputs into blocks itself."""
    return _place(tree, mesh)


def replicate_pytree(tree, mesh: Mesh):
    """As :func:`shard_pytree`: without GSPMD, a replicated and a sharded
    tree both live whole on the home device."""
    return _place(tree, mesh)


def _index(ndim: int, dim: int, sl: slice, dim2: int | None = None,
           sl2: slice | None = None) -> tuple:
    idx = [slice(None)] * ndim
    idx[dim] = sl
    if dim2 is not None:
        idx[dim2] = sl2
    return tuple(idx)


def split_blocks(a: torch.Tensor, mesh: Mesh) -> np.ndarray:
    """The (rows, cols) object array of ``a``'s tiles over its last two
    dims, each on its mesh device (a view where that is ``a``'s device)."""
    check_shardable(a, mesh)
    mr, mc = mesh.devices.shape
    r, c = a.shape[-2] // mr, a.shape[-1] // mc
    blocks = np.empty((mr, mc), dtype=object)
    for (i, j), dev in np.ndenumerate(mesh.devices):
        blocks[i, j] = a[..., i * r:(i + 1) * r, j * c:(j + 1) * c].to(dev)
    return blocks


def join_blocks(blocks: np.ndarray, mesh: Mesh) -> torch.Tensor:
    """The whole field from its blocks, on the mesh's home device."""
    mr, mc = blocks.shape
    return torch.cat([torch.cat([blocks[i, j].to(mesh.home) for j in range(mc)], dim=-1)
                      for i in range(mr)], dim=-2)


def halo_exchange(blocks: np.ndarray, k: int, mesh: Mesh,
                  dims: tuple[int, int] = (-2, -1)) -> np.ndarray:
    """Every block grown by ``k`` cells on all four sides of ``dims`` with
    its neighbours' cells, zeros past the global edge (JAX's unpaired
    ``ppermute`` receivers are zero-filled, the solver's zero-coefficient
    out-of-domain convention). Columns first, then rows from the
    neighbours' column-grown blocks, so that the corners arrive through
    the row neighbour (JAX's two-phase order; the 8-point lateral stencil
    needs them). Each grown block is a new contiguous tensor on its block's
    device. A block side smaller than ``k`` along an axis with neighbours
    raises: the scheme takes the halo from the adjacent block only."""
    mr, mc = blocks.shape
    first = blocks[0, 0]
    nd = first.dim()
    dr, dc = (d % nd for d in dims)
    r, c = first.shape[dr], first.shape[dc]
    for side, n, axis in ((r, mr, "row"), (c, mc, "col")):
        if n > 1 and side < k:
            raise ValueError(f"halo_exchange: a block side of {side} cells along "
                             f"'{axis}' is smaller than the halo k = {k}")
    pads = [0] * (2 * nd)                 # F.pad's order: the last dim first
    for d in (dr, dc):
        pads[2 * (nd - 1 - d)] = pads[2 * (nd - 1 - d) + 1] = k
    grown = np.empty((mr, mc), dtype=object)
    for i in range(mr):
        for j in range(mc):
            grown[i, j] = torch.nn.functional.pad(blocks[i, j], pads)
    rows_in = slice(k, k + r)
    # phase 1: columns, from the left and right neighbours' own cells
    to_left = _index(nd, dr, rows_in, dc, slice(0, k))
    to_right = _index(nd, dr, rows_in, dc, slice(k + c, c + 2 * k))
    last_cols, first_cols = _index(nd, dc, slice(c - k, c)), _index(nd, dc, slice(0, k))
    for i in range(mr):
        for j in range(mc):
            if j > 0:
                grown[i, j][to_left].copy_(blocks[i, j - 1][last_cols])
            if j < mc - 1:
                grown[i, j][to_right].copy_(blocks[i, j + 1][first_cols])
    # phase 2: rows, from the upper and lower neighbours' column-grown
    # blocks (rows k..k+r of each, which this phase does not write)
    to_top, to_bottom = _index(nd, dr, slice(0, k)), _index(nd, dr, slice(k + r, r + 2 * k))
    last_rows, first_rows = _index(nd, dr, slice(r, r + k)), _index(nd, dr, slice(k, 2 * k))
    for i in range(mr):
        for j in range(mc):
            if i > 0:
                grown[i, j][to_top].copy_(grown[i - 1, j][last_rows])
            if i < mr - 1:
                grown[i, j][to_bottom].copy_(grown[i + 1, j][first_rows])
    return grown


def pad_to_multiple(dem: np.ndarray, multiple_r: int, multiple_c: int,
                    nodata: float = -9999.0) -> np.ndarray:
    """Pad a DEM with nodata so (R, C) divide the mesh shape. Masked-out
    cells cost nothing in the solver, so padding to a shardable shape is
    free accuracy-wise."""
    R, C = dem.shape
    pr = (-R) % multiple_r
    pc = (-C) % multiple_c
    if pr == 0 and pc == 0:
        return dem
    return np.pad(dem, ((0, pr), (0, pc)), constant_values=nodata)
