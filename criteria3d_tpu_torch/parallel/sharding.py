"""2-D (row, col) domain decomposition over an in-process mesh of devices.

Counterpart of ``criteria3d_tpu/parallel/sharding.py``. A :class:`Mesh` is
a (rows, cols) array of ``torch.device`` with JAX's axis names 'row' and
'col'; a device may repeat, so one card (or the CPU) can hold several
blocks, as JAX's virtual CPU devices do. A field's block (i, j) holds the
(i, j)-th tile of its last two dims and lives on ``devices[i, j]``; the
exchanges between blocks are copies, across devices where they differ.

JAX partitions the whole coupled water + heat step with GSPMD from the
arrays' shardings: stencil shifts become halo exchanges, reductions
all-reduces. PyTorch has no counterpart, so the port partitions by hand.
:func:`shard_pytree` cuts every (..., R, C) field into tiles that carry a
ring of :data:`RING` cells of their neighbours (zeros past the global edge,
the fill of ``shift2d``); the step runs its per-cell arithmetic on every grown
block unchanged, refreshes the rings with :func:`exchange` where a stencil
reads them, and combines per-block partial reductions over the cells each
block owns (:func:`block_sum`, :func:`block_max`) on ``mesh.home`` in
row-major block order. :func:`gather_pytree` joins the owned cells again.
Code that takes a whole state (a ``HeatState``, ``HeatBoundary`` or
``WaterState``) gets one block's state from :func:`blocks_of`.

A mesh's blocks may be run by several machines (solver/device_loop.py's
rounds driver): by default one per device (one per card), or the explicit
grouping of :func:`make_mesh`'s ``machines``. A machine holds a *part* of
each Blocked (:func:`part`: ``None`` where another machine holds the block),
and it reads the other machines' blocks only through a :class:`Join`: at a
join each machine posts its blocks' partial sums and maxima and the owned
strips its neighbours' rings take, the driver copies every machine's posts
to every other machine (in CUDA's stream order on the card), and each
machine then combines all the blocks' partials in the mesh's row-major
block order (the float :func:`block_sum` gives) and grows its blocks from
the strips (what :func:`exchange` gives). :func:`combine` is that join, and
on a whole Blocked :func:`exchange` and :func:`block_sum` themselves.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading

import numpy as np
import torch

from criteria3d_tpu_torch.core.grid import Grid
from criteria3d_tpu_torch.device import map_tensors

__all__ = ["Mesh", "Blocked", "RING", "make_mesh", "check_shardable",
           "shard_pytree", "gather_pytree", "replicate_pytree", "split_blocks",
           "join_blocks", "halo_exchange", "exchange", "owned", "bmap", "unzip",
           "blocks_of", "is_field", "first_block", "block_sum", "block_max",
           "pad_to_multiple", "machine_groups", "part", "merge", "held", "home_of",
           "holds_home", "remesh", "Join", "joining", "combine"]

# the ring every block carries: the bundled-Jacobi kernel's K sweeps
# (solver/jacobi_bundle.SWEEPS_PER_BUNDLE), so that its owned cells are exact
# after a bundle and the assembly needs no coefficient exchange
RING = 8


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (rows, cols) object array of ``torch.device``, axes ('row', 'col');
    compared and hashed by identity, so it may sit in a frozen
    ``SolverParameters``. ``machines``, when given, is a (rows, cols) int
    array naming the machine that runs each block (:func:`machine_groups`);
    by default each device's blocks are one machine's."""

    devices: np.ndarray
    machines: np.ndarray | None = None

    @property
    def shape(self) -> dict:
        return {"row": self.devices.shape[0], "col": self.devices.shape[1]}

    @property
    def home(self) -> torch.device:
        """Where the blocks' partial reductions are combined and the 0-d
        state lives."""
        return self.devices[0, 0]


@dataclasses.dataclass(frozen=True, eq=False)
class Blocked:
    """A tensor or a :class:`Grid` over a mesh: ``blocks[i, j]`` is block
    (i, j), on ``mesh.devices[i, j]``, grown by :data:`RING` cells on each
    side of its last two dims. A Grid's blocks are Grids whose (..., R, C) fields
    are tiles and whose (L, 1, 1), (8, 1, 1) and 0-d fields are replicated;
    their metadata (``n_nodes``, ``has_culvert``, ...) stays the whole
    grid's. Per-block results of :func:`bmap` are Blocked too. Compared and
    hashed by identity."""

    mesh: Mesh
    blocks: np.ndarray


def make_mesh(n_devices: int | None = None, devices=None, machines=None) -> Mesh:
    """A ('row', 'col') mesh, factorising the device count as square as
    possible (8 gives (2, 4), 4 gives (2, 2)). ``devices`` defaults to
    every visible CUDA device, and raises when there is none; pass
    ``[torch.device("cpu")] * n`` for a mesh of CPU blocks, or
    ``[torch.device("cuda")] * n`` for n blocks on one card. ``machines``,
    one int a device in the same order, groups the blocks into the
    machines that run them (``[0, 1, 2, 3]``: each of 4 blocks its own);
    by default each device's blocks are one machine's."""
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
    if machines is not None:
        machines = np.asarray(list(machines)[:n], dtype=np.int64)
        if machines.size != n:
            raise ValueError(f"make_mesh: {machines.size} machines named for {n} devices")
        machines = machines.reshape(arr.shape)
        machines.flags.writeable = False
    mesh = Mesh(arr, machines)
    machine_groups(mesh)
    return mesh


def _device_key(d: torch.device) -> tuple:
    """A device as (type, index), ``cuda`` without an index the current
    card."""
    if d.type == "cuda" and d.index is None:
        return "cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0
    return d.type, d.index


def machine_groups(mesh: Mesh) -> list:
    """The machines that run the mesh's blocks: one tuple of block indices
    each, in row-major order, the machines ordered by their first block (so
    the first holds block (0, 0), whose device is ``mesh.home``): the
    explicit ``mesh.machines``, or one machine per device. All blocks of a
    machine lie on one device; a grouping that says otherwise raises."""
    if mesh.machines is None:
        names = {idx: _device_key(d) for idx, d in np.ndenumerate(mesh.devices)}
    else:
        if tuple(mesh.machines.shape) != tuple(mesh.devices.shape):
            raise ValueError(f"mesh machines of shape {mesh.machines.shape} for "
                             f"devices of shape {mesh.devices.shape}")
        names = {idx: int(v) for idx, v in np.ndenumerate(mesh.machines)}
    groups: dict = {}
    for idx in np.ndindex(mesh.devices.shape):
        groups.setdefault(names[idx], []).append(idx)
    out = [tuple(g) for g in groups.values()]
    for g in out:
        if len({_device_key(mesh.devices[idx]) for idx in g}) != 1:
            raise ValueError(f"a machine's blocks {g} lie on several devices")
    return out


def check_shardable(leaf: torch.Tensor, mesh: Mesh) -> bool:
    """Whether ``leaf`` is split over the mesh (its trailing two dims) or
    replicated (fewer than 2 dims, or trailing dims (1, 1): the broadcast
    helper fields), as JAX's ``_spec_for``. A full-size field whose
    trailing dims do not divide the mesh raises: silently replicating the
    whole state would defeat the decomposition."""
    if not is_field(leaf):
        return False
    shape = tuple(leaf.shape)
    r, c = shape[-2], shape[-1]
    mr, mc = mesh.shape["row"], mesh.shape["col"]
    if r % mr != 0 or c % mc != 0 or r < mr or c < mc:
        raise ValueError(
            f"field of shape {shape} cannot be sharded over mesh "
            f"{mesh.shape}: trailing dims ({r}, {c}) must be divisible by "
            f"({mr}, {mc}). Pad the domain first "
            "(criteria3d_tpu_torch.parallel.sharding.pad_to_multiple).")
    return True


def is_field(t: torch.Tensor) -> bool:
    """A (..., R, C) field, as opposed to a 0-d, 1-d or (..., 1, 1) leaf."""
    return t.dim() >= 2 and tuple(t.shape[-2:]) != (1, 1)


def _leaves(obj) -> list:
    """The tensors of a dataclass in :func:`map_tensors`' order."""
    out = []
    map_tensors(obj, lambda t: out.append(t) or t)
    return out


def _map_leaves(obj, fn):
    """:func:`map_tensors` with ``fn(tensor, index in _leaves order)``."""
    count = itertools.count()
    return map_tensors(obj, lambda t: fn(t, next(count)))


def _tiles(t: torch.Tensor, mesh: Mesh) -> np.ndarray:
    return halo_exchange(split_blocks(t, mesh), RING, mesh)


def shard_pytree(tree, mesh: Mesh):
    """Cut a tensor, a :class:`Grid` or a state over the mesh, each block
    grown by :data:`RING` cells of its neighbours (zeros past the global
    edge); a (..., R, C) field whose (R, C) does not divide the mesh raises
    (:func:`check_shardable`), as does a block side below the ring along an
    axis with neighbours (:func:`halo_exchange`).

    - a tensor becomes a :class:`Blocked` of tiles; a 0-d, 1-d or
      (..., 1, 1) one moves to ``mesh.home``;
    - a Grid becomes a Blocked of per-block Grids (see :class:`Blocked`);
    - any other frozen dataclass (a ``WaterState``, ``HeatState`` or
      ``HeatBoundary``) keeps its class: each (..., R, C) field becomes a
      Blocked of tiles, every other tensor (the 0-d ``dt_curr``,
      ``courant`` and balances, the heat balance scalars) moves to
      ``mesh.home`` and a ``None`` field stays ``None``.

    The step runs on blocks when ``SolverParameters.mesh`` is this mesh;
    :func:`gather_pytree` joins the result."""
    if isinstance(tree, torch.Tensor):
        if check_shardable(tree, mesh):
            return Blocked(mesh, _tiles(tree, mesh))
        return tree.to(mesh.home)
    if isinstance(tree, Grid):
        tiles = [_tiles(t, mesh) if check_shardable(t, mesh) else None
                 for t in _leaves(tree)]
        blocks = np.empty(mesh.devices.shape, dtype=object)
        for (i, j), dev in np.ndenumerate(mesh.devices):
            blocks[i, j] = _map_leaves(tree, lambda t, k: t.to(dev) if tiles[k] is None
                                       else tiles[k][i, j])
        return Blocked(mesh, blocks)
    done = {}                     # a tensor held by several fields is cut once

    def put(t):
        if id(t) not in done:
            done[id(t)] = shard_pytree(t, mesh)
        return done[id(t)]
    return map_tensors(tree, put)


def gather_pytree(tree, device=None):
    """The whole tree from :func:`shard_pytree`'s form: every Blocked
    joined from its blocks' owned cells (rings dropped) on ``device``
    (default: the mesh's home device); other tensors move to ``device``
    when one is given. A Blocked of Grids gives a Grid."""
    if isinstance(tree, Blocked):
        dev = tree.mesh.home if device is None else torch.device(device)
        first = tree.blocks[0, 0]
        if isinstance(first, torch.Tensor):
            return _join_owned(tree.blocks, dev)
        leaves = np.empty(tree.blocks.shape, dtype=object)
        for idx, b in np.ndenumerate(tree.blocks):
            leaves[idx] = _leaves(b)

        def join(t, k):
            if not is_field(t):
                return t.to(dev)
            parts = np.empty(tree.blocks.shape, dtype=object)
            for idx in np.ndindex(tree.blocks.shape):
                parts[idx] = leaves[idx][k]
            return _join_owned(parts, dev)
        return _map_leaves(first, join)
    if isinstance(tree, torch.Tensor):
        return tree if device is None else tree.to(device)
    changes = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if isinstance(v, (torch.Tensor, Blocked)) or (
                dataclasses.is_dataclass(v) and not isinstance(v, Mesh)):
            changes[f.name] = gather_pytree(v, device)
    return dataclasses.replace(tree, **changes)


def _join_owned(blocks: np.ndarray, dev) -> torch.Tensor:
    owned_blocks = np.empty(blocks.shape, dtype=object)
    for idx, b in np.ndenumerate(blocks):
        owned_blocks[idx] = owned(b, RING).to(dev)
    return join_blocks(owned_blocks, dev)


def replicate_pytree(tree, mesh: Mesh):
    """Every tensor of a tensor or frozen dataclass checked against the
    mesh (:func:`check_shardable`) and placed whole on its home device."""
    def put(t):
        check_shardable(t, mesh)
        return t.to(mesh.home)
    if isinstance(tree, torch.Tensor):
        return put(tree)
    return map_tensors(tree, put)


def owned(t: torch.Tensor, ring: int) -> torch.Tensor:
    """The cells a block owns: a view of ``t`` without its ring (``t``
    itself for ring 0, a whole box)."""
    if ring == 0:
        return t
    return t[..., ring:t.shape[-2] - ring, ring:t.shape[-1] - ring]


def exchange(x: Blocked) -> Blocked:
    """``x`` with fresh rings: every block's owned cells grown again by its
    neighbours' owned cells (:func:`halo_exchange`), zeros past the global
    edge. Each new block is a contiguous tensor on its device. On a
    machine's part, through its :class:`Join` (:func:`combine`)."""
    if _is_part(x):
        return combine(x)[0]
    owned_blocks = np.empty(x.blocks.shape, dtype=object)
    for idx, b in np.ndenumerate(x.blocks):
        owned_blocks[idx] = owned(b, RING)
    return Blocked(x.mesh, halo_exchange(owned_blocks, RING, x.mesh))


def bmap(fn, *args):
    """``fn`` block by block: each :class:`Blocked` argument gives its
    block, every other argument is passed as it is; the results form a
    Blocked. Without a Blocked argument it is ``fn(*args)``, once, on the
    whole tensors. Over a machine's :func:`part` it runs on the blocks every
    Blocked argument holds."""
    blocked = [a for a in args if isinstance(a, Blocked)]
    if not blocked:
        return fn(*args)
    first = blocked[0]
    for a in blocked[1:]:
        if a.mesh is not first.mesh:
            raise ValueError("bmap: the arguments are blocked over different meshes")
    out = np.empty(first.blocks.shape, dtype=object)
    for idx in np.ndindex(first.blocks.shape):
        if any(a.blocks[idx] is None for a in blocked):
            continue
        out[idx] = fn(*(a.blocks[idx] if isinstance(a, Blocked) else a for a in args))
    return Blocked(first.mesh, out)


def unzip(x):
    """A Blocked of tuples as a tuple of Blocked (a plain tuple as it is)."""
    if not isinstance(x, Blocked):
        return x
    n = len(first_block(x))
    outs = []
    for k in range(n):
        arr = np.empty(x.blocks.shape, dtype=object)
        for idx, v in np.ndenumerate(x.blocks):
            arr[idx] = None if v is None else v[k]
        outs.append(Blocked(x.mesh, arr))
    return tuple(outs)


def blocks_of(tree):
    """A frozen dataclass with :class:`Blocked` fields (a sharded state) as
    a Blocked of per-block copies: copy (i, j) holds block (i, j) of every
    Blocked field and every other field as it is (the 0-d scalars on
    ``mesh.home``), so that :func:`bmap` hands a function one block's
    state. A dataclass without a Blocked field is returned as it is."""
    fields = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
    blocked = {k: v for k, v in fields.items() if isinstance(v, Blocked)}
    if not blocked:
        return tree
    mesh = next(iter(blocked.values())).mesh
    out = np.empty(mesh.devices.shape, dtype=object)
    for idx in np.ndindex(out.shape):
        out[idx] = dataclasses.replace(tree, **{k: v.blocks[idx] for k, v in blocked.items()})
    return Blocked(mesh, out)


def held(x: Blocked) -> list:
    """The indices of the blocks ``x`` holds, in row-major order (all of
    them but on a machine's :func:`part`)."""
    return [idx for idx, b in np.ndenumerate(x.blocks) if b is not None]


def first_block(x):
    """The first block a Blocked holds, block (0, 0) but on a machine's
    part (a Grid's metadata and dtypes), else ``x``."""
    if not isinstance(x, Blocked):
        return x
    return x.blocks[held(x)[0]]


def home_of(x: Blocked) -> torch.device:
    """Where a Blocked's 0-d values live: ``mesh.home``, or on a machine's
    part the device of its first block."""
    return x.mesh.devices[held(x)[0]]


def holds_home(x) -> bool:
    """Whether ``x`` is whole, or a Blocked holding block (0, 0): the one
    machine of a mesh's that counts what happens once a period."""
    return not isinstance(x, Blocked) or x.blocks[0, 0] is not None


def part(tree, blocks):
    """One machine's part of a Blocked, or of every Blocked field of a
    frozen dataclass: the blocks at the indices ``blocks``, ``None`` at the
    others (no copy). ``blocks`` None gives ``tree`` as it is."""
    if blocks is None:
        return tree
    if isinstance(tree, Blocked):
        arr = np.empty(tree.blocks.shape, dtype=object)
        for idx in blocks:
            arr[idx] = tree.blocks[idx]
        return Blocked(tree.mesh, arr)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, (Grid, Mesh)):
        return dataclasses.replace(tree, **{
            f.name: part(getattr(tree, f.name), blocks) for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), Blocked)})
    return tree


def merge(parts: list) -> Blocked:
    """The machines' parts of one Blocked joined into the whole Blocked."""
    arr = np.empty(parts[0].blocks.shape, dtype=object)
    for p in parts:
        for idx in held(p):
            arr[idx] = p.blocks[idx]
    return Blocked(parts[0].mesh, arr)


def remesh(tree, mesh: Mesh):
    """A Blocked, or a frozen dataclass with Blocked fields, as the same
    blocks (no copy) over ``mesh``, a mesh of the same devices with another
    grouping of its blocks into machines."""
    if isinstance(tree, Blocked):
        if not (tree.mesh.devices.shape == mesh.devices.shape and all(
                _device_key(a) == _device_key(b) for a, b in
                zip(tree.mesh.devices.flat, mesh.devices.flat))):
            raise ValueError("remesh: the meshes' devices differ")
        return Blocked(mesh, tree.blocks)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, (Grid, Mesh)):
        return dataclasses.replace(tree, **{
            f.name: remesh(getattr(tree, f.name), mesh) for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), Blocked)})
    return tree


def block_sum(parts):
    """The blocks' 0-d partials added on ``mesh.home`` in row-major block
    order (JAX's all-reduce; a fixed order, so a run repeats itself); a
    tensor is returned as it is. On a machine's part, through its
    :class:`Join` (:func:`combine`)."""
    return combine(sums=(parts,))[1]


def block_max(parts):
    """As :func:`block_sum`, for a maximum."""
    return combine(maxes=(parts,))[1]


def _combine(parts, op):
    if not isinstance(parts, Blocked):
        return parts
    total = None
    for p in parts.blocks.flat:
        p = p.to(parts.mesh.home)
        total = p if total is None else op(total, p)
    return total


def _is_part(*xs) -> bool:
    return any(isinstance(x, Blocked) and any(b is None for b in x.blocks.flat)
               for x in xs)


def combine(x=None, sums=(), maxes=()):
    """One join of the blocks: ``(x', *totals)``, x' the Blocked ``x`` with
    fresh rings (:func:`exchange`; None for None) and a total for each of
    ``sums`` (:func:`block_sum`) and ``maxes`` (:func:`block_max`), each the
    blocks' 0-d partials. On a whole Blocked (or tensors) it is those
    functions; on a machine's :func:`part` one :class:`Join` of the current
    machine (:func:`joining`) gives them all, each total on the machine's
    home device and bit-equal to the whole mesh's."""
    if not _is_part(x, *sums, *maxes):
        xs = exchange(x) if isinstance(x, Blocked) else x
        return (xs, *(_combine(p, torch.add) for p in sums),
                *(_combine(p, torch.maximum) for p in maxes))
    join = getattr(_JOINING, "join", None)
    if join is None:
        raise RuntimeError("a machine's part of a mesh is joined only inside its "
                           "driver's rounds (sharding.joining)")
    return join.combine(x, sums, maxes)


_JOINING = threading.local()


@contextlib.contextmanager
def joining(join: "Join"):
    """Within the block, on this thread, :func:`combine` (and so
    :func:`exchange`, :func:`block_sum`, :func:`block_max`) over a machine's
    part goes through ``join``."""
    prev = getattr(_JOINING, "join", None)
    _JOINING.join = join
    try:
        yield join
    finally:
        _JOINING.join = prev


# the 0-d partials one join carries per block (the balance's three sums)
JOIN_PARTS = 4


class Join:
    """One machine's side of the joins between the machines of a mesh.

    Its ``board`` (a byte buffer on the machine's device) holds a record per
    block of the mesh: :data:`JOIN_PARTS` float64 partials (float32 ones
    exactly as float64) and, for an exchange, the four bands of the block's
    owned cells its neighbours' rings take (top and bottom RING rows, left
    and right RING columns, of a field shaped and typed as ``like``). The
    records are grouped machine by machine, so a machine's own blocks are
    one slice of rows (:attr:`rows`). At a join the machine writes its
    blocks' records, then :attr:`cut` (set by the driver) ends the round:
    the driver copies each other machine's rows of its board into this
    board's rows for them (and this machine's rows to the others), and the
    machine reads every block's record here. ``cut`` is the driver's: on
    the card it ends the capture of one graph and starts the next; on the
    CPU it waits for the other machines' threads."""

    def __init__(self, mesh: Mesh, groups: list, g: int, like: torch.Tensor):
        self.mesh, self.groups, self.g = mesh, groups, g
        order = [idx for grp in groups for idx in grp]
        self.row = {idx: k for k, idx in enumerate(order)}
        start = 0
        self.rows = []
        for grp in groups:
            self.rows.append((start, start + len(grp)))
            start += len(grp)
        self.device = mesh.devices[groups[g][0]]
        mr, mc = mesh.devices.shape
        k = RING
        lead = tuple(like.shape[:-2])
        self.r, self.c = like.shape[-2] - 2 * k, like.shape[-1] - 2 * k
        self.dtype, self.lead = like.dtype, lead
        # the bands along each axis that has neighbours
        bands = []
        if mr > 1:
            bands += [("top", lead + (k, self.c)), ("bottom", lead + (k, self.c))]
        if mc > 1:
            bands += [("left", lead + (self.r, k)), ("right", lead + (self.r, k))]
        item = torch.empty((), dtype=like.dtype).element_size()
        head = JOIN_PARTS * 8
        size = head + sum(int(np.prod(sh)) for _, sh in bands) * item
        self.record = -(-size // 16) * 16
        self.board = torch.zeros((len(order), self.record), dtype=torch.uint8,
                                 device=self.device)
        self.parts = [self.board[b, :head].view(torch.float64) for b in range(len(order))]
        self.bands = []
        for b in range(len(order)):
            views, off = {}, head
            for name, sh in bands:
                n = int(np.prod(sh)) * item
                views[name] = self.board[b, off:off + n].view(like.dtype).view(sh)
                off += n
            self.bands.append(views)
        self.cut = None

    def combine(self, x, sums, maxes):
        k, r, c = RING, self.r, self.c
        mine = self.groups[self.g]
        parts = list(sums) + list(maxes)
        if len(parts) > JOIN_PARTS:
            raise ValueError(f"a join carries at most {JOIN_PARTS} partials, not {len(parts)}")
        if x is not None:
            blk = first_block(x)
            if blk.dtype != self.dtype or tuple(blk.shape) != self.lead + (r + 2 * k, c + 2 * k):
                raise ValueError(f"a join exchanges fields of {self.lead + (r + 2 * k, c + 2 * k)} "
                                 f"{self.dtype}, not {tuple(blk.shape)} {blk.dtype}")
        for idx in mine:
            b = self.row[idx]
            if parts:
                self.parts[b][:len(parts)].copy_(torch.stack([p.blocks[idx] for p in parts]))
            if x is not None:
                own = owned(x.blocks[idx], k)
                views = self.bands[b]
                if "top" in views:
                    views["top"].copy_(own[..., :k, :])
                    views["bottom"].copy_(own[..., r - k:, :])
                if "left" in views:
                    views["left"].copy_(own[..., :, :k])
                    views["right"].copy_(own[..., :, c - k:])
        self.cut()
        totals = []
        for n, p in enumerate(parts):
            dtype = first_block(p).dtype
            op = torch.add if n < len(sums) else torch.maximum
            total = None
            for idx in np.ndindex(self.mesh.devices.shape):
                v = self.parts[self.row[idx]][n].to(dtype)
                total = v if total is None else op(total, v)
            totals.append(total)
        return (None if x is None else self._grown(x), *totals)

    def _grown(self, x: Blocked) -> Blocked:
        """Each held block's owned cells grown by its neighbours' bands (the
        board's), zeros past the global edge: :func:`halo_exchange`'s
        values, the corners from the diagonal neighbours' bands."""
        k, r, c = RING, self.r, self.c
        mr, mc = self.mesh.devices.shape
        out = np.empty(x.blocks.shape, dtype=object)
        for (i, j) in self.groups[self.g]:
            new = torch.zeros(self.lead + (r + 2 * k, c + 2 * k), dtype=self.dtype,
                              device=self.device)
            new[..., k:k + r, k:k + c] = owned(x.blocks[i, j], k)
            for di in (-1, 0, 1):
                for dj in (-1, 0, 1):
                    ni, nj = i + di, j + dj
                    if (di, dj) == (0, 0) or not (0 <= ni < mr and 0 <= nj < mc):
                        continue
                    src = self.bands[self.row[ni, nj]]
                    rows = {-1: slice(0, k), 0: slice(k, k + r), 1: slice(k + r, r + 2 * k)}[di]
                    cols = {-1: slice(0, k), 0: slice(k, k + c), 1: slice(k + c, c + 2 * k)}[dj]
                    if di == 0:
                        piece = src["right" if dj < 0 else "left"]
                    else:
                        band = src["bottom" if di < 0 else "top"]
                        piece = band if dj == 0 else (band[..., :, c - k:] if dj < 0
                                                      else band[..., :, :k])
                    new[..., rows, cols] = piece
            out[i, j] = new
        return Blocked(x.mesh, out)


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


def join_blocks(blocks: np.ndarray, device) -> torch.Tensor:
    """The whole field from its (rows, cols) tiles, on ``device`` (a
    :class:`Mesh` means its home device)."""
    if isinstance(device, Mesh):
        device = device.home
    mr, mc = blocks.shape
    return torch.cat([torch.cat([blocks[i, j].to(device) for j in range(mc)], dim=-1)
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
