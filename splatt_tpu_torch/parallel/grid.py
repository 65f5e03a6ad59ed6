"""The n-D medium-grained grid decomposition (≙ splatt_tpu/parallel/grid.py,
the reference's MEDIUM decomposition of src/mpi/, the default).

The ranks form an n-D grid with one axis per tensor mode (a
:class:`~splatt_tpu_torch.parallel.mesh.GridMesh`; p_get_best_mpi_dim,
src/mpi/mpi_io.c:537-574, sizes it).  Each rank holds the nonzeros whose
coordinates fall in its cell, with indices local to the cell's row blocks
(≙ mpi_io.c:816-824), and factor m is split into ``grid[m]`` row blocks
along axis m, each block held by every rank of its layer.  So the MTTKRP's
inputs are always local to a rank, and only its output is summed across
the layer.  Per mode m a sweep runs:

1. the local MTTKRP of every rank's cell, no communication;
2. the layer reduce: a sum over the ranks that share rank r's coordinate
   on axis m (every axis but m), which every one of them receives
   (≙ mpi_reduce_rows + mpi_update_rows);
3. the local solve, the same system on every replica of a block;
4. the λ and Gram allreduce over axis m only (the replicas along the
   other axes are not summed).

Row fences are equal-sized; ``balance`` relabels rows so the fences carry
equal nonzeros (balanced_relabel ≙ p_find_layer_boundaries,
mpi_io.c:365-439), and the factors come back in the original row order.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from splatt_tpu_torch.config import (Options, Verbosity, acc_dtype,
                                     default_opts, resolve_dtype)
from splatt_tpu_torch.kruskal import KruskalTensor
from splatt_tpu_torch.parallel.common import (STREAM_CHUNK, RankLayouts,
                                              _drop_pages, _memmap_dir,
                                              _subdir, allreduce,
                                              alloc_build_modes,
                                              auto_local_engine,
                                              balanced_relabel,
                                              bucket_engine, bucket_scatter,
                                              build_bucket_layout, ceil_to,
                                              comm_volume_report,
                                              dist_phase_report,
                                              engine_fallback, fit_tail,
                                              imbalance_report, is_memmapped,
                                              mode_update_tail, no_phase,
                                              place_buckets,
                                              record_local_engine,
                                              record_shard_imbalance,
                                              run_distributed_als,
                                              streamed_bucket_scatter,
                                              wrap_profiled_step)
from splatt_tpu_torch.parallel.mesh import (GridMesh, auto_grid, make_mesh,
                                            make_grid_mesh)


@dataclasses.dataclass
class GridDecomp:
    """The host-built grid decomposition of a COO tensor, the same arrays
    as the JAX package's: one leading dim per grid axis, so cell
    ``(c_0, ..., c_{n-1})`` is the rank at those coordinates."""

    grid: Tuple[int, ...]
    dims_pad: Tuple[int, ...]      # per mode, divisible by grid[m]
    block_rows: Tuple[int, ...]    # dims_pad[m] // grid[m]
    cell_nnz: int                  # padded nnz per cell
    inds_local: np.ndarray         # (nmodes, *grid, cell_nnz) int32
    vals: np.ndarray               # (*grid, cell_nnz)
    nnz: int
    fill: float                    # nnz / (ncells * cell_nnz)
    cell_counts: np.ndarray        # (ncells,) true occupancy per cell
    # per-mode old -> new row labels of the nnz-balanced fences (None per
    # mode = identity)
    relabels: Optional[List[Optional[np.ndarray]]] = None

    @property
    def nmodes(self) -> int:
        return len(self.grid)

    @property
    def ncells(self) -> int:
        return int(np.prod(self.grid))

    @staticmethod
    def build(tt, grid: Optional[Tuple[int, ...]] = None,
              n_devices: Optional[int] = None, val_dtype=np.float32,
              balance: Optional[bool] = False,
              streamed: Optional[bool] = None,
              out_dir: Optional[str] = None,
              chunk: int = STREAM_CHUNK) -> "GridDecomp":
        """≙ p_rearrange_medium (src/mpi/mpi_io.c:451-473) as a host
        bucketing.

        `grid` defaults to :func:`auto_grid` over `n_devices` (default:
        the default mesh's rank count).  `balance`: nnz-balance the row
        fences by relabeling rows; None = when the equal-fence fill is
        below 0.5 and the relabeling improves it.  Every cell is padded
        to the fullest, so the fill is the sweep's memory and compute
        efficiency.  `streamed` (None: when the tensor's indices are
        memmapped) builds in chunked passes (:meth:`_build_streamed`),
        the host holding O(chunk + cells); with `out_dir` the cells are
        memmaps under it, so a tensor larger than the host's memory
        decomposes end to end."""
        nmodes = tt.nmodes
        if grid is None:
            ndev = n_devices if n_devices is not None else make_mesh().ndev
            grid = auto_grid(ndev, tt.dims)
        grid = tuple(int(g) for g in grid)
        if len(grid) != nmodes or any(g < 1 for g in grid):
            raise ValueError(f"grid {grid} must give one positive factor "
                             f"per mode ({nmodes} modes)")
        dims_pad = tuple(ceil_to(max(d, g), g) for d, g in zip(tt.dims, grid))
        block_rows = tuple(dp // g for dp, g in zip(dims_pad, grid))
        ncells = int(np.prod(grid))
        if streamed is None:
            streamed = is_memmapped(tt.inds)
        if streamed:
            return GridDecomp._build_streamed(
                tt, grid, dims_pad, block_rows, ncells, val_dtype, balance,
                out_dir, chunk)

        def cells_of(inds_rel):
            cell = np.zeros(tt.nnz, dtype=np.int64)
            for m in range(nmodes):
                cell = cell * grid[m] + inds_rel[m] // block_rows[m]
            return cell

        def fill_of(cell):
            if tt.nnz == 0:
                return 1.0
            counts = np.bincount(cell, minlength=ncells)
            return tt.nnz / max(ncells * int(counts.max()), 1)

        inds_rel = tt.inds
        relabels: Optional[List[Optional[np.ndarray]]] = None
        cell = cells_of(inds_rel)
        fill0 = fill_of(cell)
        if balance or (balance is None and fill0 < 0.5):
            rl = [balanced_relabel(tt.mode_histogram(m), grid[m],
                                   block_rows[m])
                  if grid[m] > 1 else None
                  for m in range(nmodes)]
            cand = np.stack([r[tt.inds[m]] if r is not None else tt.inds[m]
                             for m, r in enumerate(rl)])
            cell_b = cells_of(cand)
            if balance or fill_of(cell_b) > fill0:
                inds_rel, relabels, cell = cand, rl, cell_b

        binds, vals, cell_nnz, counts = bucket_scatter(inds_rel, tt.vals,
                                                       cell, ncells,
                                                       val_dtype)
        # indices local to the cell's fences (pad slots hold 0)
        for m in range(nmodes):
            binds[m] %= block_rows[m]
        return GridDecomp(
            grid=grid, dims_pad=dims_pad, block_rows=block_rows,
            cell_nnz=cell_nnz,
            inds_local=binds.reshape((nmodes, *grid, cell_nnz)),
            vals=vals.reshape((*grid, cell_nnz)), nnz=tt.nnz,
            fill=tt.nnz / max(ncells * cell_nnz, 1), cell_counts=counts,
            relabels=relabels)

    @staticmethod
    def _build_streamed(tt, grid, dims_pad, block_rows, ncells, val_dtype,
                        balance, out_dir, chunk) -> "GridDecomp":
        """:meth:`build` in chunked passes, the same decomposition: one
        pass counts the cells (two more, a histogram and a recount, when
        balancing is considered), one scatters
        (:func:`streamed_bucket_scatter`); no O(nnz) array is made but
        the cells themselves."""
        nmodes = tt.nmodes
        nnz = tt.nnz

        def cells_of_chunk(ic, rl):
            cell = np.zeros(ic.shape[1], dtype=np.int64)
            for m in range(nmodes):
                col = rl[m][ic[m]] if rl and rl[m] is not None else ic[m]
                cell = cell * grid[m] + col // block_rows[m]
            return cell

        def counts_for(rl):
            c = np.zeros(ncells, dtype=np.int64)
            for s in range(0, nnz, chunk):
                ic = np.asarray(tt.inds[:, s:min(nnz, s + chunk)])
                c += np.bincount(cells_of_chunk(ic, rl), minlength=ncells)
                _drop_pages(tt.inds)
            return c

        def fill_of(counts):
            return (nnz / max(ncells * int(counts.max()), 1)
                    if nnz else 1.0)

        def hist_of(m):
            h = np.zeros(tt.dims[m], dtype=np.int64)
            for s in range(0, nnz, chunk):
                h += np.bincount(np.asarray(tt.inds[m, s:min(nnz, s + chunk)]),
                                 minlength=tt.dims[m])
                _drop_pages(tt.inds)
            return h

        relabels = None
        counts = counts_for(None)
        fill0 = fill_of(counts)
        if balance or (balance is None and fill0 < 0.5):
            cand = [balanced_relabel(hist_of(m), grid[m], block_rows[m])
                    if grid[m] > 1 else None for m in range(nmodes)]
            counts_b = counts_for(cand)
            if balance or fill_of(counts_b) > fill0:
                relabels, counts = cand, counts_b

        def postprocess(placed):
            for m in range(nmodes):
                rl = relabels[m] if relabels is not None else None
                col = rl[placed[m]] if rl is not None else placed[m]
                placed[m] = col % block_rows[m]
            return placed

        # the counts were taken deciding the fences: one more pass
        binds, bvals, cell_nnz, counts = streamed_bucket_scatter(
            tt.inds, tt.vals, lambda ic, s: cells_of_chunk(ic, relabels),
            ncells, val_dtype, chunk=chunk, out_dir=out_dir,
            postprocess=postprocess, counts=counts)
        return GridDecomp(
            grid=grid, dims_pad=dims_pad, block_rows=block_rows,
            cell_nnz=cell_nnz,
            inds_local=binds.reshape((nmodes, *grid, cell_nnz)),
            vals=bvals.reshape((*grid, cell_nnz)), nnz=nnz,
            fill=nnz / max(ncells * cell_nnz, 1), cell_counts=counts,
            relabels=relabels)

    def make_mesh(self, devices: Optional[Sequence] = None,
                  device=None) -> GridMesh:
        """The grid's mesh: one rank per cell (:func:`make_grid_mesh`)."""
        return make_grid_mesh(self.grid, devices=devices, device=device)

    def device_put(self, mesh: GridMesh, dtype=torch.float32):
        """Each rank's cell, ``(nmodes, cell_nnz)`` int32 local indices
        and ``(cell_nnz,)`` values in `dtype`, on its device (the stream
        engine's arrays)."""
        return place_buckets(
            self.inds_local.reshape(self.nmodes, self.ncells, -1),
            self.vals.reshape(self.ncells, -1), mesh, dtype)

    def shard_factors(self, factors: Sequence, mesh: GridMesh,
                      dtype=torch.float32) -> List[List[torch.Tensor]]:
        """Factor m zero-padded to ``dims_pad[m]`` rows (row `old` at
        label ``relabels[m][old]`` under balanced fences), each rank
        holding the row block of its coordinate on axis m."""
        return [self.shard_factor(U, m, mesh, dtype)
                for m, U in enumerate(factors)]

    def shard_factor(self, U, m: int, mesh: GridMesh,
                     dtype=torch.float32) -> List[torch.Tensor]:
        """:meth:`shard_factors` of mode m's factor alone."""
        U = torch.as_tensor(np.asarray(U) if not torch.is_tensor(U)
                            else U).detach().cpu()
        U_pad = torch.zeros((self.dims_pad[m], U.shape[1]), dtype=U.dtype)
        rl = self.relabels[m] if self.relabels is not None else None
        if rl is None:
            U_pad[:U.shape[0]] = U
        else:
            U_pad[torch.from_numpy(np.asarray(rl))] = U
        blk = self.block_rows[m]
        blocks = {}
        row = []
        for r, dev in enumerate(mesh.devices):
            c = mesh.coords(r)[m]
            if (c, dev) not in blocks:
                blocks[(c, dev)] = U_pad[c * blk:(c + 1) * blk].to(dev, dtype)
            row.append(blocks[(c, dev)])
        return row

    def row_select(self) -> Optional[List[Optional[np.ndarray]]]:
        """Per-mode gather indices restoring the original row order of a
        padded factor (for run_distributed_als)."""
        return None if self.relabels is None else list(self.relabels)

    def build_cell_layouts(self, opts: Options,
                           out_dir: Optional[str] = None,
                           chunk: int = STREAM_CHUNK) -> "CellLayouts":
        """Per-cell sorted and blocked layouts, so every rank runs the
        single-card blocked MTTKRP engine over its cell (≙ each rank
        building CSF over its local nonzeros, mpi_cpd.c:714).
        ``opts.block_alloc`` sets the layouts built, as on one card: a
        mode without its own runs the ``scatter`` path on the first.

        Memmapped cells (a streamed build with an ``out_dir``) sort in
        chunked passes, mode m's layouts memmapped under
        ``out_dir/cells_m<m>`` (default: beside the cells' own files)."""
        nmodes = self.nmodes
        binds = self.inds_local.reshape(nmodes, self.ncells, -1)
        bvals = self.vals.reshape(self.ncells, -1)
        if out_dir is None and is_memmapped(binds):
            out_dir = _memmap_dir(binds)
        build_modes = alloc_build_modes(list(self.block_rows), opts)
        if out_dir is not None and opts.verbosity >= Verbosity.LOW:
            # another sorted copy per build mode lands on disk: say where
            # and how large before writing it
            per_mode = (binds.size * binds.itemsize
                        + bvals.size * bvals.itemsize)
            print(f"  cell layouts: memmapped under {out_dir} "
                  f"(cells_m<mode>/, ~{per_mode / 1e9:.2f} GB per build "
                  f"mode x {len(build_modes)} mode(s)); not cleaned up "
                  f"automatically")
        layouts = []
        for m in build_modes:
            i, v, rs, blk, S = build_bucket_layout(
                binds, bvals, self.cell_counts, m, self.block_rows[m],
                opts.nnz_block, chunk=chunk,
                out_dir=_subdir(out_dir, f"cells_m{m}"))
            layouts.append(dict(
                inds=i.reshape((nmodes, *self.grid, -1)),
                vals=v.reshape((*self.grid, -1)),
                row_start=rs.reshape((*self.grid, -1)),
                block=blk, seg_width=S, path=bucket_engine(S, opts),
                sort_mode=m, sort_dim=self.block_rows[m]))
        mode_map = {m: (build_modes.index(m) if m in build_modes else 0)
                    for m in range(nmodes)}
        return CellLayouts(layouts=layouts, mode_map=mode_map,
                           counts=self.cell_counts)


@dataclasses.dataclass
class CellLayouts:
    """The cells' sorted and blocked host arrays, one entry per built
    layout, and the mode -> layout map (see
    :meth:`GridDecomp.build_cell_layouts`)."""

    layouts: List[dict]
    mode_map: dict
    counts: np.ndarray

    def device_put(self, mesh: GridMesh, nmodes: int,
                   dtype=torch.float32) -> List[RankLayouts]:
        """Per mode, the :class:`RankLayouts` its sweep step reads: each
        layout copied to the ranks once and shared by reference; a mode
        whose layout is sorted for another takes the ``scatter`` path."""
        ncells = len(mesh.devices)
        placed = []
        for lay in self.layouts:
            host = (lay["inds"].reshape(nmodes, ncells, -1),
                    lay["vals"].reshape(ncells, -1),
                    lay["row_start"].reshape(ncells, -1),
                    lay["block"], lay["seg_width"])
            placed.append(RankLayouts.place(host, self.counts, lay["path"],
                                            lay["sort_mode"],
                                            lay["sort_dim"], mesh, dtype))
        return [placed[self.mode_map[m]].for_mode(m) for m in range(nmodes)]


def make_grid_sweep(mesh: GridMesh, decomp: GridDecomp, reg: float,
                    cells: Optional[List[RankLayouts]] = None,
                    fallback: Optional[bool] = None, phase=no_phase):
    """One ALS sweep over the grid, as ``sweep(inds, vals, factors,
    grams, first) -> (factors, grams, λ, ⟨Z,Z⟩, ⟨X,Z⟩)`` with per-rank
    lists (factor m's list holds each rank's block of its layer).

    With `cells` (:meth:`CellLayouts.device_put`) each rank's local
    MTTKRP runs the single-card blocked engine over its cell's sorted
    arrays (`fallback` passed to its chain) and `inds`/`vals` are not
    read; without, the stream formulation over each rank's cell, the
    blocked sweep's oracle.  `phase(name)` brackets each phase of the
    sweep (:func:`make_grid_profiled_sweep`)."""
    nmodes = decomp.nmodes
    block_rows = decomp.block_rows
    last = nmodes - 1
    # the layer of mode m: every axis but m; λ and the Grams: axis m
    layers = [mesh.groups([k for k in range(nmodes) if k != m])
              for m in range(nmodes)]
    owners = [mesh.groups([m]) for m in range(nmodes)]
    inner_ranks = mesh.line(last)

    def local_mttkrp(inds, vals, factors, m, r):
        facs = [factors[k][r] for k in range(nmodes)]
        if cells is not None:
            return cells[m].mttkrp(r, facs, m, fallback)
        ids = inds[r]
        prod = vals[r][:, None].to(facs[0].dtype)
        for k in range(nmodes):
            if k != m:
                prod = prod * facs[k].index_select(0, ids[k])
        acc = acc_dtype(prod.dtype)
        return torch.zeros((block_rows[m], int(prod.shape[1])), dtype=acc,
                           device=prod.device).index_add_(0, ids[m],
                                                          prod.to(acc))

    def sweep(inds, vals, factors, grams, first: bool):
        factors = [list(f) for f in factors]
        grams = [list(g) for g in grams]
        dtype = factors[0][0].dtype
        lam = M = None
        for m in range(nmodes):
            with phase("dist_mttkrp"):
                parts = [local_mttkrp(inds, vals, factors, m, r)
                         for r in range(mesh.ndev)]
            with phase("dist_comm"):
                M = allreduce(parts, mesh, groups=layers[m])
            del parts
            with phase("dist_update"):
                U, g, lam = mode_update_tail(M, grams, m, reg, first, mesh,
                                             store_dtype=dtype,
                                             groups=owners[m])
            factors[m] = U
            grams[m] = g
        with phase("dist_fit"):
            znormsq, inner = fit_tail(lam, grams, M, factors[last], mesh,
                                      ranks=inner_ranks)
        return factors, grams, lam, znormsq, inner

    return sweep


def make_grid_profiled_sweep(mesh: GridMesh, decomp: GridDecomp, reg: float,
                             cells: Optional[List[RankLayouts]] = None,
                             fallback: Optional[bool] = None):
    """The grid sweep with its local MTTKRP, layer reduce, update and fit
    each in its ``dist_*`` timer bracket, closed after every card has
    finished it (≙ splatt_tpu/parallel/grid.py:476-586).  The grid
    localizes inputs, so there is no gather phase."""
    from splatt_tpu_torch.parallel.common import profiled_phase

    return make_grid_sweep(mesh, decomp, reg, cells=cells,
                           fallback=fallback,
                           phase=lambda name: profiled_phase(name, mesh))


def grid_cpd_als(tt, rank: int, grid: Optional[Tuple[int, ...]] = None,
                 mesh=None, opts: Optional[Options] = None, init=None,
                 relabel: Optional[str] = None,
                 local_engine: Optional[str] = None,
                 out_dir: Optional[str] = None,
                 device=None, checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 10,
                 resume: bool = True) -> KruskalTensor:
    """Distributed CPD-ALS over an n-D grid (MEDIUM decomposition).

    `grid` defaults to a :class:`GridMesh` `mesh`'s grid, else to
    :func:`auto_grid` over the ranks of `mesh` (a 1-D mesh is a pool of
    devices to arrange) or of the default mesh on `device`.
    `local_engine`: "blocked" (the default, :func:`auto_local_engine`)
    runs the single-card blocked engine in every cell over per-cell
    sorted layouts (≙ mttkrp_csf per rank, mpi_cpd.c:714); "stream"
    keeps the gather product, the oracle.  A memmapped tensor keeps the
    blocked engine when `out_dir` is given: the decomposition builds in
    chunked passes into ``out_dir/scatter`` and the cell layouts by the
    chunked counting sort into ``out_dir/cells_m<m>``, so the host's
    memory stays bounded at any scale; without it the stream engine
    runs.  `relabel`: None balances the
    fences when the equal fences fill poorly, "balanced" always (the
    nnz-balanced fences of :func:`balanced_relabel`); a
    ``reorder.PERM_TYPES`` entry ("random", "graph", "hgraph",
    "fibsched") relabels the whole tensor with :func:`reorder.reorder`
    (seeded by ``opts.random_seed``) before it is decomposed, over equal
    fences (≙ splatt_tpu/parallel/grid.py:615-650).  `init` is a list of
    arrays in the original row space; without it the factors come from a
    generator seeded by ``opts.random_seed``.  The factors come back in
    the original row order, on the CPU.  At ``Verbosity.HIGH`` the
    profiled sweep (:func:`make_grid_profiled_sweep`) runs and the phase
    table is printed.  `checkpoint_path`, `checkpoint_every` and `resume`
    are :func:`run_distributed_als`'s; under `relabel` the checkpoint
    holds the relabeled factors, as in the JAX package.
    """
    opts = (opts or default_opts()).validate()
    dtype = resolve_dtype(opts)
    balance = None
    if relabel == "balanced":
        balance, relabel = True, None
    elif relabel is not None:
        # a whole-tensor relabeling takes the place of fence balancing
        balance = False
    perm = None
    if relabel is not None:
        from splatt_tpu_torch.reorder import reorder

        perm = reorder(tt, relabel, seed=opts.seed())
        tt = perm.apply(tt)
        if init is not None:
            init = [perm.permute_factor(U, m) for m, U in enumerate(init)]

    devices = None
    if mesh is not None:
        if isinstance(mesh, GridMesh) and len(mesh.grid) == tt.nmodes:
            grid = grid or mesh.grid
            if tuple(grid) != tuple(mesh.grid):
                devices, mesh = list(mesh.devices), None
        else:
            devices, mesh = list(mesh.devices), None
    if grid is None:
        pool = (devices if devices is not None
                else make_mesh(device=device).devices)
        grid = auto_grid(len(pool), tt.dims)
    decomp = GridDecomp.build(tt, grid=grid, val_dtype=tt.vals.dtype,
                              balance=balance,
                              out_dir=_subdir(out_dir, "scatter"))
    mesh = mesh or decomp.make_mesh(devices=devices, device=device)
    xnormsq = tt.normsq()

    # the achieved cell balance, always recorded: every cell is padded to
    # the fullest, so max/mean is the wasted-compute factor
    record_shard_imbalance(
        "grid_cell", decomp.cell_counts,
        policy=("balanced" if decomp.relabels is not None else "equal"),
        fill=round(float(decomp.fill), 3))
    if opts.verbosity >= Verbosity.HIGH:
        print(f"GRID {'x'.join(str(g) for g in decomp.grid)} "
              f"fill={decomp.fill:0.2f}")
        print(imbalance_report(decomp.cell_counts, "cell"))
        for line in comm_volume_report(
                decomp.dims_pad, rank,
                torch.empty(0, dtype=dtype).element_size(),
                grid=decomp.grid):
            print(line)

    if local_engine is None:
        local_engine = auto_local_engine(tt, out_dir)
    if local_engine not in ("blocked", "stream"):
        raise ValueError(f"unknown local_engine {local_engine!r}")
    record_local_engine(local_engine, tt, out_dir)
    cells = None
    if local_engine == "blocked":
        # the blocked sweep never reads the stream cells: no O(nnz) copy
        # of them goes to the ranks
        cells = decomp.build_cell_layouts(opts, out_dir=out_dir).device_put(
            mesh, tt.nmodes, dtype)
        inds = vals = None
    else:
        inds, vals = decomp.device_put(mesh, dtype)
    if init is None:
        from splatt_tpu_torch.cpd import init_factors

        gen = torch.Generator().manual_seed(opts.seed())
        init = init_factors(tt.dims, rank, gen, dtype=dtype)
    factors = decomp.shard_factors(init, mesh, dtype)
    from splatt_tpu_torch.ops.linalg import gram

    grams = [allreduce([gram(u) for u in f], mesh, groups=mesh.groups([m]))
             for m, f in enumerate(factors)]
    profiled = opts.verbosity >= Verbosity.HIGH
    sweep = (make_grid_profiled_sweep if profiled else make_grid_sweep)(
        mesh, decomp, opts.regularization, cells=cells,
        fallback=engine_fallback(opts))

    def step(f, g, first):
        return sweep(inds, vals, f, g, first)

    if profiled:
        step = wrap_profiled_step(step)

    def place(U, m):
        return decomp.shard_factor(U, m, mesh, dtype)

    def gram_of(f, m):
        return allreduce([gram(u) for u in f], mesh, groups=mesh.groups([m]))

    out = run_distributed_als(
        step, factors, grams, rank, opts, xnormsq, tt.dims, dtype, mesh,
        row_select=decomp.row_select(),
        shard_ranks=[mesh.line(m) for m in range(tt.nmodes)],
        place=place, gram_of=gram_of, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume)
    if profiled:
        for line in dist_phase_report():
            print(line)
    if perm is not None:
        out.factors = perm.undo_factors(out.factors)
    return out
