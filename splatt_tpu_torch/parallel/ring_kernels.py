"""The ring kernels of the FINE decomposition and their entries
(≙ splatt_tpu/parallel/ring_kernels.py).

The sync ring (``parallel/ring.py``) gives the FINE decomposition
O(dim/ndev) memory per rank, but every hop is a barrier: a rank finishes
its pass over its nonzeros, then the whole block moves, then the next pass
starts.  The two kernels of ``csrc/ring.cu`` hold a ring phase's whole
ndev-step loop in one launch per card, as the Pallas kernels hold it in
``grid=(ndev,)``: the block of step s+1 travels into the right
neighbour's double-buffered landing zone while step s is consumed, and
flags in peer memory take the place of the TPU's DMA and credit
semaphores (``csrc/ring.cu`` has the protocol).

- :func:`ring_gather` (≙ ``_ring_gather_kernel``): each rank's ``(nnz_d,
  R)`` rows of a row-sharded factor at its nonzeros' global ids, exact.
- :func:`ring_reduce` (≙ ``_ring_reduce_kernel``): the ring
  reduce-scatter of the MTTKRP products into each rank's ``(block, R)``
  rows, f32; rounding follows hop order.

Both walk one :class:`RingPlan` per rank (:func:`build_ring_plans`): the
nonzeros sorted by global id once per id tensor, so bucketed by owner, as
the TPU kernels take each nonzero's owner and within-block row
precomputed (``idx_div_ref``/``idx_loc_ref``, ring_kernels.py:152-160).
A step visits only one bucket, and in the reduce a row's nonzeros are
contiguous, so they are summed in registers and written once.

Their plain versions walk the same plans: :func:`ring_gather_plain` (bit
for bit the sync ring's
:func:`~splatt_tpu_torch.parallel.ring.gather_hops`) and
:func:`ring_reduce_plain` (the sync ring's
:func:`~splatt_tpu_torch.parallel.ring.blockwise_reduce_rows` to
rounding).  A wrapper runs the sync ring for CPU tensors; for CUDA tensors
it launches the kernel on every card of the mesh, one launch per card
holding all of that card's ranks, or raises.  It launches every card's
kernel before it waits on any and never synchronizes: a spin that ran out
writes an error word that
:func:`check_errors` turns into a :class:`RingError` at the sweep's next
fit read.  Each wrapper's ``.launches`` counts its launches (one per card
per call).

The entries the sweep calls, :func:`async_ring_gather_rows` and
:func:`async_blockwise_reduce_rows`, arm the ``comm.ring_exchange`` fault
site.  On a CPU mesh they take the sync ring (which arms the site again,
as the JAX entries do), so the ``async_ring`` strategy equals ``ring``
bit for bit there and the CPU fallback ladder matches the JAX package's.
On a CUDA mesh they launch the kernels, and the comm chain of
``ASYNC_RING`` is the kernel alone: a failure raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Dict, List, Optional, Sequence

import torch

from splatt_tpu_torch.utils import faults

#: the kernels' bound on every spin, in seconds
SPIN_TIMEOUT_S = 10.0
#: ranks of one card in one launch (kMaxLocal of csrc/ring.cu)
MAX_LOCAL_RANKS = 16
#: int64 flag words per rank: ready at 0, credit at 16
FLAG_WORDS = 32
#: factor and product dtypes the kernels take
CARD_FLOATS = (torch.float32, torch.bfloat16)
#: a cooperative launch the card refused beside ops/kernels.LAUNCH_REFUSED
COOPERATIVE_TOO_LARGE = 720
#: alignment of the gather's landing slots, so the hop moves 16-byte vectors
SLOT_ALIGN = 256
#: the gathered rows' pitch in bytes is a multiple of this, a DRAM burst,
#: so the kernel's interleaved row stores never share a burst
#: (csrc/ring.cu)
ROW_PITCH_ALIGN = 64

_LOCK = threading.Lock()


class RingError(RuntimeError):
    """A ring kernel's wait for its neighbour ran out of time."""


class _RankPtrs(ctypes.Structure):
    """One rank's operands (RankPtrs of csrc/ring.cu)."""

    _fields_ = [("in_", ctypes.c_void_p), ("idx", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("acc", ctypes.c_void_p),
                ("lz", ctypes.c_void_p), ("lz_right", ctypes.c_void_p),
                ("flags", ctypes.c_void_p), ("flags_right", ctypes.c_void_p),
                ("flags_left", ctypes.c_void_p), ("nnz", ctypes.c_longlong),
                ("rank", ctypes.c_longlong), ("pos", ctypes.c_void_p),
                ("loc", ctypes.c_void_p), ("off", ctypes.c_void_p)]


class _RingState:
    """What one ring kind keeps across launches at one (mesh, block, R,
    dtype): each rank's double-buffered landing zone (the gather's two
    slots ``slot`` bytes apart, a multiple of :data:`SLOT_ALIGN`), its f32
    accumulators (the reduce's, zero between launches) and its flag words
    (zero at first, then only ever raised), and the launch generation."""

    def __init__(self, mesh, block: int, R: int, dtype: torch.dtype,
                 reduce: bool):
        for a, b in _neighbour_pairs(mesh):
            enable_peer_access(a, b)
        esize = torch.empty(0, dtype=dtype).element_size()
        if reduce:
            self.lz = [torch.zeros((2, block, R), dtype=dtype, device=dev)
                       for dev in mesh.devices]
        else:
            self.slot = -(-block * R * esize // SLOT_ALIGN) * SLOT_ALIGN
            self.lz = [torch.zeros(2 * self.slot // esize, dtype=dtype,
                                   device=dev) for dev in mesh.devices]
        self.acc = ([torch.zeros((2, block, R), dtype=torch.float32,
                                 device=dev) for dev in mesh.devices]
                    if reduce else None)
        self.flags = [torch.zeros(FLAG_WORDS, dtype=torch.int64, device=dev)
                      for dev in mesh.devices]
        self.gen = 0


_STATES: Dict[tuple, _RingState] = {}
_ERR_WORD: List[int] = []         # [host address, device address]
_PEERS: set = set()


def _lib():
    from splatt_tpu_torch.ops.kernels import load_library

    return load_library()


def _error_word() -> tuple:
    """The mapped host word every ring launch reports a timeout in."""
    with _LOCK:
        if not _ERR_WORD:
            host, dev = ctypes.c_void_p(), ctypes.c_void_p()
            err = _lib()["splatt_ring_alloc_host"](
                64, ctypes.byref(host), ctypes.byref(dev))
            if err != 0:
                raise RuntimeError(f"splatt_ring_alloc_host: CUDA error "
                                   f"{err}")
            _ERR_WORD[:] = [host.value, dev.value]
        return tuple(_ERR_WORD)


def check_errors() -> None:
    """Raise :class:`RingError` when a ring launch reported a wait that
    ran out (read from mapped host memory: no synchronization).  The
    word is cleared and every ring state dropped, so the next launch
    starts from fresh flags and zero accumulators."""
    if not _ERR_WORD:
        return
    word = ctypes.c_int.from_address(_ERR_WORD[0])
    code = word.value
    if code == 0:
        return
    word.value = 0
    _STATES.clear()
    kind, rank, step = code // 1000000, code // 1000 % 1000, code % 1000
    what = {1: "its left neighbour's block",
            2: "its right neighbour's credit"}.get(kind, "a flag")
    raise RingError(f"ring kernel: rank {rank} waited {SPIN_TIMEOUT_S} s "
                    f"for {what} at step {step}")


def enable_peer_access(a: torch.device, b: torch.device) -> None:
    """Let card `a`'s kernels read and write card `b`'s memory; a pair of
    cards without peer access raises (the ring never takes the sync
    ring's copies in its place)."""
    if a == b or (a, b) in _PEERS:
        return
    if not torch.cuda.can_device_access_peer(a.index, b.index):
        raise RuntimeError(f"{a} has no peer access to {b}: the ring "
                           f"kernels store into a neighbour's memory")
    err = _lib()["splatt_ring_enable_peer"](a.index, b.index)
    if err != 0:
        raise RuntimeError(f"enabling peer access {a} -> {b}: CUDA error "
                           f"{err}")
    _PEERS.add((a, b))


def _neighbour_pairs(mesh):
    n = mesh.ndev
    for r in range(n):
        a, b = mesh.devices[r], mesh.devices[(r + 1) % n]
        if a != b:
            yield a, b
            yield b, a


def prepare(mesh, dtype) -> None:
    """What a CUDA mesh's ring sweep needs before its first step: the
    kernels built and loaded, a dtype they take, at most
    :data:`MAX_LOCAL_RANKS` ranks per card and peer access between
    neighbouring cards.  Raises; nothing here is demoted."""
    if dtype not in CARD_FLOATS:
        raise TypeError(f"the ring kernels take {CARD_FLOATS}, not {dtype}")
    _check_mesh(mesh)
    _lib()
    _error_word()
    for a, b in _neighbour_pairs(mesh):
        enable_peer_access(a, b)


def _check_mesh(mesh) -> None:
    for card in mesh.cards:
        if len(mesh.ranks_on(card)) > MAX_LOCAL_RANKS:
            raise ValueError(f"{len(mesh.ranks_on(card))} ranks on {card}; "
                             f"the ring kernels run at most "
                             f"{MAX_LOCAL_RANKS} ranks of a card")


def _check(name: str, mats: Sequence[torch.Tensor],
           idx: Sequence[torch.Tensor], mesh, rows_of) -> None:
    """The wrappers' operand contract: one 2-D tensor and one int32 id
    vector per rank, on the rank's device, contiguous, the matrices of
    one dtype in :data:`CARD_FLOATS` and one width."""
    if len(mats) != mesh.ndev or len(idx) != mesh.ndev:
        raise ValueError(f"{name}: {len(mats)} tensors and {len(idx)} id "
                         f"vectors for {mesh.ndev} ranks")
    _check_mesh(mesh)
    R = int(mats[0].shape[1]) if mats[0].dim() == 2 else 0
    for d, (x, i) in enumerate(zip(mats, idx)):
        dev = mesh.devices[d]
        if x.device != dev or i.device != dev:
            raise ValueError(f"{name}: rank {d}'s operands are on "
                             f"{x.device} and {i.device}, not {dev}")
        if x.dtype not in CARD_FLOATS or x.dtype != mats[0].dtype:
            raise TypeError(f"{name}: rank {d}'s values are {x.dtype}; the "
                            f"kernel takes one of {CARD_FLOATS}")
        if i.dtype != torch.int32 or i.dim() != 1:
            raise TypeError(f"{name}: rank {d}'s ids must be a 1-D int32 "
                            f"tensor, got {i.dtype} {tuple(i.shape)}")
        if x.dim() != 2 or int(x.shape[1]) != R or R < 1 \
                or int(x.shape[0]) != rows_of(d):
            raise ValueError(f"{name}: rank {d}'s values have shape "
                             f"{tuple(x.shape)}, expected ({rows_of(d)}, "
                             f"{R})")
        if not (x.is_contiguous() and i.is_contiguous()):
            raise ValueError(f"{name}: rank {d}'s operands must be "
                             f"contiguous")


def _state(kind: str, mesh, block: int, R: int, dtype) -> _RingState:
    key = (kind, mesh.devices, block, R, dtype)
    st = _STATES.get(key)
    if st is None:
        st = _STATES[key] = _RingState(mesh, block, R, dtype,
                                       reduce=kind == "reduce")
    return st


def _run(wrapper, entry: str, mesh, st: _RingState, ranks, block: int,
         R: int, flag: int, exchange: bool, *extra) -> None:
    """Launch `entry` once per card, every card before any wait.  A rank
    is (source, ids, output, nnz, plan or None)."""
    fn = _lib()[entry]
    err_dev = _error_word()[1]
    st.gen += 1
    n = mesh.ndev
    launched = []
    for card in mesh.cards:
        mine = mesh.ranks_on(card)
        arr = (_RankPtrs * len(mine))()
        for slot, d in enumerate(mine):
            right, left = (d + 1) % n, (d - 1) % n
            src, ids, out, nnz, plan = ranks[d]
            arr[slot] = _RankPtrs(
                src, ids, out, st.acc[d].data_ptr() if st.acc else None,
                st.lz[d].data_ptr(), st.lz[right].data_ptr(),
                st.flags[d].data_ptr(), st.flags[right].data_ptr(),
                st.flags[left].data_ptr(), nnz, d,
                *((plan.pos.data_ptr(), plan.loc.data_ptr(),
                   plan.offsets.data_ptr()) if plan is not None
                  else (None, None, None)))
        with torch.cuda.device(card):
            err = fn(card.index, ctypes.cast(arr, ctypes.c_void_p),
                     len(mine), n, block, R, flag, st.gen, err_dev,
                     int(SPIN_TIMEOUT_S * 1e9), int(exchange), *extra,
                     torch.cuda.current_stream(card).cuda_stream)
        if err != 0:
            # the cards already launched wait on this one until their spin
            # bound runs out: let them finish, then start from fresh state
            for c in launched:
                torch.cuda.synchronize(c)
            _STATES.clear()
            if _ERR_WORD:
                ctypes.c_int.from_address(_ERR_WORD[0]).value = 0
            from splatt_tpu_torch.ops.kernels import (KernelLaunchError,
                                                      LAUNCH_REFUSED)

            if err in LAUNCH_REFUSED or err == COOPERATIVE_TOO_LARGE:
                raise KernelLaunchError(f"{entry}: the card refused the "
                                        f"launch (CUDA error {err})")
            raise RuntimeError(f"{entry}: CUDA error {err} at launch")
        launched.append(card)
        from splatt_tpu_torch.ops.kernels import count_launch

        count_launch(wrapper)


@dataclasses.dataclass(frozen=True)
class RingPlan:
    """One rank's owner buckets for :func:`ring_gather` and
    :func:`ring_reduce`, built once per id tensor (8 bytes per nonzero):
    ``pos`` the nonzero positions stably sorted by global id (so by owner
    shard and, within a shard, by row; ids of no shard, owner ndev,
    last), ``loc`` each one's row within its owner's block (0 for ids of
    no shard), both int32, and ``offsets`` the ``ndev + 2`` int32 bucket
    bounds.  A row's nonzeros are contiguous in its bucket, which the
    reduce's running row sums need."""

    pos: torch.Tensor
    loc: torch.Tensor
    offsets: torch.Tensor
    block: int


def build_ring_plans(idx: Sequence[torch.Tensor], mesh,
                     block: int) -> List[RingPlan]:
    """Each rank's :class:`RingPlan` for global ids ``idx[d]`` over
    shards of `block` rows, built on the ids' device with no host sync
    (a stable sort by id and the bucket counts by ``scatter_add_``).  ``build_ring_plans.builds`` counts the
    plans built, one per rank."""
    ndev = mesh.ndev
    plans = []
    for ids in idx:
        if ids.dim() != 1 or int(ids.shape[0]) >= 2**31:
            raise ValueError(f"ring plan: ids of shape {tuple(ids.shape)}; "
                             f"a 1-D tensor below 2^31 entries is needed")
        ids = ids.long()
        owner = torch.div(ids, block, rounding_mode="floor")
        owner = torch.where((ids >= 0) & (owner < ndev), owner,
                            torch.full_like(owner, ndev))
        # ids of no shard sort last, in their own order
        key = torch.where(owner < ndev, ids,
                          torch.full_like(ids, ndev * block))
        order = torch.sort(key, stable=True).indices
        ordered = owner[order]
        loc = torch.where(ordered < ndev, ids[order] - ordered * block,
                          torch.zeros_like(ordered))
        counts = torch.zeros(ndev + 1, dtype=torch.int64, device=ids.device)
        counts.scatter_add_(0, owner, torch.ones_like(owner))
        offsets = torch.cat([torch.zeros(1, dtype=torch.int64,
                                         device=ids.device),
                             torch.cumsum(counts, 0)])
        plans.append(RingPlan(order.int(), loc.int(), offsets.int(), block))
        build_ring_plans.builds += 1
    return plans


def _check_plans(name: str, plans, idx, block: int) -> None:
    """Each rank's plan was built from its ids over `block`-row shards."""
    for d, (plan, i) in enumerate(zip(plans, idx)):
        if plan.block != block or plan.pos.shape != i.shape \
                or plan.pos.device != i.device:
            raise ValueError(f"{name}: rank {d}'s plan does not match its "
                             f"ids and shards")


def ring_gather_plain(U_l: Sequence[torch.Tensor],
                      plans: Sequence[RingPlan], mesh
                      ) -> List[torch.Tensor]:
    """Plain PyTorch version of :func:`ring_gather`, the kernel's walk:
    at step s rank d copies the rows of its plan's bucket (d - s) mod ndev
    from the shard it holds then, and the bucket of ids of no shard gets
    zero rows.  Bit for bit the sync ring's rows."""
    ndev = mesh.ndev
    R = int(U_l[0].shape[1])
    out = []
    for d, plan in enumerate(plans):
        dev = mesh.devices[d]
        off = plan.offsets.tolist()
        pos, loc = plan.pos.long(), plan.loc.long()
        rows = torch.empty((int(pos.shape[0]), R), dtype=U_l[0].dtype,
                           device=dev)
        for s in range(ndev):
            b = (d - s) % ndev
            held = U_l[b].to(dev)
            rows[pos[off[b]:off[b + 1]]] = held[loc[off[b]:off[b + 1]]]
        rows[pos[off[ndev]:off[ndev + 1]]] = 0
        out.append(rows)
    return out


def ring_gather(U_l: Sequence[torch.Tensor], idx: Sequence[torch.Tensor],
                mesh, exchange: bool = True,
                plans: Optional[Sequence[RingPlan]] = None
                ) -> List[torch.Tensor]:
    """Rank d's ``(nnz_d, R)`` rows of the row-sharded factor ``U_l``
    (``U_l[d]``: rank d's ``(block, R)`` shard) at its global ids
    ``idx[d]``, in U's dtype; an id of no shard gives a zero row.  On a
    card each result is the ``(nnz_d, R)`` view of a buffer whose rows are
    padded to :data:`ROW_PITCH_ALIGN` bytes.  `plans` are the ids'
    :class:`RingPlan`s; without them they are built here (a caller that
    gathers at the same ids again builds them once with
    :func:`build_ring_plans`).  CPU tensors take the sync ring's
    :func:`~splatt_tpu_torch.parallel.ring.gather_hops`.  With `exchange`
    off (the overlap probe's compute-only run) the blocks do not travel
    and the result is wrong by design."""
    from splatt_tpu_torch.parallel.ring import gather_hops

    if U_l[0].device.type == "cpu":
        return gather_hops(U_l, idx, mesh)
    block = int(U_l[0].shape[0])
    if plans is None:
        plans = build_ring_plans(idx, mesh, block)
    _check("ring_gather", U_l, idx, mesh, lambda d: block)
    _check_plans("ring_gather", plans, idx, block)
    check_errors()
    R = int(U_l[0].shape[1])
    st = _state("gather", mesh, block, R, U_l[0].dtype)
    esize = U_l[0].element_size()
    pitch = -(-R * esize // ROW_PITCH_ALIGN) * ROW_PITCH_ALIGN
    rows = [torch.empty((int(i.shape[0]), pitch // esize), dtype=U.dtype,
                        device=U.device)[:, :R]
            for U, i in zip(U_l, idx)]
    ranks = [(U.data_ptr(), i.data_ptr(), r.data_ptr(), int(i.shape[0]), p)
             for U, i, r, p in zip(U_l, idx, rows, plans)]
    _run(ring_gather, "splatt_ring_gather", mesh, st, ranks, block, R,
         esize, exchange, st.slot, pitch)
    return rows


def ring_reduce_plain(prod: Sequence[torch.Tensor],
                      plans: Sequence[RingPlan], mesh) -> List[torch.Tensor]:
    """Plain PyTorch version of :func:`ring_reduce`, the kernel's walk:
    the partial of block j starts at rank j+1 and travels right; at step
    s rank d adds its plan's bucket (d - 1 - s) mod ndev (product rows
    ``pos`` into rows ``loc``) to the partial it received, in the
    accumulator dtype.  Rounding follows hop order, as the sync ring's
    :func:`~splatt_tpu_torch.parallel.ring.blockwise_reduce_rows`."""
    from splatt_tpu_torch.config import acc_dtype

    ndev = mesh.ndev
    block = plans[0].block
    R = int(prod[0].shape[1])
    out_dtype = acc_dtype(prod[0].dtype)
    held = [None] * ndev
    for s in range(ndev):
        new = []
        for d, plan in enumerate(plans):
            j = (d - 1 - s) % ndev
            lo, hi = plan.offsets[j:j + 2].tolist()
            part = torch.zeros((block, R), dtype=out_dtype,
                               device=prod[d].device)
            part.index_add_(0, plan.loc[lo:hi].long(),
                            prod[d][plan.pos[lo:hi].long()].to(out_dtype))
            new.append(part if s == 0 else part + held[d])
        held = ([new[(d - 1) % ndev].to(mesh.devices[d])
                 for d in range(ndev)] if s < ndev - 1 else new)
    return held


def ring_reduce(prod: Sequence[torch.Tensor], idx: Sequence[torch.Tensor],
                mesh, block: int, exchange: bool = True,
                plans: Optional[Sequence[RingPlan]] = None
                ) -> List[torch.Tensor]:
    """Rank d's reduced ``(block, R)`` rows, f32: the sum over every
    rank's products ``prod[e]`` (``(nnz_e, R)``) whose global id
    ``idx[e]`` falls in rank d's block.  `plans` are the ids'
    id-sorted :class:`RingPlan`s (the gather's, when it shares them);
    without them they are built here.  CPU tensors take the sync ring's
    :func:`~splatt_tpu_torch.parallel.ring.blockwise_reduce_rows`.  With
    `exchange` off the partials do not travel (the overlap probe's
    compute-only run)."""
    from splatt_tpu_torch.parallel.ring import blockwise_reduce_rows

    if prod[0].device.type == "cpu":
        return blockwise_reduce_rows(prod, idx, mesh, block)
    _check("ring_reduce", prod, idx, mesh, lambda d: int(idx[d].shape[0]))
    if block < 1:
        raise ValueError(f"ring_reduce: block must be >= 1, got {block}")
    if plans is None:
        plans = build_ring_plans(idx, mesh, block)
    _check_plans("ring_reduce", plans, idx, block)
    check_errors()
    R = int(prod[0].shape[1])
    st = _state("reduce", mesh, block, R, torch.float32)
    out = [torch.empty((block, R), dtype=torch.float32, device=p.device)
           for p in prod]
    ranks = [(p.data_ptr(), i.data_ptr(), o.data_ptr(), int(i.shape[0]), q)
             for p, i, o, q in zip(prod, idx, out, plans)]
    _run(ring_reduce, "splatt_ring_reduce", mesh, st, ranks, block, R,
         int(prod[0].dtype == torch.bfloat16), exchange)
    return out


RING_KERNELS = (ring_gather, ring_reduce)


def reset_launches() -> None:
    """Set both ring wrappers' launch counts and the count of ring plans
    built to 0."""
    for k in RING_KERNELS:
        k.launches = 0
    build_ring_plans.builds = 0


reset_launches()


# -- the entries the sweep calls ---------------------------------------------


def async_ring_gather_rows(U_l: Sequence[torch.Tensor],
                           idx: Sequence[torch.Tensor], mesh,
                           plans: Optional[Sequence[RingPlan]] = None
                           ) -> List[torch.Tensor]:
    """Rows of a row-sharded factor at each rank's global ids through the
    ring kernel (≙ splatt_tpu async_ring_gather_rows), over the ids'
    `plans` when given.  On a CPU mesh the sync ring, which needs no
    plan."""
    faults.maybe_fail("comm.ring_exchange")
    if U_l[0].device.type == "cpu":
        from splatt_tpu_torch.parallel.ring import ring_gather_rows

        return ring_gather_rows(U_l, idx, mesh)
    return ring_gather(U_l, idx, mesh, plans=plans)


def async_blockwise_reduce_rows(prod: Sequence[torch.Tensor],
                                idx: Sequence[torch.Tensor], mesh,
                                block: int,
                                plans: Optional[Sequence[RingPlan]] = None
                                ) -> List[torch.Tensor]:
    """Each rank's reduced MTTKRP rows through the ring kernel
    (≙ splatt_tpu async_blockwise_reduce_rows), over the ids' `plans`
    when given; on a CPU mesh the sync ring, which needs no plan."""
    faults.maybe_fail("comm.ring_exchange")
    if prod[0].device.type == "cpu":
        from splatt_tpu_torch.parallel.ring import blockwise_reduce_rows

        return blockwise_reduce_rows(prod, idx, mesh, block)
    return ring_reduce(prod, idx, mesh, block, plans=plans)
