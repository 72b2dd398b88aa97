"""GROOT degree-bucketed SpMM: host plan, device walks, CUDA kernels.

Port of ``repro/kernels/groot_spmm.py``.  The host plan (the count-sort /
row assembly of paper Fig. 5) is a numpy copy whose arrays are identical to
the reference's, ``rows_per_tile`` included.  The device walks run the SpMM

    out[r] = sum_{e: dst[e] = r} w[e] * x[src[e]]

(ungrouped, :func:`apply_plan`) and its grouped multi-polarity form

    out[g, r] = sum_{e: dst[e] = r} wg[e, g] * x[src[e]]

(:func:`apply_plan_grouped`) through hand-written CUDA kernels
(``csrc/groot_spmm.cu``):

  K1 ``ld_grouped_apply``      grouped low-degree rows (degree <= e_t), one ELL
     bucket of power-of-two degree d per launch; replaces ``_ld_kernel_grouped``.
  K2 ``hd_grouped_apply``      grouped high-degree rows (degree > e_t), split
     into e_t-edge chunks: a sum per chunk (chunks spread over the card's
     warps), then each row's chunks added in order; replaces
     ``_hd_kernel_grouped``.
  K4 ``ld_grouped_mxu_apply``  K1's sum as one-hot block-diagonal products on
     the tensor cores (``ld_grouped_apply(mxu=True)`` for d > 1); replaces
     ``_ld_kernel_grouped_mxu``.
  K5 ``ld_bucket_apply``       ungrouped LD rows, optional weight, VPU body or
     (``mxu=True``, d > 1) tensor-core body, both gathering through K4's
     staged ring; replaces ``_ld_kernel`` and ``_ld_kernel_mxu``.
  K6 ``hd_apply``              ungrouped HD rows, K2's body at one group;
     replaces ``_hd_kernel``.

Unlike the TPU walk, the kernels gather ``x_p[cols]`` themselves (no message
slab in device memory) and the feature axis is not padded to a 128-lane
quantum: ``x_p`` is ``(N + 1, F)`` with one zero row at index N, the target of
every pad column.  The staged bodies (K3, K4, K5, K7) are built for rows of
4, 8, 16 or 32 features; other widths are zero-padded to the next of these,
or run as 32-column slices (:func:`staged_slices`).  The HD body (K2, K6)
reads such slices of x in place instead.  Each wrapper runs its
plain PyTorch version on a CPU tensor and its kernel on a CUDA tensor, and
counts its kernel launches.

Where the product of a message and its weight is rounded follows the
reference: the grouped VPU kernels (K1, K2) widen both to f32 and multiply
there; the MXU kernel (K4) and the ungrouped walk (K5, K6) take the product in
the stream dtype (bf16 streams round it to bf16) and sum in f32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as kref
from repro_torch.obs.metrics import REGISTRY, CounterGroup

# ---------------------------------------------------------------------------
# Probe counters (the reference's ``PROBE``): a dict-shaped view over the
# process-wide registry's ``kernels.spmm.<key>`` counters.
#   ``edge_stream_gathers``/``kernel_walks``  plan walks (one per SpMM)
#   ``weight_gathers``   edge-weight streams staged
#   ``pallas_calls``     hand-written kernel launches (on a CUDA tensor)
#   ``output_scatters``  output scatters (none: assembly is a gather)
#   ``stream_bytes``     modeled bytes of the gathered edge streams
# The reference bumps them at trace time; the port runs eagerly and bumps
# them on every call.
# ---------------------------------------------------------------------------
PROBE = CounterGroup(
    REGISTRY,
    "kernels.spmm",
    ("edge_stream_gathers", "kernel_walks", "pallas_calls", "weight_gathers",
     "output_scatters", "stream_bytes"),
)


def reset_probe() -> None:
    for k in PROBE:
        PROBE[k] = 0


def probe_snapshot() -> dict:
    return dict(PROBE)

# Paper §IV thresholds: HD rows have degree > E_T; LD buckets are the
# power-of-two degrees up to E_T.  LD_TILE_EDGES and SUBLANE keep
# ``rows_per_tile`` (and so every padded bucket shape) equal to the
# reference's, even though the CUDA kernels do not tile by it.
E_T = 512
LD_TILE_EDGES = 2048
SUBLANE = 8


# ---------------------------------------------------------------------------
# Host-side plan (the count-sort / row-assembly of paper Fig. 5, step B)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LdBucket:
    """All rows whose (padded) degree is ``deg``: an ELL slab."""

    deg: int
    rows: np.ndarray        # (R_pad,) int32 destination row ids (pad = -1)
    cols: np.ndarray        # (R_pad * deg,) int32 source node ids (pad = N)
    eids: np.ndarray        # (R_pad * deg,) int32 edge ids (pad = E)
    rows_per_tile: int      # R_t

    @property
    def num_rows(self) -> int:
        return int(self.rows.shape[0])


@dataclasses.dataclass(frozen=True)
class HdPlan:
    """Rows with degree > E_T, chunked into E_t-edge pieces."""

    rows: np.ndarray        # (n_hd,) int32 destination row ids
    cols: np.ndarray        # (n_chunks * E_t,) int32 source ids (pad = N)
    eids: np.ndarray        # (n_chunks * E_t,) int32 edge ids (pad = E)
    chunk_meta: np.ndarray  # (n_chunks, 2) int32: [output row slot, is_first]

    @property
    def num_chunks(self) -> int:
        return int(self.chunk_meta.shape[0])

    def row_chunks(self) -> np.ndarray:
        """(n_hd, 2) int32 ``[first chunk, chunk count]`` per HD row, derived
        from ``chunk_meta`` (a row's chunks are consecutive): the CUDA HD
        kernel's second pass adds one row's chunk sums in this order."""
        slots = self.chunk_meta[:, 0].astype(np.int64)
        n_hd = int(self.rows.shape[0])
        first = np.searchsorted(slots, np.arange(n_hd))
        count = np.bincount(slots, minlength=n_hd)
        return np.stack([first, count], axis=1).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class SpmmPlan:
    num_nodes: int
    num_edges: int
    buckets: tuple          # tuple[LdBucket, ...]
    hd: Optional[HdPlan]
    e_t: int = E_T
    # Inverse count-sort permutation for scatter-free output assembly:
    # bucket (then HD) reductions concatenated row-major form a
    # (asm_rows, F) array whose LAST row is zero; ``asm_index[r]`` is the
    # concat position of destination row r (degree-0 rows point at the
    # zero row).  A row appears in exactly one LD bucket OR the HD plan —
    # never both — so one gather (no adds) assembles the (N, F) output.
    asm_index: Optional[np.ndarray] = None   # (N,) int32
    asm_rows: int = 0
    # device copies of the index arrays, one DevicePlan per device (filled
    # by :meth:`on`; not part of the plan's value)
    _device: dict = dataclasses.field(
        default_factory=dict, compare=False, repr=False
    )

    @property
    def num_slots(self) -> int:
        """Gathered edge-stream rows per walk (real edges + ELL padding)."""
        return sum(b.eids.size for b in self.buckets) + (
            self.hd.eids.size if self.hd else 0
        )

    def on(self, device) -> "DevicePlan":
        """The plan's index arrays on ``device``, copied there once."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            # "cuda" and the tensors' "cuda:<n>" must share one copy
            device = torch.device("cuda", torch.cuda.current_device())
        key = str(device)
        dp = self._device.get(key)
        if dp is None:
            dp = DevicePlan.build(self, device)
            self._device[key] = dp
        return dp

    def release(self) -> None:
        """Drop every device copy :meth:`on` made (a caller still holding a
        ``DevicePlan`` keeps its tensors); the next :meth:`on` copies again."""
        self._device.clear()


def build_plan(
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    num_nodes: int,
    *,
    e_t: int = E_T,
    ld_tile_edges: int = LD_TILE_EDGES,
) -> SpmmPlan:
    """Degree count-sort + row assembly (paper Fig. 5 step B, host, O(E)).

    ``eids`` index the *edge array*, so one plan serves any (x, w) pair on
    the same graph (all six slot/polarity groups of the GNN reuse it).
    """
    edge_src = np.asarray(edge_src, dtype=np.int64)
    edge_dst = np.asarray(edge_dst, dtype=np.int64)
    n, e = int(num_nodes), int(edge_dst.shape[0])
    # indices are staged as int32 (halves the index bytes per launch)
    if not (n < 2**31 and e < 2**31):
        raise ValueError(f"graph too large for int32 plan indices ({n} nodes, {e} edges)")
    deg = np.bincount(edge_dst, minlength=n).astype(np.int64)

    # CSR-style row starts after a stable count-sort of edges by dest row.
    order = np.argsort(edge_dst, kind="stable").astype(np.int64)
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=starts[1:])

    buckets: list[LdBucket] = []
    d = 1
    while d <= e_t:
        lo = 1 if d == 1 else d // 2 + 1
        rows = np.where((deg >= lo) & (deg <= d))[0]
        if rows.size:
            r_t = max(SUBLANE, (ld_tile_edges // d) // SUBLANE * SUBLANE)
            r_pad = -rows.size % r_t
            eids = np.full((rows.size + r_pad, d), e, dtype=np.int64)
            for slot in range(d):  # d slots; loop count <= 512, host-only
                take = deg[rows] > slot
                eids[: rows.size][take, slot] = order[starts[rows[take]] + slot]
            rows_p = np.concatenate(
                [rows, np.full(r_pad, -1, dtype=np.int64)]
            ).astype(np.int32)
            flat = eids.reshape(-1)
            cols = np.where(flat < e, edge_src[np.minimum(flat, e - 1)], n)
            buckets.append(
                LdBucket(
                    deg=d,
                    rows=rows_p,
                    cols=cols.astype(np.int32),
                    eids=flat.astype(np.int32),
                    rows_per_tile=r_t,
                )
            )
        d *= 2

    hd_rows = np.where(deg > e_t)[0]
    hd = None
    if hd_rows.size:
        n_chunks_per = -(-deg[hd_rows] // e_t)
        total_chunks = int(n_chunks_per.sum())
        eids = np.full((total_chunks, e_t), e, dtype=np.int64)
        meta = np.zeros((total_chunks, 2), dtype=np.int32)
        c = 0
        for slot_i, r in enumerate(hd_rows):
            row_edges = order[starts[r] : starts[r + 1]]
            for k in range(int(n_chunks_per[slot_i])):
                chunk = row_edges[k * e_t : (k + 1) * e_t]
                eids[c, : chunk.size] = chunk
                meta[c] = (slot_i, 1 if k == 0 else 0)
                c += 1
        flat = eids.reshape(-1)
        cols = np.where(flat < e, edge_src[np.minimum(flat, e - 1)], n)
        hd = HdPlan(
            rows=hd_rows.astype(np.int32),
            cols=cols.astype(np.int32),
            eids=flat.astype(np.int32),
            chunk_meta=meta,
        )

    asm_index, asm_rows = _assembly_index(n, buckets, hd)
    return SpmmPlan(
        num_nodes=n, num_edges=e, buckets=tuple(buckets), hd=hd, e_t=e_t,
        asm_index=asm_index, asm_rows=asm_rows,
    )


def _assembly_index(
    n: int, buckets: list[LdBucket], hd: Optional[HdPlan]
) -> tuple[np.ndarray, int]:
    """Inverse count-sort permutation (scatter-free output assembly).

    Concatenating every bucket's padded reduction and the HD rows
    row-major, followed by one zero row, gives an (asm_rows, F) array
    where ``take(cat, asm_index)`` is the (N, F) output — a destination
    row belongs to exactly one LD bucket or the HD plan, so no adds are
    needed.
    """
    asm = np.full(n, -1, dtype=np.int64)
    off = 0
    for b in buckets:
        live = b.rows >= 0
        rows_live = b.rows[live].astype(np.int64)
        assert (asm[rows_live] < 0).all(), "row in two LD buckets"
        asm[rows_live] = off + np.nonzero(live)[0]
        off += b.rows.shape[0]
    if hd is not None:
        hd_rows = hd.rows.astype(np.int64)
        # a row receiving both an LD and an HD contribution would need an
        # add on top of the gather; the degree partition makes it
        # impossible within one plan — assert it
        assert (asm[hd_rows] < 0).all(), "row is both LD and HD"
        asm[hd_rows] = off + np.arange(hd.rows.shape[0])
        off += hd.rows.shape[0]
    zero_row = off
    asm[asm < 0] = zero_row           # degree-0 rows read the zero row
    asm_rows = off + 1
    assert asm_rows < 2**31
    return asm.astype(np.int32), asm_rows


def plan_cat_eids(plan: SpmmPlan) -> np.ndarray:
    """Concatenated edge-id stream of every bucket + HD chunk (int32) —
    the single gather index of :func:`stage_group_weights`."""
    parts = [b.eids for b in plan.buckets]
    if plan.hd is not None:
        parts.append(plan.hd.eids)
    if not parts:
        return np.zeros(0, np.int32)
    return np.concatenate(parts).astype(np.int32)


@dataclasses.dataclass(frozen=True, eq=False)
class DevicePlan:
    """A plan's index arrays as tensors on one device, plus where each
    bucket's rows start in the (G, asm_rows, F) concatenation buffer."""

    plan: SpmmPlan
    cols: tuple             # per bucket (R_pad * deg,) int32
    offsets: tuple          # per bucket: first concat row
    hd_cols: Optional[torch.Tensor]        # (n_chunks * e_t,) int32
    hd_meta: Optional[torch.Tensor]        # (n_chunks, 2) int32 chunk_meta
    hd_row_chunks: Optional[torch.Tensor]  # (n_hd, 2) int32 [first, count]
    hd_offset: int
    cat_eids: torch.Tensor  # (num_slots,) int64 staging index
    asm_index: torch.Tensor  # (N,) int64

    @classmethod
    def build(cls, plan: SpmmPlan, device: torch.device) -> "DevicePlan":
        def t(a, dtype=torch.int32):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

        offsets, off = [], 0
        for b in plan.buckets:
            offsets.append(off)
            off += b.num_rows
        hd = plan.hd
        return cls(
            plan=plan,
            cols=tuple(t(b.cols) for b in plan.buckets),
            offsets=tuple(offsets),
            hd_cols=None if hd is None else t(hd.cols),
            hd_meta=None if hd is None else t(hd.chunk_meta),
            hd_row_chunks=None if hd is None else t(hd.row_chunks()),
            hd_offset=off,
            cat_eids=t(plan_cat_eids(plan), torch.int64),
            asm_index=t(plan.asm_index, torch.int64),
        )


# ---------------------------------------------------------------------------
# Forward-invariant weight staging: ONE gather of the concatenated edge-id
# stream puts the (E, G) group weights into every bucket's ELL layout and
# the HD chunk layout; layers 2..L touch zero edge-weight bytes.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StagedWeights:
    """Edge-weight streams pre-gathered into kernel layout (aligned with
    ``plan.buckets`` order; ``hd`` in HD-chunk layout)."""

    buckets: tuple                      # per-bucket (R_pad * deg, G)
    hd: Optional[torch.Tensor]          # (n_chunks * e_t, G) or None
    groups: int


def stage_group_weights(plan: SpmmPlan, wg: torch.Tensor, *, dtype=None) -> StagedWeights:
    """Gather the (E, G) group-weight matrix into every bucket's ELL layout
    and the HD chunk layout in ONE ``index_select`` (``dtype`` casts the
    staged streams, e.g. bf16 — kernels accumulate in f32 regardless)."""
    PROBE["weight_gathers"] += 1
    dp = plan.on(wg.device)
    g = wg.shape[1]
    wg_p = torch.cat([wg.float(), wg.new_zeros((1, g), dtype=torch.float32)])  # row E = 0
    cat = wg_p.index_select(0, dp.cat_eids)
    if dtype is not None:
        cat = cat.to(dtype)
    PROBE["stream_bytes"] += int(dp.cat_eids.numel()) * g * cat.element_size()
    chunks, off = [], 0
    for b in plan.buckets:
        chunks.append(cat[off : off + b.eids.size])
        off += b.eids.size
    hd = None
    if plan.hd is not None:
        hd = cat[off : off + plan.hd.eids.size]
    return StagedWeights(buckets=tuple(chunks), hd=hd, groups=g)


def pad_features(x: torch.Tensor) -> torch.Tensor:
    """Feature staging for the walks: one zero row appended (the gather pad
    target, index N).  The feature axis stays whole — no lane padding."""
    return torch.cat([x, x.new_zeros((1, x.shape[1]))])


# ---------------------------------------------------------------------------
# K1: grouped LD kernel
# ---------------------------------------------------------------------------

def check_stream(name: str, x_p: torch.Tensor, cols: torch.Tensor,
                 wg: Optional[torch.Tensor], slots: int) -> None:
    """Reject kernel inputs of the wrong device, dtype, shape or layout
    (``wg`` None: a stream without weights)."""
    if x_p.dim() != 2 or not x_p.is_contiguous():
        raise ValueError(f"{name}: x_p must be a contiguous (N + 1, F) tensor")
    if x_p.dtype not in (torch.float32, torch.bfloat16) or (
            wg is not None and wg.dtype != x_p.dtype):
        raise ValueError(f"{name}: x_p and wg must share dtype float32 or bfloat16, "
                         f"got {x_p.dtype} and {None if wg is None else wg.dtype}")
    if cols.dtype != torch.int32 or cols.shape != (slots,) or not cols.is_contiguous():
        raise ValueError(f"{name}: cols must be contiguous int32 of shape ({slots},)")
    if wg is not None:
        if wg.dim() != 2 or wg.shape[0] != slots or not wg.is_contiguous():
            raise ValueError(f"{name}: wg must be contiguous of shape ({slots}, G)")
        if not 1 <= wg.shape[1] <= 4:
            raise ValueError(f"{name}: the kernels take 1 to 4 groups, got {wg.shape[1]}")
    for t in (cols, wg):
        if t is not None and t.device != x_p.device:
            raise ValueError(f"{name}: every input must lie on {x_p.device}, got {t.device}")


def check_weight(name: str, x_p: torch.Tensor, cols: torch.Tensor,
                 w: Optional[torch.Tensor], slots: int) -> None:
    """:func:`check_stream` for an ungrouped stream: ``w`` is None or a
    contiguous ``(slots,)`` weight per slot."""
    if w is not None and w.dim() != 1:
        raise ValueError(f"{name}: w must be a ({slots},) weight stream, got {tuple(w.shape)}")
    check_stream(name, x_p, cols, None if w is None else w[:, None], slots)


def on_cuda(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor (the wrapper launches its kernel), False for a
    CPU tensor (it runs the plain version); raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return True


def stream(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: Optional[torch.Tensor]):
    """A tensor's device address for the C entry points (None: null)."""
    return None if t is None else t.data_ptr()


#: shared memory a block may use (H100: 227 KB)
MAX_SMEM = 227 * 1024
#: the row widths (features) the staged bodies of K3, K4, K5 and K7 are built for
STAGED_FEATS = (4, 8, 16, 32)
#: wider rows run as slices of the widest
SLICE = STAGED_FEATS[-1]


def staged_slices(feat: int) -> tuple[int, tuple]:
    """How the staged bodies cover rows of ``feat`` features: the width x is
    zero-padded to (the next of :data:`STAGED_FEATS`, or else the next
    multiple of :data:`SLICE`), and one launch per slice ``(first column,
    staged width, columns stored)``.  Zero columns add zero terms to every
    sum, so each slice's stored columns are the unpadded result's."""
    if feat < 1:
        raise ValueError(f"a row of {feat} features")
    if feat <= SLICE:
        width = next(f for f in STAGED_FEATS if f >= feat)
        return width, ((0, width, feat),)
    width = -(-feat // SLICE) * SLICE
    return width, tuple((c, SLICE, min(SLICE, feat - c)) for c in range(0, width, SLICE))


def pad_columns(t: torch.Tensor, width: int, dim: int = -1) -> torch.Tensor:
    """``t`` with zero columns appended along ``dim`` up to ``width``; ``t``
    itself (nothing copied) when it has that width already."""
    extra = width - t.shape[dim]
    if extra == 0:
        return t
    shape = list(t.shape)
    shape[dim] = extra
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def stage_width(x_p: torch.Tensor, w_stack: Optional[torch.Tensor] = None) -> tuple:
    """The staged bodies' width handling, in plain PyTorch: ``(xs, slices,
    ws)`` with ``xs`` x_p zero-padded to its staged width, ``slices`` the
    launches of :func:`staged_slices`, and, for a fused body, ``ws`` its
    (G, F, H) weight stack zero-padded to match: rows to xs's width, columns
    to a multiple of :data:`SLICE` (the body's wgmma chunks).  Nothing is
    copied where no padding is needed (F = H = 32 and F = 4 at the model's
    width).  Each slice of a wider row goes to its kernel as a contiguous
    copy (:func:`staged_slice`: x itself for one slice), so the kernels
    read rows of their staged width alone; they store every column of a
    slice (:func:`staged_out`).  The sum bodies' slices lie side
    by side, the fused bodies' add up."""
    width, slices = staged_slices(x_p.shape[1])
    xs = pad_columns(x_p, width)
    if w_stack is None:
        return xs, slices, None
    hp = -(-w_stack.shape[2] // SLICE) * SLICE
    return xs, slices, pad_columns(pad_columns(w_stack, hp), width, dim=1)


def staged_out(out: torch.Tensor, c0: int, width: int, valid: int, align: int) -> tuple:
    """Where a staged launch stores its ``width`` columns, ``out``'s from
    ``c0`` on: ``(dst, scratch)``, with ``dst`` those columns themselves
    when all ``width`` are real (``valid == width``) and the kernel's
    ``align``-byte vector stores reach every row, else an f32 scratch of
    the slice's shape, whose ``valid`` columns the caller then puts into
    ``out`` (an extra pass, at widths that need padding)."""
    if valid == width and (out.data_ptr() + 4 * c0) % align == 0 and all(
            s * 4 % align == 0 for s in out.stride()[:-1]):
        return (out if width == out.shape[-1] else out[..., c0:c0 + width]), False
    return torch.empty(out.shape[:-1] + (width,), dtype=torch.float32, device=out.device), True


def staged_slice(xs: torch.Tensor, c0: int, width: int) -> torch.Tensor:
    """The x a slice's launch reads: ``xs`` itself when one slice covers the
    row, else that slice's columns as a contiguous copy (held by the caller
    until the launch is queued)."""
    return xs if width == xs.shape[1] else xs[:, c0:c0 + width].contiguous()


def check_staged(name: str, x_p: torch.Tensor, cols: torch.Tensor, w: Optional[torch.Tensor],
                 deg: int, smem: int = 0) -> None:
    """Reject, before a launch of a staged body (K3, K4, K5, K7; ``x_p``
    already padded to its staged width), what no body takes: a degree that
    is not a power of two, inputs off 16-byte boundaries (the gather copies
    16 bytes at a time), or a block over the shared memory one may use
    (``smem``: K3's and K7's grows with W's columns, which run in blocks
    that fit; < 0: no body for this shape)."""
    if deg & (deg - 1):
        raise ValueError(f"{name}: degree {deg} is not a power of two")
    for label, t in (("x_p", x_p), ("cols", cols), ("w", w)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must start on a 16-byte boundary")
    if not 0 <= smem <= MAX_SMEM:
        raise ValueError(f"{name}: a block would need {smem} B of shared memory, "
                         f"over the {MAX_SMEM} B it may use")


def check_deg(name: str, slots: int, deg: int) -> int:
    """The row count of an ELL slab of ``slots`` slots of degree ``deg``."""
    if deg < 1 or slots % deg:
        raise ValueError(f"{name}: {slots} slots do not split into rows of {deg}")
    return slots // deg


def check_out(name: str, out: torch.Tensor, shape: tuple, device) -> None:
    if (out.dtype != torch.float32 or tuple(out.shape) != shape or out.device != device
            or out.stride(-1) != 1 or out.stride(-2) != shape[-1]):
        raise ValueError(f"{name}: out must be float32 {shape} on {device} with "
                         f"contiguous rows, got {out.dtype} {tuple(out.shape)} "
                         f"strides {out.stride()} on {out.device}")


def grouped_rowsum(msgs: torch.Tensor, wg: torch.Tensor, deg: int) -> torch.Tensor:
    """Weighted ELL row sums of gathered messages, in f32:
    msgs (R * deg, F), wg (R * deg, G) -> (G, R, F)."""
    m, w = msgs.float(), wg.float()
    prod = w.t()[:, :, None] * m[None, :, :]                        # (G, R*d, F)
    return prod.reshape(w.shape[1], -1, deg, m.shape[1]).sum(dim=2)


def ld_grouped_plain(x_p: torch.Tensor, cols: torch.Tensor, wg: torch.Tensor,
                     deg: int) -> torch.Tensor:
    """Plain PyTorch version of K1: gather, weight, reshape-sum.
    x_p (N + 1, F), cols (R * deg,), wg (R * deg, G) -> (G, R, F) f32."""
    return grouped_rowsum(x_p.index_select(0, cols.long()), wg, deg)


def _grouped_ld_io(name, x_p, cols, wg, deg, out):
    """Check a grouped LD launch's inputs; (G, R, F, out), allocating out."""
    rows = check_deg(name, cols.shape[0], deg)
    check_stream(name, x_p, cols, wg, cols.shape[0])
    g, feat = wg.shape[1], x_p.shape[1]
    if out is None:
        out = torch.empty((g, rows, feat), dtype=torch.float32, device=x_p.device)
    check_out(name, out, (g, rows, feat), x_p.device)
    return g, rows, feat, out


def ld_grouped_apply(x_p: torch.Tensor, cols: torch.Tensor, wg: torch.Tensor, deg: int,
                     out: Optional[torch.Tensor] = None, *, mxu: bool = False) -> torch.Tensor:
    """K1: grouped LD row sums of one ELL bucket, the gather fused in.

    x_p (N + 1, F) f32/bf16, cols (R * deg,) int32, wg (R * deg, G) of
    x_p's dtype -> ``out`` (G, R, F) f32, which may be a row slice of a
    larger buffer (rows contiguous, any group stride).  CPU tensors run
    :func:`ld_grouped_plain`; CUDA tensors launch the kernel (one group:
    K5's staged VPU body with K1's rounding, a power-of-two degree).
    ``mxu`` sends buckets of degree > 1 to K4 (:func:`ld_grouped_mxu_apply`),
    as the reference's ``groot_mxu`` backend does.
    """
    if mxu and deg > 1:
        return ld_grouped_mxu_apply(x_p, cols, wg, deg, out)
    g, rows, feat, out = _grouped_ld_io("ld_grouped_apply", x_p, cols, wg, deg, out)
    if not on_cuda("ld_grouped_apply", x_p):
        out.copy_(ld_grouped_plain(x_p, cols, wg, deg))
        return out
    if g == 1:  # K5's VPU body with K1's rounding (widen, then fmaf)
        ld_grouped_apply.launches += _staged_ld("ld_grouped_apply", x_p, cols, wg, deg, out[0],
                                                mxu=False, round_product=False)
        return out
    rc = build.library("groot_spmm").groot_ld_grouped(
        x_p.data_ptr(), cols.data_ptr(), wg.data_ptr(), out.data_ptr(),
        rows, deg, g, feat, out.stride(0), int(x_p.dtype == torch.bfloat16), stream(x_p),
    )
    build.check(rc, "ld_grouped_apply")
    PROBE["pallas_calls"] += 1
    ld_grouped_apply.launches += 1
    return out


ld_grouped_apply.launches = 0


# ---------------------------------------------------------------------------
# K4: grouped MXU LD kernel (tensor cores)
# ---------------------------------------------------------------------------

def ld_grouped_mxu_plain(x_p: torch.Tensor, cols: torch.Tensor, wg: torch.Tensor,
                         deg: int) -> torch.Tensor:
    """Plain PyTorch version of K4: gather, the products ``msgs * wg[:, g]``
    taken in the stream dtype (bf16 streams round them to bf16, as the
    reference's MXU kernel multiplies before its f32 matmul), then an f32
    reshape-sum.  -> (G, R, F) f32.  Unlike K1, which widens to f32 before
    it multiplies, this differs from :func:`ld_grouped_plain` in bf16."""
    msgs = x_p.index_select(0, cols.long())
    prod = (wg.t()[:, :, None] * msgs[None, :, :]).float()          # (G, R*d, F)
    return prod.reshape(wg.shape[1], -1, deg, msgs.shape[1]).sum(dim=2)


def ld_grouped_mxu_apply(x_p: torch.Tensor, cols: torch.Tensor, wg: torch.Tensor, deg: int,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4: K1's grouped LD row sums as one-hot block-diagonal matrix
    products on the tensor cores.  Same shapes and layout as
    :func:`ld_grouped_apply`.  CPU tensors run :func:`ld_grouped_mxu_plain`;
    CUDA tensors launch the kernel, which takes power-of-two degrees, once
    per slice of :func:`staged_slices` (x zero-padded to its staged width:
    nothing copied at 4, 8, 16, 32 or a multiple of 32 features)."""
    g, rows, feat, out = _grouped_ld_io("ld_grouped_mxu_apply", x_p, cols, wg, deg, out)
    if not on_cuda("ld_grouped_mxu_apply", x_p):
        out.copy_(ld_grouped_mxu_plain(x_p, cols, wg, deg))
        return out
    xs, slices, _ = stage_width(x_p)
    check_staged("ld_grouped_mxu_apply", xs, cols, wg, deg)
    lib = build.library("groot_spmm")
    for c0, sw, valid in slices:
        xc = staged_slice(xs, c0, sw)
        dst, scratch = staged_out(out, c0, sw, valid, 8)
        rc = lib.groot_ld_grouped_mxu(
            xc.data_ptr(), cols.data_ptr(), wg.data_ptr(), dst.data_ptr(), rows, deg, g, sw,
            dst.stride(0), dst.stride(1), int(xs.dtype == torch.bfloat16), stream(xs),
        )
        build.check(rc, "ld_grouped_mxu_apply")
        PROBE["pallas_calls"] += 1
        ld_grouped_mxu_apply.launches += 1
        if scratch:
            out[..., c0:c0 + valid].copy_(dst[..., :valid])
    return out


ld_grouped_mxu_apply.launches = 0


# ---------------------------------------------------------------------------
# K2: grouped HD kernel
# ---------------------------------------------------------------------------

def check_hd(name: str, x_p: torch.Tensor, cols: torch.Tensor, chunk_meta: torch.Tensor,
             row_chunks: torch.Tensor, e_t: int) -> None:
    """Reject an HD launch whose chunk tables do not fit its slots."""
    if cols.shape[0] != chunk_meta.shape[0] * e_t:
        raise ValueError(f"{name}: {cols.shape[0]} slots != {chunk_meta.shape[0]} chunks x {e_t}")
    for label, t in (("chunk_meta", chunk_meta), ("row_chunks", row_chunks)):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != 2 or not t.is_contiguous() \
                or t.device != x_p.device:
            raise ValueError(f"{name}: {label} must be contiguous int32 (., 2) on {x_p.device}")


def hd_grouped_plain(x_p: torch.Tensor, cols: torch.Tensor, wg: torch.Tensor,
                     chunk_meta: torch.Tensor, n_hd: int, e_t: int) -> torch.Tensor:
    """Plain PyTorch version of K2: per-chunk weighted sums, then
    ``index_add_`` of each chunk into its row (``chunk_meta[:, 0]``).
    -> (G, n_hd, F) f32."""
    g, feat = wg.shape[1], x_p.shape[1]
    msgs = x_p.index_select(0, cols.long()).float().reshape(-1, e_t, feat)
    w = wg.float().reshape(-1, e_t, g)
    part = torch.einsum("ceg,cef->gcf", w, msgs)                       # (G, C, F)
    out = torch.zeros((g, n_hd, feat), dtype=torch.float32, device=x_p.device)
    return out.index_add_(1, chunk_meta[:, 0].long(), part)


def _staged_hd(name: str, x_p: torch.Tensor, cols: torch.Tensor, w: Optional[torch.Tensor],
               row_chunks: torch.Tensor, n_chunks: int, e_t: int, out: torch.Tensor, *,
               round_product: bool) -> int:
    """Launch the HD body (K6 when ``round_product``, else K2) once per slice
    of :func:`staged_slices` into ``out`` ((G, n_hd, F) or (n_hd, F)),
    reading x_p in place: the kernel takes its row stride and a slice's
    first column, copies the real columns in the widest pieces (16, 8 or 4
    bytes) its rows are aligned to and zero-fills the rest of the staged
    row.  Only bf16 rows of an odd width, which no 4-byte copy can start on,
    are zero-padded first.  The chunk sums go through an f32 scratch of
    ``n_chunks * G * width`` floats.  Returns the number of launches."""
    if e_t % 8:
        raise ValueError(f"{name}: chunks of {e_t} slots; the kernel takes a multiple of 8")
    if cols.data_ptr() % 16 or (w is not None and w.data_ptr() % 16):
        label = "cols" if cols.data_ptr() % 16 else "w"
        raise ValueError(f"{name}: {label} must start on a 16-byte boundary")
    feat, es = x_p.shape[1], x_p.element_size()
    width, slices = staged_slices(feat)
    if (x_p.data_ptr() | feat * es) % 4:
        x_p = pad_columns(x_p, width)
    base, row_bytes = x_p.data_ptr(), x_p.shape[1] * es
    groups = 1 if w is None or w.dim() == 1 else w.shape[1]
    gstride, rstride = (out.stride(0), out.stride(1)) if out.dim() == 3 else (0, out.stride(0))
    part = torch.empty(n_chunks * groups * slices[0][1], dtype=torch.float32, device=x_p.device)
    lib, st, bf16 = build.library("groot_spmm"), stream(x_p), int(x_p.dtype == torch.bfloat16)
    for c0, sw, valid in slices:
        aligned, piece = (base + c0 * es) | row_bytes, min(16, sw * es)
        while aligned % piece:
            piece //= 2
        rc = lib.groot_hd(
            base + c0 * es, x_p.shape[1], cols.data_ptr(), ptr(w), row_chunks.data_ptr(),
            part.data_ptr(), out.data_ptr() + 4 * c0, n_chunks, row_chunks.shape[0], e_t, groups,
            sw, valid, piece.bit_length() - 1, gstride, rstride, int(round_product), bf16, st,
        )
        build.check(rc, name)
        PROBE["pallas_calls"] += 1
    return len(slices)


def hd_grouped_apply(x_p: torch.Tensor, cols: torch.Tensor, wg: torch.Tensor,
                     chunk_meta: torch.Tensor, row_chunks: torch.Tensor, e_t: int,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2: grouped sums of the HD rows: a sum per chunk, then each row's
    chunk sums added in order.

    x_p (N + 1, F), cols (C * e_t,) int32, wg (C * e_t, G), chunk_meta
    (C, 2) int32, row_chunks (n_hd, 2) int32 ``[first chunk, count]`` ->
    ``out`` (G, n_hd, F) f32 (rows contiguous, any group stride).  CPU
    tensors run :func:`hd_grouped_plain`; CUDA tensors launch the kernel
    (e_t a multiple of 8), once per 32-column slice of a wider row.
    """
    check_hd("hd_grouped_apply", x_p, cols, chunk_meta, row_chunks, e_t)
    check_stream("hd_grouped_apply", x_p, cols, wg, cols.shape[0])
    n_hd = row_chunks.shape[0]
    g, feat = wg.shape[1], x_p.shape[1]
    if out is None:
        out = torch.empty((g, n_hd, feat), dtype=torch.float32, device=x_p.device)
    check_out("hd_grouped_apply", out, (g, n_hd, feat), x_p.device)
    if not on_cuda("hd_grouped_apply", x_p):
        out.copy_(hd_grouped_plain(x_p, cols, wg, chunk_meta, n_hd, e_t))
        return out
    hd_grouped_apply.launches += _staged_hd("hd_grouped_apply", x_p, cols, wg, row_chunks,
                                            chunk_meta.shape[0], e_t, out, round_product=False)
    return out


hd_grouped_apply.launches = 0


# ---------------------------------------------------------------------------
# K5: ungrouped LD kernel (VPU and MXU bodies)
# ---------------------------------------------------------------------------

def weighted_msgs(x_p: torch.Tensor, cols: torch.Tensor,
                  w: Optional[torch.Tensor]) -> torch.Tensor:
    """The reference's gathered messages ``x_p[cols] * w[:, None]``, the
    product taken in the stream dtype."""
    msgs = x_p.index_select(0, cols.long())
    return msgs if w is None else msgs * w[:, None]


def ordered_rowsum(terms: torch.Tensor, deg: int) -> torch.Tensor:
    """ELL row sums of (R * deg, F) f32 terms -> (R, F), each row's slots
    added one after another in ascending order, as K5's VPU body and K7 add
    them (another order moves a sum of cancelling terms by more than the
    card tests' tolerance of its result)."""
    t = terms.reshape(-1, deg, terms.shape[1])
    out = t[:, 0].clone()
    for k in range(1, deg):
        out += t[:, k]
    return out


def ld_bucket_plain(x_p: torch.Tensor, cols: torch.Tensor, deg: int,
                    w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K5 (both bodies): weighted messages, then
    f32 row sums in slot order (:func:`ordered_rowsum`).  x_p (N + 1, F),
    cols (R * deg,), w (R * deg,) or None -> (R, F) f32."""
    return ordered_rowsum(weighted_msgs(x_p, cols, w).float(), deg)


def _staged_ld(name: str, x_p: torch.Tensor, cols: torch.Tensor, w: Optional[torch.Tensor],
               deg: int, out: torch.Tensor, *, mxu: bool, round_product: bool) -> int:
    """Launch K5's staged VPU body, or its MXU body when ``mxu``, over one
    bucket, once per slice of :func:`staged_slices`; ``round_product``: the
    product x * w rounded to the stream dtype (K5), else widened and fused
    (K1 at one group).  Returns the number of launches."""
    xs, slices, _ = stage_width(x_p)
    check_staged(name, xs, cols, w, deg)
    lib, rows = build.library("groot_spmm"), cols.shape[0] // deg
    for c0, sw, valid in slices:
        xc = staged_slice(xs, c0, sw)
        # the VPU body stores 16 bytes at a time, the MXU body 8
        dst, scratch = staged_out(out, c0, sw, valid, 8 if mxu else 16)
        rc = lib.groot_ld_bucket(
            xc.data_ptr(), cols.data_ptr(), ptr(w), dst.data_ptr(), rows, deg, sw, dst.stride(0),
            int(mxu), int(round_product), int(xs.dtype == torch.bfloat16), stream(xs),
        )
        build.check(rc, name)
        PROBE["pallas_calls"] += 1
        if scratch:
            out[:, c0:c0 + valid].copy_(dst[:, :valid])
    return len(slices)


def ld_bucket_apply(x_p: torch.Tensor, cols: torch.Tensor, deg: int,
                    w: Optional[torch.Tensor] = None, *, mxu: bool = False,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5: ungrouped LD row sums of one ELL bucket, the gather fused in.

    x_p (N + 1, F) f32/bf16, cols (R * deg,) int32, w (R * deg,) of x_p's
    dtype or None (no weight bytes read: the plain ``A @ x``) -> ``out``
    (R, F) f32 (contiguous rows; may be a row slice of a larger buffer).
    ``mxu`` and deg > 1 run the tensor-core body (K4's staged body at one
    group), else the VPU body (staged rows summed on the f32 units).  CPU
    tensors run :func:`ld_bucket_plain`; CUDA tensors launch the kernel,
    which takes power-of-two degrees, once per slice of
    :func:`staged_slices`.  ``ld_bucket_apply.body_launches`` counts the
    launches by body.
    """
    rows = check_deg("ld_bucket_apply", cols.shape[0], deg)
    check_weight("ld_bucket_apply", x_p, cols, w, cols.shape[0])
    feat = x_p.shape[1]
    if out is None:
        out = torch.empty((rows, feat), dtype=torch.float32, device=x_p.device)
    check_out("ld_bucket_apply", out, (rows, feat), x_p.device)
    if not on_cuda("ld_bucket_apply", x_p):
        out.copy_(ld_bucket_plain(x_p, cols, deg, w))
        return out
    body = "mxu" if mxu and deg > 1 else "vpu"
    n = _staged_ld("ld_bucket_apply", x_p, cols, w, deg, out, mxu=body == "mxu",
                   round_product=True)
    ld_bucket_apply.launches += n
    ld_bucket_apply.body_launches[body] += n
    return out


ld_bucket_apply.body_launches = {"vpu": 0, "mxu": 0}
ld_bucket_apply.launches = 0


# ---------------------------------------------------------------------------
# K6: ungrouped HD kernel
# ---------------------------------------------------------------------------

def hd_plain(x_p: torch.Tensor, cols: torch.Tensor, chunk_meta: torch.Tensor, e_t: int,
             w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K6: weighted messages, per-chunk f32 sums,
    accumulated per row (``chunk_meta[:, 0]``).  -> (n_hd, F) f32."""
    msgs = weighted_msgs(x_p, cols, w).float().reshape(-1, e_t, x_p.shape[1])
    return kref.hd_chunk_reduce_ref(msgs, chunk_meta[:, 0].long())


def hd_apply(x_p: torch.Tensor, cols: torch.Tensor, chunk_meta: torch.Tensor,
             row_chunks: torch.Tensor, e_t: int, w: Optional[torch.Tensor] = None,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6: ungrouped sums of the HD rows, K2's body at one group with the
    product rounded to the stream dtype.

    x_p (N + 1, F), cols (C * e_t,) int32, chunk_meta (C, 2) int32,
    row_chunks (n_hd, 2) int32 ``[first chunk, count]``, w (C * e_t,) or
    None -> ``out`` (n_hd, F) f32 (contiguous rows).  CPU tensors run
    :func:`hd_plain`; CUDA tensors launch the kernel (e_t a multiple of 8),
    once per 32-column slice of a wider row.
    """
    check_hd("hd_apply", x_p, cols, chunk_meta, row_chunks, e_t)
    check_weight("hd_apply", x_p, cols, w, cols.shape[0])
    n_hd, feat = row_chunks.shape[0], x_p.shape[1]
    if out is None:
        out = torch.empty((n_hd, feat), dtype=torch.float32, device=x_p.device)
    check_out("hd_apply", out, (n_hd, feat), x_p.device)
    if not on_cuda("hd_apply", x_p):
        out.copy_(hd_plain(x_p, cols, chunk_meta, e_t, w))
        return out
    hd_apply.launches += _staged_hd("hd_apply", x_p, cols, w, row_chunks, chunk_meta.shape[0],
                                    e_t, out, round_product=True)
    return out


hd_apply.launches = 0


# ---------------------------------------------------------------------------
# The walks: per-bucket kernels -> permutation assembly
# ---------------------------------------------------------------------------

def assemble_rows(plan: SpmmPlan, cat: torch.Tensor) -> torch.Tensor:
    """Scatter-free output assembly: ``cat`` is the (asm_rows, F)
    concatenation of every bucket's rows (then HD, then one zero row) that
    the kernels wrote in place; one gather gives (N, F)."""
    return cat.index_select(0, plan.on(cat.device).asm_index)


def assemble_rows_grouped(plan: SpmmPlan, cat: torch.Tensor) -> torch.Tensor:
    """Grouped variant: ``cat`` is (G, asm_rows, F); one gather along
    axis 1 gives (G, N, F)."""
    return cat.index_select(1, plan.on(cat.device).asm_index)


def stage_weight(plan: SpmmPlan, w: Optional[torch.Tensor], dtype) -> tuple:
    """An ungrouped (E,) edge weight in every bucket's ELL layout and the HD
    chunk layout, cast to the stream dtype first as the reference does:
    ``(per-bucket (R_pad * deg,) streams, HD (C * e_t,) stream or None)``,
    or all None for no weight."""
    if w is None:
        return (None,) * len(plan.buckets), None
    staged = stage_group_weights(plan, w.to(dtype)[:, None], dtype=dtype)
    hd = None if staged.hd is None else staged.hd.reshape(-1)
    return tuple(b.reshape(-1) for b in staged.buckets), hd


def apply_plan(plan: SpmmPlan, x: torch.Tensor, w: Optional[torch.Tensor] = None, *,
               mxu: bool = False) -> torch.Tensor:
    """``out[r] = sum_{e: dst[e]=r} w[e] * x[src[e]]`` through the
    degree-bucketed kernels K5 (LD buckets; the tensor-core body for d > 1
    when ``mxu``) and K6 (HD rows), assembled by one permutation gather.
    ``x`` (N, F) f32/bf16, ``w`` (E,) or None; returns (N, F) in
    ``x.dtype``.  Matches :func:`repro_torch.kernels.ref.spmm_ref`.
    """
    PROBE["edge_stream_gathers"] += 1
    PROBE["kernel_walks"] += 1
    if w is not None:
        PROBE["weight_gathers"] += 1
        PROBE["stream_bytes"] += plan.num_slots * x.element_size()
    dp = plan.on(x.device)
    x_p = pad_features(x)
    PROBE["stream_bytes"] += plan.num_slots * x_p.shape[1] * x.element_size()
    w_buckets, w_hd = stage_weight(plan, w, x.dtype)
    cat = torch.empty((plan.asm_rows, x.shape[1]), dtype=torch.float32, device=x.device)
    cat[-1].zero_()
    for b, cols, off, wb in zip(plan.buckets, dp.cols, dp.offsets, w_buckets):
        ld_bucket_apply(x_p, cols, b.deg, wb, mxu=mxu, out=cat[off : off + b.num_rows])
    if plan.hd is not None:
        n_hd = plan.hd.rows.shape[0]
        hd_apply(x_p, dp.hd_cols, dp.hd_meta, dp.hd_row_chunks, plan.e_t, w_hd,
                 out=cat[dp.hd_offset : dp.hd_offset + n_hd])
    return assemble_rows(plan, cat).to(x.dtype)


def apply_plan_grouped_staged(plan: SpmmPlan, x_p: torch.Tensor, staged: StagedWeights, *,
                              mxu: bool = False) -> torch.Tensor:
    """Hoisted grouped walk: pre-padded features (see :func:`pad_features`)
    + pre-staged weight streams in, ``(G, N, F)`` f32 out.  ``mxu`` runs
    the LD buckets of degree > 1 through K4."""
    PROBE["edge_stream_gathers"] += 1
    PROBE["kernel_walks"] += 1
    PROBE["stream_bytes"] += plan.num_slots * x_p.shape[1] * x_p.element_size()
    dp = plan.on(x_p.device)
    g, feat = staged.groups, x_p.shape[1]
    cat = torch.empty((g, plan.asm_rows, feat), dtype=torch.float32, device=x_p.device)
    cat[:, -1].zero_()
    for b, cols, off, wge in zip(plan.buckets, dp.cols, dp.offsets, staged.buckets):
        ld_grouped_apply(x_p, cols, wge, b.deg, out=cat[:, off : off + b.num_rows], mxu=mxu)
    if plan.hd is not None:
        n_hd = plan.hd.rows.shape[0]
        hd_grouped_apply(
            x_p, dp.hd_cols, staged.hd, dp.hd_meta, dp.hd_row_chunks, plan.e_t,
            out=cat[:, dp.hd_offset : dp.hd_offset + n_hd],
        )
    return assemble_rows_grouped(plan, cat)


def apply_plan_grouped(plan: SpmmPlan, x: torch.Tensor, wg: torch.Tensor, *,
                       mxu: bool = False) -> torch.Tensor:
    """All-groups SpMM: ``out[g, r] = sum_{e: dst[e]=r} wg[e, g] * x[src[e]]``.

    ``wg`` is ``(E, G)``; returns ``(G, N, F)`` in ``x.dtype``.  Stages the
    weight streams per call; the hoisted forward stages once per forward.
    """
    staged = stage_group_weights(plan, wg)
    out = apply_plan_grouped_staged(plan, pad_features(x.float()), staged, mxu=mxu)
    return out.to(x.dtype)
