"""Wrappers around the hand-written CUDA kernels (``csrc/*.cu``).

Each wrapper keeps the contract of its ``repro.kernels.ops`` counterpart —
an id < 0 or ≥ N scores -inf, outputs are cropped to the caller's shape —
and routes by device alone: a CPU tensor goes through the plain version in
``kernels/ref.py``; a CUDA tensor launches the kernel or raises. There is
no fallback from the card to the plain version.

``launches`` counts, per kernel, the wrapper calls that launched it, and
``launches_by_shape`` splits the count by shape: the gathers' by ``(B, C)``,
``score_topk``'s by ``(B, M, k)``, ``score_matrix``'s by ``(R, B, M)``,
``entry_draw``'s by ``(L, capacity, S)``; the CPU path never counts. While
``tracing.set_sink`` has armed it, the gathers also count their valid
lanes, those whose id lies in [0, N): on the card the kernel itself adds
them into an int64 per gather (``read_valid_lanes`` sums them with one
sync), on the CPU route the wrapper counts them in torch.
A gather launches no more kernels armed than unarmed.

A ``meta`` tensor takes a third route, for the planner
(``launch/analysis.py``): no kernel and no plain version run, the outputs
come back with their shapes and dtypes and no data. Every call, on every
route, reports the kernel's own work to ``observer`` while the planner's
counter has set it: FLOPs (``entry_draw``: int32 operations) and the
bytes each input read once and each output written once would move
(``gather_work``, ``topk_work``, ``matrix_work``, ``entry_draw_work``;
``chip_smoke.py`` prices the same work as each kernel's bound).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

METRIC_CODE = {"l2": 0, "ip": 1, "cos": 1}
TOPK_MAX_K = 128
TOPK_WIDE_MAX_K = 70            # csrc/score_topk.cu kWideMaxK
TOPK_ROWS_PER_TILE = 128        # csrc/score_topk.cu RT
TOPK_BLOCKS_PER_SM = 2          # resident blocks (launch bounds, shared memory)
TOPK_MIN_TILES_PER_SPLIT = 8
SELF_MAX_N = 64                 # csrc/score_matrix.cu self path
GATHER_WARPS = 2                # csrc/gather_scores.cu kWarps (a block)
GATHER_MIN_BLOCKS_PER_SM = 8    # csrc/gather_scores.cu kMinBlocksPerSM
GATHER_ROWS_PER_WARP = (1, 2, 4, 8)         # fp32, up to kMaxRowsPerWarp
GATHER_Q8_LANES_PER_ROW = 8                 # csrc/gather_scores.cu kQ8LanesPerRow
GATHER_Q8_ROWS_PER_WARP = (4, 8, 16, 32)    # 4 lane groups × 1..kQ8MaxRowsPerGroup
ENTRY_MAX_STARTS = 16           # csrc/entry_draw.cu kMaxStarts
ENTRY_WARPS = 8                 # csrc/entry_draw.cu kWarps (a block)
ENTRY_MIN_TILE = 512            # csrc/entry_draw.cu kMinTile (slots)
ENTRY_MIN_BLOCKS_PER_SM = 16    # the plan doubles the tile while the grid keeps these
# int32 operations a drawn slot: threefry's 20 rounds of add, rotate and xor
# (60), its 10 key injections, the counter's add, the mantissa's xor and
# shift, the threshold compare
ENTRY_OPS_PER_SLOT = 74

# ``observer(name, device_type, flops, nbytes, shape, dtype)``, set while a
# cost counter traces (launch/analysis.py), else None; ``dtype`` names the
# peak the operations run at ("float32", or "int32" for the entry draw)
observer = None

launches = {"gather_scores": 0, "gather_scores_bf16": 0, "gather_scores_q8": 0,
            "score_topk": 0, "score_matrix": 0, "entry_draw": 0}
launches_by_shape: dict = {name: {} for name in launches}
GATHERS = ("gather_scores", "gather_scores_bf16", "gather_scores_q8")

# the gathers' valid lanes while armed: the CPU route's here, the card's in
# one int64[len(GATHERS)] buffer per card, made when armed (or at the first
# armed launch on another card) and never zeroed but by reset_launches
valid_lanes = {name: 0 for name in GATHERS}
_valid_on_card: dict = {}
_armed = False

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    ("gather_scores", "gather_scores_f32"): [_P, _P, _P, _P, _P, _I, _I, _I,
                                             _I, _I, _I, _P, _P],
    ("gather_scores", "gather_scores_bf16"): [_P, _P, _P, _P, _P, _I, _I, _I,
                                              _I, _I, _I, _P, _P],
    ("gather_scores", "gather_scores_q8"): [_P, _P, _P, _P, _P, _I, _I, _I,
                                            _I, _I, _I, _P, _P],
    ("score_topk", "score_topk_f32"): [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                       _I, _I, _I, _I, _P],
    ("score_matrix", "score_matrix_f32"): [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                           _P],
    ("score_matrix", "score_matrix_bf16"): [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                            _P],
    ("score_matrix", "score_matrix_self_f32"): [_P, _P, _P, _I, _I, _I, _I, _P],
    ("entry_draw", "entry_draw"): [_P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _I, _P],
}
_SCORE_MATRIX_FN = {torch.float32: "score_matrix_f32",
                    torch.bfloat16: "score_matrix_bf16"}
# gather_scores' row types: the wrapper's launch counter and the C entry point
_GATHER_FN = {torch.float32: ("gather_scores", "gather_scores_f32"),
              torch.bfloat16: ("gather_scores_bf16", "gather_scores_bf16")}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    for by_shape in launches_by_shape.values():
        by_shape.clear()
    for name in valid_lanes:
        valid_lanes[name] = 0
    for buf in _valid_on_card.values():
        buf.zero_()


def _count(name: str, shape: tuple) -> None:
    launches[name] += 1
    by_shape = launches_by_shape[name]
    by_shape[shape] = by_shape.get(shape, 0) + 1


def arm_valid_lanes(on: bool) -> None:
    """Count the gathers' valid lanes from now on (``on``) or no longer;
    arming makes the current card's buffer (one fill), so that no armed
    launch on it allocates."""
    global _armed
    _armed = bool(on)
    if _armed and torch.cuda.is_available() and torch.cuda.is_initialized():
        _valid_buffer(torch.cuda.current_device())


def _valid_buffer(index: int) -> torch.Tensor:
    buf = _valid_on_card.get(index)
    if buf is None:
        buf = torch.zeros(len(GATHERS), dtype=torch.int64,
                          device=torch.device("cuda", index))
        _valid_on_card[index] = buf
    return buf


def _valid_ptr(name: str, device: torch.device):
    """The kernel's counter: its int64 in the card's buffer while armed,
    else NULL (None)."""
    if not _armed:
        return None
    return _valid_buffer(device.index).data_ptr() + 8 * GATHERS.index(name)


def read_valid_lanes() -> dict:
    """Valid lanes counted so far, per gather (both routes; one sync per
    card that holds a buffer)."""
    out = dict(valid_lanes)
    for buf in _valid_on_card.values():
        for name, n in zip(GATHERS, buf.tolist()):
            out[name] += n
    return out


_bound: dict = {}


def _fn(lib_name: str, fn_name: str):
    """The bound C entry point (typed once, then reused: a launch on the
    main path must not pay for the binding)."""
    fn = _bound.get((lib_name, fn_name))
    if fn is None:
        fn = getattr(build.library(lib_name), fn_name)
        fn.argtypes = _SIGNATURES[(lib_name, fn_name)]
        fn.restype = ctypes.c_int
        _bound[(lib_name, fn_name)] = fn
    return fn


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _report(name: str, device: torch.device, flops: float, nbytes: float,
            shape: tuple, dtype: str = "float32") -> None:
    if observer is not None:
        observer(name, device.type, float(flops), float(nbytes), shape, dtype)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _gather_args(table, aux, ids, q, table_dtypes, name):
    _require(table.dim() == 2 and table.dtype in table_dtypes,
             f"{name}: table must be 2-D, one of {table_dtypes}")
    _require(aux.dtype == torch.float32 and aux.shape == (table.shape[0],),
             f"{name}: per-row vector must be f32[N]")
    _require(ids.dim() == 2 and q.dim() == 2 and q.shape[0] == ids.shape[0]
             and q.shape[1] == table.shape[1],
             f"{name}: ids [B, C] and q [B, d] must match the table")
    devs = {t.device for t in (table, aux, ids, q)}
    _require(len(devs) == 1, f"{name}: all tensors must be on one device")
    return (table.contiguous(), aux.contiguous(),
            ids.to(torch.int32).contiguous(), q.float().contiguous())


def gather_blocks(rows: int, rows_per_warp: int) -> int:
    """Blocks of ``GATHER_WARPS`` warps that cover ``rows`` (b, c) pairs."""
    return -(-rows // (rows_per_warp * GATHER_WARPS))


def gather_rows_per_warp(rows: int, sms: int, q8: bool = False) -> int:
    """The gather kernels' tile: the most rows a warp that still gives every
    SM a block (all rows then go out in one wave at the beam trip's B = 64,
    C = 32), the fewest where even that does not."""
    options = GATHER_Q8_ROWS_PER_WARP if q8 else GATHER_ROWS_PER_WARP
    for r in reversed(options):
        if gather_blocks(rows, r) >= sms:
            return r
    return options[0]


@functools.lru_cache(maxsize=None)
def gather_plan(rows: int, q8: bool, device_index: int) -> int:
    """``gather_rows_per_warp`` on a card, remembered: the beam loop
    launches a handful of shapes tens of thousands of times."""
    return gather_rows_per_warp(rows, _sm_count(device_index), q8=q8)


def _gather(name, fn_name, table, aux, ids, q, metric):
    B, C = ids.shape
    out = torch.empty((B, C), dtype=torch.float32, device=table.device)
    if B * C == 0 or table.device.type == "meta":
        return out
    rpw = gather_plan(B * C, name == "gather_scores_q8", table.device.index)
    rc = _fn("gather_scores", fn_name)(
        table.data_ptr(), aux.data_ptr(), ids.data_ptr(), q.data_ptr(),
        out.data_ptr(), table.shape[0], table.shape[1], B, C,
        METRIC_CODE[metric], rpw, _stream(), _valid_ptr(name, table.device))
    _check(rc, name)
    _count(name, (B, C))
    return out


def _plain_gather(name, fn, table, aux, ids, q, metric):
    """The CPU route: ``ref``'s gather, its valid lanes counted while armed."""
    if _armed:
        valid_lanes[name] += int(((ids >= 0) & (ids < table.shape[0])).sum())
    return fn(table, aux, ids, q, metric)


def gather_work(B: int, C: int, d: int, row_bytes: int) -> tuple[float, float]:
    """(FLOPs, bytes) of a gather: each row, its id, norm or scale and
    score once, and q once."""
    return 2.0 * B * C * d, float(B * C * (row_bytes + 12) + B * d * 4)


def topk_work(B: int, M: int, d: int, k: int, metric: str) -> tuple[float, float]:
    """(FLOPs, bytes) of ``score_topk``: the rows and queries once (xsq for
    l2 only: csrc/score_topk.cu stages it for l2 alone), k scores and ids
    out."""
    return 2.0 * B * M * d, float((M * d + B * d + (M if metric == "l2" else 0)) * 4
                                  + B * k * 8)


def matrix_work(R: int, B: int, M: int, d: int, elem_bytes: int, q_is_x: bool
                ) -> tuple[float, float]:
    """(FLOPs, bytes) of ``score_matrix``: x, xsq and the [B, M] scores once,
    q too unless q is x."""
    q_bytes = 0 if q_is_x else R * B * d * elem_bytes
    return 2.0 * R * B * M * d, float(R * M * d * elem_bytes + R * M * 4 + q_bytes
                                      + R * B * M * 4)


def _report_gather(name: str, table, ids) -> None:
    (B, C), d = ids.shape, table.shape[1]
    _report(name, table.device, *gather_work(B, C, d, d * table.element_size()), (B, C))


def gather_scores(table, tsq, ids, q, *, metric: str = "l2") -> torch.Tensor:
    """[B, C] fused gather + score of each query against its own candidate
    rows (replaces ``repro.kernels.gather_distance.gather_scores_pallas``).
    The table is f32 or bf16; bf16 rows are widened to f32 exactly and
    scored in the f32 kernel's order, so they give the bits of the f32
    table of their widened values. Launches count as ``gather_scores`` or
    ``gather_scores_bf16`` by row type."""
    table, tsq, ids, q = _gather_args(table, tsq, ids, q, tuple(_GATHER_FN),
                                      "gather_scores")
    name, fn_name = _GATHER_FN[table.dtype]
    _report_gather(name, table, ids)
    if table.device.type == "cpu":
        return _plain_gather(name, ref.gather_scores, table, tsq, ids, q, metric)
    return _gather(name, fn_name, table, tsq, ids, q, metric)


def gather_scores_q8(codes, scales, ids, q, *, metric: str = "l2"
                     ) -> torch.Tensor:
    """[B, C] fused gather + asymmetric score over int8 codes (replaces
    ``repro.kernels.gather_distance.gather_scores_q8_pallas``)."""
    codes, scales, ids, q = _gather_args(codes, scales, ids, q, (torch.int8,),
                                         "gather_scores_q8")
    _report_gather("gather_scores_q8", codes, ids)
    if codes.device.type == "cpu":
        return _plain_gather("gather_scores_q8", ref.gather_scores_q8, codes, scales,
                             ids, q, metric)
    return _gather("gather_scores_q8", "gather_scores_q8", codes, scales, ids,
                   q, metric)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def num_sms(device) -> int:
    dev = torch.device(device)
    return _sm_count(torch.cuda.current_device() if dev.index is None else dev.index)


def topk_query_tile(k: int) -> int:
    """Queries per ``score_topk`` block: 128, or 64 when the lists of a
    larger k would not fit in shared memory beside the candidate buffers."""
    return 128 if k <= TOPK_WIDE_MAX_K else 64


def topk_splits(B: int, M: int, sms: int, k: int) -> int:
    """How many row ranges ``score_topk`` splits M into: one when the query
    tiles alone cover the SMs four times; else at least enough to do so,
    and up to twice that where the blocks then fill their last wave of
    ``TOPK_BLOCKS_PER_SM * sms`` resident blocks better; never less than
    ``TOPK_MIN_TILES_PER_SPLIT`` row tiles per range."""
    qtiles = -(-B // topk_query_tile(k))
    if qtiles >= 4 * sms:
        return 1
    most = max(1, M // (TOPK_MIN_TILES_PER_SPLIT * TOPK_ROWS_PER_TILE))
    want = -(-4 * sms // qtiles)
    if want >= most:
        return most
    slots = TOPK_BLOCKS_PER_SM * sms

    def fill(splits):
        blocks = qtiles * splits
        return blocks / (-(-blocks // slots) * slots)

    return max(range(want, min(2 * want, most) + 1), key=fill)


def score_topk(x, xsq, q, k: int, *, metric: str = "l2",
               n_valid: int | None = None):
    """Fused brute-force top-k: (scores f32[B, k], ids i32[B, k]) over rows
    ``< n_valid`` (default all M), ties to the lowest id, missing entries
    (-inf, -1); the [B, M] matrix is never written (replaces
    ``repro.kernels.distance_matrix.score_topk_pallas``)."""
    _require(x.dim() == 2 and q.dim() == 2 and q.shape[1] == x.shape[1],
             "score_topk: x [M, d] and q [B, d] must share d")
    _require(x.dtype == torch.float32 and xsq.dtype == torch.float32
             and xsq.shape == (x.shape[0],), "score_topk: f32 x and xsq[M]")
    _require(1 <= k <= TOPK_MAX_K, f"score_topk supports 1 <= k <= "
             f"{TOPK_MAX_K}, got {k}")
    _require(len({x.device, xsq.device, q.device}) == 1,
             "score_topk: all tensors must be on one device")
    M = x.shape[0]
    n_valid = M if n_valid is None else max(0, min(int(n_valid), M))
    x, xsq, q = x.contiguous(), xsq.contiguous(), q.float().contiguous()
    B, d = q.shape
    _report("score_topk", x.device, *topk_work(B, M, d, k, metric), (B, M, k))
    if x.device.type == "cpu":
        return ref.score_topk(x, xsq, q, k, metric, n_valid)
    dev = x.device
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0 or dev.type == "meta":
        return out_s, out_i
    splits = topk_splits(B, M, num_sms(dev), k)
    part_s = torch.empty((splits, B, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((splits, B, k), dtype=torch.int32, device=dev)
    rc = _fn("score_topk", "score_topk_f32")(
        x.data_ptr(), xsq.data_ptr(), q.data_ptr(), part_s.data_ptr(),
        part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), M,
        x.shape[1], B, k, n_valid, METRIC_CODE[metric], splits, _stream())
    _check(rc, "score_topk")
    _count("score_topk", (B, M, k))
    return out_s, out_i


def is_self_pair(x: torch.Tensor, q: torch.Tensor) -> bool:
    """Whether ``score_matrix`` takes its self path: q is x (same storage,
    offset, shape and strides), fp32, at most ``SELF_MAX_N`` candidates,
    d a positive multiple of 4, 16-byte aligned."""
    n, d = x.shape[-2], x.shape[-1]
    return (x.dtype == torch.float32 and q.dtype == torch.float32
            and x.data_ptr() == q.data_ptr() and x.shape == q.shape
            and x.stride() == q.stride() and x.is_contiguous()
            and 1 <= n <= SELF_MAX_N and d >= 4 and d % 4 == 0
            and x.data_ptr() % 16 == 0)


def score_matrix(x, xsq, q, *, metric: str = "l2") -> torch.Tensor:
    """f32 ``[..., B, M]`` scores of queries ``q [..., B, d]`` against rows
    ``x [..., M, d]``: ``2<q, x> - xsq`` (l2) or ``<q, x>`` (ip/cos). 2-D
    inputs give one matrix, 3-D inputs one per leading index r. x and q are
    both f32 or both bf16 (widened on load), accumulation is fp32 (replaces
    ``repro.kernels.distance_matrix.score_matrix_pallas``). When q is x
    (SELECT-NEIGHBORS' pair matrix) the kernel's self path stages each
    ``[n, d]`` block once; it gives the same bits as the general path."""
    _require(x.dim() in (2, 3) and q.dim() == x.dim()
             and q.shape[:-2] == x.shape[:-2] and q.shape[-1] == x.shape[-1],
             "score_matrix: x [..., M, d] and q [..., B, d] must match")
    _require(x.dtype == q.dtype and x.dtype in _SCORE_MATRIX_FN,
             "score_matrix: x and q must both be f32 or both bf16")
    _require(xsq.dtype == torch.float32 and xsq.shape == x.shape[:-1],
             "score_matrix: xsq must be f32[..., M]")
    _require(len({x.device, xsq.device, q.device}) == 1,
             "score_matrix: all tensors must be on one device")
    R = x.shape[0] if x.dim() == 3 else 1
    M, d = x.shape[-2], x.shape[-1]
    B = q.shape[-2]
    _report("score_matrix", x.device,
            *matrix_work(R, B, M, d, x.element_size(), q is x), (R, B, M))
    x, xsq, q = x.contiguous(), xsq.contiguous(), q.contiguous()
    if x.device.type == "cpu":
        return ref.score_matrix(x, xsq, q, metric)
    out = torch.empty((*x.shape[:-2], B, M), dtype=torch.float32,
                      device=x.device)
    if R * B * M == 0 or x.device.type == "meta":
        return out
    if is_self_pair(x, q):
        rc = _fn("score_matrix", "score_matrix_self_f32")(
            x.data_ptr(), xsq.data_ptr(), out.data_ptr(), R, M, d,
            METRIC_CODE[metric], _stream())
    else:
        rc = _fn("score_matrix", _SCORE_MATRIX_FN[x.dtype])(
            x.data_ptr(), xsq.data_ptr(), q.data_ptr(), out.data_ptr(), R, B,
            M, d, METRIC_CODE[metric], _stream())
    _check(rc, "score_matrix")
    _count("score_matrix", (R, B, M))
    return out


def entry_plan(L: int, capacity: int, sms: int) -> tuple[int, int]:
    """(lanes a warp, slots a tile) of ``entry_draw``: the power of two that
    covers L, at most 32 (at 32 every thread of a warp is a lane), and the
    largest tile, doubling from ``ENTRY_MIN_TILE``, whose grid of lane
    groups × tiles still gives each SM ``ENTRY_MIN_BLOCKS_PER_SM`` blocks."""
    wl = min(32, 1 << max(0, int(L) - 1).bit_length())
    groups = -(-L // wl)
    tile = ENTRY_MIN_TILE
    while groups * -(-capacity // (2 * tile)) >= ENTRY_MIN_BLOCKS_PER_SM * sms:
        tile *= 2
    return wl, tile


def entry_scratch(L: int, capacity: int, S: int, tile: int) -> int:
    """int64 elements of ``entry_draw``'s scratch: S keys a lane a tile, then
    L int32 lane positions."""
    return L * -(-capacity // tile) * S + -(-L // 2)


def entry_draw_work(L: int, capacity: int, S: int) -> tuple[float, float]:
    """(int32 operations, bytes) of ``entry_draw`` when L lanes draw over
    ``capacity`` present slots: ``ENTRY_OPS_PER_SLOT`` a (lane, slot) pair and
    a fold a lane; the present flags, the active flags and key once, S
    starts a lane out. The wrappers report the shape's (every lane drawing,
    every slot present); ``chip_smoke.py`` prices its cases' drawn lanes and
    present slots."""
    return (float(L) * (capacity + 1) * ENTRY_OPS_PER_SLOT,
            float(capacity + L + 16 + 4 * L * S))


def _as_c_int(word: int) -> int:
    """A uint32 word (taken mod 2^32) as the C int of the same bits."""
    word = int(word) & 0xFFFFFFFF
    return word - (1 << 32) if word >= 1 << 31 else word


@functools.lru_cache(maxsize=None)
def _entry_plan_on(L: int, capacity: int, device_index: int) -> tuple[int, int]:
    return entry_plan(L, capacity, _sm_count(device_index))


def entry_draw(present, key, L: int, num_starts: int, *, offset: int = 0,
               active=None, fold: bool = True) -> torch.Tensor:
    """The beam engine's entry points, i32[L, num_starts]: lane ``i`` takes
    the present slots with the largest uniform draw of ``fold_in(key,
    offset + i)`` (of ``key`` itself when ``fold`` is False), ties to the
    lowest slot, NULL past the present ones; lanes whose ``active`` is False
    get NULL and draw nothing. ``present`` is bool[capacity], ``key`` the
    int64 ``[2]`` key words, on the host (passed as two ints, no copy) or
    on the card (read there). On the card one call is one launch of
    ``csrc/entry_draw.cu`` (two passes): the lane keys are folded on the
    device, nothing is read back, and nothing as wide as L × capacity is
    written (replaces no Pallas kernel: ``repro.core.search`` draws with
    ``jax.random.gumbel`` and ``lax.top_k``)."""
    L, S = int(L), int(num_starts)
    _require(present.dim() == 1 and present.dtype == torch.bool,
             "entry_draw: present must be bool[capacity]")
    _require(key.shape == (2,), "entry_draw: key must hold two words")
    _require(active is None or (active.shape == (L,) and active.dtype == torch.bool),
             "entry_draw: active must be bool[L]")
    dev, cap = present.device, present.shape[0]
    _require(active is None or active.device == dev,
             "entry_draw: present and active must be on one device")
    _report("entry_draw", dev, *entry_draw_work(L, cap, S), (L, cap, S), "int32")
    if dev.type == "cpu":
        return ref.entry_draw(present, key, L, S, offset=offset, active=active,
                              fold=fold)
    _require(1 <= S <= ENTRY_MAX_STARTS,
             f"entry_draw supports 1 <= num_starts <= {ENTRY_MAX_STARTS}, got {S}")
    out = torch.empty((L, S), dtype=torch.int32, device=dev)
    if L == 0 or dev.type == "meta":
        return out
    present = present.contiguous()
    if key.device.type == "cpu":
        words, key = key.tolist(), None
    else:
        words, key = (0, 0), key.to(dev, torch.int64).contiguous()
    if active is not None:
        active = active.contiguous()
    wl, tile = _entry_plan_on(L, cap, dev.index)
    scratch = torch.empty(entry_scratch(L, cap, S, tile), dtype=torch.int64, device=dev)
    rc = _fn("entry_draw", "entry_draw")(
        present.data_ptr(), None if key is None else key.data_ptr(),
        *(_as_c_int(w) for w in words), None if active is None else active.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), cap, L, S, _as_c_int(offset),
        int(bool(fold)), wl, tile, _stream())
    _check(rc, "entry_draw")
    _count("entry_draw", (L, cap, S))
    return out
