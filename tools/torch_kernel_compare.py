"""Time the current hand-written kernels beside an earlier version of their
sources, on one card, in one process.

    mkdir -p build/parent_kernels
    git show <commit>:src/repro_torch/kernels/csrc/gather_scores.cu \
        > build/parent_kernels/gather_scores.cu
    python3 tools/torch_kernel_compare.py --old-src build/parent_kernels

Each of ``gather_scores.cu``, ``score_topk.cu`` and ``score_matrix.cu``
found in ``--old-src`` is built with nvcc (the flags of ``kernels/build.py``)
into a temporary directory, bound with the C interface it had before, and
compared with the current kernel:

  gather_scores  ``gather_scores_f32`` / ``gather_scores_q8`` without the
                 rows-per-warp argument (one block per query); both kernels
                 at B 64 × C 32 (the beam trip) and B 4,096 × C 32 (GLOBAL
                 repair), fp32 at B 1,000 × C 64 (the rerank), q8 at
                 B 1,000 × C 32 (the quantized walk); N = 2^20, d = 128.
                 Every call takes the next id set of a rotation whose rows
                 exceed twice the L2 (``chip_smoke.id_rotation``), so no call
                 finds its rows in L2. Per shape: ``old_ms``/``new_ms``, bare
                 C calls timed by CUDA events around ten back-to-back calls;
                 ``old_graph_ms``/``new_graph_ms``, device time per launch of
                 a CUDA graph of back-to-back launches (the host's launch cost
                 left out); ``wrapper_ms``; ``library_ms`` (``index_select`` +
                 ``einsum``); ``bound_ms`` (bytes). Checks: fp32 scores equal
                 the old kernel's bit for bit on Gaussian data over every id
                 set, and at every width and offset view of
                 ``chip_smoke.gather_tables``; q8 within rtol 1e-4 / atol 1e-3
                 of the plain version and of the old kernel.
  score_topk     ``score_topk_f32`` with its own split rule (16-query blocks,
                 64-row tiles) at B = 1,000, M = 2^20, d = 128, k = 10 (ground
                 truth) and B = 16,384, k = 65 (the bulk build's block);
  score_matrix   ``score_matrix_f32`` (before the self path) at the
                 SELECT-NEIGHBORS shapes of ``chip_smoke.SELECT_SHAPES``.

Each shape is timed in turns (old, new, new, old; medians). Prints the
card's name and power limit, then one JSON line per kernel; exits 1 if a
check fails. Needs one CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int


OLD_ARGTYPES = {
    "gather_scores": {"gather_scores_f32": [_P] * 5 + [_I] * 5 + [_P],
                      "gather_scores_q8": [_P] * 5 + [_I] * 5 + [_P]},
    "score_topk": {"score_topk_f32": [_P] * 7 + [_I] * 7 + [_P]},
    "score_matrix": {"score_matrix_f32": [_P] * 4 + [_I] * 5 + [_P]},
}


def build_old(src_dir: Path, out_dir: Path) -> dict[str, ctypes.CDLL]:
    """Build every known source in ``src_dir`` (in parallel) and bind it."""
    procs = {}
    for name in OLD_ARGTYPES:
        src = src_dir / f"{name}.cu"
        if src.exists():
            so = out_dir / f"{name}.so"
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(src)]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for old {name}.cu:\n{out}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in OLD_ARGTYPES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def old_splits(B: int, M: int, sms: int) -> int:
    """The split rule that went with the old score_topk tiling."""
    qblocks = -(-B // 16)
    want = -(-4 * sms // qblocks)
    return max(1, min(want, max(1, M // (16 * 64))))


def old_topk(lib, x, xsq, q, k):
    B, M, d = q.shape[0], x.shape[0], x.shape[1]
    splits = old_splits(B, M, ops.num_sms(x.device))
    out_s = torch.empty((B, k), dtype=torch.float32, device=x.device)
    out_i = torch.empty((B, k), dtype=torch.int32, device=x.device)
    part_s = torch.empty((splits, B, k), dtype=torch.float32, device=x.device)
    part_i = torch.empty((splits, B, k), dtype=torch.int32, device=x.device)
    rc = lib.score_topk_f32(x.data_ptr(), xsq.data_ptr(), q.data_ptr(), part_s.data_ptr(),
                            part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), M, d, B,
                            k, M, 0, splits, ops._stream())
    ops._check(rc, "old score_topk")
    return out_s, out_i


def new_matrix(x, xsq):
    """The current self path through its C entry point alone, as the old
    kernel is called (no wrapper checks), so the two compare like for like."""
    R, n, d = x.shape
    out = torch.empty((R, n, n), dtype=torch.float32, device=x.device)
    fn = ("score_matrix_self_f32" if n <= ops.SELF_MAX_N else "score_matrix_f32")
    args = ((x.data_ptr(), xsq.data_ptr(), out.data_ptr(), R, n, d, 0) if n <= ops.SELF_MAX_N
            else (x.data_ptr(), xsq.data_ptr(), x.data_ptr(), out.data_ptr(), R, n, n, d, 0))
    ops._check(ops._fn("score_matrix", fn)(*args, ops._stream()), "score_matrix")
    return out


def old_matrix(lib, x, xsq):
    R, n, d = x.shape
    out = torch.empty((R, n, n), dtype=torch.float32, device=x.device)
    rc = lib.score_matrix_f32(x.data_ptr(), xsq.data_ptr(), x.data_ptr(), out.data_ptr(),
                              R, n, n, d, 0, ops._stream())
    ops._check(rc, "old score_matrix")
    return out


def per_call_ms(fn, calls: int = 1, **kw) -> float:
    """Median time of ``calls`` back-to-back calls, per call: with several
    calls the host enqueues while the card runs, so a kernel longer than
    its launch overhead is timed alone."""
    def batch():
        for _ in range(calls):
            fn()
    return chip_smoke.median_ms(batch, **kw) / calls


def in_turns(old_fn, new_fn, timer=per_call_ms, **kw) -> dict:
    """old, new, new, old: the mean of each pair of medians."""
    o1 = timer(old_fn, **kw)
    n1 = timer(new_fn, **kw)
    n2 = timer(new_fn, **kw)
    o2 = timer(old_fn, **kw)
    return {"old_ms": (o1 + o2) / 2, "new_ms": (n1 + n2) / 2,
            "old_ms_each": [o1, o2], "new_ms_each": [n1, n2]}


# ---------------------------------------------------------------------------
# gather_scores / gather_scores_q8
# ---------------------------------------------------------------------------

GATHER_SHAPES = (("gather_scores", 64, 32), ("gather_scores", 4096, 32),
                 ("gather_scores", 1000, 64), ("gather_scores_q8", 64, 32),
                 ("gather_scores_q8", 4096, 32), ("gather_scores_q8", 1000, 32))
def old_gather(lib, name, table, aux, ids, q, metric=0):
    B, C = ids.shape
    out = torch.empty((B, C), dtype=torch.float32, device=table.device)
    fn = lib.gather_scores_q8 if name == "gather_scores_q8" else lib.gather_scores_f32
    rc = fn(table.data_ptr(), aux.data_ptr(), ids.data_ptr(), q.data_ptr(), out.data_ptr(),
            table.shape[0], table.shape[1], B, C, metric, ops._stream())
    ops._check(rc, f"old {name}")
    return out


def new_gather(name, table, aux, ids, q, metric=0):
    """The current kernel through its C entry point alone, at the wrapper's
    (remembered) tile, as the old kernel is called (no wrapper checks)."""
    B, C = ids.shape
    q8 = name == "gather_scores_q8"
    out = torch.empty((B, C), dtype=torch.float32, device=table.device)
    rpw = ops.gather_plan(B * C, q8, table.device.index)
    fn = ops._fn("gather_scores", "gather_scores_q8" if q8 else "gather_scores_f32")
    rc = fn(table.data_ptr(), aux.data_ptr(), ids.data_ptr(), q.data_ptr(), out.data_ptr(),
            table.shape[0], table.shape[1], B, C, metric, rpw, ops._stream())
    ops._check(rc, name)
    return out


def library_gather(name, table, aux, ids, q):
    """One PyTorch expression of the same function (valid ids only)."""
    B, C = ids.shape
    safe = ids.long().flatten()
    rows = table.index_select(0, safe).view(B, C, -1).float()
    a = aux.index_select(0, safe).view(B, C)
    dots = torch.einsum("bcd,bd->bc", rows, q)
    if name == "gather_scores":
        return 2.0 * dots - a
    return a * (2.0 * dots - a * torch.einsum("bcd,bcd->bc", rows, rows))


def compare_gathers(lib, dev, g, failed: list) -> dict:
    from repro_torch.core.quantize import quantize_rows
    N, d = 1 << 20, 128
    x = torch.randn((N, d), generator=g, device=dev)
    tsq = (x * x).sum(1)
    codes, scales = quantize_rows(x)
    sms = ops.num_sms(dev)
    rows = {}
    for name, B, C in GATHER_SHAPES:
        q8 = name == "gather_scores_q8"
        table, aux = (codes, scales) if q8 else (x, tsq)
        rot = chip_smoke.id_rotation(g, N, B, C, d if q8 else 4 * d, dev)
        n = rot.shape[0]
        q = torch.randn((B, d), generator=g, device=dev)

        def old(i):
            return old_gather(lib, name, table, aux, rot[i], q)

        def new(i):
            return new_gather(name, table, aux, rot[i], q)

        row = in_turns(old, new, timer=chip_smoke.median_ms_rotating, n_sets=n, calls=10)
        graph = in_turns(old, new, timer=chip_smoke.graph_ms_rotating, n_sets=n)
        row["old_graph_ms"], row["new_graph_ms"] = graph["old_ms"], graph["new_ms"]
        row["wrapper_ms"] = chip_smoke.median_ms_rotating(
            lambda i: getattr(ops, name)(table, aux, rot[i], q), n, calls=10)
        row["library_ms"] = chip_smoke.median_ms_rotating(
            lambda i: library_gather(name, table, aux, rot[i], q), n)
        row["bound_ms"] = chip_smoke.gather_byte_bound_ms(B, C, d, d if q8 else 4 * d)
        rpw = ops.gather_rows_per_warp(B * C, sms, q8=q8)
        row["rows_per_warp"], row["blocks"] = rpw, ops.gather_blocks(B * C, rpw)
        row["rotation_sets"] = n
        if q8:
            plain = [chip_smoke._close(new(i), ref.gather_scores_q8(table, aux, rot[i], q))
                     for i in range(n)]
            vs_old = [chip_smoke._close(new(i), old(i)) for i in range(n)]
            row["max_abs_err_vs_plain"], row["max_abs_err_vs_old"] = max(plain), max(vs_old)
        else:
            row["bits_equal_old"] = all(torch.equal(new(i), old(i)) for i in range(n))
            if not row["bits_equal_old"]:
                failed.append(f"{name} B={B} C={C}: bits differ from the old kernel")
        rows[f"{name}_B{B}_C{C}"] = row
        del rot
    del x, tsq, codes, scales
    torch.cuda.empty_cache()
    # every width and offset view: fp32 bits equal the old kernel's, q8 close
    widths = {}
    make = (lambda shape: torch.randn(shape, generator=g, device=dev))
    for label, t, (c8, s8) in chip_smoke.gather_tables(torch, make, make((1 << 16, d)), dev):
        n_rows = t.shape[0]
        tq = (t * t).sum(1)
        equal, err = True, 0.0
        for B in (64, 4096):
            ids = chip_smoke.edge_ids(torch, g, n_rows, B, 32, dev)
            q = make((B, t.shape[1]))
            for metric in (0, 1):
                equal &= bool(torch.equal(new_gather("gather_scores", t, tq, ids, q, metric),
                                          old_gather(lib, "gather_scores", t, tq, ids, q, metric)))
                err = max(err, chip_smoke._close(
                    new_gather("gather_scores_q8", c8, s8, ids, q, metric),
                    old_gather(lib, "gather_scores_q8", c8, s8, ids, q, metric)))
        widths[label] = {"fp32_bits_equal_old": equal, "q8_max_abs_err_vs_old": err}
        if not equal:
            failed.append(f"gather_scores {label}: bits differ from the old kernel")
    return {"shapes": rows, "widths": widths}


def compare_topk(lib, dev, g) -> dict:
    N, d = 1 << 20, 128
    x = torch.randn((N, d), generator=g, device=dev)
    xsq = (x * x).sum(1)
    topk = {}
    for B, k, runs in ((1000, 10, 20), (16384, 65, 3)):
        q = torch.randn((B, d), generator=g, device=dev)
        row = in_turns(lambda: old_topk(lib, x, xsq, q, k),
                       lambda: ops.score_topk(x, xsq, q, k), runs=runs, warmup=1)
        os_, oi = old_topk(lib, x, xsq, q, k)
        ns, ni = ops.score_topk(x, xsq, q, k)
        row["ids_equal"] = bool(torch.equal(oi, ni))
        row["scores_equal"] = bool(torch.equal(os_, ns))
        if B * N * 4 <= 8 << 30:
            row["library_ms"] = chip_smoke.median_ms(
                lambda: torch.topk(2.0 * (q @ x.T) - xsq[None, :], k, dim=1),
                runs=runs, warmup=1)
        else:
            row["library_ms"] = None
        row["bound_ms"] = 2.0 * B * N * d / chip_smoke.PEAK_FP32_FLOPS * 1e3
        topk[f"B{B}_k{k}"] = row
        del q
    del x, xsq
    torch.cuda.empty_cache()
    return {"M": N, "d": d, **topk}


def compare_matrix(lib, dev, g) -> dict:
    d = 128
    mat = {}
    for R, n in chip_smoke.SELECT_SHAPES:
        v = torch.randn((R, n, d), generator=g, device=dev)
        vsq = (v * v).sum(-1)
        row = in_turns(lambda: old_matrix(lib, v, vsq), lambda: new_matrix(v, vsq), calls=10)
        row["wrapper_ms"] = per_call_ms(lambda: ops.score_matrix(v, vsq, v), calls=10)
        row["equal"] = bool(torch.equal(old_matrix(lib, v, vsq), ops.score_matrix(v, vsq, v)))
        row["library_ms"] = per_call_ms(
            lambda: torch.baddbmm(-vsq[:, None, :], v, v.transpose(1, 2), alpha=2.0),
            calls=10)
        row["bound_ms"] = max(
            2.0 * R * n * n * d / chip_smoke.PEAK_FP32_FLOPS,
            (R * n * d + R * n + R * n * n) * 4 / chip_smoke.PEAK_BYTES_PER_S) * 1e3
        mat[f"R{R}_n{n}"] = row
    return {"d": d, **mat}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-src", type=Path, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_kernel_compare: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(chip_smoke.nvidia_smi_line(), flush=True)
    build.build_all()
    failed: list = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_old(args.old_src, Path(tmp))
        if not libs:
            print(f"torch_kernel_compare: no known source in {args.old_src}", file=sys.stderr)
            return 2
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        try:
            if "gather_scores" in libs:
                print(json.dumps({"kernel": "gathers",
                                  **compare_gathers(libs["gather_scores"], dev, g, failed)}),
                      flush=True)
            if "score_topk" in libs:
                print(json.dumps({"kernel": "score_topk",
                                  **compare_topk(libs["score_topk"], dev, g)}), flush=True)
            if "score_matrix" in libs:
                print(json.dumps({"kernel": "score_matrix",
                                  **compare_matrix(libs["score_matrix"], dev, g)}), flush=True)
        except chip_smoke.SmokeFailure as e:
            failed.append(str(e))
    for what in failed:
        print(f"torch_kernel_compare: FAILED: {what}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
