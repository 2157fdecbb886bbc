"""Time the current ``score_topk`` and ``score_matrix`` kernels beside an
earlier version of their sources, on one card, in one process.

    git show <commit>:src/repro_torch/kernels/csrc/score_topk.cu > OLD/score_topk.cu
    git show <commit>:src/repro_torch/kernels/csrc/score_matrix.cu > OLD/score_matrix.cu
    python3 tools/torch_kernel_compare.py --old-src OLD

The old sources are built with nvcc (the flags of ``kernels/build.py``)
into a temporary directory and bound with the C interface they had before
the self path: ``score_topk_f32`` with its own split rule (16-query blocks,
64-row tiles) and ``score_matrix_f32``. Each shape is timed in turns (old,
new, new, old; medians of CUDA-event times, per call of ten back-to-back
calls at the select shapes) on the same inputs, each
through its bare C entry point (``wrapper_ms`` adds the current Python
wrapper, which is what the main path pays), beside the one PyTorch call
that computes the same function where there is one:

  score_topk    B = 1,000, M = 2^20, d = 128, k = 10 (ground truth) and
                B = 16,384, k = 65 (the bulk build's block);
  score_matrix  the SELECT-NEIGHBORS shapes of ``chip_smoke.SELECT_SHAPES``
                (q is x, as select calls it).

Prints the card's name and power limit, then one JSON line per kernel.
Needs one CUDA device; imports nothing of JAX.
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
from repro_torch.kernels import build, ops  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int


def build_old(src_dir: Path, out_dir: Path) -> dict[str, ctypes.CDLL]:
    libs = {}
    for name in ("score_topk", "score_matrix"):
        so = out_dir / f"{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(src_dir / f"{name}.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for old {name}.cu:\n{res.stdout}{res.stderr}")
        libs[name] = ctypes.CDLL(str(so))
    libs["score_topk"].score_topk_f32.argtypes = [_P] * 7 + [_I] * 7 + [_P]
    libs["score_matrix"].score_matrix_f32.argtypes = [_P] * 4 + [_I] * 5 + [_P]
    for lib, fn in ((libs["score_topk"], "score_topk_f32"),
                    (libs["score_matrix"], "score_matrix_f32")):
        getattr(lib, fn).restype = ctypes.c_int
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


def in_turns(old_fn, new_fn, **kw) -> dict:
    """old, new, new, old: the mean of each pair of medians."""
    o1 = per_call_ms(old_fn, **kw)
    n1 = per_call_ms(new_fn, **kw)
    n2 = per_call_ms(new_fn, **kw)
    o2 = per_call_ms(old_fn, **kw)
    return {"old_ms": (o1 + o2) / 2, "new_ms": (n1 + n2) / 2,
            "old_ms_each": [o1, o2], "new_ms_each": [n1, n2]}


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
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_old(args.old_src, Path(tmp))
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        N, d = 1 << 20, 128
        x = torch.randn((N, d), generator=g, device=dev)
        xsq = (x * x).sum(1)
        topk = {}
        for B, k, runs in ((1000, 10, 20), (16384, 65, 3)):
            q = torch.randn((B, d), generator=g, device=dev)
            row = in_turns(lambda: old_topk(libs["score_topk"], x, xsq, q, k),
                           lambda: ops.score_topk(x, xsq, q, k), runs=runs, warmup=1)
            os_, oi = old_topk(libs["score_topk"], x, xsq, q, k)
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
        print(json.dumps({"kernel": "score_topk", "M": N, "d": d, **topk}), flush=True)
        del x, xsq
        torch.cuda.empty_cache()
        mat = {}
        for R, n in chip_smoke.SELECT_SHAPES:
            v = torch.randn((R, n, d), generator=g, device=dev)
            vsq = (v * v).sum(-1)
            row = in_turns(lambda: old_matrix(libs["score_matrix"], v, vsq),
                           lambda: new_matrix(v, vsq), calls=10)
            row["wrapper_ms"] = per_call_ms(lambda: ops.score_matrix(v, vsq, v), calls=10)
            row["equal"] = bool(torch.equal(old_matrix(libs["score_matrix"], v, vsq),
                                            ops.score_matrix(v, vsq, v)))
            row["library_ms"] = per_call_ms(
                lambda: torch.baddbmm(-vsq[:, None, :], v, v.transpose(1, 2), alpha=2.0),
                calls=10)
            row["bound_ms"] = max(
                2.0 * R * n * n * d / chip_smoke.PEAK_FP32_FLOPS,
                (R * n * d + R * n + R * n * n) * 4 / chip_smoke.PEAK_BYTES_PER_S) * 1e3
            mat[f"R{R}_n{n}"] = row
        print(json.dumps({"kernel": "score_matrix", "d": d, **mat}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
