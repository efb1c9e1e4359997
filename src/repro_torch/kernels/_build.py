"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled by `nvcc` for Hopper (`sm_90a`) into a
shared library with a plain C interface, and loaded with `ctypes`; no
PyTorch headers are involved, so a build takes seconds.  Libraries go to
`kernels/build/` (listed in `.gitignore`), named by a hash of the source,
the `csrc/*.cuh` headers and the flags, so an edited source is rebuilt
and an unchanged one is reused.  `load_all()` starts one `nvcc` per
stale source, all at once, and waits for them together; it holds a lock,
so threads that first need a library together build and load it once
(`COUNTS` counts the builds and loads of this process).

Every exported function takes device pointers and the CUDA stream as
`void*` and returns `cudaGetLastError()` after its launch; `check` turns
a nonzero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_V = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# exported C functions per source: name -> argtypes (restype is int
# unless RESTYPES says otherwise)
SIGNATURES = {
    "mindist": {
        # lo, hi, breakpoints, card, q_lo, q_hi, q_stride, valid, out,
        # n, w, nseg, batch, seg_len, stream
        "ulisse_mindist_sym": [_V, _V, _V, _I, _V, _V, _I, _V, _V,
                               _L, _I, _I, _I, _F, _V],
        # lo, hi, q_lo, q_hi, q_stride, valid, out, n, w, nseg, batch,
        # seg_len, stream
        "ulisse_mindist_paa": [_V, _V, _V, _V, _I, _V, _V,
                               _L, _I, _I, _I, _F, _V],
    },
    "fused_verify": {
        # data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors,
        # qs, out, num_series, n, batch, rows, qlen, g, znorm, stream
        "ulisse_fused_gather_ed": [_V, _V, _V, _V, _V, _V, _V, _V, _V, _V,
                                   _L, _I, _I, _I, _I, _I, _I, _V],
        # the same arguments and otile (before the stream): the long-row
        # kernel
        "ulisse_fused_gather_ed_long": [_V, _V, _V, _V, _V, _V, _V, _V, _V,
                                        _V, _L, _I, _I, _I, _I, _I, _I, _I,
                                        _V],
        # qlen, g (the long entries: and otile)
        "ulisse_fused_gather_ed_chunk_tile": [_I, _I],
        "ulisse_fused_gather_ed_chunk_long_tile": [_I, _I, _I],
        "ulisse_fused_gather_lb_keogh_tile": [_I, _I],
        # qlen, g, force
        "ulisse_fused_gather_ed_long_otile": [_I, _I, _I],
        # data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors,
        # n_master, lbs2, qs, pool_d2, gkth, stats, part, num_series, n,
        # batch, rows, qlen, g, znorm, n_pad, col0, k, stream
        "ulisse_fused_gather_ed_chunk": [
            _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _L,
            _I, _I, _I, _I, _I, _I, _L, _L, _I, _V],
        "ulisse_fused_gather_ed_chunk_long": [
            _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _L,
            _I, _I, _I, _I, _I, _I, _L, _L, _I, _I, _V],
        # data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors,
        # n_master, lbs2, qs, eps2, ovf, stats, out, num_series, n, batch,
        # rows, qlen, g, znorm, n_pad, col0, n_chunks, stream
        "ulisse_fused_gather_ed_range": [
            _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _L,
            _I, _I, _I, _I, _I, _I, _L, _L, _I, _V],
        "ulisse_fused_gather_ed_range_long": [
            _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _L,
            _I, _I, _I, _I, _I, _I, _L, _L, _I, _I, _V],
        # data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors,
        # dtw_lo, dtw_hi, lb, mu, sd, num_series, n, batch, rows, qlen, g,
        # znorm, stream
        "ulisse_fused_gather_lb_keogh": [_V, _V, _V, _V, _V, _V, _V, _V, _V,
                                         _V, _V, _V, _V, _L, _I, _I, _I, _I,
                                         _I, _I, _V],
        # the same and items, ptile: the long-row kernel
        "ulisse_fused_gather_lb_keogh_long": [
            _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _L, _I, _I,
            _I, _I, _I, _I, _I, _I, _V],
        # data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors,
        # n_master, lbs2, dtw_lo, dtw_hi, cut, gkth, ovf, stats, lb, mu,
        # sd, slist, nsurv, dp_out, cand_sid, cand_off, num_series, n,
        # batch, rows, qlen, g, znorm, n_pad, col0, k, range, n_chunks,
        # stream
        "ulisse_fused_gather_lb_keogh_chunk": [
            _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V,
            _V, _V, _V, _V, _V, _V, _V, _V, _L, _I, _I, _I, _I, _I, _I, _L,
            _L, _I, _I, _I, _V],
        # the same and items, ptile: the long-row kernel
        "ulisse_fused_gather_lb_keogh_chunk_long": [
            _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V,
            _V, _V, _V, _V, _V, _V, _V, _V, _L, _I, _I, _I, _I, _I, _I, _L,
            _L, _I, _I, _I, _I, _I, _V],
        # data, sids, anchors, mu, sd, out, num_series, n, num_rows, qlen,
        # g, stream
        "ulisse_gather_znorm": [_V, _V, _V, _V, _V, _V, _L, _I, _L, _I, _I,
                                _V],
    },
    "dtw_band": {
        # q, candidates, out, num, l, r, stream
        "ulisse_dtw_band": [_V, _V, _V, _L, _I, _I, _V],
        # data, qs, slist, nsurv, cand_sid, cand_off, mu, sd, out,
        # num_series, n, batch, m, l, r, znorm, stream
        "ulisse_dtw_survivors": [_V, _V, _V, _V, _V, _V, _V, _V, _V, _L, _I,
                                 _I, _I, _I, _I, _I, _V],
        # l, r (returns floats, a long long)
        "ulisse_dtw_wide_scratch": [_I, _I],
        # q, candidates, out, scratch, scratch_blocks, num, l, r, pairs,
        # segs, stream
        "ulisse_dtw_band_wide": [_V, _V, _V, _V, _I, _L, _I, _I, _I, _I,
                                 _V],
        # data, qs, slist, nsurv, cand_sid, cand_off, mu, sd, out, scratch,
        # scratch_blocks, num_series, n, batch, m, l, r, znorm, pairs,
        # segs, stream
        "ulisse_dtw_survivors_wide": [_V, _V, _V, _V, _V, _V, _V, _V, _V, _V,
                                      _I, _L, _I, _I, _I, _I, _I, _I, _I, _I,
                                      _V],
    },
    "envelope": {
        # csum, csum2, lo, hi, num_series, n, n_env, lmin, lmax, gamma,
        # seg_len, stream
        "ulisse_envelope_znorm": [_V, _V, _V, _V, _L, _I, _I, _I, _I, _I,
                                  _I, _V],
        # segmean, s1, s2, offsets, lo, hi, m, w, n_len, n, lmin, seg_len,
        # stream
        "ulisse_envelope_znorm_masters": [_V, _V, _V, _V, _V, _V, _L, _I,
                                          _I, _I, _I, _I, _V],
    },
    "batch_ed": {
        # windows, queries, out, num, l, qb, ldo, znorm, stream
        "ulisse_batch_ed": [_V, _V, _V, _L, _I, _I, _I, _I, _V],
    },
    "lb_keogh": {
        # env_lo, env_hi, windows, out, num, l, stream
        "ulisse_lb_keogh": [_V, _V, _V, _V, _L, _I, _V],
    },
    "range_append": {
        # d2, sids, anchors, eps2, buf_d2, buf_sid, buf_off, cnt, ovf,
        # batch, m, n_pad, col0, g, cap, chunk_i, n_chunks, stream
        "ulisse_range_append": [_V, _V, _V, _V, _V, _V, _V, _V, _V, _I, _I,
                                _L, _L, _I, _I, _I, _I, _V],
    },
    "pool_merge": {
        # pool_d2, pool_sid, pool_off, part, tmp, batch, k, nparts, stream
        "ulisse_pool_merge_partials": [_V, _V, _V, _V, _V, _I, _I, _L, _V],
        # pool_d2, pool_sid, pool_off, d2, cand_sid, cand_off, part, tmp,
        # batch, k, m, slice, stream
        "ulisse_pool_merge_dense": [_V, _V, _V, _V, _V, _V, _V, _V, _I, _I,
                                    _I, _I, _V],
    },
}

# the exported functions that return something other than an error code
RESTYPES = {"ulisse_dtw_wide_scratch": _L}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# libraries compiled and libraries loaded by this process
COUNTS = {"builds": 0, "loads": 0}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((str(Path(home) / "bin" / "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the repro_torch CUDA kernels")


def _target(name: str) -> Path:
    # every source includes its headers from csrc/: they key the build too
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{key[:16]}.so"


def build_log(name: str) -> str:
    """The compiler's report (registers, shared memory, spills) of the
    last build of `name`, or '' when it was reused from an earlier run."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load_all() -> Dict[str, ctypes.CDLL]:
    """Build every stale kernel library in parallel, then load them all."""
    with _LOCK:
        pending = {n: _target(n) for n in SIGNATURES
                   if n not in _LIBS and not _target(n).exists()}
        if pending:
            _build_all(pending)
        for name in SIGNATURES:
            if name not in _LIBS:
                lib = ctypes.CDLL(str(_target(name)))
                for fn, argtypes in SIGNATURES[name].items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = RESTYPES.get(fn, ctypes.c_int)
                _LIBS[name] = lib
                COUNTS["loads"] += 1
    return _LIBS


def _build_all(pending: Dict[str, Path]) -> None:
    """One nvcc per (name -> target) of `pending`, all started at once; a
    temporary output per process and thread, renamed into place."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, target in pending.items():
        tmp = target.with_name(
            f"{target.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
            continue
        target.with_suffix(".log").write_text(out)
        os.replace(tmp, target)
        COUNTS["builds"] += 1
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu` (builds on first use)."""
    if name not in _LIBS:
        load_all()
    return _LIBS[name]


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def check_tensors(what: str, device, specs) -> None:
    """Raise unless every (name, tensor, dtype, shape) of `specs` is a
    contiguous tensor of that dtype and shape on `device` — what the
    kernels take through their raw pointers."""
    for name, t, dtype, shape in specs:
        if t.device != device or t.dtype != dtype \
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(
                f"{what}: {name} must be a contiguous {dtype} {shape} on "
                f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
