"""Build the CUDA sources of ``kernels/csrc`` with nvcc and load them.

Each source is compiled on first use into a shared library with a plain
C interface,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o <lib> <source>

and loaded with ``ctypes``.  Libraries live under
``<checkout>/build/repro_torch_kernels/``, named by a hash of the
source, the shared headers of ``csrc`` (``*.cuh``) and the flags, so an
edited source or header rebuilds and an unchanged one is loaded as it
is.  The source is the only input: nothing is downloaded
and no prebuilt library is shipped.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# the C entry points of each source and their ctypes signatures
_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
SIGNATURES: Dict[str, Dict[str, Tuple]] = {
    "paged_attention.cu": {
        # dtype, fp8, hd, G, C, T, splits, rows, n
        "paged_attention_max_clusters": (_I, _I, _I, _I, _I, _I, _I, _I,
                                         _P),
        # dtype, hd, q, k, v, block_table, kv_len, out,
        # B, H, KH, bs, MB, splits, rows, scale, stream
        "paged_decode_fwd": (_I, _I, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _F, _P),
        # dtype, hd, q, k, v, block_table, pos, out,
        # B, C, H, KH, bs, MB, splits, rows, scale, stream
        "paged_chunk_fwd": (_I, _I, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
        # dtype, hd, q, k, v, k_scale, v_scale, block_table, kv_len, out,
        # B, H, KH, bs, MB, splits, rows, scale, stream
        "paged_decode_fp8_fwd": (_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _F, _P),
        # dtype, hd, q, k, v, k_scale, v_scale, block_table, pos, out,
        # B, C, H, KH, bs, MB, splits, rows, scale, stream
        "paged_chunk_fp8_fwd": (_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    },
    "flash_attention.cu": {
        # dtype, hd
        "flash_attention_body": (_I, _I),
        # dtype, hd, q, k, v, o, lse, B, Sq, Sk, H, KH, causal, window,
        # q_offset, n_pad_keys, scale, stream
        "flash_attention_fwd": (_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _I, _I, _I, _I, _F, _P),
    },
    "matmul.cu": {
        # dtype, bm, bn, bk
        "matmul_smem_bytes": (_I, _I, _I, _I),
        "matmul_wgmma_smem_bytes": (_I, _I, _I, _I),
        # dtype, M, N, K, bm, bn, bk, aligned
        "matmul_body": (_I, _I, _I, _I, _I, _I, _I, _I),
        # dtype, a, b, c, M, N, K, bm, bn, bk, b_kmajor, stream
        "matmul_fwd": (_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
        # dtype, M, N, K, aligned
        "single_tile_matmul_body": (_I, _I, _I, _I, _I),
        # dtype, M, N, K
        "single_tile_matmul_smem_bytes": (_I, _I, _I, _I),
        # dtype, a, b, c, M, N, K, bk, stream
        "single_tile_matmul_fwd": (_I, _P, _P, _P, _I, _I, _I, _I, _P),
    },
    "fp8_matmul.cu": {
        # bm, bn, bk
        "fp8_matmul_smem_bytes": (_I, _I, _I),
        "fp8_matmul_wgmma_smem_bytes": (_I, _I, _I),
        # M, N, K, bm, bn, bk, aligned
        "fp8_matmul_body": (_I, _I, _I, _I, _I, _I, _I),
        # fmt, a, b, sx, sw, c, M, N, K, bm, bn, bk, b_kmajor, stream
        "fp8_matmul_fwd": (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _I, _P),
    },
    "async_pipeline.cu": {
        # bm, bn, bk, stages
        "pipelined_matmul_smem_bytes": (_I, _I, _I, _I),
        # M, N, K, bm, bn, bk, aligned
        "pipelined_matmul_body": (_I, _I, _I, _I, _I, _I, _I),
        # a, b, c, M, N, K, bm, bn, bk, stages, stream
        "pipelined_matmul_fwd": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    },
    "dpx.cu": {
        # fn, dtype, a, b, c, out, n, stream
        "dpx_fused_fwd": (_I, _I, _P, _P, _P, _P, _L, _P),
        # bm, bn, bk
        "tropical_smem_bytes": (_I, _I, _I),
        # a, b, c, M, N, K, bm, bn, bk, body, stream
        "tropical_matmul_fwd": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _P),
        # warps
        "smith_waterman_smem_bytes": (_I,),
        # rows' seq, columns' seq, out, edge, B, rows, cols, S, warps,
        # pairs, match, mismatch, gap, stream
        "smith_waterman_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _I, _I, _P),
    },
    "dsm.cu": {
        # dtype (0 float32, 1 int32), x, out, cluster size, shard
        # length, hops, ilp, stream
        "rbc_ring_copy_fwd": (_I, _P, _P, _I, _L, _I, _I, _P),
        # x, out, cluster size, stream
        "ring_latency_probe_fwd": (_P, _P, _I, _P),
        # dsm, nbins, cluster size
        "histogram_smem_bytes": (_I, _I, _I),
        # dsm, values, out, shard length, nbins, cluster size, stream
        "histogram_fwd": (_I, _P, _P, _L, _I, _I, _P),
        # x, out, cluster size, piece length, stream
        "all_to_all_fwd": (_P, _P, _I, _L, _P),
    },
}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "from source on a machine with the CUDA toolkit")
    return path


def library_path(source: str) -> Path:
    src = CSRC / source
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    key = h.hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}_{key}.so"


def compile_source(source: str, *, ptxas_verbose: bool = False
                   ) -> Tuple[Path, float, str]:
    """Compile one source unless its library exists.  Returns (library
    path, build seconds (0.0 when it was there), compiler output).  The
    library is written under a temporary name and renamed into place,
    so a build that is cut leaves no library behind."""
    out = library_path(source)
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)]
    if ptxas_verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, time.perf_counter() - t0, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """The loaded library of `source`, built first if needed, with the
    argtypes and restype of every entry point set."""
    path, _, _ = compile_source(source)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES[source].items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


class LaunchError(RuntimeError):
    """A C entry point refused or failed a launch; `code` is the CUDA
    error it returned."""

    def __init__(self, entry: str, code: int):
        super().__init__(f"{entry} launch failed: CUDA error {code}")
        self.code = code


def launch(source: str, entry: str, device, *args) -> None:
    """Call `entry` of `source` with `args` and the current stream of
    `device`; raise LaunchError if the launch failed (the C entry points
    return the CUDA error of the launch, 0 when it launched)."""
    import torch
    fn = getattr(load(source), entry)
    err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise LaunchError(entry, err)
