"""Wrapper of the hand-written CUDA segmented scan (csrc/seg_scan.cu).

The kernel replaces bfqzip_tpu/ops/pallas_scan.py::_seg_scan_kernel.  This
wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates the output and the per-tile scratch with torch.empty,
launches on the current stream and raises if the launch was refused.  The
plain PyTorch version of the same function is ops/scan.py::seg_scan; the
dispatch between the two lives in ops/scan.py::LocalScanOps.

`launches` counts the calls that launched the kernel (its three passes count
as one), so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from bfqzip_tpu_torch.utils import cuda_build

OPS = {"add": 0, "max": 1, "or": 2, "keepleft": 3}

launches = 0

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = cuda_build.load("seg_scan")
        ptr = ctypes.c_void_p
        common = [ptr, ptr, ptr, ptr, ptr, ptr, ctypes.c_longlong, ctypes.c_int]
        lib.bfq_seg_scan_i32.argtypes = common + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr]
        lib.bfq_seg_scan_i32.restype = ctypes.c_int
        lib.bfq_seg_scan_f64.argtypes = common + [ctypes.c_double, ctypes.c_int, ptr]
        lib.bfq_seg_scan_f64.restype = ctypes.c_int
        lib.bfq_seg_scan_tile.argtypes = []
        lib.bfq_seg_scan_tile.restype = ctypes.c_int
        _lib = lib
    return _lib


def seg_scan(x: torch.Tensor, flag: torch.Tensor, op: str, init, reverse: bool = False) -> torch.Tensor:
    """Inclusive segmented scan of x ([n] or channel-first [C, n]) on the card.

    flag: [n] bool or uint8, shared by all channels; a nonzero flag restarts
    the scan at its position.  op: add/max/or/keepleft on int32, add on
    float64.  reverse scans from position n-1 down to 0.
    """
    global launches
    if not (x.is_cuda and flag.is_cuda and x.device == flag.device):
        raise ValueError(f"seg_scan kernel needs CUDA tensors on one device, got {x.device}, {flag.device}")
    if op not in OPS:
        raise ValueError(f"unknown scan op {op!r}")
    if x.dtype == torch.float64:
        if op != "add":
            raise ValueError(f"float64 scan supports add only, got {op!r}")
    elif x.dtype != torch.int32:
        raise TypeError(f"seg_scan kernel takes int32 or float64, got {x.dtype}")
    if x.dim() not in (1, 2):
        raise ValueError(f"x must be [n] or [C, n], got shape {tuple(x.shape)}")
    n = x.shape[-1]
    C = 1 if x.dim() == 1 else x.shape[0]
    if flag.shape != (n,):
        raise ValueError(f"flag must have shape ({n},), got {tuple(flag.shape)}")
    if flag.dtype == torch.bool:
        flag = flag.view(torch.uint8)
    elif flag.dtype != torch.uint8:
        raise TypeError(f"flag must be bool or uint8, got {flag.dtype}")
    if not (x.is_contiguous() and flag.is_contiguous()):
        raise ValueError("seg_scan kernel needs contiguous x and flag")
    out = torch.empty_like(x)
    if n == 0 or C == 0:
        return out

    lib = _library()
    ntiles = -(-n // lib.bfq_seg_scan_tile())
    agg_v = torch.empty(C * ntiles, dtype=x.dtype, device=x.device)
    agg_f = torch.empty(C * ntiles, dtype=torch.uint8, device=x.device)
    carry = torch.empty(C * ntiles, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (x.data_ptr(), flag.data_ptr(), out.data_ptr(), agg_v.data_ptr(),
                agg_f.data_ptr(), carry.data_ptr(), n, C)
        if x.dtype == torch.float64:
            err = lib.bfq_seg_scan_f64(*args, float(init), int(reverse), stream)
        else:
            err = lib.bfq_seg_scan_i32(*args, OPS[op], int(init), int(reverse), stream)
    if err != 0:
        raise RuntimeError(f"seg_scan kernel launch failed: cudaError {err}")
    launches += 1
    return out
