"""Wrapper of the hand-written CUDA segmented scan (csrc/seg_scan.cu).

The kernel replaces bfqzip_tpu/ops/pallas_scan.py::_seg_scan_kernel.  This
wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates the output with torch.empty and the launch's scratch
(tile status words and tile counter, or float64's tile aggregates) zeroed
with torch.zeros, launches on the current stream and raises if the launch
was refused.  The plain PyTorch version of the same function is
ops/scan.py::seg_scan; the dispatch between the two lives in
ops/scan.py::LocalScanOps.

`launches` counts the calls that launched the kernel (float64's three
passes count as one), so a run can show that it went through the kernel;
`launches_by_dtype` splits the same count by the scanned dtype.
"""

from __future__ import annotations

import ctypes

import torch

from bfqzip_tpu_torch.utils import cuda_build

OPS = {"add": 0, "max": 1, "or": 2, "keepleft": 3}
DTYPES = {torch.int32: 0, torch.int64: 1, torch.float64: 2}  # the library's dtype codes

launches = 0
launches_by_dtype: dict[str, int] = {}

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = cuda_build.load("seg_scan")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bfq_seg_scan.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, i64, i32, i32, i32, ptr]
        lib.bfq_seg_scan.restype = i32
        lib.bfq_seg_scan_scratch_bytes.argtypes = [i32, i64, i32]
        lib.bfq_seg_scan_scratch_bytes.restype = i64
        lib.bfq_seg_scan_tile.argtypes = [i32]
        lib.bfq_seg_scan_tile.restype = i32
        _lib = lib
    return _lib


def _channel_init(init, dtype: torch.dtype, C: int, device) -> torch.Tensor:
    """`init` as a contiguous [C] tensor of `dtype` on `device`: a Python
    number fills it; a 0-d or [C] tensor (a carry left on the device by the
    previous segment) is broadcast, never copied to the host."""
    if not isinstance(init, torch.Tensor):
        return torch.full((C,), init, dtype=dtype, device=device)
    if init.device != torch.device(device):
        raise ValueError(f"init lies on {init.device}, x on {device}")
    if init.dim() > 1 or (init.dim() == 1 and init.shape[0] != C):
        raise ValueError(f"init must be 0-d or [{C}], got shape {tuple(init.shape)}")
    return init.to(dtype).expand(C).contiguous()


def tile_size(dtype: torch.dtype) -> int:
    """Positions per tile of the kernel for `dtype` (builds the library)."""
    return _library().bfq_seg_scan_tile(DTYPES[dtype])


def seg_scan(x: torch.Tensor, flag: torch.Tensor, op: str, init, reverse: bool = False) -> torch.Tensor:
    """Inclusive segmented scan of x ([n] or channel-first [C, n]) on the card.

    flag: [n] bool or uint8, shared by all channels; a nonzero flag restarts
    the scan at its position.  op: add/max/or/keepleft on int32 and int64,
    add on float64.  init: a number, or a 0-d or [C] tensor on x's device
    (each channel's value before its first flag).  reverse scans from
    position n-1 down to 0.
    """
    global launches
    if not (x.is_cuda and flag.is_cuda and x.device == flag.device):
        raise ValueError(f"seg_scan kernel needs CUDA tensors on one device, got {x.device}, {flag.device}")
    if op not in OPS:
        raise ValueError(f"unknown scan op {op!r}")
    if x.dtype not in DTYPES:
        raise TypeError(f"seg_scan kernel takes int32, int64 or float64, got {x.dtype}")
    if x.dtype == torch.float64 and op != "add":
        raise ValueError(f"float64 scan supports add only, got {op!r}")
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
    init_c = _channel_init(init, x.dtype, C, x.device)
    out = torch.empty_like(x)
    if n == 0 or C == 0:
        return out

    lib = _library()
    code = DTYPES[x.dtype]
    scratch = torch.zeros(lib.bfq_seg_scan_scratch_bytes(code, n, C), dtype=torch.uint8,
                          device=x.device)
    with torch.cuda.device(x.device):
        err = lib.bfq_seg_scan(code, x.data_ptr(), flag.data_ptr(), out.data_ptr(),
                               scratch.data_ptr(), init_c.data_ptr(), n, C, OPS[op],
                               int(reverse), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"seg_scan kernel launch failed: cudaError {err}")
    launches += 1
    name = str(x.dtype).removeprefix("torch.")
    launches_by_dtype[name] = launches_by_dtype.get(name, 0) + 1
    return out
