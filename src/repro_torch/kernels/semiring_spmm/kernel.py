"""CUDA kernel wrapper: blocked semiring SpMV on Hopper (``sm_90a``).

Replaces the TPU kernel ``spmv_blocked_pallas``
(``src/repro/kernels/semiring_spmm/kernel.py:80``, bodies ``_spmv_body``,
``_spmv_kernel``, ``_spmv_kernel_nnz``).  Source:
``src/repro_torch/kernels/csrc/semiring_spmm.cu`` with the shared walk in
``csrc/blocked_walk.cuh``.

What bounds it on this card: memory.  Every tile is read once and does B
multiply-adds (or add-mins) per 4-byte weight, i.e. 0.5 operation per
byte, far below the H100's ~20 float32 operations per byte of HBM
bandwidth.  The least time is the tile bytes over HBM bandwidth; at the
TR_SMALL local sweep (8 partitions x 824 tiles of 64x64 float32,
108 MB) that is 32 us on an H100 SXM at 3.35 TB/s, and 106 us for the
boundary consume (8 x 2,703 tiles, 354 MB).

What the design does about it: the TPU kernel walks the (P, T) tile list
sequentially and carries ``y`` in VMEM.  Here output blocks are
independent, because sorted columns make each block's tiles one
contiguous run, so one CTA owns one (partition, output block): all P
partitions go in one launch, a CTA finds its run by binary search, and
its threads stream the run's tiles as 16-byte loads (four columns of a
tile row each, several rows in flight per thread) in a fixed fold order
(no atomics, deterministic).  A first, simple version: no TMA pipeline, no
persistent CTAs, and a long run stays on one CTA.

On a CPU tensor the wrapper runs the plain version (``ref.py``); on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.semiring import Semiring
from repro_torch.kernels import _build
from repro_torch.kernels.semiring_spmm.ref import spmv_blocked_ref


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"spmv_blocked_cuda: {msg}")


def spmv_blocked_cuda(
    tiles: torch.Tensor,  # (T, B, B) or (P, T, B, B) float32
    rows: torch.Tensor,  # (T,) or (P, T) int32, -1 = padding
    cols: torch.Tensor,  # (T,) or (P, T) int32, sorted valid prefix
    x: torch.Tensor,  # (nvb*B,) or (Px, nvb*B) float32, Px in {P, 1}
    sr: Semiring,
    *,
    n_out_blocks: Optional[int] = None,
    nnz=None,  # valid-tile count: () / (1,) or (P,) int32
) -> torch.Tensor:
    """Blocked semiring SpMV.  Returns ``(nob*B,)`` or ``(P, nob*B)``."""
    if tiles.device.type == "cpu":
        return spmv_blocked_ref(tiles, rows, cols, x, sr,
                                n_out_blocks=n_out_blocks, nnz=nnz)
    _need(tiles.device.type == "cuda",
          f"tensors on {tiles.device} (need cuda, or cpu for the plain "
          f"version)")
    single = tiles.ndim == 3
    if single:
        _need(rows.ndim == 1 and cols.ndim == 1 and x.ndim == 1,
              "single-partition form takes (T,) rows/cols and (nvb*B,) x")
        tiles, rows, cols, x = tiles[None], rows[None], cols[None], x[None]
    _need(tiles.ndim == 4 and tiles.shape[2] == tiles.shape[3],
          f"tiles must be (P, T, B, B), got {tuple(tiles.shape)}")
    P, T, B, _ = tiles.shape
    _need(rows.shape == (P, T) and cols.shape == (P, T),
          f"rows/cols must be {(P, T)}, got {tuple(rows.shape)}/"
          f"{tuple(cols.shape)}")
    _need(x.ndim == 2 and x.shape[0] in (1, P) and x.shape[1] % B == 0,
          f"x must be (P or 1, nvb*B), got {tuple(x.shape)}")
    _need(tiles.dtype == torch.float32 and x.dtype == torch.float32,
          "tiles and x must be float32")
    _need(rows.dtype == torch.int32 and cols.dtype == torch.int32,
          "rows and cols must be int32")
    _need(all(t.device == tiles.device for t in (rows, cols, x)),
          "all tensors must be on one device")
    _need(all(t.is_contiguous() for t in (tiles, rows, cols, x)),
          "all tensors must be contiguous")
    _need(B % 4 == 0, f"block size {B} must be a multiple of 4")
    _need(tiles.data_ptr() % 16 == 0, "tiles must be 16-byte aligned")
    nob = n_out_blocks if n_out_blocks is not None else x.shape[1] // B
    if nnz is not None:
        nnz = torch.as_tensor(nnz, device=tiles.device)
        _need(nnz.dtype == torch.int32 and nnz.numel() == P,
              f"nnz must be int32 with {P} entries")
        nnz = nnz.reshape(P).contiguous()
    y = torch.empty((P, nob * B), dtype=torch.float32, device=tiles.device)
    if y.numel():
        lib = _build.library()
        code = lib.spmv_blocked_f32(
            tiles.data_ptr(), rows.data_ptr(), cols.data_ptr(), x.data_ptr(),
            None if nnz is None else nnz.data_ptr(), y.data_ptr(), P, T, B,
            0 if x.shape[0] == 1 else x.shape[1], nob,
            _build.SEMIRING_CODES[sr.name],
            torch.cuda.current_stream(tiles.device).cuda_stream)
        _build.check(code, "spmv_blocked_cuda")
        spmv_blocked_cuda.launches += 1
    return y[0] if single else y


#: launches of the CUDA kernel in this process (the plain CPU path and
#: empty outputs launch nothing and count nothing)
spmv_blocked_cuda.launches = 0
