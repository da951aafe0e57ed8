"""Launch of the CUDA Pavlov LSTM recurrence (``csrc/pavlov_lstm.cu``).

Replaces ``repro/kernels/pavlov_lstm/kernel.py::_lstm_kernel``, and adds
what the LSTM layer needs: a carried float32 ``(h0, c0)`` in and
``(h_T, c_T)`` out.  One call enqueues T step launches on the current
stream (the kernel boundary is the barrier between steps; ``launches``
counts calls, ``step_launches`` the steps they enqueued).  What bounds it
on the card: every step reads all of W_h (67 MB in float32 at H = 2048,
more than the L2), about 20 µs a step from device memory, where the
function needs W_h once (0.1 ms of float32 operations at B = 1, T = 200).
A block owns 16 hidden units and their four gate columns, so c and h are
updated where the gates are summed.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import LaunchCounter, check, load

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = LaunchCounter()
#: the step launches the calls enqueued (T per call)
step_launches = LaunchCounter()

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 5 + [_I] * 4 + [_P]


def _lib():
    fn = load("pavlov_lstm").pavlov_lstm_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _need(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"pavlov_lstm_raw: {what}")


def pavlov_lstm_raw(xg: torch.Tensor, w_h: torch.Tensor,
                    h0: torch.Tensor | None = None,
                    c0: torch.Tensor | None = None):
    """xg: (B, T, 4H), w_h: (H, 4H), contiguous CUDA tensors of one dtype
    (float32 or bfloat16); h0, c0: (B, H) float32 (zeros when None) ->
    (h (B, T, H) in xg's dtype, h_T (B, H) float32, c_T (B, H) float32)."""
    state = [t for t in (h0, c0) if t is not None]
    if not all(t.is_cuda for t in (xg, w_h, *state)):
        raise ValueError("pavlov_lstm_raw takes CUDA tensors")
    if xg.dtype not in _DTYPES or w_h.dtype != xg.dtype:
        raise TypeError(f"dtypes {xg.dtype}/{w_h.dtype}: need one of "
                        f"float32, bfloat16 for xg and w_h")
    if any(t.dtype != torch.float32 for t in state):
        raise TypeError("h0 and c0 must be float32")
    _need(xg.dim() == 3 and xg.numel() > 0 and xg.shape[2] % 4 == 0,
          f"xg {tuple(xg.shape)}: need a non-empty (B, T, 4H)")
    b, t, h4 = xg.shape
    hd = h4 // 4
    _need(tuple(w_h.shape) == (hd, h4),
          f"w_h {tuple(w_h.shape)}: need ({hd}, {h4})")
    _need(all(tuple(s.shape) == (b, hd) for s in state),
          f"h0/c0 {[tuple(s.shape) for s in state]}: need ({b}, {hd})")
    _need(xg.is_contiguous() and w_h.is_contiguous(),
          "needs contiguous xg and w_h")
    y = torch.empty((b, t, hd), dtype=xg.dtype, device=xg.device)
    hbuf = torch.empty((2, b, hd), dtype=torch.float32, device=xg.device)
    c = torch.empty((b, hd), dtype=torch.float32, device=xg.device)
    if h0 is None:
        hbuf[0].zero_()
    else:
        hbuf[0].copy_(h0)
    if c0 is None:
        c.zero_()
    else:
        c.copy_(c0)
    stream = torch.cuda.current_stream(xg.device).cuda_stream
    err = _lib()(xg.data_ptr(), w_h.data_ptr(), hbuf.data_ptr(),
                 c.data_ptr(), y.data_ptr(), _DTYPES[xg.dtype], b, t, hd,
                 stream)
    check(err, "pavlov_lstm_fwd")
    launches.n += 1
    step_launches.n += t
    return y, hbuf[t % 2], c
