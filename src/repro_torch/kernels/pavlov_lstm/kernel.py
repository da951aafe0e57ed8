"""Launch of the CUDA Pavlov LSTM recurrence (``csrc/pavlov_lstm.cu``).

Replaces ``repro/kernels/pavlov_lstm/kernel.py::_lstm_kernel``, and adds
what the LSTM layer needs: a carried float32 ``(h0, c0)`` in and
``(h_T, c_T)`` out.  One call is one persistent cooperative launch on the
current stream (``launches`` counts them): a CTA an SM owns a run of hidden
units and their four gate columns, packs its slice of W_h once into
registers, shared memory and, for what does not fit (float32 at H = 2048),
a scratch re-read from L2 each step, and the steps meet at a grid-wide
barrier.  What bounds it on the card: W_h is read from device memory once
a call; a step costs the barrier and h's round trip through L2 (latency)
and, in float32, the L2 rate for the off-chip part of the slice.  The
layout (and with it the order of every sum) depends on H and the card's SM
count, never on T.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import LaunchCounter, check, load

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = LaunchCounter()

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 4 + [_P]
_SCRATCH_ARGTYPES = [_I, _I, _I, ctypes.POINTER(ctypes.c_int64)]


def _lib(name: str, argtypes: list):
    fn = getattr(load("pavlov_lstm"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _need(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"pavlov_lstm_raw: {what}")


def check_lstm_args(xg: torch.Tensor, w_h: torch.Tensor,
                    h0: torch.Tensor | None = None,
                    c0: torch.Tensor | None = None) -> None:
    """Raise on what the kernel does not take: dtypes, shapes, xg or w_h
    not contiguous.  The C entry refuses an H too wide for the card's SMs
    (a CTA's units of one batch group may not outnumber its threads)."""
    state = [t for t in (h0, c0) if t is not None]
    if xg.dtype not in _DTYPES or w_h.dtype != xg.dtype:
        raise TypeError(f"dtypes {xg.dtype}/{w_h.dtype}: need one of "
                        f"float32, bfloat16 for xg and w_h")
    if any(t.dtype != torch.float32 for t in state):
        raise TypeError("h0 and c0 must be float32")
    _need(xg.dim() == 3 and xg.numel() > 0 and xg.shape[2] % 4 == 0,
          f"xg {tuple(xg.shape)}: need a non-empty (B, T, 4H)")
    b, _, h4 = xg.shape
    hd = h4 // 4
    _need(tuple(w_h.shape) == (hd, h4),
          f"w_h {tuple(w_h.shape)}: need ({hd}, {h4})")
    _need(all(tuple(s.shape) == (b, hd) for s in state),
          f"h0/c0 {[tuple(s.shape) for s in state]}: need ({b}, {hd})")
    _need(xg.is_contiguous() and w_h.is_contiguous(),
          "needs contiguous xg and w_h")


def pavlov_lstm_raw(xg: torch.Tensor, w_h: torch.Tensor,
                    h0: torch.Tensor | None = None,
                    c0: torch.Tensor | None = None):
    """xg: (B, T, 4H), w_h: (H, 4H), contiguous CUDA tensors of one dtype
    (float32 or bfloat16); h0, c0: (B, H) float32 (zeros when None) ->
    (h (B, T, H) in xg's dtype, h_T (B, H) float32, c_T (B, H) float32)."""
    check_lstm_args(xg, w_h, h0, c0)
    if not all(t.is_cuda for t in (xg, w_h, h0, c0) if t is not None):
        raise ValueError("pavlov_lstm_raw takes CUDA tensors")
    b, t, h4 = xg.shape
    hd = h4 // 4
    code = _DTYPES[xg.dtype]
    nbytes = ctypes.c_int64(0)
    check(_lib("pavlov_lstm_scratch", _SCRATCH_ARGTYPES)(
        code, b, hd, ctypes.byref(nbytes)), "pavlov_lstm_scratch")
    y = torch.empty((b, t, hd), dtype=xg.dtype, device=xg.device)
    hbuf = torch.empty((2, b, hd), dtype=torch.float32, device=xg.device)
    c = torch.empty((b, hd), dtype=torch.float32, device=xg.device)
    scratch = torch.empty(max(nbytes.value, 16), dtype=torch.uint8,
                          device=xg.device)
    if h0 is None:
        hbuf[0].zero_()
    else:
        hbuf[0].copy_(h0)
    if c0 is None:
        c.zero_()
    else:
        c.copy_(c0)
    stream = torch.cuda.current_stream(xg.device).cuda_stream
    err = _lib("pavlov_lstm_fwd", _ARGTYPES)(
        xg.data_ptr(), w_h.data_ptr(), hbuf.data_ptr(), c.data_ptr(),
        y.data_ptr(), scratch.data_ptr(), code, b, t, hd, stream)
    check(err, "pavlov_lstm_fwd")
    launches.n += 1
    return y, hbuf[t % 2], c
