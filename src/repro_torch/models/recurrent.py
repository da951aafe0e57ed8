"""The recurrent blocks: RecurrentGemma/Griffin's (a temporal depthwise
conv, then the RG-LRU gated linear recurrence, times a GeLU-gated branch),
Falcon-Mamba's Mamba-1 selective SSM (conv, SiLU, the selective scan,
times a SiLU-gated branch) and the LSTM layer.

The PyTorch counterpart of ``repro.models.recurrent``.  Each recurrence
always goes through its kernel wrapper — the CUDA kernel for a tensor on
the card, its plain sequential loop for one on the CPU:
  * the RG-LRU through ``kernels.pavlov_rglru.ops.pavlov_rglru``, the JAX
    package's ``impl="pallas"`` route (the carried state folded into
    ``b[:, 0]``);
  * the selective scan through ``kernels.pavlov_ssm.ops.pavlov_ssm``, which
    takes the carried ``h0`` and the prefix ``length`` and returns ``h_T``:
    the function of ``mamba_ssm``'s masked XLA route, which the JAX package
    serves with (its Pallas route carries no state);
  * the LSTM through ``kernels.pavlov_lstm.ops.pavlov_lstm``: the paper's
    Pavlov decoupled schedule, the input GEMM over all T on the Pascal
    matmul wrapper, then the recurrence with the carried ``(h, c)`` — the
    function of ``lstm_layer``'s XLA scan (the JAX package's Pallas LSTM
    starts from zero state).
Under autograd, where the wrappers have no backward, the RG-LRU and the
selective scan take the JAX package's training route instead
(``impl="xla"``): ``chunked_linear_scan``, the port of
``_chunked_linear_scan``, in differentiable PyTorch ops.  The model picks
it by passing ``scan_chunk`` in train mode while autograd records, and in
every mode on ``meta`` activations (the dry run: the JAX dry run lowers
the same XLA route, T/chunk steps a layer, where the wrappers' plain
versions would loop over every step).

Weights are cast per call to the dtype each product runs in, where the JAX
package casts them: a model built for training holds float32 masters and
differentiates through the cast; a serving model stores them already cast,
and the cast is a no-op.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.pavlov_lstm.ops import pavlov_lstm
from ..kernels.pavlov_rglru.ops import pavlov_rglru
from ..kernels.pavlov_ssm.ops import pavlov_ssm
from . import spmd
from .common import copy_into, fan_in_std, gelu

#: ``a = sigmoid(lambda)^(C * r)``: the RG-LRU's fixed temperature
C_RGLRU = 8.0


def _hillis_steele(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of the affine maps ``h -> a_t*h + b_t`` along axis 1
    in log2(T) doubling steps: returns (prod a, h from 0) at every t."""
    d = 1
    while d < a.shape[1]:
        a_prev = torch.cat([torch.ones_like(a[:, :d]), a[:, :-d]], dim=1)
        b_prev = torch.cat([torch.zeros_like(b[:, :d]), b[:, :-d]], dim=1)
        a, b = a * a_prev, a * b_prev + b
        d *= 2
    return a, b


def chunked_linear_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                        chunk: int):
    """h_t = a_t * h_{t-1} + b_t along axis 1 from ``h0``
    (``repro.models.recurrent._chunked_linear_scan``): a, b (B,S,...), h0
    (B,...).  Chunks of ``chunk`` steps, each a log-depth scan with the
    carry folded in; a tail that does not fill a chunk is identity-padded
    (a=1, b=0) and sliced off.  Differentiable.  Returns (h (B,S,...),
    h_S)."""
    s = a.shape[1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        widths = (0, 0) * (a.dim() - 2) + (0, pad)
        a = torch.nn.functional.pad(a, widths, value=1.0)
        b = torch.nn.functional.pad(b, widths, value=0.0)
    h, outs = h0, []
    for c0 in range(0, s + pad, chunk):
        aa, bb = _hillis_steele(a[:, c0:c0 + chunk], b[:, c0:c0 + chunk])
        hs = aa * h[:, None] + bb
        h = hs[:, -1]
        outs.append(hs)
    return torch.cat(outs, dim=1)[:, :s], h


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: torch.Tensor | None = None,
                  length: torch.Tensor | None = None):
    """Depthwise causal temporal conv.  x: (B,S,C), w: (K,C).
    ``state``: (B,K-1,C) trailing context of the previous segment.
    ``length``: (B,) valid prefix lengths of a right-padded x — the returned
    state is then the context trailing position ``length-1``, not S-1 (a
    row with length 0 keeps its old state).  Returns (y, new_state).  On a
    mesh (a DTensor ``state``) it runs on each rank's rows and channels
    (``spmd.conv``)."""
    return spmd.conv(_causal_conv1d, x, w, state, length)


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                   state: torch.Tensor | None,
                   length: torch.Tensor | None):
    k = w.shape[0]
    b, s, c = x.shape
    if state is None:
        state = x.new_zeros((b, k - 1, c))
    xp = torch.cat([state, x], dim=1)
    y = xp[:, 0:s] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i]
    if k == 1:
        return y.to(x.dtype), state
    if length is None:
        return y.to(x.dtype), xp[:, -(k - 1):]
    # xp index of real token t is (k-1)+t, so the k-1 inputs trailing
    # position length-1 sit at xp[length .. length+k-2]
    idx = length.long()[:, None] + torch.arange(k - 1, device=x.device)
    idx = idx.clamp(0, xp.shape[1] - 1)
    new_state = torch.gather(xp, 1, idx[:, :, None].expand(b, k - 1, c))
    return y.to(x.dtype), new_state


@torch.no_grad()
def init_rglru_block(params: dict, generator: torch.Generator,
                     sink=copy_into) -> None:
    """Fill a block's parameters with the JAX package's distributions:
    every matrix normal with std 1/sqrt(fan-in) (the rows of each block
    when ``w_a``/``w_i`` are block-diagonal, ``(G, d/G, d/G)``),
    ``conv_w`` with std 1/sqrt(conv width), and ``lambda`` so that
    ``a = sigmoid(lambda)^C`` is uniform in [0.9, 0.999].  Each value is
    drawn whole in float32 on ``generator``'s device and handed to
    ``sink(p, value)`` (default: copied into ``p``)."""
    for name, p in params.items():
        w = torch.empty(p.shape, dtype=torch.float32,
                        device=generator.device)
        if name == "lambda":
            w.uniform_(0.9, 0.999, generator=generator)
            r = w ** (1.0 / C_RGLRU)
            sink(p, torch.log(r / (1.0 - r)))
        else:
            w.normal_(0.0, fan_in_std(tuple(p.shape[-2:])),
                      generator=generator)
            sink(p, w)


def rglru_core(params: dict, x: torch.Tensor,
               h0: torch.Tensor | None = None,
               seq_mask: torch.Tensor | None = None,
               scan_chunk: int | None = None):
    """The RG-LRU recurrence.  x: (B,S,d_rnn) (post-conv); ``h0``: (B,d_rnn)
    float32 carried state.  ``seq_mask``: (B,S) bool; False positions are
    identity steps (a=1, b=0), so the final row holds the state at the last
    True position.  With ``scan_chunk`` the recurrence runs
    ``chunked_linear_scan`` in chunks of that many steps (the
    differentiable route), else the kernel wrapper.  Returns (y in
    x.dtype, h_last float32)."""
    dt = x.dtype
    xf = x.float()
    w_a, w_i = params["w_a"], params["w_i"]
    if w_a.dim() == 3:      # block-diagonal gates, in float32
        g = w_a.shape[0]
        xg = xf.reshape(xf.shape[0], xf.shape[1], g, -1)
        r = torch.sigmoid(torch.einsum("bsgd,gde->bsge", xg, w_a.float())
                          .reshape(xf.shape))
        i = torch.sigmoid(torch.einsum("bsgd,gde->bsge", xg, w_i.float())
                          .reshape(xf.shape))
    else:                   # dense gates in the compute dtype, sigmoid in f32
        r = torch.sigmoid(torch.matmul(x, w_a.to(dt)).float())
        i = torch.sigmoid(torch.matmul(x, w_i.to(dt)).float())
    log_a = -C_RGLRU * r * F.softplus(-params["lambda"].float())
    a = torch.exp(log_a)
    gated = i * xf
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-6)) \
        * gated
    if seq_mask is not None:
        m = seq_mask[:, :, None]
        a = torch.where(m, a, torch.ones_like(a))
        b = torch.where(m, b, torch.zeros_like(b))
    if scan_chunk is not None:
        h, h_last = spmd.linear_scan(chunked_linear_scan, a, b, h0,
                                     scan_chunk)
        return h.to(dt), h_last
    h, h_last = spmd.rglru_scan(_rglru_scan, a, b, h0)
    return h.to(dt), h_last


def _rglru_scan(a: torch.Tensor, b: torch.Tensor,
                h0: torch.Tensor | None):
    """The RG-LRU kernel wrapper over a, b (B,S,W) from ``h0``: (h float32,
    h at the last step)."""
    if h0 is not None:
        # the kernel scans from h=0; folding a_0*h0 into b_0 gives the
        # h0-seeded recurrence (h_0 = a_0*h0 + b_0 either way)
        b[:, 0] += a[:, 0] * h0
    h = pavlov_rglru(a.contiguous(), b.contiguous())
    return h, h[:, -1].float()


def rglru_block(params: dict, x: torch.Tensor, *,
                state: dict | None = None,
                length: torch.Tensor | None = None,
                scan_chunk: int | None = None):
    """The Griffin recurrent block.  x: (B,S,D) -> (B,S,D).  ``state``:
    ``{"conv": (B,K-1,d_rnn), "h": (B,d_rnn) float32}`` carried from an
    earlier segment.  ``length``: (B,) valid prefix lengths of a
    right-padded x — the returned state then reflects position length-1.
    ``scan_chunk``: the differentiable route's chunk (``rglru_core``).
    Returns (out, new state)."""
    dt = x.dtype
    y = gelu(torch.matmul(x, params["w_y"].to(dt)))
    u = torch.matmul(x, params["w_x"].to(dt))
    conv_state = state["conv"] if state else None
    h0 = state["h"] if state else None
    seq_mask = None if length is None else spmd.rows(
        lambda n: torch.arange(x.shape[1], device=n.device)[None, :]
        < n[:, None], length, length)
    u, new_conv = causal_conv1d(u, params["conv_w"].to(dt), conv_state,
                                length=length)
    h, h_last = rglru_core(params, u, h0, seq_mask, scan_chunk)
    out = torch.matmul(h * y, params["w_out"].to(dt))
    return out, {"conv": new_conv, "h": h_last}


def rglru_param_shapes(d_model: int, d_rnn: int, conv_width: int,
                       gate_blocks: int) -> dict[str, tuple[int, ...]]:
    """The shape of each parameter of one block (``lambda`` and the gates'
    layout as ``repro.models.recurrent.init_rglru_block`` makes them)."""
    if gate_blocks:
        if d_rnn % gate_blocks:
            raise ValueError(f"d_rnn {d_rnn} is not a multiple of "
                             f"gate_blocks {gate_blocks}")
        bd = d_rnn // gate_blocks
        gate = (gate_blocks, bd, bd)
    else:
        gate = (d_rnn, d_rnn)
    return {"w_x": (d_model, d_rnn), "w_y": (d_model, d_rnn),
            "conv_w": (conv_width, d_rnn), "w_a": gate, "w_i": gate,
            "lambda": (d_rnn,), "w_out": (d_rnn, d_model)}



# ---------------------------------------------------------------------- Mamba-1
#: Mamba parameters ``mamba_ssm`` reads in float32; the port stores them so
MAMBA_F32 = ("x_proj", "dt_proj", "dt_bias", "a_log", "d_skip")


def mamba_param_shapes(d_model: int, d_inner: int, d_state: int,
                       d_conv: int, dt_rank: int) -> dict[str, tuple[int, ...]]:
    """The shape of each parameter of one Mamba-1 block, as
    ``repro.models.recurrent.init_mamba_block`` makes them."""
    return {"in_proj": (d_model, 2 * d_inner), "conv_w": (d_conv, d_inner),
            "x_proj": (d_inner, dt_rank + 2 * d_state),
            "dt_proj": (dt_rank, d_inner), "dt_bias": (d_inner,),
            "a_log": (d_inner, d_state), "d_skip": (d_inner,),
            "out_proj": (d_inner, d_model)}


@torch.no_grad()
def init_mamba_block(params: dict, generator: torch.Generator,
                     sink=copy_into) -> None:
    """Fill a Mamba block's parameters with the JAX package's
    distributions: every matrix normal with std 1/sqrt(fan-in) (``conv_w``:
    1/sqrt(conv width)), ``dt_bias = log(expm1(u))`` with u uniform in
    [1e-3, 1e-1], ``a_log = log(1..N)`` on every row exactly, ``d_skip``
    ones.  Each value is made whole in float32 on ``generator``'s device
    and handed to ``sink(p, value)`` (default: copied into ``p``)."""
    for name, p in params.items():
        w = torch.empty(p.shape, dtype=torch.float32,
                        device=generator.device)
        if name == "dt_bias":
            w.uniform_(1e-3, 1e-1, generator=generator)
            w = torch.log(torch.expm1(w))
        elif name == "a_log":
            n = torch.arange(1, p.shape[1] + 1, dtype=torch.float32,
                             device=w.device)
            w = torch.log(n).expand(p.shape)
        elif name == "d_skip":
            w.fill_(1.0)
        else:
            w.normal_(0.0, fan_in_std(tuple(p.shape)), generator=generator)
        sink(p, w)


def mamba_ssm(params: dict, x: torch.Tensor, dt_rank: int, d_state: int,
              h0: torch.Tensor | None = None,
              length: torch.Tensor | None = None,
              scan_chunk: int | None = None):
    """Selective scan.  x: (B,S,d_inner) (post conv+silu); ``h0``:
    (B,d_inner,d_state) float32 carried state; ``length``: (B,) int32 valid
    prefix lengths — later steps leave the state unchanged.  The input
    projections, softplus and ``a`` in float32 with PyTorch ops, where the
    JAX package computes them outside its kernel; the recurrence in the
    kernel wrapper, or, with ``scan_chunk``, as the JAX package's XLA route
    computes it (decays and drives materialized per state, then
    ``chunked_linear_scan``): the differentiable route.  Returns (y in
    x.dtype, h_T float32)."""
    xf = x.float()
    f32 = torch.float32
    # on a mesh the row-parallel product's sum is taken here, before the
    # split: torch 2.11's DTensor cannot lay a data-split dt_in out for the
    # next product otherwise ("redistribute from S(0) to P(sum)")
    proj = spmd.settle(torch.matmul(xf, params["x_proj"].to(f32)), xf)
    dt_in, b_in, c_in = torch.split(proj, [dt_rank, d_state, d_state],
                                    dim=-1)
    delta = F.softplus(torch.matmul(dt_in, params["dt_proj"].to(f32))
                       + params["dt_bias"].to(f32))
    a = -torch.exp(params["a_log"].to(f32))
    d_skip = params["d_skip"].to(f32)
    if scan_chunk is None:
        y, h_last = spmd.ssm_scan(pavlov_ssm, delta, xf, b_in.contiguous(),
                                  c_in.contiguous(), a, d_skip, h0, length)
        return y.to(x.dtype), h_last
    alpha = torch.exp(delta[..., None] * a)                  # (B,S,di,N)
    beta = (delta * xf)[..., None] * b_in[:, :, None, :]
    if length is not None:
        m = (torch.arange(x.shape[1], device=x.device)[None, :]
             < length[:, None])[:, :, None, None]
        alpha = torch.where(m, alpha, torch.ones_like(alpha))
        beta = torch.where(m, beta, torch.zeros_like(beta))
    h, h_last = spmd.linear_scan(chunked_linear_scan, alpha, beta, h0,
                                 scan_chunk)
    y = torch.einsum("bsdn,bsn->bsd", h, c_in) + xf * d_skip
    return y.to(x.dtype), h_last


def mamba_block(params: dict, x: torch.Tensor, *, d_state: int,
                dt_rank: int, state: dict | None = None,
                length: torch.Tensor | None = None,
                scan_chunk: int | None = None):
    """The Mamba-1 block.  x: (B,S,D) -> (B,S,D).  ``state``:
    ``{"conv": (B,K-1,d_inner), "h": (B,d_inner,d_state) float32}`` carried
    from an earlier segment.  ``length``: (B,) int32 valid prefix lengths of
    a right-padded x — the returned state then reflects position length-1
    (a row with 0 keeps its state bit for bit).  ``scan_chunk``: the
    differentiable route's chunk (``mamba_ssm``).  Returns (out, new
    state)."""
    dt = x.dtype
    xi, z = torch.matmul(x, params["in_proj"].to(dt)).chunk(2, dim=-1)
    conv_state = state["conv"] if state else None
    h0 = state["h"] if state else None
    xi, new_conv = causal_conv1d(xi, params["conv_w"].to(dt), conv_state,
                                 length=length)
    y, h_last = mamba_ssm(params, F.silu(xi), dt_rank, d_state, h0, length,
                          scan_chunk)
    out = torch.matmul(y * F.silu(z), params["out_proj"].to(dt))
    return out, {"conv": new_conv, "h": h_last}


# ------------------------------------------------------------------------ LSTM
@torch.no_grad()
def init_lstm_layer(d_in: int, d_hidden: int,
                    generator: torch.Generator) -> dict:
    """One LSTM layer's float32 parameters with the JAX package's
    distributions (``repro.models.recurrent.init_lstm_layer``): ``w_x``
    (d_in, 4H) and ``w_h`` (H, 4H) normal with std 1/sqrt(fan-in), ``b``
    (4H,) zeros; made on the generator's device."""
    dev = generator.device
    params = {}
    for name, shape in (("w_x", (d_in, 4 * d_hidden)),
                        ("w_h", (d_hidden, 4 * d_hidden))):
        w = torch.empty(shape, dtype=torch.float32, device=dev)
        params[name] = w.normal_(0.0, fan_in_std(shape), generator=generator)
    params["b"] = torch.zeros((4 * d_hidden,), dtype=torch.float32, device=dev)
    return params


def lstm_layer(params: dict, x: torch.Tensor,
               state: tuple[torch.Tensor, torch.Tensor] | None = None):
    """x: (B,S,Din) -> (B,S,H).  The input MVMs for all timesteps are one
    GEMM before the recurrence (the Pavlov decoupled schedule), so W_x is
    read once.  ``state``: (h, c), each (B,H) float32, carried from an
    earlier segment (zeros when None).  Returns (y in x.dtype, (h_T, c_T)
    float32).

    The model-level API of the JAX package's ``lstm_layer`` (a parameter
    tree and a state tuple) over the kernel-level ``pavlov_lstm`` (bare
    tensors, as the JAX package's ``kernels.pavlov_lstm.ops``), which the
    tests hold to its JAX counterpart; the two are one route here."""
    h0, c0 = state if state is not None else (None, None)
    y, h, c = pavlov_lstm(x, params["w_x"], params["w_h"], params["b"], h0,
                          c0)
    return y, (h, c)
