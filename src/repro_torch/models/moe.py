"""Top-k routed mixture-of-experts feed-forward: the PyTorch counterpart of
``repro.models.moe.moe_ffn`` with its three routes.

``params`` holds a float32 ``router`` (D, E), the expert banks ``w_gate`` /
``w_up`` (E, D, F) and ``w_down`` (E, F, D), and, for a model with a shared
expert, ``shared``: a GLU (``w_gate``, ``w_up``, ``w_down``) run on every
token.  Routing follows the reference bit for bit where it decides
anything: the router runs in float32, the top-k keeps the lower expert
index first on an exact tie (``lax.top_k``'s order, which ``torch.topk``
does not promise on the card), the gates are divided by ``max(sum, 1e-9)``
and not renormalised after drops, and an expert's queue is filled
token-major, then by k (the exclusive cumsum over the flattened (N*K, E)
one-hot), so a token's second choice is queued before the next token's
first.  Capacity counts every position of the call, padding included.

The routes:

  * ``einsum`` and ``scatter`` — the reference's two capacity routes
    compute one function (a one-hot einsum and a scatter-add there); here
    both dispatch by index: each kept assignment is written into its
    (expert, queue position) row of an (E, C, D) buffer, every expert's
    bank multiplies its C rows (``torch.bmm``, as the reference's einsums
    multiply every bank), and each token gathers back its K rows.  A
    dropped assignment contributes zero.
  * ``ragged`` — dropless: a stable sort by expert and one product per
    expert group (the reference's ``lax.ragged_dot``).

No route reaches a hand-written kernel: the reference computes these
products in XLA, outside any Pallas kernel.

On a (data, model) mesh (DTensor tokens, rows split over the data axes;
the expert banks split by expert over ``model``) every route runs per
shard (``_moe_on_mesh``): each rank routes its own tokens, the queue
positions are the meshless ones — each data rank's exclusive cumsum
offset by the counts of the ranks before it, and the capacity counts
every token of the call — and each ``model`` rank multiplies only its own
experts' banks (gathered whole over the data axes first) over a buffer
as deep as the whole call's capacity (``ragged``: as its own assignments,
none dropped), its partial outputs summed over ``model``.
"""
from __future__ import annotations

import torch

from . import spmd
from .common import ACTIVATIONS
from .ffn import glu_ffn

IMPLS = ("einsum", "scatter", "ragged")


def route(params: dict, xt: torch.Tensor, top_k: int):
    """The shared router on tokens ``xt`` (N, D): float32 softmax
    probabilities (N, E), the normalised gate values (N, K) and the expert
    indices (N, K), highest probability first, the lower index first on an
    exact tie (a stable sort, as ``lax.top_k``)."""
    logits = torch.matmul(xt.float(), params["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gate_idx = torch.argsort(probs, dim=-1, descending=True,
                             stable=True)[:, :top_k]
    gate_vals = torch.gather(probs, 1, gate_idx)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, gate_vals, gate_idx


def capacity(capacity_factor: float, n: int, top_k: int, e: int) -> int:
    """Rows an expert takes in a call of ``n`` tokens: the reference's
    ``max(1, int(capacity_factor * n * top_k / e))``, in Python floats in
    that order."""
    return max(1, int(capacity_factor * n * top_k / e))


def queue_positions(gate_idx: torch.Tensor, e: int, cap: int):
    """Each assignment's position in its expert's queue and whether it is
    kept (position < ``cap``), both (N, K): the exclusive cumsum over the
    token-major, then k, one-hot (``repro.models.moe``)."""
    n, k = gate_idx.shape
    flat = torch.nn.functional.one_hot(gate_idx.reshape(-1), e)  # (N*K, E)
    pos = torch.cumsum(flat, dim=0) - flat
    pos = (pos * flat).sum(dim=-1).reshape(n, k)
    return pos, pos < cap


def routing(params: dict, xt: torch.Tensor, top_k: int,
            capacity_factor: float | None) -> dict:
    """What the router decides for tokens ``xt`` (N, D): ``probs``,
    ``gate_vals``, ``gate_idx`` and, for a capacity route
    (``capacity_factor`` not None), the queue position ``pos``, the
    ``keep`` mask and the ``capacity``."""
    e = params["router"].shape[1]
    probs, gate_vals, gate_idx = route(params, xt, top_k)
    out = dict(probs=probs, gate_vals=gate_vals, gate_idx=gate_idx)
    if capacity_factor is not None:
        cap = capacity(capacity_factor, xt.shape[0], top_k, e)
        out["pos"], out["keep"] = queue_positions(gate_idx, e, cap)
        out["capacity"] = cap
    return out


def _experts(params: dict, xe: torch.Tensor, activation: str) -> torch.Tensor:
    """Every expert's GLU on its rows: (E, C, D) -> (E, C, D)."""
    dt = xe.dtype
    act = ACTIVATIONS[activation]
    g = torch.bmm(xe, params["w_gate"].to(dt))
    u = torch.bmm(xe, params["w_up"].to(dt))
    return torch.bmm(act(g) * u, params["w_down"].to(dt))


def _combine(contrib: torch.Tensor, w: torch.Tensor, n: int,
             k: int) -> torch.Tensor:
    """Each token's sum of its K weighted expert rows, (N*K, D) -> (N, D).
    A sum over K of a gathered (N, K, D), with no ``index_add_`` (which
    adds in any order on the card): the reference adds at most K <= 2
    terms into a zero, which rounds alike in either order."""
    y = contrib * w[:, None]
    return y.reshape(n, k, -1).sum(dim=1)


def _capacity_route(params, xt, r, activation):
    e, d = params["router"].shape[1], xt.shape[1]
    n, k = r["gate_idx"].shape
    cap, keep = r["capacity"], r["keep"].reshape(-1)
    expert = r["gate_idx"].reshape(-1)
    # a dropped assignment goes to the scratch row C, never read back
    slot = torch.where(keep, r["pos"].reshape(-1),
                       torch.full_like(expert, cap))
    tok = torch.arange(n * k, device=xt.device) // k
    xe = torch.zeros((e, cap + 1, d), dtype=xt.dtype, device=xt.device)
    xe = xe.index_put((expert, slot), xt[tok])
    ye = _experts(params, xe[:, :cap], activation)
    ye = torch.cat([ye, ye.new_zeros((e, 1, d))], dim=1)
    w = (r["gate_vals"].reshape(-1) * keep.float()).to(xt.dtype)
    return _combine(ye[expert, slot], w, n, k)


def _ragged_route(params, xt, r, activation):
    dt = xt.dtype
    act = ACTIVATIONS[activation]
    e = params["router"].shape[1]
    n, k = r["gate_idx"].shape
    expert = r["gate_idx"].reshape(-1)
    order = torch.argsort(expert, stable=True)
    xs = xt[order // k]
    sizes = torch.bincount(expert, minlength=e).tolist()
    ys = torch.empty_like(xs)
    start = 0
    for i, size in enumerate(sizes):
        if size:
            rows = xs[start:start + size]
            h = act(torch.matmul(rows, params["w_gate"][i].to(dt))) \
                * torch.matmul(rows, params["w_up"][i].to(dt))
            ys[start:start + size] = torch.matmul(
                h, params["w_down"][i].to(dt))
        start += size
    contrib = torch.empty_like(ys)
    contrib[order] = ys
    return _combine(contrib, r["gate_vals"].reshape(-1).to(dt), n, k)


def moe_ffn(params: dict, x: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25, activation: str = "silu",
            return_aux: bool = False, impl: str = "einsum"):
    """x: (B, S, D) -> (B, S, D) [, aux]: ``repro.models.moe.moe_ffn``.
    ``aux``: ``load_balance`` (E * sum(frac_tokens * frac_probs), the
    first choice's share of tokens against the mean probability) and
    ``dropped_frac`` (zero for ``ragged``), float32 scalars."""
    if impl not in IMPLS:
        raise ValueError(f"moe impl {impl!r}: one of {IMPLS}")
    if spmd.is_dtensor(x):
        return _moe_on_mesh(params, x, top_k=top_k,
                            capacity_factor=capacity_factor,
                            activation=activation, return_aux=return_aux,
                            dropless=impl == "ragged")
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    dropless = impl == "ragged"
    r = routing(params, xt, top_k, None if dropless else capacity_factor)
    if dropless:
        y = _ragged_route(params, xt, r, activation)
    else:
        y = _capacity_route(params, xt, r, activation)
    if "shared" in params:
        y = y + glu_ffn(params["shared"], xt, activation)
    y = y.reshape(b, s, d)
    if not return_aux:
        return y
    probs, e = r["probs"], params["router"].shape[1]
    frac_tokens = torch.nn.functional.one_hot(
        r["gate_idx"][:, 0], e).float().mean(dim=0)
    aux = {"load_balance": e * torch.sum(frac_tokens * probs.mean(dim=0)),
           "dropped_frac": probs.new_zeros(()) if dropless
           else 1.0 - r["keep"].float().mean()}
    return y, aux


def _moe_on_mesh(params: dict, x, *, top_k: int, capacity_factor: float,
                 activation: str, return_aux: bool, dropless: bool):
    """``moe_ffn`` of DTensor tokens x (B,S,D) (see the module's
    docstring): the router's probabilities as DTensor ops, then the
    routing decisions, the experts' products and the load-balance terms
    per shard (``spmd.moe_shards``)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    probs = torch.softmax(torch.matmul(xt.float(),
                                       params["router"].float()), dim=-1)
    e, n_all = params["router"].shape[1], b * s
    cap = n_all // spmd.row_shards(xt) * top_k if dropless \
        else capacity(capacity_factor, n_all, top_k, e)

    def decide(p, offset):
        """The local tokens' gates, expert indices, queue positions and
        keep mask; ``offset(counts)``: the assignments to each expert of
        the data ranks before this one."""
        gate_idx = torch.argsort(p, dim=-1, descending=True,
                                 stable=True)[:, :top_k]
        gate_vals = torch.gather(p, 1, gate_idx)
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
        if dropless:      # this rank's own queues: none dropped
            return (gate_vals, gate_idx) + queue_positions(gate_idx, e, cap)
        flat = torch.nn.functional.one_hot(gate_idx.reshape(-1), e)
        pos = torch.cumsum(flat, dim=0) - flat + offset(flat.sum(dim=0))
        pos = (pos * flat).sum(dim=-1).reshape(gate_idx.shape)
        return gate_vals, gate_idx, pos, pos < cap

    def experts(xt, gate_vals, gate_idx, pos, keep, wg, wu, wd, lo: int):
        """This rank's experts ``[lo, lo + E_l)`` on its tokens: the
        capacity route's dispatch, multiply and combine, with every
        assignment to another rank's expert sent to the scratch row."""
        n, k = gate_idx.shape
        e_l, dm = wg.shape[0], xt.shape[1]
        mine = ((gate_idx >= lo) & (gate_idx < lo + e_l) & keep).reshape(-1)
        expert = (gate_idx.reshape(-1) - lo).clamp(0, e_l - 1)
        slot = torch.where(mine, pos.reshape(-1),
                           torch.full_like(expert, cap))
        tok = torch.arange(n * k, device=xt.device) // k
        xe = torch.zeros((e_l, cap + 1, dm), dtype=xt.dtype,
                         device=xt.device).index_put((expert, slot), xt[tok])
        ye = _experts({"w_gate": wg, "w_up": wu, "w_down": wd}, xe[:, :cap],
                      activation)
        ye = torch.cat([ye, ye.new_zeros((e_l, 1, dm))], dim=1)
        w = (gate_vals.reshape(-1) * mine.float()).to(xt.dtype)
        return _combine(ye[expert, slot], w, n, k)

    def terms(p, gate_idx, keep):
        """This rank's shares: first choices by expert, mean probability
        by expert, kept assignments."""
        return (torch.nn.functional.one_hot(gate_idx[:, 0], e).float()
                .mean(dim=0), p.mean(dim=0), keep.float().mean())

    y, (frac_tokens, mean_probs, kept) = spmd.moe_shards(
        decide, experts, terms, xt, probs, params["w_gate"],
        params["w_up"], params["w_down"])
    if "shared" in params:
        y = y + glu_ffn(params["shared"], xt, activation)
    y = y.reshape(b, s, d)
    if not return_aux:
        return y
    return y, {"load_balance": e * torch.sum(frac_tokens * mean_probs),
               "dropped_frac": 1.0 - kept}


def routing_flips(want: dict, got: dict, margin: float) -> dict:
    """Where two routings of the same tokens part (``routing``'s outputs,
    ``want`` the reference side's, e.g. the CPU's float32 against the
    card's).  A token's top-k may flip only between experts whose
    ``want`` probabilities lie within ``margin``; a keep bit may then flip
    at that token or any later one (the queues are token-major).
    Returns ``{"gate": [...], "keep": [...], "unexplained": [...]}``:
    (token, k) pairs, the last those no near-tie accounts for."""
    wi, gi = want["gate_idx"].cpu(), got["gate_idx"].cpu()
    probs = want["probs"].cpu()
    out: dict = {"gate": [], "keep": [], "unexplained": []}
    first_tie = None
    for n, k in (wi != gi).nonzero().tolist():
        out["gate"].append((n, k))
        gap = abs(float(probs[n, wi[n, k]]) - float(probs[n, gi[n, k]]))
        if gap <= margin:
            first_tie = n if first_tie is None else min(first_tie, n)
        else:
            out["unexplained"].append((n, k))
    if "keep" in want:
        for n, k in (want["keep"].cpu() != got["keep"].cpu()).nonzero() \
                .tolist():
            out["keep"].append((n, k))
            if first_tie is None or n < first_tie:
                out["unexplained"].append((n, k))
    return out
