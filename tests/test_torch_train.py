"""The port's train path against the JAX package on the CPU, at reduced size
in float32: the same seed's weights go through both packages (the bridge
carries them across, ``to_jax_tree`` carries gradients and moments back)
and the same batches from the copied pipeline.

- ``cross_entropy_loss``, ``flash_attention_xla`` (causal, windowed,
  non-causal at Sq != Skv, several KV blocks) and ``chunked_linear_scan``
  against the JAX functions, values and gradients;
- ``Model.loss`` and every gradient leaf against ``jax.value_and_grad``
  for all ten archs, with a mask and without (internvl2-2b with
  ``modality``, seamless-m4t-medium with ``src_embeds``; the two MoE archs
  with their load-balance term, the router's gradient among the leaves),
  and starcoder2-7b with an encoder in front.

The optimizer, the step, the pipeline, checkpoints and ``train_once`` are in
``tests/test_torch_trainer.py``, which shares this file's helpers.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models import recurrent as ref_recurrent  # noqa: E402
from repro_torch.bridge import from_jax_params, to_jax_tree  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticTokens  # noqa: E402
from repro_torch.models.attention import flash_attention_xla  # noqa: E402
from repro_torch.models.common import cross_entropy_loss  # noqa: E402
from repro_torch.models.recurrent import chunked_linear_scan  # noqa: E402

#: every arch of ``configs.archs.ARCHS``
ARCHS = ("qwen3-0.6b", "qwen2-0.5b", "smollm-135m", "starcoder2-7b",
         "internvl2-2b", "recurrentgemma-2b", "falcon-mamba-7b",
         "seamless-m4t-medium", "phi3.5-moe-42b-a6.6b",
         "llama4-scout-17b-a16e")
#: the archs whose loss adds an MoE load-balance term
MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e")
B, S = 2, 24
#: float32 losses of the two frameworks (|loss| ~6-7): sums over the vocab
#: and the batch in other orders (they part by at most 1.4e-7 relative)
LOSS_RTOL = 1e-6
#: float32 gradients, per leaf, as a share of the leaf's largest entry:
#: products and sums in other orders (at most 2.1e-6 on these archs)
GRAD_SHARE = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees(got, want, share=GRAD_SHARE, what="leaf", floor=1e-7):
    """Every leaf of ``got`` (a JAX-layout tree) within ``share`` of the
    largest entry of the same leaf of ``want``."""
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w)
    for k in w:
        tol = share * float(np.abs(w[k]).max()) + floor
        np.testing.assert_allclose(g[k], w[k], atol=tol, rtol=0,
                                   err_msg=f"{what} {k}")


def _cfgs(arch: str, **kw):
    """(JAX config, port config) at reduced size, float32 compute."""
    return (jax_reduced(arch).replace(compute_dtype="float32", **kw),
            reduced_config(arch).replace(compute_dtype="float32", **kw))


def _init(arch: str, seed: int = 0, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    jm = jax_build(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    return jm, tree, tcfg


def _batch(cfg, step: int = 0, mask: bool = False, b: int = B,
           s: int = S) -> dict:
    """A numpy batch of the copied pipeline (with ``modality`` and
    ``src_embeds`` where the config takes them) and, with ``mask``, a
    random 0/1 float mask with a few zeros in every row."""
    data = SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=s, global_batch=b,
        modality_tokens=cfg.modality_tokens, modality_dim=cfg.modality_dim,
        encdec=cfg.is_encdec, d_model=cfg.d_model))
    out = data.batch(step)
    if mask:
        out["mask"] = (np.random.RandomState(step).rand(b, s) > 0.3) \
            .astype(np.float32)
    return out


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


# ------------------------------------------------------------- the functions
@pytest.mark.parametrize("mask", ["none", "random", "all_zero"])
def test_cross_entropy_loss_matches_jax(mask):
    rng = np.random.RandomState(0)
    logits = (3 * rng.standard_normal((2, 7, 50))).astype(np.float32)
    labels = rng.randint(0, 50, (2, 7)).astype(np.int32)
    m = None if mask == "none" else (
        (rng.rand(2, 7) > 0.4).astype(np.float32) if mask == "random"
        else np.zeros((2, 7), np.float32))
    want, want_g = jax.value_and_grad(
        lambda x: ref_common.cross_entropy_loss(
            x, jnp.asarray(labels), None if m is None else jnp.asarray(m)))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = cross_entropy_loss(x, torch.from_numpy(labels),
                             None if m is None else torch.from_numpy(m))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_np(x.grad), np.asarray(want_g), atol=1e-7,
                               rtol=0)


FLASH_CASES = {
    # (B, Sq, Skv, H, KVH, hd, causal, window, block_kv)
    "causal": (2, 24, 24, 4, 2, 16, True, 0, 512),
    "causal_blocks": (2, 40, 40, 4, 2, 16, True, 0, 16),
    "window": (2, 40, 40, 4, 1, 16, True, 12, 16),
    "encoder": (2, 24, 24, 4, 4, 16, False, 0, 512),
    "cross_sq_lt_skv": (2, 9, 40, 4, 4, 16, False, 0, 16),
    "cross_sq_gt_skv": (2, 33, 7, 4, 2, 16, False, 0, 512),
    # causal with q aligned to the start of a longer KV sequence
    "causal_sq_lt_skv": (2, 8, 40, 4, 2, 16, True, 0, 16),
    "window_ragged_blocks": (2, 37, 37, 4, 2, 16, True, 5, 8),
}


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_xla_matches_jax(case):
    b, sq, skv, h, kvh, hd, causal, window, bkv = FLASH_CASES[case]
    rng = np.random.RandomState(1)
    q, k, v, cot = (rng.standard_normal(sh).astype(np.float32) for sh in (
        (b, sq, h, hd), (b, skv, kvh, hd), (b, skv, kvh, hd),
        (b, sq, h, hd)))
    kw = dict(causal=causal, window=window, block_kv=bkv)

    def ref(q, k, v):
        out = ref_attention.flash_attention(q, k, v, **kw)
        return jnp.sum(out * cot), out

    (_, want), want_g = jax.value_and_grad(ref, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = flash_attention_xla(*ts, **kw)
    torch.sum(got * torch.from_numpy(cot)).backward()
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=0)
    for t, g in zip(ts, want_g):
        np.testing.assert_allclose(_np(t.grad), np.asarray(g), atol=5e-5,
                                   rtol=0)


@pytest.mark.parametrize("shape,chunk", [((2, 37, 5), 8), ((2, 16, 5), 16),
                                         ((2, 21, 3, 4), 16),
                                         ((1, 9, 6), 32)])
def test_chunked_linear_scan_matches_jax(shape, chunk):
    rng = np.random.RandomState(2)
    a = rng.uniform(0.5, 1.0, shape).astype(np.float32)
    bb = rng.standard_normal(shape).astype(np.float32)
    h0 = rng.standard_normal((shape[0],) + shape[2:]).astype(np.float32)
    cot = rng.standard_normal(shape).astype(np.float32)

    def ref(a, bb, h0):
        hs, last = ref_recurrent._chunked_linear_scan(a, bb, h0, chunk)
        return jnp.sum(hs * cot) + jnp.sum(last), (hs, last)

    (_, (hs, last)), want_g = jax.value_and_grad(
        ref, argnums=(0, 1, 2), has_aux=True)(a, bb, h0)
    ts = [torch.from_numpy(x).requires_grad_() for x in (a, bb, h0)]
    got, got_last = chunked_linear_scan(*ts, chunk)
    (torch.sum(got * torch.from_numpy(cot)) + got_last.sum()).backward()
    np.testing.assert_allclose(_np(got), np.asarray(hs), atol=2e-6, rtol=0)
    np.testing.assert_allclose(_np(got_last), np.asarray(last), atol=2e-6,
                               rtol=0)
    for t, g in zip(ts, want_g):
        np.testing.assert_allclose(_np(t.grad), np.asarray(g), atol=2e-5,
                                   rtol=0)


# ---------------------------------------------------------- loss and grads
def _loss_and_grads(arch: str, mask: bool, s: int = S, **kw):
    jm, tree, tcfg = _init(arch, **kw)
    batch = _batch(tcfg, mask=mask, s=s)
    loss_and_grad = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))
    want, want_g = loss_and_grad(jax.tree.map(jnp.asarray, tree),
                                 jax.tree.map(jnp.asarray, batch))
    tm = from_jax_params(tree, tcfg, "cpu", train=True)
    loss, metrics = tm.loss(_torch(batch))
    loss.backward()
    # a leaf the loss never reaches has no .grad; jax.grad gives it zeros
    grads = to_jax_tree(tm, {n: torch.zeros_like(p) if p.grad is None
                             else p.grad for n, p in tm.named_parameters()})
    return want, want_g, (loss, metrics), grads


@pytest.mark.parametrize("mask", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_jax(arch, mask):
    (want, wm), want_g, (loss, metrics), grads = _loss_and_grads(arch, mask)
    keys = {"ce_loss", "loss"} | ({"load_balance"} if arch in MOE_ARCHS
                                  else set())
    assert set(metrics) == set(wm) == keys
    np.testing.assert_allclose(float(loss), float(want), rtol=LOSS_RTOL)
    for key in keys - {"loss"}:
        np.testing.assert_allclose(float(metrics[key]), float(wm[key]),
                                   rtol=LOSS_RTOL, err_msg=key)
    _assert_trees(grads, want_g, what=f"{arch} grad")


def test_an_encoder_in_front_of_a_decoder_stack_matches_jax():
    """starcoder2-7b with two encoder layers: its attn blocks ignore the
    memory, but the encoder's leaves are in the tree (their gradients are
    0 in both) and the bridge carries them."""
    (want, _), want_g, (loss, _), grads = _loss_and_grads(
        "starcoder2-7b", False, enc_layers=2)
    assert "encoder" in grads and "enc_norm" in grads
    np.testing.assert_allclose(float(loss), float(want), rtol=LOSS_RTOL)
    _assert_trees(grads, want_g, what="starcoder2+encoder grad")


def test_local_attention_trains_at_whole_windows():
    """recurrentgemma's local layers at S = 2 windows take
    ``local_attention`` (at S = 24 above, flash with a window) — under
    autograd too."""
    (want, _), want_g, (loss, _), grads = _loss_and_grads(
        "recurrentgemma-2b", True, s=32)
    np.testing.assert_allclose(float(loss), float(want), rtol=LOSS_RTOL)
    _assert_trees(grads, want_g, what="recurrentgemma S=32 grad")


def test_no_grad_forward_of_the_encdec_matches_train_forward():
    """With autograd off the encoder takes the flash wrapper (the CUDA
    kernel on the card; its plain version here): the same logits."""
    _, tree, tcfg = _init("seamless-m4t-medium")
    tm = from_jax_params(tree, tcfg, "cpu", train=True)
    bt = _torch(_batch(tcfg))
    with torch.no_grad():
        a = tm(bt["tokens"], src_embeds=bt["src_embeds"])
    b = tm.train_forward(bt["tokens"], src_embeds=bt["src_embeds"])
    np.testing.assert_allclose(_np(a), _np(b), atol=2e-5, rtol=0)


def test_a_serving_build_stores_compute_dtype_and_a_train_build_float32():
    cfg = reduced_config("seamless-m4t-medium")            # bf16 compute
    _, tree, _ = _init("seamless-m4t-medium")
    serve = from_jax_params(tree, cfg, "cpu")
    train = from_jax_params(tree, cfg, "cpu", train=True)
    assert serve.layers[0].xattn["wq"].dtype == torch.bfloat16
    assert not any(p.requires_grad for p in serve.parameters())
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in train.parameters())
    bt = _torch(_batch(cfg))
    with torch.no_grad():
        a = serve(bt["tokens"], src_embeds=bt["src_embeds"])
        b = train(bt["tokens"], src_embeds=bt["src_embeds"])
    # the masters are cast per call to what the serving build stores
    assert torch.equal(a, b)
