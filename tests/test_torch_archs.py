"""The four dense decoders of the slice against the JAX package on the
CPU, at reduced size (2 layers of width 64): qwen2-0.5b (qkv bias, 7 q
heads a kv head), smollm-135m (3 a kv head), starcoder2-7b (LayerNorm, the
GELU MLP with biases, qkv bias) and internvl2-2b (an untied ``lm_head`` and
the ``mm_proj`` modality stub).

- ``layer_norm`` and ``mlp_ffn`` equal the JAX functions;
- the bridge consumes every leaf of the JAX tree and refuses a leftover;
- forward logits match ``Model.forward`` (internvl2-2b with a modality
  input too, and its one-shot prefill), float32 at ``ATOL_F32``, bf16 at
  ``BF16_SHARE`` of the logits' scale, with random norms and biases (they initialize at 1 and 0,
  where a dropped bias would go unseen);
- greedy tokens of the port's engine equal the JAX engine's, paged and
  dense;
- chunked prefill equals one-shot inside the port (the two MoE archs
  too), and both packages refuse it for the modality model;
- the placement plan equals the JAX plan (the two MoE archs too: their
  MoE layers' cluster included).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models import ffn as ref_ffn  # noqa: E402
from repro.serve import placement as ref_placement  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.models.common import layer_norm  # noqa: E402
from repro_torch.models.ffn import mlp_ffn  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.placement import ExecutionOracle  # noqa: E402

from test_torch_model import ATOL_BF16, ATOL_F32, lively_params  # noqa: E402
from test_torch_placement import (PLAN_FIELDS,  # noqa: E402
                                  POLICY_FIELDS)

ARCHS = ("qwen2-0.5b", "smollm-135m", "starcoder2-7b", "internvl2-2b")
#: the MoE archs (``tests/test_torch_moe.py``): chunked prefill at the
#: reduced capacity, where nothing drops, and the plan
MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e")
VLM = "internvl2-2b"
MAX_LEN, BS = 64, 8
#: weight gain by compute dtype: float32 takes the tripled "lively" weights
#: (greedy tokens vary); bf16 the init's.  Tripled, bf16 rounding moves the
#: logits of the JAX package itself by 0.5-1.3 from its float32 logits on
#: these archs, so two bf16 runs part by more than ATOL_BF16 on noise
#: alone; at the init's weights each stays within 0.06 of float32.
GAIN = {"float32": 3.0, "bfloat16": 1.0}
#: the bf16 bound as a share of the run's max|logits|: ATOL_BF16 is set for
#: logits reaching ~20, and at the init's weights these reach only 3-9 (the
#: port parts from JAX by 0.4-1.0% of that max on these inputs)
BF16_SHARE = ATOL_BF16 / 20


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def arch_params(arch: str, compute_dtype: str = "float32", seed: int = 0):
    """``lively_params`` at the dtype's ``GAIN``, with every leaf that
    initializes at zero (the biases) drawn at random too."""
    jm, _, tree = lively_params(compute_dtype, seed=seed, arch=arch,
                                gain=GAIN[compute_dtype])
    rng = np.random.RandomState(seed + 100)

    def biased(a):
        a = np.asarray(a, np.float32)
        return rng.normal(0, 0.5, a.shape).astype(np.float32) \
            if not a.any() else a

    tree = jax.tree.map(biased, tree)
    return jm, jax.tree.map(jnp.asarray, tree), tree


def _port(arch, tree, compute_dtype="float32"):
    return from_jax_params(tree, reduced_config(arch).replace(
        compute_dtype=compute_dtype), "cpu")


@pytest.fixture(scope="module", params=[(a, dt) for a in ARCHS
                                        for dt in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    arch, dt = request.param
    jm, jp, tree = arch_params(arch, dt)
    return arch, dt, jm, jp, _port(arch, tree, dt)


def _atol(dt, want):
    """The bound for logits ``want`` computed in ``dt``."""
    return ATOL_F32 if dt == "float32" \
        else BF16_SHARE * float(np.abs(_np(want)).max())


# ----------------------------------------------------------- the functions
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.RandomState(0)
    x = (3.0 * rng.standard_normal((2, 5, 64)) + 1.0).astype(np.float32)
    scale = rng.normal(1.0, 0.5, 64).astype(np.float32)
    bias = rng.normal(0.0, 0.5, 64).astype(np.float32)
    want = ref_common.layer_norm(jnp.asarray(x, dtype), jnp.asarray(scale),
                                 jnp.asarray(bias))
    got = layer_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                     torch.from_numpy(scale), torch.from_numpy(bias))
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_allclose(_np(got), _np(want),
                               atol=1e-5 if dtype == "float32" else 2e-2,
                               rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_ffn_matches_jax(dtype):
    rng = np.random.RandomState(1)
    params = {k: rng.normal(0, s, shape).astype(np.float32)
              for k, s, shape in (("w_in", 0.125, (64, 128)),
                                  ("b_in", 0.5, (128,)),
                                  ("w_out", 0.09, (128, 64)),
                                  ("b_out", 0.5, (64,)))}
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    want = ref_ffn.mlp_ffn({k: jnp.asarray(v) for k, v in params.items()},
                           jnp.asarray(x, dtype), "gelu")
    dt = getattr(torch, dtype)
    got = mlp_ffn({k: torch.from_numpy(v).to(dt) for k, v in params.items()},
                  torch.from_numpy(x).to(dt), "gelu")
    np.testing.assert_allclose(_np(got), _np(want),
                               atol=1e-5 if dtype == "float32" else 5e-2,
                               rtol=0)


# ---------------------------------------------------------------- bridge
@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_consumes_every_leaf(arch):
    """Every leaf of the JAX tree lands in one tensor of the port's model,
    bit for bit (float32), and every tensor of the model comes from one."""
    _, _, tree = arch_params(arch)
    tm = _port(arch, tree)
    cfg = tm.cfg
    leaves = {jax.tree_util.keystr(p): np.asarray(a) for p, a in
              jax.tree_util.tree_flatten_with_path(tree)[0]}
    got = {name: p.numpy() for name, p in tm.state_dict().items()}
    # the JAX leaf of each port tensor: (key, layer index or None)
    want = {"embed": ("['embed']", None),
            "final_norm": ("['final_norm']['scale']", None)}
    if cfg.norm == "layer":
        want["final_norm_bias"] = ("['final_norm']['bias']", None)
    if not cfg.tie_embeddings:
        want["lm_head"] = ("['lm_head']", None)
    if cfg.modality_tokens:
        for w in ("w1", "w2"):
            want[f"mm_proj.{w}"] = (f"['mm_proj']['{w}']", None)
    pre = "['groups']['0']"
    for i in range(cfg.num_layers):
        for norm in ("ln1", "ln2"):
            want[f"layers.{i}.{norm}"] = (f"{pre}['{norm}']['scale']", i)
            if cfg.norm == "layer":
                want[f"layers.{i}.{norm}_bias"] = (
                    f"{pre}['{norm}']['bias']", i)
        for part in ("attn", "ffn"):
            for key in leaves:
                if key.startswith(f"{pre}['{part}']"):
                    leaf = key[len(f"{pre}['{part}']['"):-2]
                    want[f"layers.{i}.{part}.{leaf}"] = (key, i)
    assert set(got) == set(want)
    assert {key for key, _ in want.values()} == set(leaves)
    for name, (key, i) in want.items():
        a = leaves[key] if i is None else leaves[key][i]
        np.testing.assert_array_equal(got[name], a, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_refuses_a_leftover_or_a_missing_leaf(arch):
    _, _, tree = arch_params(arch)
    cfg = reduced_config(arch).replace(compute_dtype="float32")
    extra = dict(tree, stray=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="stray"):
        from_jax_params(extra, cfg, "cpu")
    norm = dict(tree["final_norm"], shift=np.zeros(64, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        from_jax_params(dict(tree, final_norm=norm), cfg, "cpu")
    ffn = dict(tree["groups"]["0"]["ffn"])
    ffn.pop(sorted(ffn)[0])
    group = dict(tree["groups"]["0"], ffn=ffn)
    with pytest.raises(ValueError, match="ffn"):
        from_jax_params(dict(tree, groups={"0": group}), cfg, "cpu")
    # a tied tree under an untied config, and the other way round
    other = cfg.replace(tie_embeddings=not cfg.tie_embeddings)
    with pytest.raises(ValueError, match="lm_head"):
        from_jax_params(tree, other, "cpu")


# ----------------------------------------------------------------- model
def test_forward_matches_jax(pair):
    arch, dt, jm, jp, tm = pair
    toks = np.random.RandomState(1).randint(0, 512, (2, 12))
    lj, _ = jm.forward(jp, jnp.asarray(toks, jnp.int32))
    lt = tm(torch.from_numpy(toks))
    np.testing.assert_allclose(_np(lt), _np(lj), atol=_atol(dt, lj), rtol=0)


def _modality(cfg, b=2):
    return np.random.RandomState(2).standard_normal(
        (b, cfg.modality_tokens, cfg.modality_dim)).astype(np.float32)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_vlm_forward_with_modality_matches_jax(dt):
    """The projected modality tokens go first; their logits are dropped."""
    jm, jp, tree = arch_params(VLM, dt)
    tm = _port(VLM, tree, dt)
    toks = np.random.RandomState(1).randint(0, 512, (2, 12))
    mod = _modality(tm.cfg)
    lj, _ = jm.forward(jp, jnp.asarray(toks, jnp.int32), jnp.asarray(mod))
    lt = tm(torch.from_numpy(toks), torch.from_numpy(mod))
    assert lt.shape == (2, 12, tm.cfg.vocab_size)
    np.testing.assert_allclose(_np(lt), _np(lj), atol=_atol(dt, lj), rtol=0)
    # the modality changes the text's logits
    assert not np.allclose(_np(lt), _np(tm(torch.from_numpy(toks))))


def test_vlm_prefill_with_modality_matches_jax():
    """One-shot prefill with the modality tokens ahead of the prompt: the
    last logits and the dense caches (modality positions included)."""
    jm, jp, tree = arch_params(VLM)
    tm = _port(VLM, tree)
    toks = np.random.RandomState(3).randint(1, 512, (2, 12))
    mod = _modality(tm.cfg)
    js = jm.init_states(2, MAX_LEN)
    ts = tm.init_states(2, MAX_LEN)
    lj, js, _ = jm.prefill(jp, jnp.asarray(toks, jnp.int32), js,
                           modality=jnp.asarray(mod))
    lt, ts = tm.prefill(torch.from_numpy(toks), ts,
                        modality=torch.from_numpy(mod))
    np.testing.assert_allclose(_np(lt), _np(lj), atol=ATOL_F32, rtol=0)
    kv = js["groups"]["0"].kv
    for i, st in enumerate(ts):
        np.testing.assert_allclose(_np(st.kv.k), _np(kv.k[i]),
                                   atol=ATOL_F32, rtol=0)
        np.testing.assert_array_equal(st.kv.length.numpy(),
                                      np.asarray(kv.length[i]))
    assert ts[0].kv.length.tolist() == [20, 20]      # 8 modality + 12


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
def test_chunked_prefill_equals_one_shot(arch):
    """Inside the port, paged: a 21-token prompt in chunks of 8 leaves the
    last logits and the pool where one-shot prefill leaves them (an MoE at
    its reduced capacity, which drops nothing: under drops a chunk's
    capacity differs from the whole prompt's, in the reference too).  The
    modality model refuses chunked prefill, as the JAX one does."""
    jm, jp, tree = arch_params(arch)
    tm = _port(arch, tree)
    nb = MAX_LEN // BS
    prompt = np.random.RandomState(4).randint(1, 512, (1, 21))
    table = torch.arange(nb, dtype=torch.int32)[None]
    piece = np.zeros((1, 8), np.int64)
    piece[0] = prompt[0, :8]
    chunk = dict(length=torch.tensor([8], dtype=torch.int32),
                 offset=torch.tensor([0], dtype=torch.int32),
                 block_table=table)
    if arch == VLM:
        with pytest.raises(NotImplementedError, match="decoder-only token"):
            tm.prefill(torch.from_numpy(piece),
                       tm.init_states(1, MAX_LEN, kv_block_size=BS), **chunk)
        js = jm.init_states(1, MAX_LEN, kv_block_size=BS)
        with pytest.raises(NotImplementedError, match="decoder-only token"):
            jm.prefill(jp, jnp.asarray(piece, jnp.int32), js,
                       length=jnp.asarray([8], jnp.int32),
                       offset=jnp.asarray([0], jnp.int32),
                       block_table=jnp.asarray(table.numpy()))
        return
    one = tm.init_states(1, MAX_LEN, kv_block_size=BS)
    lo, one = tm.prefill(torch.from_numpy(prompt), one,
                         length=torch.tensor([21], dtype=torch.int32),
                         block_table=table)
    chunked = tm.init_states(1, MAX_LEN, kv_block_size=BS)
    for off in (0, 8, 16):
        piece = np.zeros((1, 8), np.int64)
        n = min(8, 21 - off)
        piece[0, :n] = prompt[0, off:off + n]
        lc, chunked = tm.prefill(
            torch.from_numpy(piece), chunked,
            length=torch.tensor([n], dtype=torch.int32),
            offset=torch.tensor([off], dtype=torch.int32), block_table=table)
    torch.testing.assert_close(lc, lo, atol=1e-5, rtol=0)
    assert int(lc.argmax()) == int(lo.argmax())
    for a, b in zip(one, chunked):
        torch.testing.assert_close(a.kv.k, b.kv.k, atol=1e-5, rtol=0)
        torch.testing.assert_close(a.kv.v, b.kv.v, atol=1e-5, rtol=0)
        assert torch.equal(a.kv.length, b.kv.length)


# ---------------------------------------------------------------- engine
KW = dict(slots=3, max_len=128, buckets=(16, 32), prefill_chunk=32)


def _trace(arch):
    """The engine trace: a prompt longer than the largest bucket (chunked)
    and a shared 20-token prefix (a prefix hit mid-block, paged) — for the
    modality model, which cannot chunk (in either package), prompts within
    the buckets only."""
    rng = np.random.RandomState(1)
    if arch == VLM:
        return [rng.randint(1, 512, n).tolist()
                for n in (5, 9, 14, 30, 26, 29)]
    shared = rng.randint(1, 512, 20).tolist()
    prompts = [rng.randint(1, 512, n).tolist() for n in (5, 9, 14, 70)]
    prompts.append(shared + rng.randint(1, 512, 6).tolist())
    return prompts + [shared + rng.randint(1, 512, 9).tolist()]


def _serve(engine, request_cls, prompts):
    first = engine.run([request_cls(rid=i, prompt=p, max_new_tokens=8)
                        for i, p in enumerate(prompts[:-1])])
    # the shared prefix is published once request 4 has prefilled
    second = engine.run([request_cls(rid=len(prompts) - 1,
                                     prompt=prompts[-1], max_new_tokens=8)])
    return [r.generated for r in first + second]


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine(arch, paged):
    jm, jp, tree = arch_params(arch)
    tm = _port(arch, tree)
    kw = dict(KW, kv_block_size=8) if paged else dict(KW)
    if arch == VLM:
        kw["prefix_cache"] = False
    jax_engine, engine = JaxEngine(jm, jp, **kw), ServeEngine(tm, **kw)
    prompts = _trace(arch)
    want = _serve(jax_engine, JaxRequest, prompts)
    got = _serve(engine, Request, prompts)
    assert got == want
    assert len({tuple(g) for g in got}) == len(got)    # tokens vary
    js, ts = jax_engine.stats, engine.stats
    assert (ts.prefill_calls, ts.prefill_chunks, ts.decode_steps) \
        == (js.prefill_calls, js.prefill_chunks, js.decode_steps)
    assert (ts.prefix_hits, ts.blocks_copied, ts.kv_blocks_peak) \
        == (js.prefix_hits, js.blocks_copied, js.kv_blocks_peak)
    if arch != VLM:
        assert ts.prefill_chunks >= 3
        assert ts.prefix_hits == (1 if paged else 0)
    assert engine.stats.summary()["nonfinite_logits"] == 0


# ------------------------------------------------------------- placement
@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
def test_plan_matches_reference_at_the_serving_geometry(arch):
    """The card's plan for the full-size arch at phase 6's geometry equals
    the JAX plan field for field, but for the kernel labels, which name the
    port's kernels: flash and paged decode for the attention cluster."""
    geo = dict(slots=4, max_len=1024, max_bucket=256)
    got = ExecutionOracle(get_config(arch), **geo).resolve()
    want = ref_placement.ExecutionOracle(ref_get_config(arch),
                                         backend="cpu", **geo).resolve()
    for f in PLAN_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    for p, q in zip(got.policies, want.policies, strict=True):
        for f in POLICY_FIELDS:
            assert getattr(p, f) == getattr(q, f), (p.cluster, f)
    variants = {k: p.variants for p in got.policies for k in p.kinds}
    assert variants["attn"] == ("cuda_flash", "cuda_paged")
    assert got.backend == "cuda" and all(p.kernel == "cuda"
                                         for p in got.policies)
