"""The port's disaggregated serving for the recurrent state families
against the JAX package's meshless ``DisaggEngine``, float32:
recurrentgemma-2b cut to its (rec, rec, local) pattern, with dense KV and a
16-token window ring that the 40-token prompt and its decode wrap, and
falcon-mamba-7b with its conv and SSM states.  The pair serves the
interleaved engine's tokens, one handoff a request, and its suitcase moves
a slot's ring and recurrent rows bit for bit."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

from test_torch_disagg import (IDENTITY_KW, check_pair,  # noqa: E402
                               check_suitcase, family, identity_trace,
                               serve_four_ways)
from test_torch_model import RG_GAIN  # noqa: E402
from test_torch_mamba import FM_GAIN  # noqa: E402

GAINS = {"recurrentgemma-2b": RG_GAIN, "falcon-mamba-7b": FM_GAIN}


@pytest.fixture(scope="module", params=sorted(GAINS))
def models(request):
    return request.param, family(request.param, gain=GAINS[request.param])


def test_disagg_engine_token_identity(models):
    arch, fam = models
    dis, jax_dis, *_ = serve_four_ways(
        fam, lambda cls: identity_trace(cls, 512), slots=8,
        prefill_slots=4, decode_slots=8, **IDENTITY_KW)
    s = check_pair(dis, jax_dis, 6)
    assert s["roles"]["prefill"]["prefill_chunks"] >= 2
    assert "kv" not in s["roles"]["decode"]
    assert set(fam[2].kinds) == ({"rec", "local"}
                                 if arch == "recurrentgemma-2b" else {"ssm"})


def test_suitcase_moves_rings_and_recurrent_rows_bit_for_bit(models):
    _, fam = models
    pre, dec = check_suitcase(fam[2])
    local = [st.kv for st in dec.states if st.kv is not None]
    # the ring's length (and with it its write position) crossed intact
    assert all(int(kv.length[1]) == 27 for kv in local)
