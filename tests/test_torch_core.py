"""The port's copies of the Mensa framework (``repro_torch.core``) against
the JAX package's (``repro.core``) on the 24 edge models of each package's
zoo copy.  Both run the same float64 arithmetic in the same order, so every
number is held with ``==``: characterization, rule clusters, the two-phase
schedule, the four system costs, the zoo summary, the variation report, the
strict fraction, seeded k-means labels and centroids, the rule-vs-k-means
agreement, and every field of the six accelerator configs."""
import dataclasses
from pathlib import Path

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core as ref  # noqa: E402
import repro_torch.core as port  # noqa: E402
from repro.edge import edge_zoo as ref_zoo  # noqa: E402
from repro_torch.core import accelerators as port_accelerators  # noqa: E402
from repro_torch.edge import edge_zoo  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ACCELERATORS = ("EDGE_TPU", "BASE_HB", "EYERISS_V2", "PASCAL", "PAVLOV",
                "JACQUARD")


def _plain(obj):
    """A dataclass as a dict of plain values (enums by value, nested
    dataclasses as dicts), so copies of one class from two packages
    compare."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            v = _plain(v)
        elif hasattr(v, "value"):
            v = v.value
        out[f.name] = v
    return out


def _cost(c) -> dict:
    """Every number of a ScheduleCost, its per-layer costs included."""
    return {
        "model": c.model, "latency_s": c.latency_s, "flops": c.flops,
        "energy": _plain(c.energy), "energy_total": c.energy.total,
        "transfer_bytes": c.transfer_bytes, "stage_time_s": c.stage_time_s,
        "throughput_flops": c.throughput_flops,
        "efficiency_flops_per_j": c.efficiency_flops_per_j,
        "per_layer": [_plain(lc) for lc in c.per_layer],
    }


@pytest.fixture(scope="module")
def chars():
    return port.characterize_zoo(edge_zoo()), ref.characterize_zoo(ref_zoo())


# ---------------------------------------------------------- per model
@pytest.mark.parametrize("idx", range(24))
def test_characterize_and_cluster_match_reference(idx):
    got_g, ref_g = edge_zoo()[idx], ref_zoo()[idx]
    assert got_g.name == ref_g.name
    got, want = port.characterize_model(got_g), ref.characterize_model(ref_g)
    assert [_plain(c) for c in got] == [_plain(c) for c in want]
    assert [c.compute_centric for c in got] \
        == [c.compute_centric for c in want]
    assert [_plain(port.rule_cluster(c)) for c in got] \
        == [_plain(ref.rule_cluster(c)) for c in want]


@pytest.mark.parametrize("policy", ["cluster", "cost"])
@pytest.mark.parametrize("idx", range(24))
def test_schedule_and_evaluation_match_reference(idx, policy):
    got_g, ref_g = edge_zoo()[idx], ref_zoo()[idx]
    got = port.MensaScheduler(policy=policy).schedule(got_g)
    want = ref.MensaScheduler(policy=policy).schedule(ref_g)
    assert got.accelerator_names() == want.accelerator_names()
    assert got.clusters == want.clusters
    assert [a.name for a in got.phase1_mapping] \
        == [a.name for a in want.phase1_mapping]
    assert got.n_remapped == want.n_remapped
    got_r = port.evaluate_model(got_g, policy=policy)
    want_r = ref.evaluate_model(ref_g, policy=policy)
    assert (got_r.model, got_r.family) == (want_r.model, want_r.family)
    for system in ("baseline", "base_hb", "eyeriss", "mensa"):
        assert _cost(getattr(got_r, system)) \
            == _cost(getattr(want_r, system)), system


# ---------------------------------------------------------- whole zoo
def test_zoo_summary_matches_reference():
    got = port.summarize(port.evaluate_zoo(edge_zoo()))
    want = ref.summarize(ref.evaluate_zoo(ref_zoo()))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert all(np.isfinite(v) for v in dataclasses.astuple(got))


def test_variation_report_and_strict_fraction_match_reference(chars):
    got, want = chars
    assert port.variation_report(got) == ref.variation_report(want)
    for pad in (1.0, 2.5):
        assert port.strict_fraction(got, pad) \
            == ref.strict_fraction(want, pad)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_kmeans_matches_reference_under_a_seed(chars, seed):
    got, want = chars
    gl, gc = port.kmeans_cluster(got, seed=seed)
    wl, wc = ref.kmeans_cluster(want, seed=seed)
    assert np.array_equal(gl, wl) and np.array_equal(gc, wc)
    again, _ = port.kmeans_cluster(got, seed=seed)
    assert np.array_equal(again, gl)


def test_agreement_and_cluster_all_match_reference(chars):
    got, want = chars
    assert port.agreement(got) == ref.agreement(want)
    assert [_plain(a) for a in port.cluster_all(got)] \
        == [_plain(a) for a in ref.cluster_all(want)]


# ---------------------------------------------------------- accelerators
@pytest.mark.parametrize("name", ACCELERATORS)
def test_accelerator_config_matches_reference(name):
    got, want = getattr(port, name), getattr(ref, name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.n_pes, got.freq_hz) == (want.n_pes, want.freq_hz)
    assert port.by_name(got.name) == got


def test_accelerator_maps_match_reference():
    assert {c: a.name for c, a in port.CLUSTER_TO_ACCELERATOR.items()} \
        == {c: a.name for c, a in ref.CLUSTER_TO_ACCELERATOR.items()}
    assert [a.name for a in port.MENSA_ACCELERATORS] \
        == [a.name for a in ref.MENSA_ACCELERATORS]
    assert dataclasses.asdict(port.DEFAULT_ENERGY) \
        == dataclasses.asdict(ref.DEFAULT_ENERGY)
    assert sorted(port.__all__) == sorted(ref.__all__)


def test_port_holds_no_datacenter_chip_rates():
    """The copy leaves out the JAX package's datacenter-chip config: no
    TPU chip's rate enters the port."""
    assert not hasattr(port_accelerators, "HostChipConfig")
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        text = path.read_text()
        assert "TPU_V5E" not in text and "tpu_v5e" not in text, path
