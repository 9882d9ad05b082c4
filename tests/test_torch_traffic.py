"""The serving-traffic mix (``tpu_operator_torch/serving/traffic.py``) against
the reference's (``tpu_operator/serving/traffic.py``): the same inputs give
equal dicts, exactly (the arithmetic is Python floats in the same order,
so there is no tolerance), for the plain, unplanned re-tile, planned,
migrate and sampled forms at three seeds; then the twins of the traffic
cases of tests/test_serving.py, run on the port. The one difference, the
fallback layout with no handoff, is
``test_torch_operator_mapping.TRAFFIC_FALLBACK_SLICES``.
"""

import pytest

from test_torch_operator_mapping import TRAFFIC_FALLBACK_SLICES
from tpu_operator.serving import traffic as ref_traffic
from tpu_operator_torch.serving.traffic import run_scenario, scenario_from_handoff

#: the handoff's groups as the port's partitioner writes them: GPU groups by
#: link class (the reference's tests use three 2x2 slices of 4 chips)
GROUPS = [{"topology": "nvlink", "chips": [0, 1, 2, 3]},
          {"topology": "nvlink", "chips": [4, 5, 6, 7]},
          {"topology": "nvlink", "chips": [8, 9, 10, 11]}]
#: tests/test_serving.py's sustained load
HEAVY = dict(duration_s=120.0, arrival_rate_per_s=3.0, per_token_ms=25.0,
             queue_slo_s=1.0)

FORMS = {
    "plain": {},
    "unplanned-retile": {"retile": {"at": 60.0, "blocked": [1], "drain_window_s": 10.0}},
    "planned": {"retile": {"at": 60.0, "blocked": [1], "drain_window_s": 10.0,
                           "planned": True}},
    "migrate": {"retile": {"at": 60.0, "blocked": [1], "drain_window_s": 10.0,
                           "planned": True, "migrate": True, "migrate_latency_s": 0.5}},
    "sampled": {"sample_interval_s": 5.0},
}


@pytest.mark.parametrize("seed", [7, 4242, 20260805])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_run_scenario_gives_the_reference_s_dict(form, seed):
    kwargs = dict(HEAVY, seed=seed, **FORMS[form])
    port = run_scenario(GROUPS, **kwargs)
    assert port == ref_traffic.run_scenario(GROUPS, **kwargs)
    assert port["unhandled_errors"] == 0
    if form == "sampled":
        assert len(port["timeseries"]) == int(HEAVY["duration_s"] / 5.0) + 1
    if form == "migrate":
        assert port["retile"]["migrated_tenants"] > 0


def test_scenario_from_handoff_gives_the_reference_s_dict():
    handoff = {"partition": "two-halves", "groups": GROUPS[:2]}
    kwargs = dict(seed=3, duration_s=30.0, sample_interval_s=1.0)
    assert scenario_from_handoff(handoff, **kwargs) == \
        ref_traffic.scenario_from_handoff(handoff, **kwargs)


# -- twins of tests/test_serving.py's traffic cases --------------------------------

def test_traffic_scenario_deterministic():
    a = run_scenario(GROUPS, seed=7, duration_s=30.0, arrival_rate_per_s=2.0,
                     per_token_ms=5.0)
    b = run_scenario(GROUPS, seed=7, duration_s=30.0, arrival_rate_per_s=2.0,
                     per_token_ms=5.0)
    assert a == b
    c = run_scenario(GROUPS, seed=8, duration_s=30.0, arrival_rate_per_s=2.0,
                     per_token_ms=5.0)
    assert c != a


def test_traffic_scenario_conserves_requests():
    out = run_scenario(GROUPS, seed=3, **HEAVY)
    assert out["arrivals"] == (out["completed"] + out["rejected"]
                               + out["incomplete"])
    assert out["unhandled_errors"] == 0
    assert out["latency_p99_s"] >= out["latency_p50_s"]
    assert "retile" not in out


def test_traffic_retile_drains_and_replaces_within_window():
    out = run_scenario(
        GROUPS, seed=20260805,
        retile={"at": 60.0, "blocked": [1], "drain_window_s": 10.0},
        **HEAVY)
    assert out["unhandled_errors"] == 0
    assert out["slices"][1]["blocked"] is True
    rt = out["retile"]
    assert rt["drained_tenants"] > 0
    assert rt["all_replaced_within_window"] is True
    assert rt["replaced_within_window"] == rt["drained_tenants"]
    assert 0 < rt["max_replace_s"] <= 10.0
    assert out["preemptions"] > 0
    assert out["placement_churn"] >= out["preemptions"]


def test_traffic_planned_drain_migrates_before_deadline():
    out = run_scenario(
        GROUPS, seed=20260805,
        retile={"at": 60.0, "blocked": [1], "drain_window_s": 10.0,
                "planned": True},
        **HEAVY)
    assert out["unhandled_errors"] == 0
    assert out["slices"][1]["blocked"] is True
    rt = out["retile"]
    assert rt["planned"] is True
    assert rt["drained_tenants"] > 0
    assert rt["drained_within_window"] == rt["drained_tenants"]
    assert rt["all_drained_within_window"] is True
    assert 0 < rt["max_replace_s"] <= 10.0


def test_traffic_planned_vs_unplanned_drain_clock():
    common = dict(seed=4242, **HEAVY)
    unplanned = run_scenario(
        GROUPS, retile={"at": 60.0, "blocked": [1],
                        "drain_window_s": 10.0}, **common)
    planned = run_scenario(
        GROUPS, retile={"at": 60.0, "blocked": [1], "drain_window_s": 10.0,
                        "planned": True}, **common)
    assert unplanned["retile"]["planned"] is False
    assert planned["retile"]["planned"] is True
    for out in (unplanned, planned):
        assert out["unhandled_errors"] == 0
        assert out["arrivals"] == (out["completed"] + out["rejected"]
                                   + out["incomplete"])


def test_traffic_interactive_preempts_batch():
    out = run_scenario([{"chips": [0, 1, 2, 3]}], seed=11,
                       duration_s=60.0, arrival_rate_per_s=4.0,
                       per_token_ms=40.0)
    assert out["preemptions"] > 0
    assert out["unhandled_errors"] == 0


def test_traffic_soak_retile_under_sustained_load():
    out = run_scenario(
        GROUPS, seed=20260805, duration_s=600.0, arrival_rate_per_s=3.0,
        per_token_ms=25.0, queue_slo_s=1.0,
        retile={"at": 300.0, "blocked": [2], "drain_window_s": 10.0})
    assert out["unhandled_errors"] == 0
    assert out["arrivals"] > 1000
    assert out["arrivals"] == (out["completed"] + out["rejected"]
                               + out["incomplete"])
    rt = out["retile"]
    assert rt["drained_tenants"] > 0
    assert rt["all_replaced_within_window"] is True
    assert out["slo_attainment"] is not None


def test_scenario_from_handoff_falls_back_to_single_slice():
    """With no handoff the port plays the mix over one group of one GPU,
    where the reference's falls back to one 4-chip slice."""
    out = scenario_from_handoff(None, seed=1, duration_s=10.0)
    assert out["slices"] == TRAFFIC_FALLBACK_SLICES["port"]
    assert ref_traffic.scenario_from_handoff(None, seed=1, duration_s=10.0)["slices"] == \
        TRAFFIC_FALLBACK_SLICES["reference"]
    out = scenario_from_handoff({"groups": GROUPS}, seed=1, duration_s=10.0)
    assert len(out["slices"]) == 3
