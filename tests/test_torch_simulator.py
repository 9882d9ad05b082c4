"""The port's fleet simulator (``tpu_operator_torch/simulator/``, ``gpu-sim``)
against the reference's (``tpu_operator/simulator/``, ``tpuop-sim``).

Twins of the 21 tests of tests/test_simulator.py, run on the port, then
the parity checks: the committed scenarios parse to equal dicts in both
packages (and the port's YAML reads back under PyYAML), the fuzzer samples
the same 25 scenarios at the pinned seed, ``seed_for`` derives the same
seeds, and each committed case at the pinned seed ends the same in both:
oracle names and verdicts, the settle tick, the injections (victims under
the name mapping), the Event counts and the terminal nodes after label
mapping. Everything is compared exactly: there is no floating-point kernel
here. The deliberate differences are in tests/test_torch_operator_mapping.py.
Then the harness pieces the engine added: the labeller's stamp on the pinned
clock, the informer's read barrier, the apiserver's fault hook, and the
node curve built from the card's frontier.
"""

import glob
import os

import pytest
import yaml

from test_torch_operator_mapping import (map_sim_injection, map_sim_name,
                                         map_sim_terminal)
from tpu_operator import simulator as ref_sim
from tpu_operator.simulator.fuzz import sample_scenario as ref_sample
from tpu_operator_torch import consts
from tpu_operator_torch import simulator as port_sim
from tpu_operator_torch.serving import frontier as frontier_schema
from tpu_operator_torch.simulator import (
    DEFAULT_SCENARIO_SEED,
    FleetSimulator,
    Injection,
    Scenario,
    ScenarioError,
    parse,
    parse_file,
    repro_command,
    resolve_seed,
    seed_for,
)
from tpu_operator_torch.simulator import engine
from tpu_operator_torch.simulator.fuzz import sample_scenario
from tpu_operator_torch.simulator.minimize import minimize

SCENARIO_DIR = os.path.join(os.path.dirname(__file__), "cases", "scenarios")
SCENARIOS = sorted(glob.glob(os.path.join(SCENARIO_DIR, "*.yaml")))
IDS = [os.path.splitext(os.path.basename(p))[0] for p in SCENARIOS]

_RUNS = {}


def _run(package: str, path: str, seed: int) -> dict:
    """One run of a committed case, kept for the module: the twins and the
    parity checks read the same runs."""
    key = (package, path, seed)
    if key not in _RUNS:
        sim = ref_sim if package == "reference" else port_sim
        _RUNS[key] = sim.FleetSimulator(sim.parse_file(path), seed=seed).run()
    return _RUNS[key]


# -- seeds --------------------------------------------------------------------------

def test_seed_for_is_stable_across_processes():
    assert seed_for(20260806, "node-chaos") == seed_for(20260806, "node-chaos")
    assert seed_for(20260806, "node-chaos") != seed_for(20260806, "pod-chaos")
    assert seed_for(1, "traffic") != seed_for(2, "traffic")
    assert 0 <= seed_for(20260806, "traffic") < 2 ** 32


def test_resolve_seed_precedence(monkeypatch):
    monkeypatch.delenv("SCENARIO_SEED", raising=False)
    assert resolve_seed(None) == DEFAULT_SCENARIO_SEED == 20260806
    monkeypatch.setenv("SCENARIO_SEED", "99")
    assert resolve_seed(None) == 99
    assert resolve_seed(7) == 7


def test_repro_command_forms():
    assert repro_command(5, case="tests/cases/scenarios/x.yaml") == (
        "SCENARIO_SEED=5 python -m tpu_operator_torch.cmd.sim run "
        "tests/cases/scenarios/x.yaml")
    cmd = repro_command(5, budget=25, index=3)
    assert "--seed 5" in cmd and "--budget 25" in cmd and "--index 3" in cmd
    assert "tpu_operator_torch.cmd.sim fuzz" in cmd


# -- DSL ----------------------------------------------------------------------------

def test_injection_compact_string_forms():
    i = Injection.from_string("az_loss(frac=0.3) at t=drain_open")
    assert i.kind == "az_loss" and i.params["frac"] == 0.3
    assert i.when == "drain_open" and i.at is None
    i = Injection.from_string(
        "apiserver_brownout(p=0.4, dur=60) during migration.restoring")
    assert i.params == {"p": 0.4, "dur": 60}
    assert i.when == "migration.restoring"
    i = Injection.from_string("thundering_herd(join=1000) during upgrade")
    assert i.params["join"] == 1000 and i.when == "upgrade"
    i = Injection.from_string("revocation_wave(frac=0.2) at scale_up")
    assert i.when == "scale_up"
    i = Injection.from_string("pod_chaos(kills=3) at t=12")
    assert i.at == 12 and i.when is None
    i = Injection.from_string("az_loss(frac=0.5)")
    assert i.when == "start"


def test_injection_rejects_garbage():
    with pytest.raises(ScenarioError):
        Injection.from_string("launch_missiles(frac=1.0) at 3")
    with pytest.raises(ScenarioError):
        Injection.from_string("az_loss(blast_radius=1.0)")
    with pytest.raises(ScenarioError):
        Injection.from_string("az_loss(frac=0.5) during no_such_condition")
    with pytest.raises(ScenarioError):
        Injection(kind="az_loss", params={}, at=3, when="start")


def test_scenario_parse_round_trips():
    sc = parse({
        "name": "rt", "operation": "autoscale",
        "fleet": {"size": 6, "preemptible": False, "zones": 3},
        "ticks": 32,
        "injections": [
            "az_loss(frac=0.5) at t=drain_open",
            {"apiserver_brownout": {"p": 0.2, "dur": 30}, "at": 4},
        ],
    })
    assert sc.fleet == 6 and not sc.preemptible and sc.zones == 3
    assert sc.injections[0].when == "drain_open"
    assert sc.injections[1].at == 4
    assert parse(sc.to_yaml()).to_dict() == sc.to_dict()


def test_scenario_validation():
    with pytest.raises(ScenarioError):
        parse({"name": "x", "operation": "defragment"})
    with pytest.raises(ScenarioError):
        parse({"name": "x", "operation": "migrate", "fleet": 1})
    with pytest.raises(ScenarioError):
        parse("][ not yaml }{")
    with pytest.raises(ScenarioError):
        parse("just a string")


def test_committed_scenarios_parse():
    assert len(SCENARIOS) >= 4
    names = set()
    for path in SCENARIOS:
        sc = parse_file(path)
        assert sc.name == os.path.splitext(os.path.basename(path))[0]
        names.add(sc.name)
    assert {"az-loss-mid-drain", "brownout-mid-migration",
            "herd-join-mid-upgrade",
            "revocation-wave-mid-scale-up"} <= names


# -- fuzzer sampling ----------------------------------------------------------------

def test_sample_scenario_is_deterministic():
    a = sample_scenario(20260806, 3)
    b = sample_scenario(20260806, 3)
    assert a.to_dict() == b.to_dict()
    assert sample_scenario(20260806, 4).to_dict() != a.to_dict()
    assert sample_scenario(20260806, 7).to_dict() == \
        sample_scenario(20260806, 7).to_dict()


# -- minimizer ----------------------------------------------------------------------

def test_minimize_shrinks_to_the_guilty_injection():
    sc = Scenario(name="min", operation="autoscale", fleet=8, ticks=64,
                  injections=[
                      Injection(kind="az_loss", params={}, at=2),
                      Injection(kind="pod_chaos", params={}, at=3),
                      Injection(kind="thundering_herd", params={}, at=4),
                  ])

    def failing(candidate, seed):
        return (any(i.kind == "az_loss" for i in candidate.injections)
                and candidate.fleet >= 4)

    shrunk, runs = minimize(sc, seed=1, failing=failing)
    assert [i.kind for i in shrunk.injections] == ["az_loss"]
    assert shrunk.fleet == 4
    assert shrunk.ticks < sc.ticks
    assert runs <= 24


def test_minimize_keeps_fixed_tick_injections_inside_timeline():
    sc = Scenario(name="min2", operation="autoscale", fleet=4, ticks=64,
                  injections=[Injection(kind="az_loss", params={}, at=20)])
    shrunk, _ = minimize(sc, seed=1, failing=lambda c, s: True)
    assert shrunk.ticks > 20


def test_minimize_tolerates_erroring_candidates():
    sc = Scenario(name="min3", operation="autoscale", fleet=8, ticks=32,
                  injections=[Injection(kind="az_loss", params={}, at=1)])

    def failing(candidate, seed):
        if candidate.fleet < 8:
            raise RuntimeError("boom")
        return True

    shrunk, _ = minimize(sc, seed=1, failing=failing)
    assert shrunk.fleet == 8


# -- engine: determinism ------------------------------------------------------------

def test_double_run_is_byte_identical():
    sc = parse({
        "name": "det", "operation": "autoscale",
        "fleet": {"size": 3, "preemptible": True, "zones": 2},
        "ticks": 12,
        "injections": ["revocation_wave(frac=0.34) at 4"],
    })
    r1 = FleetSimulator(sc, seed=11).run()
    r2 = FleetSimulator(sc, seed=11).run()
    assert r1["canonical"] == r2["canonical"]
    assert r1["injections_applied"] == r2["injections_applied"]


def test_different_seeds_diverge():
    sc = parse({
        "name": "div", "operation": "autoscale",
        "fleet": {"size": 4, "preemptible": True, "zones": 2},
        "ticks": 12,
        "injections": ["revocation_wave(frac=0.5) at 4"],
    })
    r1 = FleetSimulator(sc, seed=1).run()
    r2 = FleetSimulator(sc, seed=2).run()
    assert (r1["injections_applied"] != r2["injections_applied"]
            or r1["canonical"] != r2["canonical"])


# -- engine: the committed cases ------------------------------------------------------

@pytest.mark.parametrize("path", SCENARIOS, ids=IDS)
def test_committed_scenario_replays_green(path):
    seed = resolve_seed(None)
    report = _run("port", path, seed)
    failed = [o for o in report["oracles"] if not o["ok"]]
    assert report["ok"], (
        "; ".join(f"{o['name']}: {o['detail']}" for o in failed)
        + f"\n  repro: {repro_command(seed, case=path)}")
    assert not report["injections_unfired"], report["injections_unfired"]


def test_revocation_during_upgrade_drain_window():
    """NodeChaos eats a node while the upgrade machine has it in the drain
    window: no node stuck in progress, no duplicate protocol Event, and the
    survivors all roll."""
    seed = resolve_seed(None)
    scenario = parse({
        "name": "revoke-in-upgrade-drain",
        "operation": "upgrade",
        "fleet": {"size": 4, "preemptible": True, "zones": 2},
        "ticks": 48,
        "injections": [
            {"revocation_wave": {"frac": 0.25, "target": "draining"},
             "when": "upgrade.draining"},
        ],
    })
    report = FleetSimulator(scenario, seed=seed).run()
    oracles = {o["name"]: o for o in report["oracles"]}
    fired = [r for r in report["injections_applied"]
             if r["kind"] == "revocation_wave"]
    assert fired and fired[0]["victims"]
    assert fired[0]["victims"][0] not in report["terminal"]
    for name in ("no_stuck_upgrade", "exactly_once_events", "converged", "upgrade_rolled"):
        assert oracles[name]["ok"], oracles[name]["detail"]


# -- artifacts ----------------------------------------------------------------------

def test_failure_bundle_contents(tmp_path):
    from tpu_operator_torch.simulator.artifacts import dump, failure_banner

    sc = parse({
        "name": "bundle-check", "operation": "autoscale",
        "fleet": {"size": 3, "preemptible": True, "zones": 2},
        "ticks": 8,
    })
    sim = FleetSimulator(sc, seed=3)
    report = sim.run()
    bundle = dump(str(tmp_path), sc, report, seed=3, sim=sim)
    for name in ("scenario.yaml", "repro.txt", "report.json",
                 "journal.jsonl", "timeline.json", "nodes.json",
                 "events.json", "canonical.log"):
        assert os.path.exists(os.path.join(bundle, name)), name
    with open(os.path.join(bundle, "repro.txt")) as f:
        assert "SCENARIO_SEED=3" in f.read()
    assert parse_file(os.path.join(bundle, "scenario.yaml")).name == "bundle-check"
    banner = failure_banner(sc, report, seed=3, bundle=bundle)
    assert "repro:" in banner and "SCENARIO_SEED=3" in banner


# -- parity with the reference --------------------------------------------------------

@pytest.mark.parametrize("path", SCENARIOS, ids=IDS)
def test_a_committed_case_parses_as_the_reference_s(path):
    port = parse_file(path)
    assert port.to_dict() == ref_sim.parse_file(path).to_dict()
    assert yaml.safe_load(port.to_yaml()) == port.to_dict()


def test_the_fuzzer_samples_the_reference_s_scenarios():
    for i in range(25):
        assert sample_scenario(DEFAULT_SCENARIO_SEED, i).to_dict() == \
            ref_sample(DEFAULT_SCENARIO_SEED, i).to_dict(), i


def test_seed_for_gives_the_reference_s_seeds():
    names = ("traffic", "pod-chaos", "node-chaos", "client-chaos", "brownout",
             "injections", "retry-jitter", "feeder-jitter", "fuzz-0", "scenario-24")
    for root in (0, 1, DEFAULT_SCENARIO_SEED):
        assert [seed_for(root, n) for n in names] == [ref_sim.seed_for(root, n) for n in names]


def _assert_same_end(port: dict, ref: dict) -> None:
    assert [(o["name"], o["ok"]) for o in port["oracles"]] == \
        [(o["name"], o["ok"]) for o in ref["oracles"]]
    assert port["settled_at_tick"] == ref["settled_at_tick"]
    assert [map_sim_injection(r) for r in port["injections_applied"]] == \
        [map_sim_injection(r) for r in ref["injections_applied"]]
    assert port["event_counts"] == ref["event_counts"]
    assert port["terminal"] == map_sim_terminal(ref["terminal"])
    assert port["node_deletes"] == ref["node_deletes"]


@pytest.mark.parametrize("path", SCENARIOS, ids=IDS)
def test_a_committed_case_ends_as_the_reference_s(path):
    port = _run("port", path, DEFAULT_SCENARIO_SEED)
    ref = _run("reference", path, DEFAULT_SCENARIO_SEED)
    _assert_same_end(port, ref)
    assert not port["reconcile_errors"] and not ref["reconcile_errors"]


def _sampled_ends_as_the_reference_s(index: int) -> None:
    seed = seed_for(DEFAULT_SCENARIO_SEED, f"scenario-{index}")
    port = FleetSimulator(sample_scenario(DEFAULT_SCENARIO_SEED, index), seed=seed).run()
    ref = ref_sim.FleetSimulator(ref_sample(DEFAULT_SCENARIO_SEED, index), seed=seed).run()
    _assert_same_end(port, ref)


@pytest.mark.parametrize("index", [1, 4, 10])
def test_a_sampled_scenario_ends_as_the_reference_s(index):
    """Fuzz scenarios whose outcome hangs on sorted node names (a herd
    scaled down in name order, a revocation wave's victims on a migration
    and under a brownout): the port's names sort as the reference's, so the
    same seed draws the same victims. The whole pinned sweep takes minutes:
    ``PYTHONPATH=. python tests/test_torch_simulator.py``."""
    _sampled_ends_as_the_reference_s(index)


# -- the card's curve -----------------------------------------------------------------

def test_the_node_curve_is_the_card_s_times_its_gpus():
    """With no drift the measured path and the GPU-constant path agree: the
    nominal per-GPU rate is the node curve's best at the SLO after the
    annotation's round trip, over the node's GPUs."""
    from tpu_operator_torch.state.nodepool import get_node_pools
    from tpu_operator_torch.testing.kubelet import GPUS_PER_NODE
    from tpu_operator_torch.validator.feature_discovery import chip_type_from_kind

    assert engine.GPUS_PER_NODE == GPUS_PER_NODE == 8
    sim = FleetSimulator(parse_file(SCENARIOS[0]))
    driver = engine._AutoscaleDriver(sim)
    curve = frontier_schema.decode_annotation(driver._healthy_frontier_value())
    best = curve.best_tokens_per_s(engine.MAX_P99_MS)
    assert GPUS_PER_NODE * driver.tokens_per_gpu == best > 0
    assert engine.tokens_per_gpu(engine.CARD_FRONTIER) == driver.tokens_per_gpu
    card_best = max(t for _, p99, t in engine.CARD_FRONTIER if p99 <= engine.MAX_P99_MS)
    assert best == pytest.approx(GPUS_PER_NODE * card_best, rel=1e-5)  # 6 figures
    [pool] = get_node_pools([engine.gpu_node("gpu-000", "z0", True)])
    assert pool.name == driver.POOL  # preemptiblePools names the fleet's pool
    card_name = engine.CARD_FRONTIER_CARD.split(",")[0]
    assert chip_type_from_kind(card_name) == engine.GPU_MODEL


AUTOSCALE_CASES = [p for p in SCENARIOS if parse_file(p).operation == "autoscale"]


@pytest.mark.parametrize("path", AUTOSCALE_CASES,
                         ids=[os.path.splitext(os.path.basename(p))[0] for p in AUTOSCALE_CASES])
def test_another_card_s_curve_changes_no_decision(path):
    """The canonical log holds no token figure: the autoscaler reads ratios,
    so a card half as fast with other depths decides the same."""
    other = [(b, p99 * 1.5, t * 0.37) for b, p99, t in engine.CARD_FRONTIER]
    report = FleetSimulator(parse_file(path), seed=DEFAULT_SCENARIO_SEED,
                            frontier=other).run()
    assert report["canonical"] == _run("port", path, DEFAULT_SCENARIO_SEED)["canonical"]


# -- the harness pieces ----------------------------------------------------------------

def test_the_labeller_stamps_the_pinned_clock():
    """The image pre-pull stamp reads utils.clock, which the simulator pins
    to its virtual clock, as the reference's labeller does."""
    from tpu_operator_torch.api.clusterpolicy import ClusterPolicy, new_cluster_policy
    from tpu_operator_torch.client.fake import FakeClient
    from tpu_operator_torch.nodeinfo.labeler import label_gpu_nodes
    from tpu_operator_torch.utils import clock

    client = FakeClient(objects=[engine.gpu_node("gpu-000", "z0", False)])
    policy = ClusterPolicy.from_obj(new_cluster_policy())
    with clock.pinned(lambda: 1234.5):
        label_gpu_nodes(client, policy)
    annotations = client.get("v1", "Node", "gpu-000")["metadata"]["annotations"]
    assert annotations[consts.IMAGE_PREPULL_ANNOTATION] == "1234.500"


def test_the_read_barrier_waits_for_the_watch():
    """``wait_caught_up`` returns once every informer's watch delivered the
    backend's newest event of its scope; a write-through does not count."""
    from tpu_operator_torch.client.cache import CachedClient
    from tpu_operator_torch.client.fake import FakeClient

    backend = FakeClient()
    cached = CachedClient(backend)
    try:
        assert cached.list("v1", "Node") == []
        assert cached.wait_caught_up(backend.last_event_rv, timeout=5.0)
        for i in range(5):
            backend.create(engine.gpu_node(f"gpu-{i:03d}", "z0", False))
        assert cached.wait_caught_up(backend.last_event_rv, timeout=5.0)
        assert [n["metadata"]["name"] for n in cached.list("v1", "Node")] == \
            [f"gpu-{i:03d}" for i in range(5)]
        [informer] = cached._informers.values()
        watermark = informer.max_rv
        informer.apply("MODIFIED", dict(backend.get("v1", "Node", "gpu-000"),
                                        metadata={"name": "gpu-000",
                                                  "resourceVersion": str(watermark + 100)}))
        assert informer.max_rv == watermark
        assert not informer.caught_up(watermark + 1)
    finally:
        cached.stop()


def test_the_apiserver_s_fault_hook_and_latency():
    """The brownout's hook fails requests with its code (a write's body read
    off the connection first), leaves watches alone, and ``latency_s``
    delays every request."""
    import time

    from tpu_operator_torch.client.errors import ApiError
    from tpu_operator_torch.client.rest import RestClient
    from tpu_operator_torch.testing.apiserver import MiniApiServer

    srv = MiniApiServer(latency_s=0.05)
    client = RestClient(srv.start())
    try:
        client.create(engine.gpu_node("gpu-000", "z0", False))
        srv.fault = lambda method, path: 503 if method == "PATCH" else None
        with pytest.raises(ApiError) as err:
            client.patch("v1", "Node", "gpu-000", {"metadata": {"labels": {"a": "b"}}})
        assert err.value.code == 503
        t = time.monotonic()
        assert client.get("v1", "Node", "gpu-000")["metadata"]["name"] == "gpu-000"
        assert time.monotonic() - t >= 0.05
        srv.fault = None
        client.patch("v1", "Node", "gpu-000", {"metadata": {"labels": {"a": "b"}}})
        assert srv.backend.get("v1", "Node", "gpu-000")["metadata"]["labels"]["a"] == "b"
    finally:
        client.stop()
        srv.stop()



def test_latency_delays_each_request_on_a_kept_alive_connection():
    """Two requests on one kept-alive connection, the second after an idle
    gap longer than ``latency_s``: each answer comes at least ``latency_s``
    after its request was sent (the delay starts once a request is read,
    so it cannot hide in the gap)."""
    import http.client
    import time
    import urllib.parse

    from tpu_operator_torch.testing.apiserver import MiniApiServer

    latency_s = 0.05
    srv = MiniApiServer(latency_s=latency_s)
    url = urllib.parse.urlparse(srv.start())
    srv.backend.create(engine.gpu_node("gpu-000", "z0", False))
    conn = http.client.HTTPConnection(url.hostname, url.port, timeout=10)
    try:
        waits = []
        for gap in (0.0, 3 * latency_s):
            time.sleep(gap)
            t = time.monotonic()
            conn.request("GET", "/api/v1/nodes/gpu-000")
            answer = conn.getresponse()
            body = answer.read()
            waits.append(time.monotonic() - t)
            assert answer.status == 200, body
        assert conn.sock is not None  # still the first connection
        assert min(waits) >= latency_s, waits
    finally:
        conn.close()
        srv.stop()

def test_a_fleet_name_maps_to_the_reference_s():
    assert map_sim_name("tpu-004") == "node-004"
    assert map_sim_name("v5-lite-podslice-4x4-a3") == f"{engine.GPU_MODEL}-a3"
    assert map_sim_name("herd-0002") == "herd-0002"
    assert map_sim_name("job-tpu-002") == "gpu-consumer-node-002"
    assert map_sim_name("libtpu-driver-herd-0001") == "gpu-driver-herd-0001"
    assert map_sim_name("tpu-operator-validator-tpu-001") == "gpu-operator-validator-node-001"
    # the port's node names and pod names each sort as the reference's, so a
    # seeded draw picks the same victims
    nodes = ["tpu-001", "herd-0003", "v5-lite-podslice-4x4-a1", "tpu-000"]
    pods = ["job-tpu-001", "libtpu-driver-tpu-001", "tpu-feature-discovery-herd-0003",
            "tpu-operator-validator-tpu-001", "tpu-telemetry-exporter-tpu-000"]
    for ref in (nodes, pods):
        assert [map_sim_name(n) for n in sorted(ref)] == sorted(map_sim_name(n) for n in ref)


if __name__ == "__main__":
    # the scenario-fuzz gate's 25 sampled scenarios at the pinned seed, each
    # run by both packages and required to end the same
    for i in range(25):
        _sampled_ends_as_the_reference_s(i)
        print(f"fuzz-{DEFAULT_SCENARIO_SEED}-{i}: ends as the reference's", flush=True)
