"""GPU groups over NVML's link topology (tpu_operator_torch/partitioner/
topology.py and the link bindings in tpu_operator_torch/nvml.py), beside
the reference's ICI-grid tiler (tpu_operator/partitioner/topology.py) on
the layouts where both must place the same GPUs.

The boards are fake NVML nodes (tpu_operator_torch/testing/fake_nvml.py):
an NVSwitch board (every pair NVLink) and an 8-GPU PCIe board with GPUs in
pairs under four PCIe switches, two switches under each CPU socket.
"""

import itertools

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tpu_operator.partitioner import topology as ref_topology
from tpu_operator_torch import nvml
from tpu_operator_torch.partitioner import topology
from tpu_operator_torch.partitioner.partitioner import node_links
from tpu_operator_torch.testing import fake_nvml

V5E = "tpu-v5-lite-podslice"


def board(n=8, seed=0, level=None):
    gpus = fake_nvml.random_gpus(n, seed)
    links = fake_nvml.pcie_links(gpus, level) if level else {}
    return fake_nvml.FakeNvml(gpus, links=links)


def links_of(fake):
    return node_links(fake)[1]


@pytest.fixture
def nvswitch8():
    return links_of(board(8))


@pytest.fixture
def pcie8():
    return links_of(board(8, level=fake_nvml.two_sockets))


# -- link classes from NVML -------------------------------------------------------

@pytest.mark.parametrize("level, nvlink, expected", [
    (nvml.TOPOLOGY_INTERNAL, False, "nvlink"),
    (nvml.TOPOLOGY_SINGLE, False, "pcie-switch"),
    (nvml.TOPOLOGY_MULTIPLE, False, "pcie-switch"),
    (nvml.TOPOLOGY_HOSTBRIDGE, False, "host-bridge"),
    (nvml.TOPOLOGY_NODE, False, "numa"),
    (nvml.TOPOLOGY_SYSTEM, False, "system"),
    (nvml.TOPOLOGY_SYSTEM, True, "nvlink"),
])
def test_link_class_from_nvml(level, nvlink, expected):
    gpus = fake_nvml.random_gpus(2, 3)
    fake = fake_nvml.FakeNvml(gpus, links={frozenset(g.uuid for g in gpus): (level, nvlink)})
    with nvml.session(fake) as s:
        found = s.gpus()
        assert s.links(found) == [[None, expected], [expected, None]]
    assert fake.open_sessions == 0


def test_links_follow_pci_order_whatever_nvml_lists(pcie8):
    """The fake lists its GPUs off PCI order; the matrix is in PCI order,
    the plugin's unit order: pairs (0,1), (2,3), ... share a switch."""
    for i, j in itertools.combinations(range(8), 2):
        assert pcie8[i][j] == pcie8[j][i] == (
            "pcie-switch" if i // 2 == j // 2 else "numa" if i // 4 == j // 4 else "system")
    assert all(pcie8[i][i] is None for i in range(8))


@pytest.mark.parametrize("call", ["nvmlDeviceGetTopologyCommonAncestor",
                                  "nvmlDeviceGetP2PStatus"])
def test_a_pair_nvml_cannot_answer_raises(call):
    fake = board(4, level=fake_nvml.two_sockets)
    fake.fail[call] = nvml.NOT_SUPPORTED
    with nvml.session(fake) as s:
        with pytest.raises(nvml.NvmlError, match=call):
            s.links(s.gpus())


def test_an_unknown_topology_level_is_not_guessed():
    gpus = fake_nvml.random_gpus(2, 4)
    fake = fake_nvml.FakeNvml(gpus, links={frozenset(g.uuid for g in gpus): (35, False)})
    with nvml.session(fake) as s:
        with pytest.raises(nvml.NvmlError, match="unknown topology level 35"):
            s.links(s.gpus())


def test_one_gpu_has_no_pairs_to_ask_about():
    fake = board(1)
    fake.fail["nvmlDeviceGetTopologyCommonAncestor"] = nvml.NOT_SUPPORTED
    assert links_of(fake) == [[None]]


def test_driver_version_from_nvml():
    with nvml.session(fake_nvml.FakeNvml([], driver_version="580.159.03")) as s:
        assert s.driver_version() == "580.159.03"


# -- the derived topology and the cost -------------------------------------------------

def test_group_class_is_the_worst_pair(pcie8):
    assert topology.group_class([5], pcie8) == "single"
    assert topology.group_class([4, 5], pcie8) == "pcie-switch"
    assert topology.group_class([4, 5, 6], pcie8) == "numa"
    assert topology.group_class([0, 1, 7], pcie8) == "system"


def test_link_cost_sums_the_ranks(pcie8, nvswitch8):
    assert topology.link_cost([0, 1, 2, 3], pcie8) == 2 * 1 + 4 * 3
    assert topology.link_cost([0, 1, 4, 5], pcie8) == 2 * 1 + 4 * 4
    assert topology.link_cost([0, 1, 2, 3], nvswitch8) == 0
    assert topology.link_cost([0, 5], None) == 0


# -- the tiler --------------------------------------------------------------------

def test_undeclared_entries_take_the_tightest_class_that_tiles(pcie8):
    pairs = topology.tile_partition(pcie8, [{"chips": 2}, {"chips": 2}])
    assert pairs == [{"topology": "pcie-switch", "chips": [0, 1]},
                     {"topology": "pcie-switch", "chips": [2, 3]}]
    halves = topology.tile_partition(pcie8, [{"chips": 4}, {"chips": 4}])
    assert halves == [{"topology": "numa", "chips": [0, 1, 2, 3]},
                      {"topology": "numa", "chips": [4, 5, 6, 7]}]
    assert topology.tile_partition(pcie8, [{"chips": 8}]) == [
        {"topology": "system", "chips": list(range(8))}]


def test_a_declared_class_is_an_upper_bound(pcie8):
    with pytest.raises(topology.TopologyError, match="cannot place"):
        topology.tile_partition(pcie8, [{"chips": 4, "topology": "host-bridge"}])
    assert topology.tile_partition(pcie8, [{"chips": 4, "topology": "numa"}]) == [
        {"topology": "numa", "chips": [0, 1, 2, 3]}]
    # looser bounds admit tighter sets; the string is derived, not copied
    assert topology.tile_partition(pcie8, [{"chips": 2, "topology": "system"}]) == [
        {"topology": "pcie-switch", "chips": [0, 1]}]
    assert topology.tile_partition(pcie8, [{"chips": 1, "topology": "single"}]) == [
        {"topology": "single", "chips": [0]}]


@pytest.mark.parametrize("declared", ["2x2", "1x1", "2x2x1", "nvswitch", "single"])
def test_a_grid_string_is_refused_naming_the_classes(nvswitch8, declared):
    with pytest.raises(topology.TopologyError, match="nvlink.*pcie-switch.*system"):
        topology.tile_partition(nvswitch8, [{"chips": 2, "topology": declared}])


def test_blocked_gpus_are_occupied(pcie8):
    groups = topology.tile_partition(pcie8, [{"chips": 2, "count": "all"}], blocked=[2])
    assert groups == [{"topology": "pcie-switch", "chips": [0, 1]},
                      {"topology": "pcie-switch", "chips": [4, 5]},
                      {"topology": "pcie-switch", "chips": [6, 7]}]
    with pytest.raises(topology.TopologyError, match="outside"):
        topology.tile_partition(pcie8, [{"chips": 1}], blocked=[8])
    with pytest.raises(topology.TopologyError, match="health-gated"):
        topology.tile_partition(pcie8, [{"chips": 4}, {"chips": 4}], blocked=[0])


def test_count_all_scales_down_to_the_healthy_gpus(nvswitch8):
    singles = topology.tile_partition(nvswitch8, [{"chips": 1, "count": "all"}],
                                      blocked=[3, 6])
    assert [g["chips"] for g in singles] == [[0], [1], [2], [4], [5], [7]]
    with pytest.raises(topology.TopologyError, match="requests 8 GPU"):
        topology.tile_partition(nvswitch8, [{"chips": 1, "count": 8}], blocked=[0])


def test_backtracking_places_a_layout_greedy_refuses(pcie8):
    """Lexical first fit takes {0, 1} for the pair and then finds no
    second 3-GPU set within one socket; the search moves the pair across
    the sockets instead."""
    layout = [{"chips": 2, "topology": "system"}, {"chips": 3, "topology": "numa"},
              {"chips": 3, "topology": "numa"}]
    assert [g["chips"] for g in topology.tile_partition(pcie8, layout)] == \
        [[0, 4], [1, 2, 3], [5, 6, 7]]


@pytest.mark.parametrize("entry, match", [
    ({"chips": "four"}, "chips must be an integer"),
    ({"chips": 2, "count": {}}, "count must be an integer"),
    ({"chips": 0}, "invalid chips count"),
    ("2x2", "must be mappings"),
])
def test_nonsense_entries_are_refused(nvswitch8, entry, match):
    with pytest.raises(topology.TopologyError, match=match):
        topology.tile_partition(nvswitch8, [entry])


def test_a_matrix_of_the_wrong_size_is_refused(pcie8):
    with pytest.raises(topology.TopologyError, match="not 8 x 8"):
        topology.tile_partition([row[:7] for row in pcie8], [{"chips": 1}])


# -- incremental re-tile ---------------------------------------------------------------

def test_retile_keeps_healthy_groups_and_drops_what_cannot_move(pcie8):
    previous = topology.tile_partition(pcie8, [{"chips": 4}, {"chips": 4}])
    groups, dropped = topology.retile_incremental(pcie8, [2], previous)
    assert groups == [previous[1]] and dropped == [previous[0]]


def test_retile_replaces_a_hit_group_within_its_class(nvswitch8):
    previous = [{"topology": "nvlink", "chips": [0, 1]}, {"topology": "nvlink", "chips": [2, 3]}]
    groups, dropped = topology.retile_incremental(nvswitch8, [1], previous)
    # the first free set in lexical order: GPU 0 stays, 1 is blocked, 2-3 kept
    assert groups == [{"topology": "nvlink", "chips": [0, 4]}, previous[1]] and dropped == []


@pytest.mark.parametrize("previous", [[{"chips": [9]}], [{"topology": "2x2", "chips": [0]}],
                                      [{"topology": "nvlink"}], [{"chips": ["a"]}]])
def test_retile_refuses_malformed_previous_groups(nvswitch8, previous):
    with pytest.raises(topology.TopologyError):
        topology.retile_incremental(nvswitch8, [0], previous)


# -- beside the reference, where both must place the same GPUs --------------------------

SAME_SETS = [
    # (GPUs, board, v5e host chips, layout)
    (4, None, 4, [{"chips": 2, "count": "all"}]),
    (4, None, 4, [{"chips": 1, "count": "all"}]),
    (4, None, 4, [{"chips": 2}, {"chips": 1, "count": "all"}]),
    (4, None, 4, [{"chips": 4}]),
    (8, fake_nvml.two_sockets, 8, [{"chips": 2, "count": "all"}]),
    (8, fake_nvml.two_sockets, 8, [{"chips": 1, "count": "all"}]),
    (8, fake_nvml.two_sockets, 8, [{"chips": 8}]),
]


@pytest.mark.parametrize("n, level, chips, layout", SAME_SETS)
@pytest.mark.parametrize("blocked", [[], [2]])
def test_same_gpu_sets_as_the_reference(n, level, chips, layout, blocked):
    links = links_of(board(n, level=level))
    try:
        ref = [g["chips"] for g in ref_topology.tile_partition(V5E, chips, layout, blocked)]
    except ref_topology.TopologyError:
        ref = None
    try:
        port = [g["chips"] for g in topology.tile_partition(links, layout, blocked)]
    except topology.TopologyError:
        port = None
    assert port == ref


@pytest.mark.parametrize("n, level, chips, layout", SAME_SETS[:2] + SAME_SETS[4:6])
def test_same_incremental_retile_as_the_reference(n, level, chips, layout):
    links = links_of(board(n, level=level))
    ref_prev = ref_topology.tile_partition(V5E, chips, layout)
    port_prev = topology.tile_partition(links, layout)
    ref_groups, ref_dropped = ref_topology.retile_incremental(V5E, chips, [2], ref_prev)
    groups, dropped = topology.retile_incremental(links, [2], port_prev)
    assert [g["chips"] for g in groups] == [g["chips"] for g in ref_groups]
    assert [g["chips"] for g in dropped] == [g["chips"] for g in ref_dropped]


def test_four_gpu_groups_take_the_sockets_where_the_reference_takes_boxes(pcie8):
    """A deliberate difference: on the v5e 2x4 grid a 4-chip group is a
    2x2 box, [0, 1, 4, 5]; on a two-socket GPU board it is a socket."""
    layout = [{"chips": 4}, {"chips": 4}]
    assert [g["chips"] for g in ref_topology.tile_partition(V5E, 8, layout)] == \
        [[0, 1, 4, 5], [2, 3, 6, 7]]
    assert [g["chips"] for g in topology.tile_partition(pcie8, layout)] == \
        [[0, 1, 2, 3], [4, 5, 6, 7]]


# -- a property over random boards and layouts ------------------------------------------

@st.composite
def boards_and_layouts(draw):
    n = draw(st.integers(1, 8))
    classes = list(nvml.LINK_CLASSES)
    m = [[None] * n for _ in range(n)]
    for i, j in itertools.combinations(range(n), 2):
        m[i][j] = m[j][i] = draw(st.sampled_from(classes))
    layout = draw(st.lists(st.fixed_dictionaries(
        {"chips": st.integers(1, 4)},
        optional={"topology": st.sampled_from(classes), "count": st.sampled_from([1, 2, "all"])}),
        max_size=4))
    blocked = draw(st.lists(st.integers(0, n - 1), max_size=2, unique=True))
    return m, layout, blocked


@settings(max_examples=80, deadline=None)
@given(boards_and_layouts())
def test_every_group_holds_its_class_and_none_overlap(case):
    links, layout, blocked = case
    try:
        groups = topology.tile_partition(links, layout, blocked)
    except topology.TopologyError:
        return
    used = [c for g in groups for c in g["chips"]]
    assert len(used) == len(set(used)) and not set(used) & set(blocked)
    assert all(0 <= c < len(links) for c in used)
    for g in groups:
        assert g["topology"] == topology.group_class(g["chips"], links)
        assert g["chips"] == sorted(g["chips"])
    if any(e.get("count") == "all" for e in layout):
        return  # how many groups an "all" entry makes depends on the others
    declared = [(e["chips"], e.get("topology")) for e in layout for _ in range(e.get("count", 1))]
    assert len(groups) == len(declared)
    for g, (chips, bound) in zip(groups, declared):
        assert len(g["chips"]) == chips
        if bound is not None and chips > 1:
            assert topology.RANK[g["topology"]] <= topology.RANK[bound]
