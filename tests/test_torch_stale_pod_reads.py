"""The port's health machine (tpu_operator_torch/health/machine.py) behind a
cache that reports its pod deletes late.

Remediation recycles the node's validator pods (and, from the second
attempt, its driver pods), as the upgrade's validation step does
(tests/test_torch_upgrade_recycle.py). The health machine does not read
those pods to decide: every edge it takes reads the node (the published
verdict, its own stamps) and the clock. So each of the reference's 26
health cases, run on the port's machine over Pod lists that keep each pod
the machine deleted two sweeps, must leave exactly what the same case
leaves without the lag: the same states, annotations, cordons and counts
after every sweep, the same Events, pods and journal.
"""

import pytest

from test_torch_health import CASES, PORT, World
from test_torch_upgrade_recycle import LaggingPods


class LagWorld(World):
    """The port's health World whose machines read and write through
    :class:`LaggingPods`."""

    def __init__(self, side, sweeps):
        super().__init__(side)
        self.lagging = LaggingPods(self.client, sweeps)

    def machine(self, **spec):
        return self.s.m.HealthStateMachine(self.lagging, "tpu-operator",
                                           self.s.HealthSpec.from_dict(spec),
                                           now=self.clock, journal=self.journal,
                                           migrate=self.migrate)

    def sweep(self, **spec):
        try:
            return super().sweep(**spec)
        finally:
            self.lagging.tick()


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_health_machine_takes_no_edge_on_a_deleted_pod(case):
    plain, lagging = World(PORT), LagWorld(PORT, sweeps=2)
    CASES[case](plain)
    CASES[case](lagging)
    assert lagging.record() == plain.record()
