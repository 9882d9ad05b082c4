# Case: a live ClusterPolicy spec update rolls the operand (the counterpart
# of tests/cases/update-clusterpolicy.sh).

set -eu

before="$(ds_image gpu-driver)"
kpatch "${CP_PATH}" '{"spec": {"driver": {"version": "0.2.0"}}}' >/dev/null

want_image() { [ "$(ds_image gpu-driver)" != "${before}" ] && \
               ds_image gpu-driver | grep -q "0.2.0"; }
wait_for "driver DS image rolled to 0.2.0" 30 want_image
wait_for "ClusterPolicy ready after update" 60 cp_state_is ready
wait_for "driver DS ready after roll" 60 ds_ready gpu-driver

# revert so later cases see the sample spec
kpatch "${CP_PATH}" '{"spec": {"driver": {"version": "0.1.0"}}}' >/dev/null
wait_for "ClusterPolicy ready after revert" 60 cp_state_is ready
