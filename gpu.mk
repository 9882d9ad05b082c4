# Developer entry points of the PyTorch/CUDA port, tpu_operator_torch (the
# counterpart of the Makefile's, target for target; the benchmark targets,
# bench and *-bench, come with the port's benchmark harness).
#
# Usage:
#   make -f gpu.mk <target> [PYTHON=python3]
#
# Every target runs on the CPU but graft-check, which wants the card
# (graft-check DEVICE=cpu runs it on gloo ranks), and e2e-kind and
# e2e-envtest, which exit 77 without their binaries. Tier-1 (pytest -m
# 'not slow') runs none of these targets; tests/test_torch_gpu_mk.py checks
# them with make -n.

PYTHON ?= python3
#: every test file of the port
PORT_TESTS = tests/test_torch_*.py

.PHONY: test
test:
	$(PYTHON) -m pytest $(PORT_TESTS) -q

.PHONY: e2e
e2e:
	bash tests/scripts/torch/end-to-end.sh

.PHONY: lint
lint:  ## ruff (when installed) then gpuop-lint; fails on any finding the empty baseline does not hold
	@if command -v ruff >/dev/null 2>&1; then \
		ruff check tpu_operator_torch; \
	else \
		echo "lint: ruff not installed; skipping (gpuop-lint still runs)"; \
	fi
	$(PYTHON) -m tpu_operator_torch.cmd.lint

LINT_CHANGED_REF ?= HEAD

.PHONY: lint-changed
lint-changed:  ## gpuop-lint on the files changed against LINT_CHANGED_REF; the whole-program graph still covers the tree
	$(PYTHON) -m tpu_operator_torch.cmd.lint --changed=$(LINT_CHANGED_REF)

.PHONY: lint-baseline
lint-baseline:  ## rewrite .gpuop-lint-baseline.json from the tree (review the diff)
	$(PYTHON) -m tpu_operator_torch.cmd.lint --write-baseline

CHAOS_SEED ?= 1729

.PHONY: chaos
chaos:  ## the port's seeded fault-injection and soak twins: 30% API failures, watch chops, pod chaos, churn soaks
	CHAOS_SEED=$(CHAOS_SEED) SOAK_SEED=$(CHAOS_SEED) $(PYTHON) -m pytest $(PORT_TESTS) -q \
		-k "chaos or fault or soak" --continue-on-collection-errors

DRAIN_SOAK_SEED ?= 20260805
#: the twins of the reference's health soak and drain protocol tests
DRAIN_SOAK_TESTS = \
	tests/test_torch_health_phase.py::test_a_drain_ack_releases_the_gate_before_the_deadline \
	tests/test_torch_drain.py tests/test_torch_trainjob.py

.PHONY: drain-soak
drain-soak:  ## the drain protocol: plan, checkpoint ack, incremental re-tile, resume
	CHAOS_SEED=$(DRAIN_SOAK_SEED) $(PYTHON) -m pytest $(DRAIN_SOAK_TESTS) -q

CRASH_SOAK_SEED ?= 20260805
#: the crash-point twins (the two coverage-complete matrices, slow ones
#: included), the fence (tests/test_torch_leader.py) and split-brain twins
CRASH_SOAK_TESTS = tests/test_torch_crash_soak.py \
	tests/test_torch_migrate.py::test_migration_crash_baseline_and_sampled_kills \
	tests/test_torch_migrate.py::test_migration_crash_point_matrix \
	tests/test_torch_leader.py tests/test_torch_split_brain.py

.PHONY: crash-soak
crash-soak:  ## kill the port's operator before and after every mutating write of a health episode and of a migration; every replay must converge
	CRASH_SOAK_SEED=$(CRASH_SOAK_SEED) $(PYTHON) -m pytest $(CRASH_SOAK_TESTS) -q

SCENARIO_SEED ?= 20260806
SCENARIO_FUZZ_BUDGET ?= 25

.PHONY: scenario-fuzz
scenario-fuzz:  ## the fleet simulator's gate: $(SCENARIO_FUZZ_BUDGET) sampled compound-failure scenarios through the port's reconcilers, then the sweep again, event logs byte-identical
	SCENARIO_SEED=$(SCENARIO_SEED) $(PYTHON) -m tpu_operator_torch.cmd.sim fuzz \
		--budget $(SCENARIO_FUZZ_BUDGET) --double-run

.PHONY: scenario-replay
scenario-replay:  ## every committed scenario case through the port's simulator, all oracles green
	SCENARIO_SEED=$(SCENARIO_SEED) $(PYTHON) -m pytest tests/test_torch_simulator.py -q

OPSAN_SEED ?= 20260807
OPSAN_REPORT_DIR ?= build/gpu-operator-opsan
RACE_SOAK_FUZZ_BUDGET ?= 10
#: the twin of the reference's health soak
HEALTH_SOAK_TEST = tests/test_torch_health_phase.py::test_a_drain_ack_releases_the_gate_before_the_deadline
OPSAN_ENV = GPU_OPERATOR_OPSAN=1 GPU_OPERATOR_OPSAN_PERTURB=1 \
	GPU_OPERATOR_OPSAN_REPORT=$(OPSAN_REPORT_DIR) OPSAN_SEED=$(OPSAN_SEED)
#: the race soak's runs, each a fresh sanitized process that writes its own
#: report: the sanitizer's bookkeeping grows with every operator a process
#: starts (one process through the health matrix's 100-odd episodes ran
#: its last episodes several times slower than its first), and make -j runs
#: them at once
RACE_SOAK_RUNS = race-soak-crash race-soak-migration race-soak-fence race-soak-health \
	race-soak-fuzz

.PHONY: race-soak race-soak-crash race-soak-migration race-soak-fence race-soak-health \
	race-soak-fuzz
race-soak:  ## the crash-soak, fence, split-brain and health-soak twins and a $(RACE_SOAK_FUZZ_BUDGET)-scenario fuzz slice under the port's race sanitizer with its schedule perturber, then the gate: no race, no dynamic-only lock edge without a fixture in tests/cases/torch_opsan/dynamic_edges.json
	rm -rf $(OPSAN_REPORT_DIR) && mkdir -p $(OPSAN_REPORT_DIR)
	$(MAKE) -f gpu.mk $(RACE_SOAK_RUNS)
	$(PYTHON) -m tpu_operator_torch.cmd.opsan check --reports $(OPSAN_REPORT_DIR) \
		--fixtures tests/cases/torch_opsan/dynamic_edges.json

race-soak-crash:
	$(OPSAN_ENV) CRASH_SOAK_SEED=$(CRASH_SOAK_SEED) $(PYTHON) -m pytest \
		tests/test_torch_crash_soak.py -q

race-soak-migration:
	$(OPSAN_ENV) CRASH_SOAK_SEED=$(CRASH_SOAK_SEED) $(PYTHON) -m pytest \
		tests/test_torch_migrate.py::test_migration_crash_baseline_and_sampled_kills \
		tests/test_torch_migrate.py::test_migration_crash_point_matrix -q

race-soak-fence:
	$(OPSAN_ENV) CHAOS_SEED=$(OPSAN_SEED) $(PYTHON) -m pytest \
		tests/test_torch_leader.py tests/test_torch_split_brain.py -q

race-soak-health:
	$(OPSAN_ENV) CHAOS_SEED=$(OPSAN_SEED) $(PYTHON) -m pytest $(HEALTH_SOAK_TEST) -q

race-soak-fuzz:
	$(OPSAN_ENV) SCENARIO_SEED=$(SCENARIO_SEED) $(PYTHON) -m tpu_operator_torch.cmd.sim fuzz \
		--budget $(RACE_SOAK_FUZZ_BUDGET) --double-run

.PHONY: generate
generate:  ## write every CRD copy from the spec dataclasses
	$(PYTHON) -m tpu_operator_torch.api.schema_gen --write

.PHONY: validate-generated
validate-generated:  ## the committed CRD copies match the spec dataclasses
	$(PYTHON) -m tpu_operator_torch.api.schema_gen --check

.PHONY: validate-csv
validate-csv:  ## the OLM bundle: alm-examples valid, owned CRDs shipped
	$(PYTHON) -m tpu_operator_torch.cmd.cfg validate-csv bundle-gpu/manifests/gpu-operator.clusterserviceversion.yaml

.PHONY: validate-helm-values
validate-helm-values:  ## the chart renders a schema-valid ClusterPolicy
	$(PYTHON) -m pytest tests/test_torch_chart.py -q

.PHONY: e2e-kind
e2e-kind:  ## the real-apiserver e2e (needs kind, docker and kubectl; exit 77 without them)
	bash tests/e2e-kind-gpu.sh

.PHONY: e2e-envtest
e2e-envtest:  ## kube-apiserver and etcd, no containers (exit 77 without the binaries)
	bash tests/e2e-envtest-gpu.sh

.PHONY: must-gather
must-gather:
	bash hack/gpu-must-gather.sh

.PHONY: validate-samples
validate-samples:
	$(PYTHON) -m tpu_operator_torch.cmd.cfg validate config/gpu/samples/*.yaml

.PHONY: validate-manifests
validate-manifests:
	$(PYTHON) -m pytest tests/test_torch_operand_states.py tests/test_torch_operator_render.py -q

.PHONY: native
native:
	$(MAKE) -C tpu_operator_torch/native

DEVICE ?= cuda

.PHONY: graft-check
graft-check:  ## the single-GPU check, then the mesh dry run over every visible GPU
	$(PYTHON) -m tpu_operator_torch.graft_entry --device=$(DEVICE)

.PHONY: multihost
multihost:  ## the multi-node sweep's slow twins: 2 x 4, 4 x 2, a killed worker and a clean retry, 4 x 4, the 16-rank dry run
	$(PYTHON) -m pytest tests/test_torch_workload.py -m slow -q

.PHONY: clean
clean:
	rm -rf build dist *.egg-info
	find . -name __pycache__ -not -path "./.git/*" -exec rm -rf {} + 2>/dev/null || true
