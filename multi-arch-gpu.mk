# Multi-arch builds of the port's images with docker buildx (the counterpart
# of multi-arch.mk).
#
# The operator pod can land on any node of a mixed cluster (arm64 control
# planes exist), so gpu-operator builds for amd64 and arm64. gpu-validator
# stays amd64-only: its payload (the CUDA toolkit, torch for CUDA, the
# native probes exec'd on GPU hosts) only runs on amd64 GPU nodes.
#
# Usage:
#   make -f multi-arch-gpu.mk build-all-multiarch \
#       REGISTRY=registry.example.com/gpu-operator VERSION=0.1.0 [PUSH_ON_BUILD=true]
#
# Needs a buildx builder (docker buildx create --use) and network for the
# base images and wheels. tests/test_torch_images.py checks the targets
# with `make -n`.

PUSH_ON_BUILD ?= false
ATTACH_ATTESTATIONS ?= false
REGISTRY ?= registry.example.com/gpu-operator
VERSION ?= 0.1.0
IMAGE ?= $(REGISTRY)/gpu-operator:$(VERSION)
VALIDATOR_IMAGE ?= $(REGISTRY)/gpu-validator:$(VERSION)

OPERATOR_PLATFORMS = linux/amd64,linux/arm64
VALIDATOR_PLATFORMS = linux/amd64

DOCKER_BUILD_OPTIONS = --output=type=image,push=$(PUSH_ON_BUILD) \
	--provenance=$(ATTACH_ATTESTATIONS) --sbom=$(ATTACH_ATTESTATIONS)

.PHONY: build-operator-multiarch
build-operator-multiarch:
	docker buildx build $(DOCKER_BUILD_OPTIONS) \
		--platform=$(OPERATOR_PLATFORMS) \
		-f docker/gpu-operator.Dockerfile -t $(IMAGE) .

.PHONY: build-validator-multiarch
build-validator-multiarch:
	docker buildx build $(DOCKER_BUILD_OPTIONS) \
		--platform=$(VALIDATOR_PLATFORMS) \
		-f docker/gpu-validator.Dockerfile -t $(VALIDATOR_IMAGE) .

.PHONY: build-all-multiarch
build-all-multiarch: build-operator-multiarch build-validator-multiarch
