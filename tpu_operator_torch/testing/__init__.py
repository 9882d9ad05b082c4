"""Test doubles for code paths that need hardware or a cluster this package
cannot assume: fake NVML and CUDA driver libraries for the device plumbing,
an in-process apiserver (:mod:`~.apiserver`) and kubelets (:mod:`~.kubelet`)
for the operator, cluster chaos (:mod:`~.chaos`: ``PodChaos``,
``NodeChaos``) and a simulated training job (:mod:`~.trainjob`) for drain
and migration soaks."""
