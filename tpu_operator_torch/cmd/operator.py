"""``gpu-operator`` entry point (counterpart of tpu_operator/cmd/operator.py;
NVIDIA's cmd/gpu-operator/main.go:74-233).

The parser has every flag of the reference, with the reference's defaults.
"""

from __future__ import annotations

import argparse
import sys

from .. import __version__


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gpu-operator",
                                description="GPU cluster operator controller manager")
    p.add_argument("--api-server", default=None,
                   help="API server base URL (default: $KUBE_API_URL, else in-cluster config)")
    p.add_argument("--token", default=None, help="Bearer token (default: serviceaccount token)")
    p.add_argument("--namespace", default=None, help="operator namespace (default: $OPERATOR_NAMESPACE)")
    p.add_argument("--metrics-port", type=int, default=8080, help="Prometheus metrics port (0 disables)")
    p.add_argument("--health-port", type=int, default=8081, help="healthz port (0 disables)")
    p.add_argument("--log-level", default="info", choices=["debug", "info", "warning", "error"])
    p.add_argument("--leader-elect", action="store_true",
                   help="enable Lease-based leader election (multi-replica deployments)")
    p.add_argument("--api-timeout", type=float, default=30.0,
                   help="per-request apiserver deadline in seconds (the watch "
                        "stream keeps its own 330s read timeout)")
    p.add_argument("--api-qps", type=float, default=20.0,
                   help="client-side steady-state apiserver request rate "
                        "(token bucket; 0 disables rate limiting)")
    p.add_argument("--api-burst", type=int, default=40,
                   help="client-side rate limiter burst size")
    p.add_argument("--breaker-threshold", type=int, default=5,
                   help="consecutive hard apiserver failures (5xx/transport) "
                        "before the circuit breaker opens and the operator "
                        "enters degraded mode")
    p.add_argument("--no-cache-reads", dest="cache_reads", action="store_false",
                   help="serve reconcile reads directly from the apiserver "
                        "instead of informer caches")
    p.add_argument("--trace-buffer-size", type=int, default=256,
                   help="reconcile traces kept in the flight recorder behind "
                        "/debug/traces (error traces pinned in a separate "
                        "quarter-sized ring)")
    p.add_argument("--debug-endpoints", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="serve /debug/{traces,join-traces,queue,state,informers,capacity,"
                        "threads,timeline,opsan} on the health port "
                        "(--no-debug-endpoints disables)")
    p.add_argument("--version", action="version", version=f"gpu-operator {__version__}")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # deferred import so --help/--version work without a cluster
    from ..controllers.manager import run_operator

    return run_operator(args)


if __name__ == "__main__":
    sys.exit(main())
