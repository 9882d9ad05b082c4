"""Hand-written gRPC service wrappers for the kubelet device-plugin API
(copy of tpu_operator/deviceplugin/grpc_api.py).

The message classes come from protoc (proto/deviceplugin_pb2.py); the
service stubs and handlers, normally emitted into ``*_pb2_grpc.py`` by
grpc_tools, are written here against the stable method paths. Part of the
device plugin's wire layer: only that layer imports this module, since it
needs ``grpc`` and ``google.protobuf``.
"""

from __future__ import annotations

import grpc

from .. import consts
from .proto import deviceplugin_pb2 as pb

API_VERSION = "v1beta1"
KUBELET_SOCKET = consts.KUBELET_SOCKET
PLUGIN_SOCKET_NAME = consts.PLUGIN_SOCKET_NAME

_REG = "/v1beta1.Registration/Register"
_DP = "/v1beta1.DevicePlugin/{}"


class RegistrationStub:
    """Client for kubelet's Registration service."""

    def __init__(self, channel: grpc.Channel):
        self.Register = channel.unary_unary(
            _REG,
            request_serializer=pb.RegisterRequest.SerializeToString,
            response_deserializer=pb.Empty.FromString)


class DevicePluginStub:
    """Client for a DevicePlugin server (kubelet's view; used in tests)."""

    def __init__(self, channel: grpc.Channel):
        self.GetDevicePluginOptions = channel.unary_unary(
            _DP.format("GetDevicePluginOptions"),
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.DevicePluginOptions.FromString)
        self.ListAndWatch = channel.unary_stream(
            _DP.format("ListAndWatch"),
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.ListAndWatchResponse.FromString)
        self.GetPreferredAllocation = channel.unary_unary(
            _DP.format("GetPreferredAllocation"),
            request_serializer=pb.PreferredAllocationRequest.SerializeToString,
            response_deserializer=pb.PreferredAllocationResponse.FromString)
        self.Allocate = channel.unary_unary(
            _DP.format("Allocate"),
            request_serializer=pb.AllocateRequest.SerializeToString,
            response_deserializer=pb.AllocateResponse.FromString)
        self.PreStartContainer = channel.unary_unary(
            _DP.format("PreStartContainer"),
            request_serializer=pb.PreStartContainerRequest.SerializeToString,
            response_deserializer=pb.PreStartContainerResponse.FromString)


def add_deviceplugin_servicer(server: grpc.Server, servicer) -> None:
    handlers = {
        "GetDevicePluginOptions": grpc.unary_unary_rpc_method_handler(
            servicer.GetDevicePluginOptions,
            request_deserializer=pb.Empty.FromString,
            response_serializer=pb.DevicePluginOptions.SerializeToString),
        "ListAndWatch": grpc.unary_stream_rpc_method_handler(
            servicer.ListAndWatch,
            request_deserializer=pb.Empty.FromString,
            response_serializer=pb.ListAndWatchResponse.SerializeToString),
        "GetPreferredAllocation": grpc.unary_unary_rpc_method_handler(
            servicer.GetPreferredAllocation,
            request_deserializer=pb.PreferredAllocationRequest.FromString,
            response_serializer=pb.PreferredAllocationResponse.SerializeToString),
        "Allocate": grpc.unary_unary_rpc_method_handler(
            servicer.Allocate,
            request_deserializer=pb.AllocateRequest.FromString,
            response_serializer=pb.AllocateResponse.SerializeToString),
        "PreStartContainer": grpc.unary_unary_rpc_method_handler(
            servicer.PreStartContainer,
            request_deserializer=pb.PreStartContainerRequest.FromString,
            response_serializer=pb.PreStartContainerResponse.SerializeToString),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler("v1beta1.DevicePlugin", handlers),))


def add_registration_servicer(server: grpc.Server, servicer) -> None:
    """Fake-kubelet side, for tests."""
    handlers = {
        "Register": grpc.unary_unary_rpc_method_handler(
            servicer.Register,
            request_deserializer=pb.RegisterRequest.FromString,
            response_serializer=pb.Empty.SerializeToString),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler("v1beta1.Registration", handlers),))
