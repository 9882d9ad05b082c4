"""The kubelet device-plugin API's messages (``protoc --python_out`` of
``deviceplugin.proto``, package ``v1beta1``): imported only by the device
plugin's wire layer, since it needs ``google.protobuf``."""
