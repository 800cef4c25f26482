# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: serve.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0bserve.proto\x12\rray_tpu.serve\"\xbc\x01\n\x0cServeRequest\x12\r\n\x05route\x18\x01 \x01(\t\x12\x0e\n\x06method\x18\x02 \x01(\t\x12\x0f\n\x07payload\x18\x03 \x01(\x0c\x12\x39\n\x07headers\x18\x04 \x03(\x0b\x32(.ray_tpu.serve.ServeRequest.HeadersEntry\x12\x11\n\ttimeout_s\x18\x05 \x01(\x02\x1a.\n\x0cHeadersEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"N\n\nServeReply\x12\x0e\n\x06status\x18\x01 \x01(\x05\x12\x0f\n\x07payload\x18\x02 \x01(\x0c\x12\r\n\x05\x65rror\x18\x03 \x01(\t\x12\x10\n\x08is_final\x18\x04 \x01(\x08\"\x07\n\x05\x45mpty\"v\n\x0cRouteListing\x12\x37\n\x06routes\x18\x01 \x03(\x0b\x32\'.ray_tpu.serve.RouteListing.RoutesEntry\x1a-\n\x0bRoutesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x32\x8a\x02\n\x08ServeAPI\x12>\n\x04\x43\x61ll\x12\x1b.ray_tpu.serve.ServeRequest\x1a\x19.ray_tpu.serve.ServeReply\x12\x46\n\nCallStream\x12\x1b.ray_tpu.serve.ServeRequest\x1a\x19.ray_tpu.serve.ServeReply0\x01\x12?\n\nListRoutes\x12\x14.ray_tpu.serve.Empty\x1a\x1b.ray_tpu.serve.RouteListing\x12\x35\n\x07Healthz\x12\x14.ray_tpu.serve.Empty\x1a\x14.ray_tpu.serve.Emptyb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'serve_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _SERVEREQUEST_HEADERSENTRY._options = None
  _SERVEREQUEST_HEADERSENTRY._serialized_options = b'8\001'
  _ROUTELISTING_ROUTESENTRY._options = None
  _ROUTELISTING_ROUTESENTRY._serialized_options = b'8\001'
  _SERVEREQUEST._serialized_start=31
  _SERVEREQUEST._serialized_end=219
  _SERVEREQUEST_HEADERSENTRY._serialized_start=173
  _SERVEREQUEST_HEADERSENTRY._serialized_end=219
  _SERVEREPLY._serialized_start=221
  _SERVEREPLY._serialized_end=299
  _EMPTY._serialized_start=301
  _EMPTY._serialized_end=308
  _ROUTELISTING._serialized_start=310
  _ROUTELISTING._serialized_end=428
  _ROUTELISTING_ROUTESENTRY._serialized_start=383
  _ROUTELISTING_ROUTESENTRY._serialized_end=428
  _SERVEAPI._serialized_start=431
  _SERVEAPI._serialized_end=697
# @@protoc_insertion_point(module_scope)
