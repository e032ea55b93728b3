# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: prediction_service.proto
"""Generated protocol buffer code.

The reference's descriptor, byte for byte: the same file name
(``prediction_service.proto``) and package (``tpu_pipelines.serving``), so
both packages can load it in one process and the wire paths
(``/tpu_pipelines.serving.PredictionService/...``) are shared.
"""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x18prediction_service.proto\x12\x15tpu_pipelines.serving\"N\n\x0bTensorValue\x12\r\n\x05shape\x18\x01 \x03(\x03\x12\r\n\x05\x64type\x18\x02 \x01(\t\x12\x0c\n\x04\x64\x61ta\x18\x03 \x01(\x0c\x12\x13\n\x0bstring_vals\x18\x04 \x03(\x0c\"\xba\x01\n\x0ePredictRequest\x12\x12\n\nmodel_name\x18\x01 \x01(\t\x12\x41\n\x06inputs\x18\x02 \x03(\x0b\x32\x31.tpu_pipelines.serving.PredictRequest.InputsEntry\x1aQ\n\x0bInputsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x31\n\x05value\x18\x02 \x01(\x0b\x32\".tpu_pipelines.serving.TensorValue:\x02\x38\x01\"a\n\x0fPredictResponse\x12\x15\n\rmodel_version\x18\x01 \x01(\t\x12\x37\n\x0bpredictions\x18\x02 \x01(\x0b\x32\".tpu_pipelines.serving.TensorValue\"(\n\x12ModelStatusRequest\x12\x12\n\nmodel_name\x18\x01 \x01(\t\"5\n\x13ModelStatusResponse\x12\x0f\n\x07version\x18\x01 \x01(\t\x12\r\n\x05state\x18\x02 \x01(\t2\xd6\x01\n\x11PredictionService\x12X\n\x07Predict\x12%.tpu_pipelines.serving.PredictRequest\x1a&.tpu_pipelines.serving.PredictResponse\x12g\n\x0eGetModelStatus\x12).tpu_pipelines.serving.ModelStatusRequest\x1a*.tpu_pipelines.serving.ModelStatusResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'prediction_service_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _PREDICTREQUEST_INPUTSENTRY._options = None
  _PREDICTREQUEST_INPUTSENTRY._serialized_options = b'8\001'
  _TENSORVALUE._serialized_start=51
  _TENSORVALUE._serialized_end=129
  _PREDICTREQUEST._serialized_start=132
  _PREDICTREQUEST._serialized_end=318
  _PREDICTREQUEST_INPUTSENTRY._serialized_start=237
  _PREDICTREQUEST_INPUTSENTRY._serialized_end=318
  _PREDICTRESPONSE._serialized_start=320
  _PREDICTRESPONSE._serialized_end=417
  _MODELSTATUSREQUEST._serialized_start=419
  _MODELSTATUSREQUEST._serialized_end=459
  _MODELSTATUSRESPONSE._serialized_start=461
  _MODELSTATUSRESPONSE._serialized_end=514
  _PREDICTIONSERVICE._serialized_start=517
  _PREDICTIONSERVICE._serialized_end=731
# @@protoc_insertion_point(module_scope)
