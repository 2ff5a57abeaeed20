"""The ProgramDesc wire format: ``framework.proto`` is the schema (the
TPU package's, copied), ``framework_pb2`` its codec, written by hand so
that the port needs no protobuf package."""
from . import framework_pb2  # noqa: F401
