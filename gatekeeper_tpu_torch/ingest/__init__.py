# Copied from gatekeeper_tpu/ingest/__init__.py; no line below differs.
"""Wire-speed ingest plane (docs/ingest.md): framed streaming
transport, zero-copy AdmissionReview decode into encoder token rows,
connection-aware hand-off to the micro-batchers."""

from .decode import DecodeSurprise, LazyObject, decode_review, scan_review
from .transport import (
    FLAG_DEADLINE,
    FRAME_ERROR,
    FRAME_PING,
    FRAME_PONG,
    FRAME_RESPONSE,
    FRAME_VERSION,
    Frame,
    FrameReader,
    PLANE_AGENT,
    PLANE_LABEL,
    PLANE_MUTATE,
    PLANE_VALIDATE,
    ProtocolError,
    StreamClient,
    StreamListener,
    encode_frame,
)
from .server import IngestServer

__all__ = [
    "DecodeSurprise",
    "FLAG_DEADLINE",
    "FRAME_ERROR",
    "FRAME_PING",
    "FRAME_PONG",
    "FRAME_RESPONSE",
    "FRAME_VERSION",
    "Frame",
    "FrameReader",
    "IngestServer",
    "LazyObject",
    "PLANE_AGENT",
    "PLANE_LABEL",
    "PLANE_MUTATE",
    "PLANE_VALIDATE",
    "ProtocolError",
    "StreamClient",
    "StreamListener",
    "decode_review",
    "encode_frame",
    "scan_review",
]
