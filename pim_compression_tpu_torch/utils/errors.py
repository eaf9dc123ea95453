"""Typed error surface (role of the reference's snappy_status,
dpu_snappy.h:21-25, plus the new framework's validation philosophy:
validate the stream, raise typed errors — SURVEY.md §5.3)."""

from __future__ import annotations

import enum


class SnappyStatus(enum.IntEnum):
    OK = 0
    INVALID_INPUT = -1
    BUFFER_TOO_SMALL = -2
    BAD_ARGUMENT = -3


class SnappyError(ValueError):
    """Raised on malformed streams or invalid arguments."""

    def __init__(self, status: SnappyStatus, message: str | None = None):
        self.status = status
        super().__init__(message or f"snappy codec error: {status.name}")
