"""Stan frontend errors with source locations."""

from __future__ import annotations


class StanCompileError(Exception):
    """Raised for syntax errors and unsupported constructs."""

    def __init__(self, message: str, line: int = 0, col: int = 0):
        self.line = line
        self.col = col
        if line:
            message = f"line {line}:{col}: {message}"
        super().__init__(message)


class StanRuntimeError(Exception):
    """Raised when model evaluation fails (e.g. missing data)."""
