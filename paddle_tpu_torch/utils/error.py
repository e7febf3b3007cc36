"""Error handling (analog of paddle/utils/Error.h and PADDLE_ENFORCE,
reference paddle/platform/enforce.h). Counterpart of
``paddle_tpu/utils/error.py``."""

from __future__ import annotations


class Error(RuntimeError):
    """Rich error with context chain, like paddle::Error."""

    def __init__(self, msg: str, *context: str):
        self.context = list(context)
        super().__init__(msg if not context else msg + "\n  " + "\n  ".join(context))


def enforce(cond, msg: str = "enforce failed", *context: str):
    """PADDLE_ENFORCE analog: raise Error with context on failure."""
    if not cond:
        raise Error(msg, *context)
    return True
