"""Serving tier of the port: the continuous-batching ``ProjectionEngine``,
the flush()-driven ``ProjectionService``, and LM prefill/decode steps."""
from .engine import (DeadlineExceededError, ProjectionEngine,  # noqa: F401
                     QueueFullError, ServingError, Ticket,
                     UnknownTicketError)
from .lm import generate, make_decode_step, make_prefill  # noqa: F401
from .projection_service import ProjectionService  # noqa: F401
