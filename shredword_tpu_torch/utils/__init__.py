from . import logging  # noqa: F401
from .logging import Timer  # noqa: F401
