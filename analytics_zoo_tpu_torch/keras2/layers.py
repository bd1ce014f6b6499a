"""Keras-2-named layers: every name of the port's ``nn``."""

from ..nn import *  # noqa: F401,F403
from ..nn import __all__ as _nn_all

__all__ = list(_nn_all)
