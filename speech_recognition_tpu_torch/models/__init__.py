"""LAS for inference."""

from .las import LAS

__all__ = ["LAS"]
