"""Serving: the single-stream ``Server`` (``engine``)."""
from repro_torch.serving.engine import Server

__all__ = ["Server"]
