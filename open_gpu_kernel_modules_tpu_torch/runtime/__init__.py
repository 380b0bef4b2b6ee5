"""The native library loader and RM client (``native``), the real-arena
consumer that mirrors the engine's HBM tier onto the card (``hbm``), and
the serving scheduler (``sched``)."""

from . import native

__all__ = ["native"]
