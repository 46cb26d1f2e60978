from .root import main

__all__ = ["main"]
