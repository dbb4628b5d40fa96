from .manipulation import flatten

__all__ = ["flatten"]
