"""Client stack: the librados-shaped API + objecter (SURVEY.md §2.7)."""

from .rados import RadosClient

__all__ = ["RadosClient"]
