"""Models of the port: the JAX package's ``models`` for every architecture
config (see ``model.py``)."""
from .model import Model

__all__ = ["Model"]
