"""Dense models of the port: the JAX package's ``models`` for configs made
of ``attn`` and ``mlp`` sublayers (see ``model.py`` for what waits)."""
from .model import Model

__all__ = ["Model"]
