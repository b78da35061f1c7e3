"""The plain reference the benchmark holds the program's outputs against.
It imports torch alone: nothing of the program and nothing of JAX."""

from portbench.reference.model import Reference, flatten, unflatten

__all__ = ["Reference", "flatten", "unflatten"]
