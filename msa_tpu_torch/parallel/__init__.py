"""Parallelism of the port: the (data, model) mesh of ranks, the
multi-process launch with the data and model groups' collectives, and the
tensor-parallel layout of the parameters (``msa_tpu/parallel``'s
counterparts)."""

from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, make_hybrid_mesh, make_mesh  # noqa: F401
