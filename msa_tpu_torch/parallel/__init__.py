"""Parallelism of the port: the (data, model) mesh of ranks and the
multi-process data-parallel launch (``msa_tpu/parallel``'s counterparts;
tensor parallelism is not ported yet)."""

from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, make_hybrid_mesh, make_mesh  # noqa: F401
