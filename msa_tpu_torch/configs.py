"""Experiment configuration: the JAX package's host-only config classes.

``msa_tpu.configs`` imports no jax, so the port shares it as is instead of
copying it; this module is the port's one door to it.
"""

from msa_tpu.configs import (  # noqa: F401
    BertConfig,
    ExperimentConfig,
    MMBertConfig,
    build_experiment,
)
