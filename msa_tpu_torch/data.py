"""Featurisation and tokenizers: the JAX package's host-only data code.

``msa_tpu.data.featurize``, ``wordpiece`` and ``fast_wordpiece`` are numpy
and Python and import no jax, so the port shares them as they are.
"""

from msa_tpu.data.fast_wordpiece import FastTokenizer  # noqa: F401
from msa_tpu.data.featurize import FeaturizedSplit, synthetic_split  # noqa: F401
from msa_tpu.data.wordpiece import make_test_vocab  # noqa: F401
