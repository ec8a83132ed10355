"""Host-side data code: featurisation, tokenizers and the batch iterator.

The port's own copies of ``msa_tpu/data/{featurize,wordpiece,fast_wordpiece,
dataset}.py`` (numpy and Python; the port imports nothing of ``msa_tpu``).
"""

from .dataset import MultimodalDataset, sample_pairing  # noqa: F401
from .fast_wordpiece import FastTokenizer  # noqa: F401
from .featurize import FeaturizedSplit, featurize, synthetic_split  # noqa: F401
from .wordpiece import Tokenizer, make_test_vocab  # noqa: F401
