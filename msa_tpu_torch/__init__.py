"""msa_tpu_torch: the MSA framework on PyTorch and CUDA (NVIDIA Hopper).

The port of ``msa_tpu`` (JAX on TPU), slice by slice.  It reuses the JAX
package's host-only modules (configs, featurisation, tokenizers, the
serving line protocol) by importing them, and never imports jax.  Every
Pallas kernel on a ported path becomes a hand-written CUDA kernel for
``sm_90a`` (``csrc/``), built with nvcc at first use (``_build.py``), with
a plain PyTorch version beside it that runs for CPU tensors.

This slice: the bf16 serving path -- ``inference.Predictor`` and
``cli.serve.serve_stream`` over ``models.mmbert.mmbert_forward``.
"""
