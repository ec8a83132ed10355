"""msa_tpu_torch: the MSA framework on PyTorch and CUDA (NVIDIA Hopper).

The port of ``msa_tpu`` (JAX on TPU), slice by slice.  It imports torch and
never jax, and nothing of ``msa_tpu``: the host-only modules it needs
(configs, featurisation, tokenizers, the batch iterator, the serving line
protocol, the FLOPs model) are its own copies.  Every Pallas kernel on a
ported path becomes a hand-written CUDA kernel for ``sm_90a`` (``csrc/``),
built with nvcc at first use (``_build.py``), with a plain PyTorch version
beside it that runs for CPU tensors.

Ported so far:

* serving -- ``inference.Predictor`` and ``cli.serve.serve_stream`` over
  ``models.mmbert.mmbert_forward``;
* training -- ``training.trainer.Trainer``: the train step (MLM masking,
  dropout, the joint loss, the backward through the attention kernels,
  AdamW, or the fused AdamW kernel under ``fused_optimizer``) and the eval
  step, ``fit`` and the CLIs, the named remat policies;
* the host-side surface -- ``fuse_text_pass``, ``Predictor(
  inflight_batches=)``, ``TrainConfig.profile_dir``, ``cli.sweep``,
  ``cli.preprocess``;
* data parallelism across processes -- ``parallel`` (a mesh of ranks, the
  launch and the collectives) under ``Trainer``, ``Predictor`` and
  ``cli.train --dp``; tensor and sequence parallelism are not ported yet.
"""
