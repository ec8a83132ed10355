"""Typed configuration objects, the port's own copy.

A copy of ``msa_tpu/configs.py``: the same frozen dataclasses, fields and
defaults, so one ``ExperimentConfig`` (or its JSON) drives either package.
The port keeps its own copy because it imports nothing of ``msa_tpu``; a
field added there is added here too.  Knobs that only the JAX runtime reads
(``prng_impl``, ``scan_unroll``, ``sequence_parallel``, ...) are carried
for the JSON round trip; the port's trainer says which ones it refuses.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional

# Modality feature dims (reference: config.py:12-17).
TEXTDIM = 1024
MOSEIVISUALDIM = 35
MOSIVISUALDIM = 47
FUNNYVISUALDIM = 371
CMUSPEECHDIM = 74
FUNNYSPEECHDIM = 81

MODALITY_DIMS = {
    # dataset -> (visual_dim, speech_dim)
    "mosi": (MOSIVISUALDIM, CMUSPEECHDIM),
    "mosei": (MOSEIVISUALDIM, CMUSPEECHDIM),
    "ur_funny": (FUNNYVISUALDIM, FUNNYSPEECHDIM),
}

EMOTIONS = ["sentiment", "happy", "sad", "anger", "surprise", "disgust", "fear"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class BertConfig:
    """BERT encoder hyper-parameters (HF-compatible semantics)."""

    vocab_size: int = 30522
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    # TPU-specific knobs (no reference equivalent): pad the vocab so the tied
    # MLM decoder matmul tiles cleanly onto the 128x128 MXU.
    vocab_pad_multiple: int = 128
    # Force the exact-erf gelu even in bf16 compute (SURVEY.md section 7
    # deviation (m)): by default bf16 uses the tanh approximation, whose
    # error is below bf16's own rounding but 17x cheaper on the VPU.  Set
    # True for bit-level HF parity runs.
    exact_gelu: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def padded_vocab_size(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_multiple)


BERT_BASE = BertConfig(
    hidden_size=768,
    num_hidden_layers=12,
    num_attention_heads=12,
    intermediate_size=3072,
)
BERT_LARGE = BertConfig()

BERT_PRESETS = {
    "bert-base-uncased": BERT_BASE,
    "bert-large-uncased": BERT_LARGE,
}


def _register_tiny_preset():
    # 'tiny' exists for CI/smoke runs (the reference CLI only offered
    # base/large, train.py:28); registered via function so tests can assert
    # the real presets stay untouched.
    BERT_PRESETS["tiny"] = BertConfig(
        vocab_size=30522, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=128,
        max_position_embeddings=128, vocab_pad_multiple=128)


_register_tiny_preset()


def tiny_bert_config(
    hidden_size: int = 32,
    num_hidden_layers: int = 2,
    num_attention_heads: int = 2,
    intermediate_size: int = 64,
    vocab_size: int = 128,
    max_position_embeddings: int = 96,
) -> BertConfig:
    """Small config for tests / CPU golden-value comparisons."""
    return BertConfig(
        vocab_size=vocab_size,
        hidden_size=hidden_size,
        num_hidden_layers=num_hidden_layers,
        num_attention_heads=num_attention_heads,
        intermediate_size=intermediate_size,
        max_position_embeddings=max_position_embeddings,
        vocab_pad_multiple=1,
    )


@dataclass(frozen=True)
class MMBertConfig:
    """The multimodal pretraining model.

    Mirrors the reference model definition (MMBertForPretraining.py:304-448,
    MMBertEmbedding.py:34-72) with fixes documented in SURVEY.md section 7:
      * cpc_size derives from hidden_size instead of the hardcoded 1024
        (ref MMBertForPretraining.py:328) unless overridden.
    """

    bert: BertConfig = field(default_factory=lambda: BERT_LARGE)
    visual_dim: int = MOSIVISUALDIM
    speech_dim: int = CMUSPEECHDIM
    num_labels: int = 1
    joint_dropout_prob: float = 0.5  # ref MMBertForPretraining.py:26
    alpha: float = 1.0
    beta: float = 1.0
    # reference defines nn.Dropout(0.38) but never applies it in forward
    # (MMBertForPretraining.py:322); kept as a documented no-op default.
    fusion_dropout_prob: float = 0.0
    cpc_size: Optional[int] = None  # None -> hidden_size

    @property
    def cpc_x_size(self) -> int:
        return self.cpc_size if self.cpc_size is not None else self.bert.hidden_size

    @property
    def regression(self) -> bool:
        # ref MMBertForPretraining.py:431: num_labels in (1, 7) -> MSE path
        return self.num_labels in (1, 7)

    def with_dataset(self, dataset: str) -> "MMBertConfig":
        vdim, sdim = MODALITY_DIMS[dataset]
        return dataclasses.replace(self, visual_dim=vdim, speech_dim=sdim)


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "mosi"  # mosi | mosei | ur_funny
    emotion: str = "sentiment"
    num_labels: int = 1
    max_seq_length: int = 40  # ref train.py:38
    # Frame-level mode (beyond-reference, SURVEY.md section 5.7 seam): keep
    # visual/speech streams at native frame rate with their own fixed length
    # Lp instead of word-aligning them to L; the joint passes then run over
    # L + Lp tokens (the blockwise flash kernel dispatches at L+Lp >= 1024).
    # None = reference behaviour (word-aligned, Lp == L).
    pair_seq_length: Optional[int] = None
    mlm: bool = True
    mlm_probability: float = 0.15  # ref train.py:37
    # Probability a joint view keeps its aligned pair (ref MMBertDataset.py:148:
    # r > 0.5 -> aligned, label 1).
    aligned_prob: float = 0.5
    seed: int = 0


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 5e-4  # ref train.py:29
    weight_decay: float = 0.01  # ref train.py:83
    warmup_proportion: float = 0.1
    n_epochs: int = 200
    train_batch_size: int = 32
    val_batch_size: int = 4
    test_batch_size: int = 8
    gradient_accumulation_steps: int = 1
    max_grad_norm: float = 0.0  # 0 disables clipping (reference never clips)
    patience: int = 25  # ref trainer.py:279
    # Deviations from reference bugs, each documented in SURVEY.md section 7:
    # (d) no MLM masking at eval; (h) model selection on the val split.
    eval_masking: bool = False
    eval_random_pairs: bool = False
    select_on: str = "val"  # 'val' | 'test' ('test' replicates ref trainer.py:268)
    # TPU execution knobs.
    compute_dtype: str = "bfloat16"  # bfloat16 | float32
    use_flash_attention: str = "auto"  # auto | always | never
    remat: bool = True  # checkpoint encoder layers + fused MLM CE
    # PRNG implementation for training keys: 'rbg' is much faster than
    # 'threefry2x32' on TPU for the per-step dropout/masking draws.
    prng_impl: str = "rbg"
    # One [3B, 2L] encoder call per step instead of [B, L] + [2B, 2L]
    # (see mmbert_forward.fuse_text_pass).  Measured on v5e at B=32/L=40:
    # the +20% padded tokens cost more than the saved launches -> off.
    fuse_text_pass: bool = False
    # lax.scan unroll factor over encoder layers (compile time vs schedule).
    # 0 = no scan at all: a Python loop over static layer indices, which
    # turns the per-layer remat residuals into independent buffers (no
    # scan-stash dynamic_slice/squeeze copies in the backward) at ~L x the
    # compile time.  None = auto (round 5): 0 at frame level on the flash
    # path -- the scan-stash copies it deletes scale with the stash, a
    # measured win at every benched length (S=1024: 767.3 -> 755.1 ms,
    # BENCH.md round 4/5) -- and 1 (scan) everywhere else, where noscan
    # measured neutral-to-worse and compiles ~L x slower.
    scan_unroll: Optional[int] = None
    # Megatron-style sequence parallelism (requires model_parallel > 1):
    # the residual stream is constrained to a sequence-sharded layout at
    # LayerNorm boundaries, so GSPMD turns the TP all-reduces into
    # reduce-scatter + all-gather and LN/dropout/residual math runs on
    # S/mp tokens per chip.  Identity on numerics (tests/test_seq_parallel.py).
    sequence_parallel: bool = False
    # remat policy: 'auto' | 'full' (recompute all) | 'dots' (save all
    # matmul outputs) | 'save_small' (save only [*, H]-wide outputs;
    # recompute FFN + softmax) | 'save_wide' (save FFN tensors too) |
    # 'save_attn' (save q/k/v/ctx per layer: backward skips the attention
    # kernel's forward recompute and the QKV projections) | 'save_pack'
    # (save_attn bytes packed as [*,3H] q|k|v + [*,H] ctx -- 2 stash
    # buffers/layer instead of 4, via the packed short kernel; degrades to
    # save_attn where that kernel cannot dispatch) | 'save_ctx'
    # (save only the attention output; QKV recomputed, kernel never
    # re-run).  'auto' walks the measured v5e ladder in
    # Trainer._resolve_remat_policy: save_attn while its per-layer stash
    # fits the HBM budget (from device.memory_stats), then save_ctx, then
    # full (BENCH.md: B<=120 save_attn, B=128-160 save_ctx word-aligned).
    # Any named policy takes a '+drop' suffix (e.g. 'save_ctx+drop',
    # 'full+drop'): ALSO stash the bool dropout masks so the backward
    # reads them instead of re-running the PRNG (models/bert.py), and/or a
    # '+probs' suffix: stash the short-attention kernel's signed
    # post-softmax probs so its backward skips the whole softmax+dropout
    # recompute (ops/short_attention.py v2s; no-op where that kernel does
    # not dispatch).  Suffixes compose ('save_attn+drop+probs'); pairing
    # one with a base that cannot honor it ('dots', 'auto') raises.
    remat_policy: str = "auto"
    # dtype for Adam's first moment (mu): bfloat16 halves its HBM traffic in
    # the (bandwidth-bound) update with no observed training difference; use
    # float32 for bit-exact torch AdamW parity.
    adam_mu_dtype: str = "float32"
    # dtype for Adam's second moment (nu); honored by both the optax path
    # (optim.scale_by_adam_casted) and the fused path.  bfloat16 shaves the
    # update's nu read+write; nu only feeds 1/(sqrt(nu_hat)+eps), so its
    # ~0.4% rounding perturbs the effective per-param LR by <0.2% -- loss
    # trajectories track f32 within 5% over 30 steps
    # (tests/test_nu16_quality.py).  float32 default here for bit-exact
    # torch AdamW parity; bench.py flips it (like mu) for the perf config.
    adam_nu_dtype: str = "float32"
    # Run the AdamW update as one fused kernel pass per tensor
    # (training/optim.py::FusedAdamW, csrc/fused_adamw.cu in this port);
    # semantics identical to the optax path.  Measured SLOWER on the v5e flagship step (315.2 vs 311.4 ms,
    # BENCH.md round 2: XLA's update fusions overlap with the backward
    # while per-tensor custom-calls serialize), so it defaults off; kept
    # for regimes with many small tensors.  Requires
    # gradient_accumulation_steps == 1.
    fused_optimizer: bool = False
    # Include the global gradient norm in per-step train metrics (one extra
    # full read of the grads, ~1% step time at bert-large).
    log_grad_norm: bool = False
    # Write a jax profiler trace of train steps [profile_start, profile_stop)
    # of epoch 0 into this directory (None = off).  Ref has no tracing at all
    # (SURVEY.md section 5.1).
    profile_dir: Optional[str] = None
    profile_start: int = 3
    profile_stop: int = 8
    data_parallel: int = -1  # -1 -> all devices
    model_parallel: int = 1
    seed: int = 42


@dataclass(frozen=True)
class ExperimentConfig:
    model_name: str = "bert-large-uncased"
    model: MMBertConfig = field(default_factory=MMBertConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentConfig":
        raw = json.loads(text)
        return cls(
            model_name=raw.get("model_name", "bert-large-uncased"),
            model=_mmbert_from_dict(raw.get("model", {})),
            data=DataConfig(**raw.get("data", {})),
            train=TrainConfig(**raw.get("train", {})),
        )


def _mmbert_from_dict(raw: dict) -> MMBertConfig:
    raw = dict(raw)
    bert = raw.pop("bert", None)
    kwargs: dict[str, Any] = dict(raw)
    if bert is not None:
        kwargs["bert"] = BertConfig(**bert)
    return MMBertConfig(**kwargs)


def build_experiment(
    dataset: str = "mosi",
    model_name: str = "bert-large-uncased",
    num_labels: int = 1,
    emotion: str = "sentiment",
    alpha: float = 1.0,
    beta: float = 1.0,
    **train_overrides: Any,
) -> ExperimentConfig:
    """Convenience builder mirroring the reference CLI surface (train.py:24-41)."""
    bert = BERT_PRESETS[model_name]
    vdim, sdim = MODALITY_DIMS[dataset]
    model = MMBertConfig(
        bert=bert,
        visual_dim=vdim,
        speech_dim=sdim,
        num_labels=num_labels,
        alpha=alpha,
        beta=beta,
    )
    data = DataConfig(dataset=dataset, emotion=emotion, num_labels=num_labels)
    train = TrainConfig(**train_overrides)
    return ExperimentConfig(model_name=model_name, model=model, data=data, train=train)
