"""Unified training configuration (a copy of ``evdr_tpu/train/config.py``:
the same fields, defaults and ``validate()`` less its probe for orbax, so a
``config.json`` written by either package loads in the other).

One config + two selectors (``loss``, ``aug``) replace the reference's 24
near-identical ``main*.py`` scripts (SURVEY.md §2.2). Defaults follow the
reference flagship ``mainv2_iter_liscore.py:29-53`` argparser. Settings the
port does not run yet pass ``validate()`` and are refused by the harness
(``train/harness.py: check_ported``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List

from evdr_tpu_torch.losses.distill import COMBINED_RECIPES, LOSS_REGISTRY

VALID_LOSSES = tuple(LOSS_REGISTRY) + tuple(COMBINED_RECIPES)
VALID_AUGS = ("none", "qnoise", "mixup", "hardtoken")
VALID_TRAINERS = ("iter", "epoch")


@dataclass
class TrainConfig:
    # data
    datasets: List[str] = field(default_factory=lambda: ["tabfquad"])
    query_root: str = "data/proxyq"        # pseudo-query feature npz root
    teacher_root: str = "data/features"    # teacher (split_before / train / test) root
    init_root: str = "data/features/S3E_init"
    mfs: List[int] = field(default_factory=lambda: [5, 10, 25, 50])
    use_labeled_split: bool = False        # mainv1-style: train/test npz instead of ProxyQ

    # run
    out_root: str = "results"
    name: str = "run"
    seed: int = 42

    # trainer
    trainer: str = "iter"                  # 'iter' (step-based) | 'epoch'
    loss: str = "liscore"
    aug: str = "none"
    max_steps: int = 23460                 # mainv2_iter_* default
    epochs: int = 30                       # mainv2 epoch family default
    # 0 = auto: 200 for the iter trainer (mainv2_iter_liscore.py default),
    # once per epoch for the epoch trainer (reference epoch scripts evaluate
    # every epoch, mainv2_distill_infonce.py loop)
    eval_every: int = 0
    print_every: int = 20
    q_batch: int = 32
    full_batch: bool = False               # mainv1 SPL: one full-batch step per epoch

    # optimization (reference: AdamW lr 1e-3 wd 1e-2)
    opt: str = "adamw"
    lr: float = 1e-3
    weight_decay: float = 1e-2

    # loss hyperparameters
    temp: float = 0.1
    k: int = 40
    lambda_list: float = 1.0
    lambda_score: float = 1.0
    lambda_pair: float = 1.0
    lambda_info: float = 1.0
    list_temp: float = 1.0
    info_temp: float = 0.1
    alpha: float = 1.0                     # lambda_loss
    eps: float = 1e-6
    lambda_weight: float = 1.0             # ranknce regularizer weight

    # augmentation hyperparameters (mainv3 family defaults)
    q_noise_std: float = 0.01
    mixup_alpha: float = 0.2
    lambda_mix: float = 1.0
    virt_noise_std: float = 0.1
    lambda_aux: float = 0.3
    aux_docs: int = 4
    gap_log_every: int = 500
    gap_topk: int = 10

    # periodic export (mainv1.py:375-395: compressed_ep{N}.npz every
    # save_period epochs; 0 disables). Counted in epochs for the epoch
    # trainer, in raw steps for the iter trainer.
    save_period: int = 0
    # print masked-gradient/param invariants (mainv1.py:74-87 diagnostics)
    debug_invariants: bool = False

    # engine
    # >1 runs K optimizer steps per loop turn (the JAX package fuses them
    # into one dispatched program); logging/eval cadences round up to
    # multiples of K
    steps_per_dispatch: int = 1
    chunk_p: int = 128
    score_impl: str = "xla"                # 'xla' | 'pallas' | 'auto'
    eval_impl: str = "auto"
    precompute_teacher: bool = True        # teacher is frozen: score the pool once
    checkpoint_every: int = 0              # 0 = only best-npz artifacts
    checkpoint_backend: str = "npz"        # "npz" (single file) | "orbax"
    # closing the train->serve loop: after training, additionally convert
    # best_ndcg5.npz into the packed SERVING format at the given storage
    # tier (tools/convert_packed.py; "none" skips). The packed file drops
    # straight into RetrievalEngine.from_npz / evdr-serve.
    export_packed: str = "none"            # none|float32|bfloat16|int8|int4|pq|opq
    # quantization-aware distillation (ops/qat.py): score the student's
    # quantize->dequantize SERVING reconstruction in the train step with
    # straight-through gradients, so post-hoc index quantization at this
    # tier costs (much) less quality. Eval + best-checkpoint selection run
    # on the reconstruction too. 'pq' refits its codebooks on the current
    # student at every eval (the grid tracks the drifting embeddings) and
    # exports the final books with the best npz ("qat_books" key) — serve
    # with those, not a refit.
    # 'opq' = the shipped PQ form: expanded rotated codebooks
    # (ops/pq.expand_books); refits train_opq at every eval and serves via
    # engine pq_opq=True / the exported expanded qat_books
    qat: str = "none"                      # none|int8|int4|pq|opq
    # subvector count for qat='pq'/'opq' codebooks — MUST match the geometry
    # the index will be served/exported with (engine pq_m / convert_packed
    # --pq_m), or training targets the wrong quantization grid
    qat_pq_m: int = 16
    # QAT as a FINE-TUNE phase: the first frac*max_steps train WITHOUT the
    # STE pass (an identical trajectory to a qat='none' run under the same
    # seed — quantization noise in every training score from step 0
    # measurably DEGRADES the student, RESULTS.md round-4 QAT study), then
    # the tail adapts to the serving grid. Serving-form eval/selection
    # applies for the whole run either way. 0.0 = STE from step 0.
    qat_start_frac: float = 0.0
    # best-checkpoint selection window under a QAT fine-tune phase: when
    # True (default) best trackers only update at steps >= the STE switch,
    # so a "QAT" artifact is never a checkpoint from before the mechanism
    # engaged (VERDICT r4: several round-4 matrix cells selected pre-switch
    # checkpoints — those cells measured post-hoc quantization twice, not
    # QAT). False = legacy whole-run window (both numbers reportable via
    # two runs). No effect when qat='none' or qat_start_frac=0.
    qat_select_post: bool = True
    resume: bool = False
    # multi-device training: shard the student/teacher doc axis over an
    # N-device mesh (global-softmax losses via XLA collectives,
    # parallel/train_sharded.py); 0/1 = single device
    mesh_docs: int = 0

    def loss_hp(self) -> dict:
        return {
            "temperature": self.temp,
            "k": self.k,
            "lambda_list": self.lambda_list,
            "lambda_score": self.lambda_score,
            "lambda_pair": self.lambda_pair,
            "lambda_info": self.lambda_info,
            "list_temp": self.list_temp,
            "info_temp": self.info_temp,
            "alpha": self.alpha,
            "eps": self.eps,
            "lambda_weight": self.lambda_weight,
        }

    def validate(self) -> "TrainConfig":
        if self.loss not in VALID_LOSSES:
            raise ValueError(f"unknown loss {self.loss!r}; valid: {VALID_LOSSES}")
        if self.aug not in VALID_AUGS:
            raise ValueError(f"unknown aug {self.aug!r}; valid: {VALID_AUGS}")
        if self.trainer not in VALID_TRAINERS:
            raise ValueError(f"unknown trainer {self.trainer!r}")
        if self.opt != "adamw":
            raise ValueError("only adamw is supported (reference utils/utils.py:78-80)")
        if self.checkpoint_backend not in ("npz", "orbax"):
            raise ValueError(f"unknown checkpoint_backend {self.checkpoint_backend!r}")
        if self.export_packed not in ("none", "float32", "bfloat16", "int8",
                                      "int4", "pq", "opq"):
            raise ValueError(
                f"unknown export_packed {self.export_packed!r}")
        if self.qat not in ("none", "int8", "int4", "pq", "opq"):
            raise ValueError(f"unknown qat tier {self.qat!r}")
        if self.qat in ("pq", "opq") and self.mesh_docs > 1:
            raise ValueError(f"qat={self.qat!r} is single-device for now "
                             "(the codebook arg is not threaded through the "
                             "sharded step); int8/int4 QAT shard fine")
        if not 0.0 <= self.qat_start_frac < 1.0:
            raise ValueError(
                f"qat_start_frac must be in [0, 1), got {self.qat_start_frac}")
        # checkpoint_backend='orbax': the JAX package probes for orbax here;
        # the port refuses the backend (NotImplementedError, check_ported)
        if self.loss == "infonce_sup" and self.aug in ("mixup", "hardtoken"):
            # these augs build aux terms FROM teacher scores; the supervised
            # loss trains without a teacher (sc_t is None), so rejecting here
            # replaces an opaque trace-time TypeError. qnoise only perturbs
            # queries and composes fine.
            raise ValueError(
                f"aug={self.aug!r} requires teacher scores; the supervised "
                "'infonce_sup' loss has none (use aug='qnoise' or a "
                "distillation loss)")
        # mesh_docs > 1 composes with every loss (collective or row-gather
        # fallback), every teacher-based aug, and steps_per_dispatch —
        # parallel/train_sharded.py.
        return self

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), ensure_ascii=False, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "TrainConfig":
        return cls(**json.loads(text))
