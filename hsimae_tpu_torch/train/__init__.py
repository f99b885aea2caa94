from hsimae_tpu_torch.train.optim import (
    timm_cosine_schedule,
    wd_mask,
    AdamW,
    pretrain_optimizer,
    finetune_optimizer,
)
from hsimae_tpu_torch.train.pretrain import make_pretrain_step, run_pretraining
from hsimae_tpu_torch.train.finetune import (
    cross_entropy_ignore0,
    make_dual_step,
    dual_branch_finetune,
    FinetuneResult,
)
from hsimae_tpu_torch.train.evaluate import classify_scene, evaluate_scene, SceneEvalResult
from hsimae_tpu_torch.train.protocol import run_protocol, ProtocolResult

__all__ = [
    "timm_cosine_schedule",
    "wd_mask",
    "AdamW",
    "pretrain_optimizer",
    "finetune_optimizer",
    "make_pretrain_step",
    "run_pretraining",
    "cross_entropy_ignore0",
    "make_dual_step",
    "dual_branch_finetune",
    "FinetuneResult",
    "classify_scene",
    "evaluate_scene",
    "SceneEvalResult",
    "run_protocol",
    "ProtocolResult",
]
