from evdr_tpu_torch.losses.distill import (
    COMBINED_RECIPES,
    LOSS_REGISTRY,
    combined_loss,
    infonce_distillation_loss,
    infonce_supervised_loss,
    lambda_loss,
    listwise_distillation_loss,
    pairwise_distillation_loss,
    ranknce_loss,
    score_preserving_loss,
    score_preserving_std_loss,
    spl_loss,
)
