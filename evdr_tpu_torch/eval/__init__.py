from evdr_tpu_torch.eval.evaluator import (
    CustomRetrievalEvaluator,
    eval_retrieval,
    scores_to_results,
)
from evdr_tpu_torch.eval.metrics import compute_retrieval_metrics
