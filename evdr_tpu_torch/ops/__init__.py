from evdr_tpu_torch.ops.cuda_maxsim import (
    maxsim_cuda,
    maxsim_cuda_f32,
    maxsim_cuda_int8,
    maxsim_cuda_int8full,
    maxsim_int8_plain,
    maxsim_int8full_plain,
    maxsim_plain,
)
from evdr_tpu_torch.ops.cuda_maxsim_train import (
    MaxSimFn,
    maxsim_bwd_plain,
    maxsim_cuda_bwd,
    maxsim_cuda_fwd_train,
    maxsim_fwd_train_plain,
)
from evdr_tpu_torch.ops.maxsim import (
    maxsim,
    maxsim_numpy,
    maxsim_torch,
    score_multi_vector,
    score_single_vector,
)
from evdr_tpu_torch.ops.quantize import dequantize_int8, quantize_tokens_int8
