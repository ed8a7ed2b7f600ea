from evdr_tpu_torch.ops.cuda_maxsim import (
    maxsim_cuda,
    maxsim_cuda_int8,
    maxsim_cuda_int8full,
    maxsim_int8_plain,
    maxsim_int8full_plain,
    maxsim_plain,
)
from evdr_tpu_torch.ops.maxsim import (
    maxsim_numpy,
    maxsim_torch,
    score_multi_vector,
    score_single_vector,
)
from evdr_tpu_torch.ops.quantize import dequantize_int8, quantize_tokens_int8
