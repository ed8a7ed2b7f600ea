from evdr_tpu_torch.parallel.sharded_index import ShardedIndex, build_sharded_index
from evdr_tpu_torch.parallel.topk import sharded_maxsim, sharded_topk
