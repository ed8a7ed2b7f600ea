from evdr_tpu_torch.parallel.mesh import (DeviceMesh, make_mesh, make_mesh_2d,
                                          mesh_of)
from evdr_tpu_torch.parallel.sharded_index import ShardedIndex, build_sharded_index
from evdr_tpu_torch.parallel.topk import sharded_maxsim, sharded_topk
from evdr_tpu_torch.parallel.train_sharded import (
    build_sharded_eval_loss, build_sharded_train_step, has_collective_form,
    precompute_teacher_scores_sharded)
