from evdr_tpu_torch.parallel.mesh import (DeviceMesh, make_mesh, make_mesh_2d,
                                          mesh_of)
from evdr_tpu_torch.parallel.sharded_index import ShardedIndex, build_sharded_index
from evdr_tpu_torch.parallel.topk import sharded_maxsim, sharded_topk
