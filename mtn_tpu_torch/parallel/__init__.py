from mtn_tpu_torch.parallel import multihost
from mtn_tpu_torch.parallel.mesh import make_mesh
from mtn_tpu_torch.parallel.sharding import Shardings, default_rules

__all__ = ["make_mesh", "Shardings", "default_rules", "multihost"]
